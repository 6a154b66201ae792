// The sysid lag history: the states of the 8 thrusters' third-order lag
// filters over a whole recording, hist (N, 8, 3) from the static-curve
// thrusts F_cmd (N, 8), x_{k+1} = Ad x_k + Bd f_k from rest; hist[k] is the
// state before F_cmd[k] (hist[0] is zero).  Templated on float and double.
//
// Replaces no Pallas kernel: the JAX package's lag_history is a lax.scan
// (bluerov2_dynamics_tpu/models/sysid.py:219) with no pallas_call.  The port
// ran it as a Python loop of about 3 launches a row, some 110,000 at the
// 36,658 rows of a tank recording's training split, most of a fit's wall
// time (PERF.md); here it is one launch.
//
// What bounds it on an H100: by bytes, N x 8 values read and N x 24 written,
// 1.2 MB and 3.5 MB in float32 at 36,658 rows, ~1.4 us at 3.35 TB/s.  In
// practice the serial chain: ceil(N / 256) chunks, each 16 dependent lag
// steps a lane and 5 shuffle levels (PERF.md's kernel table has the measured
// time).  At a fit's size that is well under 1% of the fit, so a multi-block
// look-back scan, which would cut the chain, is not worth its complexity.
//
// Design: one block of 8 warps, one thruster a warp, over chunks of kChunk
// rows: the lane scan of rollout.cu's tau_chunk_scan.  Each lane runs its
// kLaneRows rows from rest (lane 0 from the chunk's start state); a 5-level
// __shfl_up_sync scan combines the lanes' affine maps x -> P x + e, with
// P = Ad^kLaneRows squared at each level (the lag is contractive, |eig(Ad)| <
// 0.77 at dt = 0.02, so the reassociated sum stays within rounding of the
// serial one); each lane reruns its rows from its true start state and
// writes the state before each row; the last lane's end state carries into
// the next chunk.  The next chunk's F_cmd is prefetched with cp.async while
// the current one scans, into a lane-major layout that the lanes read
// without bank conflicts.  A chunk's output is staged in shared memory,
// swizzled so that the lanes' writes and the vector reads spread over the
// banks, and goes out as coalesced 16-byte stores.  Ad and Bd are read from
// device memory, so the launcher never reads them back to the host.
// models/thrusters.py::lag_history_chunked is its plain version, in the same
// association order.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThrusters = 8;
constexpr int kLanes = 32;                          // one warp a thruster
constexpr int kBlock = kThrusters * kLanes;
constexpr int kChunk = 256;                         // rows a pass
constexpr int kLaneRows = kChunk / kLanes;          // 8 rows a lane
constexpr int kScanLevels = 5;                      // log2(kLanes)
constexpr int kRowOut = kThrusters * 3;             // values of one row of hist
constexpr int kLaneOut = kLaneRows * kRowOut;       // values of one lane's rows
constexpr int kFStride = kLanes + 1;                // s_F row (thruster, lane row), padded
constexpr int kFSize = kThrusters * kLaneRows * kFStride;   // one F buffer
constexpr int kOutSize = kChunk * kRowOut;
constexpr int kOutSlots = kOutSize + kOutSize / 32 + kOutSize / kLaneOut;
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(kLaneRows == 8, "Ad^kLaneRows is three squarings");
static_assert(kLanes == 1 << kScanLevels, "one scan level a doubling");
static_assert(kLaneOut % 32 == 0 && kOutSize % 4 == 0, "the output swizzle");

// The shared slot of value e of a chunk's output (e = row * 24 + 3 j + r):
// one pad slot every 32 values spreads 32 threads' reads of consecutive
// vectors over the banks (two-way at most, where they straddle a lane's
// rows), one more every lane's rows (192 values) the 32 lanes' writes of one
// (row, thruster, component).
__device__ __forceinline__ int out_slot(int e) { return e + e / 32 + e / kLaneOut; }

// The 16 bytes of output from value e on: 4 floats or 2 doubles.
__device__ __forceinline__ float4 gather16(const float* s_out, int e) {
  return make_float4(s_out[out_slot(e)], s_out[out_slot(e + 1)], s_out[out_slot(e + 2)],
                     s_out[out_slot(e + 3)]);
}

__device__ __forceinline__ double2 gather16(const double* s_out, int e) {
  return make_double2(s_out[out_slot(e)], s_out[out_slot(e + 1)]);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(kBytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Rows t0 .. t0+n-1 of F (row-major, 8 a row) into s_F: row s = 8 l + i of
// the chunk, thruster j at (j * kLaneRows + i) * kFStride + l.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ F, int64_t t0, int n, T* s_F) {
  for (int e = threadIdx.x; e < n * kThrusters; e += kBlock) {
    const int s = e / kThrusters, j = e % kThrusters;
    cp_async<sizeof(T)>(&s_F[(j * kLaneRows + s % kLaneRows) * kFStride + s / kLaneRows],
                        F + t0 * kThrusters + e);
  }
  cp_async_commit();
}

// R <- A A for a row-major 3x3 A.
template <typename T>
__device__ __forceinline__ void square3(const T* A, T* R) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      R[r * 3 + q] = A[r * 3] * A[q] + A[r * 3 + 1] * A[3 + q] + A[r * 3 + 2] * A[6 + q];
    }
  }
}

// x <- Ad x + Bd f (thrusters.lag_step's state update).
template <typename T>
__device__ __forceinline__ void lag_step(const T* Ad, const T* Bd, T* x, T f) {
  const T n0 = Ad[0] * x[0] + Ad[1] * x[1] + Ad[2] * x[2] + Bd[0] * f;
  const T n1 = Ad[3] * x[0] + Ad[4] * x[1] + Ad[5] * x[2] + Bd[1] * f;
  const T n2 = Ad[6] * x[0] + Ad[7] * x[1] + Ad[8] * x[2] + Bd[2] * f;
  x[0] = n0;
  x[1] = n1;
  x[2] = n2;
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
lag_history_kernel(const T* __restrict__ Ad_g, const T* __restrict__ Bd_g,
                   const T* __restrict__ F, T* __restrict__ hist, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_F = reinterpret_cast<T*>(smem);  // two buffers of kFSize
  T* s_out = s_F + 2 * kFSize;          // kOutSlots
  const int j = threadIdx.x / kLanes;   // thruster
  const int l = threadIdx.x % kLanes;   // lane
  const int chunks = (N + kChunk - 1) / kChunk;
  if (chunks > 0) load_chunk(F, 0, min(kChunk, N), s_F);

  T Ad[9], Bd[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) Ad[i] = Ad_g[i];
#pragma unroll
  for (int r = 0; r < 3; ++r) Bd[r] = Bd_g[r];
  // P[s] = Ad^(kLaneRows 2^s): the map of 2^s lanes' rows
  T P[kScanLevels][9], A[9];
  square3(Ad, A);
  square3(A, P[0]);
  square3(P[0], A);
#pragma unroll
  for (int i = 0; i < 9; ++i) P[0][i] = A[i];
#pragma unroll
  for (int s = 1; s < kScanLevels; ++s) square3(P[s - 1], P[s]);

  T L[3] = {T(0), T(0), T(0)};  // this thruster's state at the chunk's start
  for (int c = 0; c < chunks; ++c) {
    const int r0 = c * kChunk;
    const int64_t t0 = r0;
    const int n = min(kChunk, N - r0);
    // the next chunk's buffer was last read before the previous chunk's
    // second barrier
    if (c + 1 < chunks) {
      load_chunk(F, t0 + kChunk, min(kChunk, N - r0 - kChunk), s_F + ((c + 1) & 1) * kFSize);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's F is in; the previous chunk's output is out
    const T* f_s = s_F + (c & 1) * kFSize;
    const int s0 = l * kLaneRows;  // the lane's first row
    const int k = max(0, min(kLaneRows, n - s0));
    T f[kLaneRows];
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i) {
      f[i] = i < k ? f_s[(j * kLaneRows + i) * kFStride + l] : T(0);
    }
    // the lane's rows from rest (lane 0 from the chunk's start state)
    T e[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) e[r] = l == 0 ? L[r] : T(0);
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i) {
      if (i < k) lag_step(Ad, Bd, e, f[i]);
    }
    // inclusive scan of the lanes' maps: e_l <- P^(2^s) e_(l - 2^s) + e_l; a
    // lane past the last row has no map, and only lanes after it read it
#pragma unroll
    for (int s = 0; s < kScanLevels; ++s) {
      const int d = 1 << s;
      T o[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) o[r] = __shfl_up_sync(kFullMask, e[r], d);
      if (l >= d) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          e[r] = P[s][r * 3] * o[0] + P[s][r * 3 + 1] * o[1] + P[s][r * 3 + 2] * o[2] + e[r];
        }
      }
    }
    // each lane starts where the lane before it ended; rerun from there,
    // writing the state before each row
    T x[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      x[r] = __shfl_up_sync(kFullMask, e[r], 1);
      if (l == 0) x[r] = L[r];
    }
#pragma unroll
    for (int i = 0; i < kLaneRows; ++i) {
      if (i < k) {
        const int base = (s0 + i) * kRowOut + 3 * j;
#pragma unroll
        for (int r = 0; r < 3; ++r) s_out[out_slot(base + r)] = x[r];
        lag_step(Ad, Bd, x, f[i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) L[r] = __shfl_sync(kFullMask, x[r], kLanes - 1);
    __syncthreads();
    // the chunk's n rows out, 16 bytes a thread and store
    using V = decltype(gather16(s_out, 0));
    constexpr int kVec = sizeof(V) / sizeof(T);
    V* out = reinterpret_cast<V*>(hist + t0 * kRowOut);
    for (int q = threadIdx.x; q < n * kRowOut / kVec; q += kBlock) {
      out[q] = gather16(s_out, q * kVec);
    }
  }
}

template <typename T>
int launch(const void* Ad, const void* Bd, const void* F, void* hist, int N, cudaStream_t s) {
  constexpr int bytes = (2 * kFSize + kOutSlots) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(lag_history_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lag_history_kernel<T><<<1, kBlock, bytes, s>>>(
      static_cast<const T*>(Ad), static_cast<const T*>(Bd), static_cast<const T*>(F),
      static_cast<T*>(hist), N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// hist (N, 8, 3) from F (N, 8), both contiguous, allocated by the caller,
// hist 16-byte aligned; Ad (3, 3) row-major and Bd (3) in device memory;
// all float32, or all float64 where is_double.
int brov2_lag_history(const void* Ad, const void* Bd, const void* F, void* hist, int N,
                      int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? launch<double>(Ad, Bd, F, hist, N, s) : launch<float>(Ad, Bd, F, hist, N, s);
}

const char* brov2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
