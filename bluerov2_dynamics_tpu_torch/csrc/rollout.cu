// K1: euler12 rollout of B starts for T steps under ONE shared command
// sequence, and its prologue, the shared wrench sequence tau_seq (T, 6).
//
// Replaces ops/pallas_rollout.py::make_rollout_final_pallas (kernel body
// kernel_factory) of the JAX package, and the lax.scan shared_tau_sequence
// that feeds it.
//
// What bounds it on an H100: operations.  Per trajectory and RK4 step the
// row step does ~684 flops, 8 divisions and 12 exact sincosf (24 sines and
// cosines); the only traffic is x0 read once, xT written once and U
// (16 KB at T=500), so the FP32 pipes, not memory, set the floor.  The
// design keeps the 12 states of a trajectory in registers for all T steps
// (one thread per start) and stages tau_seq through shared memory in
// chunks, where every thread of the block reads the same word (a
// broadcast, no bank conflict).  Each angle's sine and cosine come from one
// range reduction (fossen_rows.cuh).  Blocks of kBlock = 256 threads (by
// measurement: 64 and 128 were 1-2% slower, PERF.md); __launch_bounds__
// keeps 3 blocks resident an SM (72 registers on a ready tau_seq, 80 with
// the prologue folded in, no spill), so up to 101,376 trajectories run in
// one wave, the bench's 65,536 among them.  No tensor cores: the work is a
// recurrence of scalar f32 operations with no matrix product to give
// them.
//
// The prologue (curve, lag, wrench map) is latency, not work: ~60 flops a
// step, but the third-order lag is a serial recurrence of ~4 dependent
// FMAs a step.  A chunk of kTauChunk steps runs on the block's 8 warps,
// one thruster a warp and kLaneSteps steps a lane: each lane runs its steps
// from rest, a 5-level warp-shuffle scan combines the lanes' affine maps
// (the lag is contractive: |eig(Ad)| < 0.77 at dt = 0.02, so the
// reassociated sum stays within float32 rounding of the serial one), and
// each lane reruns its steps from its true start state; then one thread a
// step applies the wrench map.  The main path runs it inside K1 itself
// (rollout_commands_kernel): every block computes each chunk of tau_seq
// straight into its shared memory before it steps, so U -> xT is one
// launch with no tau_seq in device memory.  The repeated work is
// 256 blocks x T x 8 lag steps, about 0.1% of K1's flops.  By measurement
// (PERF.md, the K1 prologue candidates) this beat the prologue as a kernel of its own before K1,
// serial or scanned, with or without programmatic dependent launch.
// ops/cuda_rollout.py::shared_tau_sequence_chunked is its plain version,
// in the same association order; tau_seq_kernel runs it alone.
#include <cstdint>

#include "fossen_rows.cuh"

namespace {

constexpr int kTauChunk = 256;  // steps of tau_seq staged per pass (6 KB)
constexpr int kBlock = 256;     // threads per block
constexpr int kMinBlocks = 2;   // at most 128 registers a thread (rollout_kernel takes 72)
// K1 with the prologue folded in: 3 blocks an SM, at most 80 registers, as
// resident as rollout_kernel and as fast as 2 blocks (PERF.md)
constexpr int kCommandsMinBlocks = 3;
constexpr int kLanes = 32;      // lanes of one thruster's lag scan: one warp
constexpr int kLaneSteps = kTauChunk / kLanes;  // 8 steps a lane
constexpr int kLaneStride = kLaneSteps + 1;     // a lane's row in s_F, padded: no bank conflict
constexpr int kScanLevels = 5;  // log2(kLanes)
constexpr int kFSize = 8 * kLanes * kLaneStride;

static_assert(kBlock == 8 * kLanes, "one warp a thruster");
static_assert(kTauChunk == kBlock, "one step a thread in the wrench map");
static_assert(kLaneSteps == 8, "Ad^kLaneSteps is three squarings");

// A <- A A for a row-major 3x3 A.
__device__ __forceinline__ void square3(float* A) {
  float R[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      R[r * 3 + q] = A[r * 3] * A[q] + A[r * 3 + 1] * A[3 + q] + A[r * 3 + 2] * A[6 + q];
    }
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) A[i] = R[i];
}

// One chunk of n <= kTauChunk steps of tau_seq from its commands U (n, 8),
// on all kBlock threads of the block: out[t * 6 + i] for t < n.  L is the
// lag state of this warp's thruster at the chunk's start, the same in
// every lane; it leaves as the state after the chunk's last step when the
// chunk is full.  Ends with the wrench map; the caller syncs before s_F is
// written again.
__device__ __forceinline__ void tau_chunk_scan(const ThrusterConsts& c, const float* __restrict__ U,
                                               int n, bool use_lag, float* L, float* s_F,
                                               float* out) {
  const int j = threadIdx.x / kLanes;  // thruster
  const int l = threadIdx.x % kLanes;  // lane
  const int s0 = l * kLaneSteps;       // the lane's first step
  const int k = max(0, min(kLaneSteps, n - s0));
  float f[kLaneSteps];
#pragma unroll
  for (int i = 0; i < kLaneSteps; ++i) {
    f[i] = i < k ? static_thrust_row(c, U[(s0 + i) * 8 + j]) : 0.0f;
  }
  if (use_lag) {
    // the lane's steps from rest (lane 0 from the chunk's start state)
    float e[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) e[r] = l == 0 ? L[r] : 0.0f;
#pragma unroll
    for (int i = 0; i < kLaneSteps; ++i) {
      if (i < k) lag_row(c, e, f[i]);
    }
    // inclusive scan of the lanes' maps x -> P x + e, P = Ad^kLaneSteps:
    // e_l <- P^(2^s) e_(l - 2^s) + e_l; a lane past the last step has no
    // map, and only lanes after it (which have no steps) read its result
    float P[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) P[i] = c.Ad[i];
    square3(P);
    square3(P);
    square3(P);
#pragma unroll
    for (int s = 0; s < kScanLevels; ++s) {
      const int d = 1 << s;
      float o[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) o[r] = __shfl_up_sync(BROV2_FULL_MASK, e[r], d);
      if (l >= d) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          e[r] = P[r * 3] * o[0] + P[r * 3 + 1] * o[1] + P[r * 3 + 2] * o[2] + e[r];
        }
      }
      if (s + 1 < kScanLevels) square3(P);
    }
    // each lane's start is the lane before it's end; rerun from there
    float x[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      x[r] = __shfl_up_sync(BROV2_FULL_MASK, e[r], 1);
      if (l == 0) x[r] = L[r];
    }
#pragma unroll
    for (int i = 0; i < kLaneSteps; ++i) {
      if (i < k) f[i] = lag_row(c, x, f[i]);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) L[r] = __shfl_sync(BROV2_FULL_MASK, x[r], kLanes - 1);
  }
#pragma unroll
  for (int i = 0; i < kLaneSteps; ++i) {
    if (i < k) s_F[(j * kLanes + l) * kLaneStride + i] = f[i];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < n) {
    float Ft[8], tt[6];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      Ft[q] = s_F[(q * kLanes + t / kLaneSteps) * kLaneStride + t % kLaneSteps];
    }
    wrench_rows(c, Ft, tt);
#pragma unroll
    for (int i = 0; i < 6; ++i) out[t * 6 + i] = tt[i];
  }
}

// The prologue alone: one block writes tau (T, 6).
__global__ void __launch_bounds__(kBlock)
tau_seq_kernel(ThrusterConsts c, const float* __restrict__ U, float* __restrict__ tau, int T,
               int use_lag) {
  __shared__ float s_F[kFSize];
  float L[3] = {0.0f, 0.0f, 0.0f};
  for (int t0 = 0; t0 < T; t0 += kTauChunk) {
    const int n = min(kTauChunk, T - t0);
    __syncthreads();
    tau_chunk_scan(c, U + t0 * 8, n, use_lag != 0, L, s_F, tau + t0 * 6);
  }
}

template <int METHOD>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
rollout_kernel(RowConsts k, const float* __restrict__ tau_seq, const float* __restrict__ x0,
               float* __restrict__ xT, int B, int T) {
  __shared__ float s_tau[kTauChunk * 6];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  float x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = live ? x0[(int64_t)b * 12 + i] : 0.0f;

  for (int t0 = 0; t0 < T; t0 += kTauChunk) {
    const int n = min(kTauChunk, T - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n * 6; j += blockDim.x) s_tau[j] = tau_seq[t0 * 6 + j];
    __syncthreads();
    if (live) {
      for (int t = 0; t < n; ++t) step_rows<METHOD>(k, x, &s_tau[t * 6]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 12; ++i) xT[(int64_t)b * 12 + i] = x[i];
  }
}

// K1 with its prologue folded in: each block computes every chunk of
// tau_seq from U into s_tau before it steps; block 0 also writes it to
// tau_out where that is not null.
template <int METHOD>
__global__ void __launch_bounds__(kBlock, kCommandsMinBlocks)
rollout_commands_kernel(RowConsts k, ThrusterConsts c, const float* __restrict__ U,
                        const float* __restrict__ x0, float* __restrict__ xT,
                        float* __restrict__ tau_out, int B, int T, int use_lag) {
  __shared__ float s_tau[kTauChunk * 6];
  __shared__ float s_F[kFSize];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  float x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = live ? x0[(int64_t)b * 12 + i] : 0.0f;
  float L[3] = {0.0f, 0.0f, 0.0f};

  for (int t0 = 0; t0 < T; t0 += kTauChunk) {
    const int n = min(kTauChunk, T - t0);
    __syncthreads();
    tau_chunk_scan(c, U + t0 * 8, n, use_lag != 0, L, s_F, s_tau);
    __syncthreads();
    if (tau_out != nullptr && blockIdx.x == 0) {
      for (int j = threadIdx.x; j < n * 6; j += blockDim.x) tau_out[t0 * 6 + j] = s_tau[j];
    }
    if (live) {
      for (int t = 0; t < n; ++t) step_rows<METHOD>(k, x, &s_tau[t * 6]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 12; ++i) xT[(int64_t)b * 12 + i] = x[i];
  }
}

}  // namespace

extern "C" {

// tau (T, 6) is allocated by the caller; F_scratch is not used (the
// prologue stages its thrusts in shared memory).
int brov2_tau_seq(const void* consts, const float* U, float* F_scratch, float* tau,
                  int T, int use_lag, void* stream) {
  (void)F_scratch;
  const ThrusterConsts c = *static_cast<const ThrusterConsts*>(consts);
  tau_seq_kernel<<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(c, U, tau, T, use_lag);
  return static_cast<int>(cudaGetLastError());
}

int brov2_rollout_final(const void* consts, const float* tau_seq, const float* x0, float* xT,
                        int B, int T, int method, void* stream) {
  const RowConsts k = *static_cast<const RowConsts*>(consts);
  const dim3 grid((B + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (method == 0) {
    rollout_kernel<0><<<grid, kBlock, 0, s>>>(k, tau_seq, x0, xT, B, T);
  } else {
    rollout_kernel<1><<<grid, kBlock, 0, s>>>(k, tau_seq, x0, xT, B, T);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 from the commands: U (T, 8) and x0 (B, 12) -> xT (B, 12) in one
// launch, the prologue folded in; tau (T, 6) receives tau_seq where it is
// not null (block 0 writes it, so one block runs even at B = 0).
int brov2_rollout_from_commands(const void* row_consts, const void* thr_consts, const float* U,
                                const float* x0, float* xT, float* tau, int B, int T, int method,
                                int use_lag, void* stream) {
  const RowConsts k = *static_cast<const RowConsts*>(row_consts);
  const ThrusterConsts c = *static_cast<const ThrusterConsts*>(thr_consts);
  const dim3 grid(max(1, (B + kBlock - 1) / kBlock));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (method == 0) {
    rollout_commands_kernel<0><<<grid, kBlock, 0, s>>>(k, c, U, x0, xT, tau, B, T, use_lag);
  } else {
    rollout_commands_kernel<1><<<grid, kBlock, 0, s>>>(k, c, U, x0, xT, tau, B, T, use_lag);
  }
  return static_cast<int>(cudaGetLastError());
}

// The block size brov2_rollout_final launches, and the resident blocks per
// SM of rollout_kernel<method> at that size.
int brov2_rollout_occupancy(int method, int* block, int* blocks_per_sm) {
  *block = kBlock;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, method == 0 ? rollout_kernel<0> : rollout_kernel<1>, kBlock, 0));
}

// The same for rollout_commands_kernel<method>, which
// brov2_rollout_from_commands launches.
int brov2_rollout_commands_occupancy(int method, int* block, int* blocks_per_sm) {
  *block = kBlock;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, method == 0 ? rollout_commands_kernel<0> : rollout_commands_kernel<1>, kBlock,
      0));
}

const char* brov2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
