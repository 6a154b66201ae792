// The sysid window loss and its gradient in one launch: for every start s
// of models/sysid.py::thruster_loss (Euler), H steps from X[s] with the lag
// from its warm-start row (or zero), the squared error against X[s + t + 1]
// summed over the starts, steps and 12 states, and the gradient of that
// mean with respect to the 23 log-scales, and with gains the 8 log-gains,
// and with a fitted current its 3 components.  A torch.autograd.Function in
// models/sysid.py wraps it as the loss of the fit's CUDA graph; its plain
// version is the autograd loss of the same module.
//
// It replaces no Pallas kernel: the JAX fit takes jax.value_and_grad of
// the window loss through a lax.scan (bluerov2_dynamics_tpu/models/
// sysid.py:135-173), which XLA compiles into one program.  PyTorch's
// autograd made of the same loss 6,819 device kernels an Adam iteration,
// each a few hundred kilobytes wide, and the fit's time was theirs.
//
// What bounds it on an H100: operations, about 6.9e8 an iteration at 36,648
// starts and H = 10 (portbench/opcounts.py::fit_ops), some 10 us at the FP32
// peak; the bytes are the recording, read once into L2. But one thread a
// start gives the card barely two warps a scheduler, so each thread's chain
// of dependent steps sets the time. The design: one thread a start, the
// state, lag, adjoint and gradient sums in registers; the forward stores each
// step's state and wrench in shared memory (18 floats a step, 26 with gains)
// and never in device memory; the reverse runs the hand-written adjoint of
// the Euler step (sysid_adjoint.cuh) over them. Blocks of 3 warps take 69 KB
// of shared memory at H = 10; the registers (about 240 a thread) hold an SM
// to 2 of them, so 36,648 starts run in 1.45 waves. Blocks of 1, 2 and 4
// warps measured slower; a register cap for a third block an SM measured
// faster but spills to local memory, which is device memory, so it is not
// taken (PERF.md). The sums leave each block as float64 partials (warp
// shuffles, then the warps in turn) and the last block to take the ticket
// adds them in a fixed order, applies the chain rule to the log-scales and
// writes the loss and gradient: the same inputs give the same bits, and no
// float value goes through an atomic.
//
// Numerics: float32 throughout the rows, exact sincosf, IEEE division, no
// fast math; the sums across starts in float64.
#include <cstdint>

#include "fossen_rows.cuh"
#include "sysid_adjoint.cuh"

namespace {

// Threads a block and the most steps a start stores at once.
constexpr int kSysidThreads = 96;
constexpr int kSysidSegment = 10;
constexpr int kSysidWarps = kSysidThreads / 32;

struct SysidOut {
  float* loss;         // one float
  float* grad;         // 34 floats: log-scales, log-gains, current
  double* partials;    // grad_slots() doubles a block
  unsigned* ticket;    // zero between launches
};

// The NC sums of a block (v: this thread's), into out[0..NC) by the
// threads c < NC: warp shuffles in float64, then the warps in turn.
template <int NC, typename T>
__device__ __forceinline__ void block_sum(const T* v, double* out, double (*warp_part)[NC]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    double d = (double)v[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_down_sync(BROV2_FULL_MASK, d, o);
    if (lane == 0) warp_part[warp][c] = d;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < NC; c += kSysidThreads) {
    double t = warp_part[0][c];
#pragma unroll
    for (int w = 1; w < kSysidWarps; ++w) t += warp_part[w][c];
    out[c] = t;
  }
}

template <bool USE_LAG, bool GAINS, bool CURRENT>
__global__ void __launch_bounds__(kSysidThreads)
    sysid_window_kernel(SysidConsts sc, ThrusterConsts tc0, const float* __restrict__ log_s,
                        const float* __restrict__ log_g, const float* __restrict__ cur,
                        const float* __restrict__ X, const float* __restrict__ U,
                        const float* __restrict__ L0, SysidOut o, int n_start, int H, int delay,
                        int seg) {
  constexpr int NC = grad_slots<GAINS, CURRENT>();
  extern __shared__ float store[];
  __shared__ RowConsts k;
  __shared__ ThrusterConsts tc;
  __shared__ float coeff[23];
  __shared__ double warp_part[kSysidWarps][NC];
  __shared__ double total[NC];
  __shared__ bool last;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 23; ++i) coeff[i] = sc.nominal[i] * expf(log_s[i]);
    float cu[3] = {0.0f, 0.0f, 0.0f};
    if (CURRENT) {
#pragma unroll
      for (int i = 0; i < 3; ++i) cu[i] = cur[i];
    }
    assemble_rows(sc, coeff, cu, k);
    tc = tc0;
    if (GAINS) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = expf(log_g[j]);
#pragma unroll
        for (int i = 0; i < 6; ++i) tc.Wm[j * 6 + i] = tc0.Wm[j * 6 + i] * e;
      }
    }
  }
  __syncthreads();

  // a thread past the last start shadows it and adds nothing
  const int own = blockIdx.x * kSysidThreads + threadIdx.x;
  const bool live = own < n_start;
  float G[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) G[c] = 0.0f;
  window_start_vjp<USE_LAG, GAINS, CURRENT>(k, tc, X, U, L0, live ? own : n_start - 1, H, delay,
                                            seg, store + threadIdx.x, kSysidThreads, G);
  if (!live) {
#pragma unroll
    for (int c = 0; c < NC; ++c) G[c] = 0.0f;
  }

  // the block's partials; the last block to arrive leaves the ticket at zero
  block_sum<NC>(G, total, warp_part);
  __syncthreads();
  for (int c = threadIdx.x; c < NC; c += kSysidThreads)
    o.partials[(int64_t)blockIdx.x * NC + c] = total[c];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(o.ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the grid's sums: each thread its blocks in turn, then the block sum
  double acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kSysidThreads) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] += __ldcg(o.partials + (int64_t)b * NC + c);
  }
  __syncthreads();
  block_sum<NC>(acc, total, warp_part);
  __syncthreads();
  if (threadIdx.x == 0) {
    const double scale = 1.0 / ((double)n_start * 12.0 * (double)H);
    *o.loss = (float)(total[kGLoss] * scale);
    chain_to_log_scales<GAINS, CURRENT>(sc, coeff, k, total, scale, o.grad);
  }
}

using Kernel = void (*)(SysidConsts, ThrusterConsts, const float*, const float*, const float*,
                        const float*, const float*, const float*, SysidOut, int, int, int, int);

Kernel pick(int use_lag, int gains, int current) {
  static const Kernel table[2][2][2] = {
      {{sysid_window_kernel<false, false, false>, sysid_window_kernel<false, false, true>},
       {sysid_window_kernel<false, true, false>, sysid_window_kernel<false, true, true>}},
      {{sysid_window_kernel<true, false, false>, sysid_window_kernel<true, false, true>},
       {sysid_window_kernel<true, true, false>, sysid_window_kernel<true, true, true>}}};
  return table[use_lag != 0][gains != 0][current != 0];
}

int slots(int gains, int current) { return kGRows + (gains ? 8 : 0) + (current ? 3 : 0); }

int store_bytes(int H, int gains) {
  const int seg = H < kSysidSegment ? H : kSysidSegment;
  return seg * (gains ? 26 : 18) * kSysidThreads * (int)sizeof(float);
}

// The dynamic shared memory a block may take: above 48 KB only once asked.
cudaError_t allow_store(Kernel fn) {
  const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             store_bytes(kSysidSegment, 1));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

// log_g and cur null where not fitted, L0 null for a lag from rest; U must
// be 16-byte aligned with rows of 8 floats; `partials` holds n_partials
// doubles, at least the grid times the slots; `ticket` is zero.
int brov2_sysid_window(const void* sysid_consts, const void* thr_consts, const float* log_s,
                       const float* log_g, const float* cur, const float* X, const float* U,
                       const float* L0, float* loss, float* grad, double* partials,
                       int n_partials, unsigned* ticket, int n_start, int H, int delay,
                       int use_lag, void* stream) {
  const int gains = log_g != nullptr, current = cur != nullptr;
  const int n_blocks = (n_start + kSysidThreads - 1) / kSysidThreads;
  if (n_start <= 0 || H <= 0 || (int64_t)n_blocks * slots(gains, current) > n_partials)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel fn = pick(use_lag, gains, current);
  static bool allowed[2][2][2] = {};
  bool& ok = allowed[use_lag != 0][gains][current];
  if (!ok) {
    const cudaError_t e = allow_store(fn);
    if (e != cudaSuccess) return static_cast<int>(e);
    ok = true;
  }
  const SysidOut out{loss, grad, partials, ticket};
  fn<<<n_blocks, kSysidThreads, store_bytes(H, gains), static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const SysidConsts*>(sysid_consts),
      *static_cast<const ThrusterConsts*>(thr_consts), log_s, log_g, cur, X, U, L0, out, n_start,
      H, delay, H < kSysidSegment ? H : kSysidSegment);
  return static_cast<int>(cudaGetLastError());
}

// The launch plan at n_start starts and horizon H: plan[0..6] = block,
// blocks, dynamic shared bytes, resident blocks per SM, registers a
// thread, local (spilled) bytes a thread, and the doubles of partials a
// launch needs.
int brov2_sysid_window_plan(int use_lag, int gains, int current, int n_start, int H, int* plan) {
  const Kernel fn = pick(use_lag, gains, current);
  cudaError_t e = allow_store(fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  plan[0] = kSysidThreads;
  plan[1] = (n_start + kSysidThreads - 1) / kSysidThreads;
  plan[2] = store_bytes(H, gains);
  plan[4] = attr.numRegs;
  plan[5] = static_cast<int>(attr.localSizeBytes);
  plan[6] = plan[1] * slots(gains, current);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(plan + 3, fn, kSysidThreads, plan[2]));
}

const char* brov2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
