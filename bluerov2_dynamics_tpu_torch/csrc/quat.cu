// K5: sliding-window endpoint evaluator of the quat13 wrench-input model.
// For every start s < N - H: H steps from X[s] under the body wrench
// TAU[s + t]; writes the (N - H, 13) endpoint states or, fused, the one
// float32 sum over starts of |x_H(s) - X[s + H]|^2 (fossen_rows.cuh
// grid_sum; the per-rank body of K7 and the T4 app's RMSE).
//
// K6: quat13 rollout of B starts for T steps under ONE shared wrench
// sequence TAU (T, 6); writes the (B, 13) final states.
//
// Both normalise the quaternion at every RHS entry (rsqrt with the
// identity fallback), take the restoring wrench from the third DCM row and,
// with RENORM, renormalise after every step.
//
// Replace ops/pallas_quat.py::_make_quat_window_kernel (K5, through
// make_endpoint_final_pallas_quat / window_pallas_call) and
// make_rollout_final_pallas_quat (K6) of the JAX package.
//
// What bounds them on an H100: operations.  The quat13 step is trig-free:
// per trajectory and RK4 step ~877 flops and 5 rsqrt (Euler: 212 flops
// and 2 rsqrt); the traffic is the states in and out plus the small wrench
// rows.  K5 at the apps' shape (9,065 starts, H=100) fills fewer than one
// wave of 132 SMs, so one thread's chain of 100 dependent steps (latency)
// sets its time, as in K2, and each step of the parent's kernel waited on
// the global load of its wrench row.  The design: one thread per start
// with its 13 states in registers for all steps; K5 reads its 52-byte
// state rows element by element, and each block stages the TAU rows of
// its starts in shared memory first (window_rows.cuh), so a step reads
// its row from there; the fused form reduces the squared errors in the
// kernel.  A start split over a warp pair (the quaternion on one warp,
// the body velocities on the other, as K4 does) measured slower than the
// staged one-thread form at every start count from 9,065 to 44,800
// (PERF.md).  K6 stages the shared TAU through shared memory in
// chunks, where every thread of the block reads the same word (a
// broadcast).
#include <cstdint>

#include "fossen_rows.cuh"
#include "window_rows.cuh"

namespace {

// K5's block (mirrored by ops/cuda_quat.py::QUAT_CONSTS), and the steps
// of TAU a block stages at a time (4.6 KB of rows).
constexpr int kWindowThreads = 64;
constexpr int kWindowTauChunk = 128;
constexpr int kRollThreads = 128;
constexpr int kTauChunk = 256;  // steps of TAU staged per pass (6 KB)

template <int METHOD, bool RENORM, bool SQ>
__global__ void window_staged_quat_kernel(RowConsts k, const float* __restrict__ X,
                                          const float* __restrict__ TAU,
                                          float* __restrict__ out, int n_start, int H,
                                          SqScratch sq) {
  window_staged_body<13, METHOD, RENORM, SQ, kWindowThreads, kWindowTauChunk>(k, X, TAU, out,
                                                                              n_start, H, sq);
}

template <int METHOD, bool RENORM>
__global__ void rollout_quat_kernel(RowConsts k, const float* __restrict__ TAU,
                                    const float* __restrict__ x0, float* __restrict__ xT,
                                    int B, int T) {
  __shared__ float s_tau[kTauChunk * 6];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < B;
  float x[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) x[i] = live ? x0[(int64_t)b * 13 + i] : 0.0f;

  for (int t0 = 0; t0 < T; t0 += kTauChunk) {
    const int n = min(kTauChunk, T - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < n * 6; j += blockDim.x) s_tau[j] = TAU[t0 * 6 + j];
    __syncthreads();
    if (live) {
      for (int t = 0; t < n; ++t) step_quat_rows<METHOD, RENORM>(k, x, &s_tau[t * 6]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 13; ++i) xT[(int64_t)b * 13 + i] = x[i];
  }
}

int grid_of(int n_start) { return (n_start + kWindowThreads - 1) / kWindowThreads; }

using WindowKernel = void (*)(RowConsts, const float*, const float*, float*, int, int, SqScratch);

WindowKernel pick_window(int method, int renormalize, bool sq) {
  static const WindowKernel table[2][2][2] = {
      {{window_staged_quat_kernel<0, false, false>, window_staged_quat_kernel<0, false, true>},
       {window_staged_quat_kernel<0, true, false>, window_staged_quat_kernel<0, true, true>}},
      {{window_staged_quat_kernel<1, false, false>, window_staged_quat_kernel<1, false, true>},
       {window_staged_quat_kernel<1, true, false>, window_staged_quat_kernel<1, true, true>}}};
  return table[method != 0][renormalize != 0][sq];
}

int launch_window(const void* row_consts, const float* X, const float* TAU, float* out,
                  const SqScratch* sq, int n_partials, int n_start, int H, int method,
                  int renormalize, void* stream) {
  if (sq && grid_of(n_start) > n_partials) return static_cast<int>(cudaErrorInvalidValue);
  pick_window(method, renormalize, sq != nullptr)<<<grid_of(n_start), kWindowThreads, 0,
                                                    static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const RowConsts*>(row_consts), X, TAU, out, n_start, H,
      sq ? *sq : SqScratch{nullptr, nullptr, nullptr});
  return static_cast<int>(cudaGetLastError());
}

template <int METHOD, bool RENORM>
void launch_rollout(const RowConsts& k, const float* TAU, const float* x0, float* xT,
                    int B, int T, cudaStream_t s) {
  const dim3 grid((B + kRollThreads - 1) / kRollThreads);
  rollout_quat_kernel<METHOD, RENORM><<<grid, kRollThreads, 0, s>>>(k, TAU, x0, xT, B, T);
}

}  // namespace

extern "C" {

// TAU must be 8-byte aligned with rows of 6 floats (the wrapper checks).
int brov2_window_eval_quat(const void* row_consts, const float* X, const float* TAU,
                           float* out, int n_start, int H, int method, int renormalize,
                           void* stream) {
  return launch_window(row_consts, X, TAU, out, nullptr, 0, n_start, H, method, renormalize,
                       stream);
}

// K5 fused: the sum of the squared endpoint errors into *sq.  `partials`
// holds n_partials floats (at least the plan's grid); `ticket` is zero.
int brov2_window_sq_quat(const void* row_consts, const float* X, const float* TAU, float* sq,
                         float* partials, int n_partials, unsigned* ticket, int n_start, int H,
                         int method, int renormalize, void* stream) {
  const SqScratch scratch{sq, partials, ticket};
  return launch_window(row_consts, X, TAU, nullptr, &scratch, n_partials, n_start, H, method,
                       renormalize, stream);
}

// K5's plan for n_start starts and its endpoint (sq = 0) or fused kernel:
// plan[0..4] = warps a start, block, blocks, resident blocks per SM,
// static shared bytes.
int brov2_window_quat_occupancy(int method, int renormalize, int sq, int n_start, int* plan) {
  const WindowKernel fn = pick_window(method, renormalize, sq != 0);
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  plan[0] = 1;
  plan[1] = kWindowThreads;
  plan[2] = grid_of(n_start);
  plan[4] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(plan + 3, fn, kWindowThreads, 0));
}

int brov2_rollout_final_quat(const void* row_consts, const float* TAU, const float* x0,
                             float* xT, int B, int T, int method, int renormalize,
                             void* stream) {
  const RowConsts k = *static_cast<const RowConsts*>(row_consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (method == 0) {
    if (renormalize) launch_rollout<0, true>(k, TAU, x0, xT, B, T, s);
    else launch_rollout<0, false>(k, TAU, x0, xT, B, T, s);
  } else {
    if (renormalize) launch_rollout<1, true>(k, TAU, x0, xT, B, T, s);
    else launch_rollout<1, false>(k, TAU, x0, xT, B, T, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* brov2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
