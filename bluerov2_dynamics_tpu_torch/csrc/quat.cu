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
// sets its time, as in K2.  The design: one thread per start with its 13
// states in registers for all steps.  K5 reads its 52-byte state rows
// element by element and TAU[s + t] as three float2 (neighbouring starts
// read neighbouring rows, reused from L1/L2 by the H starts that need
// them); the fused form reduces the squared errors in the kernel.  K6
// stages the shared TAU through shared memory in chunks, where every
// thread of the block reads the same word (a broadcast).
#include <cstdint>

#include "fossen_rows.cuh"

namespace {

constexpr int kWindowThreads = 64;
constexpr int kRollThreads = 128;
constexpr int kTauChunk = 256;  // steps of TAU staged per pass (6 KB)

template <int METHOD, bool RENORM, bool SQ>
__global__ void window_eval_quat_kernel(RowConsts k, const float* __restrict__ X,
                                        const float* __restrict__ TAU,
                                        float* __restrict__ out, int n_start, int H,
                                        SqScratch sq) {
  const int own = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = own < n_start;
  if (!SQ && !live) return;
  const int s = live ? own : n_start - 1;   // fused: a dead thread shadows the last start
  float x[13];
#pragma unroll
  for (int i = 0; i < 13; ++i) x[i] = X[(int64_t)s * 13 + i];
  for (int t = 0; t < H; ++t) {
    // a 24-byte row is 8-byte aligned when the base is (the wrapper checks)
    const float2* row = reinterpret_cast<const float2*>(TAU + (int64_t)(s + t) * 6);
    const float2 a = row[0], b = row[1], d = row[2];
    const float tau[6] = {a.x, a.y, b.x, b.y, d.x, d.y};
    step_quat_rows<METHOD, RENORM>(k, x, tau);
  }
  if constexpr (SQ) grid_sum<kWindowThreads>(endpoint_sq<13>(x, X, s, H, live), sq);
  else write_endpoint<13>(x, out, s);
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

template <int METHOD, bool RENORM, bool SQ>
void launch_window(const RowConsts& k, const float* X, const float* TAU, float* out,
                   SqScratch sq, int n_start, int H, cudaStream_t s) {
  const dim3 grid((n_start + kWindowThreads - 1) / kWindowThreads);
  window_eval_quat_kernel<METHOD, RENORM, SQ><<<grid, kWindowThreads, 0, s>>>(k, X, TAU, out,
                                                                             n_start, H, sq);
}

template <bool SQ>
void launch_window_any(const RowConsts& k, const float* X, const float* TAU, float* out,
                       SqScratch sq, int n_start, int H, int method, int renormalize,
                       cudaStream_t s) {
  if (method == 0) {
    if (renormalize) launch_window<0, true, SQ>(k, X, TAU, out, sq, n_start, H, s);
    else launch_window<0, false, SQ>(k, X, TAU, out, sq, n_start, H, s);
  } else {
    if (renormalize) launch_window<1, true, SQ>(k, X, TAU, out, sq, n_start, H, s);
    else launch_window<1, false, SQ>(k, X, TAU, out, sq, n_start, H, s);
  }
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
  launch_window_any<false>(*static_cast<const RowConsts*>(row_consts), X, TAU, out,
                           SqScratch{nullptr, nullptr, nullptr}, n_start, H, method, renormalize,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K5 fused: the sum of the squared endpoint errors into *sq.  `partials`
// holds n_partials floats (at least the grid); `ticket` is zero.
int brov2_window_sq_quat(const void* row_consts, const float* X, const float* TAU, float* sq,
                         float* partials, int n_partials, unsigned* ticket, int n_start, int H,
                         int method, int renormalize, void* stream) {
  if ((n_start + kWindowThreads - 1) / kWindowThreads > n_partials)
    return static_cast<int>(cudaErrorInvalidValue);
  launch_window_any<true>(*static_cast<const RowConsts*>(row_consts), X, TAU, nullptr,
                          SqScratch{sq, partials, ticket}, n_start, H, method, renormalize,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
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
