// K2: sliding-window endpoint evaluator of the thruster-input euler12
// model.  For every start s < N - H: H steps from X[s] under the commands
// U[s + t], each step being curve -> lag (fresh at every start) -> wrench
// map -> one Euler/RK4 step with tau held across its stages.  Writes the
// (N - H, 12) endpoint states.
//
// K4: sliding-window endpoints of the wrench-input euler12 model: H steps
// from X[s] under the body wrench TAU[s + t]; no curve and no lag.
//
// Replace, in the JAX package, ops/pallas_eval.py::
// _make_thruster_window_kernel (K2, through window_pallas_call /
// make_endpoint_final_pallas) and _make_wrench_window_kernel (K4, through
// make_endpoint_final_pallas_wrench).  K3, the per-trajectory rollout, is
// in batched_rollout.cu.
//
// What bounds them on an H100: their work is operations (per start and
// Euler step ~156 flops, 2 divisions and 3 sincosf of the row step, plus
// ~300 flops of actuation in K2), but at the apps' shapes (9,065 starts,
// H=100) K2 and K4 fill fewer than one wave of 132 SMs and each thread
// runs 100 dependent steps, so the dependency chain of one thread
// (latency) sets their time.
// The design: one thread per start, 12 states (and 24 lag states) in
// registers for all steps, inputs read directly (no pre-shifted copy):
// the rows of neighbouring starts are neighbouring, so a warp's reads
// coalesce; every row is reused from L1/L2 by the H starts that need it.
#include <cstdint>

#include "fossen_rows.cuh"

namespace {

constexpr int kThreads = 64;

// K2: input row s + t of U (N, 8).
template <int METHOD, bool USE_LAG>
__global__ void window_eval_kernel(RowConsts k, ThrusterConsts c,
                                   const float* __restrict__ X, const float* __restrict__ U,
                                   float* __restrict__ out, int n_start, int H) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_start) return;
  float x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = X[(int64_t)s * 12 + i];
  float L[8][3];
#pragma unroll
  for (int j = 0; j < 8; ++j) L[j][0] = L[j][1] = L[j][2] = 0.0f;

  for (int t = 0; t < H; ++t) {
    const float4* row = reinterpret_cast<const float4*>(U + (int64_t)(s + t) * 8);
    const float4 lo = row[0], hi = row[1];
    const float u8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float F[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = static_thrust_row(c, u8[j]);
      F[j] = USE_LAG ? lag_row(c, L[j], f) : f;
    }
    float tau[6];
    wrench_rows(c, F, tau);
    step_rows<METHOD>(k, x, tau);
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) out[(int64_t)s * 12 + i] = x[i];
}

template <int METHOD>
__global__ void window_eval_wrench_kernel(RowConsts k, const float* __restrict__ X,
                                          const float* __restrict__ TAU,
                                          float* __restrict__ out, int n_start, int H) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_start) return;
  float x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = X[(int64_t)s * 12 + i];
  for (int t = 0; t < H; ++t) {
    // a 24-byte row is 8-byte aligned when the base is (the wrapper checks)
    const float2* row = reinterpret_cast<const float2*>(TAU + (int64_t)(s + t) * 6);
    const float2 a = row[0], b = row[1], d = row[2];
    const float tau[6] = {a.x, a.y, b.x, b.y, d.x, d.y};
    step_rows<METHOD>(k, x, tau);
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) out[(int64_t)s * 12 + i] = x[i];
}

void launch_thruster(const RowConsts& k, const ThrusterConsts& c, const float* X,
                     const float* U, float* out, int n_start, int H, int method,
                     int use_lag, cudaStream_t s) {
  const dim3 grid((n_start + kThreads - 1) / kThreads);
  if (method == 0) {
    if (use_lag) window_eval_kernel<0, true><<<grid, kThreads, 0, s>>>(k, c, X, U, out, n_start, H);
    else window_eval_kernel<0, false><<<grid, kThreads, 0, s>>>(k, c, X, U, out, n_start, H);
  } else {
    if (use_lag) window_eval_kernel<1, true><<<grid, kThreads, 0, s>>>(k, c, X, U, out, n_start, H);
    else window_eval_kernel<1, false><<<grid, kThreads, 0, s>>>(k, c, X, U, out, n_start, H);
  }
}

}  // namespace

extern "C" {

// U must be 16-byte aligned with rows of 8 floats (the wrapper checks).
int brov2_window_eval(const void* row_consts, const void* thr_consts, const float* X,
                      const float* U, float* out, int n_start, int H, int method,
                      int use_lag, void* stream) {
  launch_thruster(*static_cast<const RowConsts*>(row_consts),
                  *static_cast<const ThrusterConsts*>(thr_consts), X, U, out, n_start, H, method,
                  use_lag, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// TAU must be 8-byte aligned with rows of 6 floats (the wrapper checks).
int brov2_window_eval_wrench(const void* row_consts, const float* X, const float* TAU,
                             float* out, int n_start, int H, int method, void* stream) {
  const RowConsts k = *static_cast<const RowConsts*>(row_consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_start + kThreads - 1) / kThreads);
  if (method == 0) window_eval_wrench_kernel<0><<<grid, kThreads, 0, s>>>(k, X, TAU, out, n_start, H);
  else window_eval_wrench_kernel<1><<<grid, kThreads, 0, s>>>(k, X, TAU, out, n_start, H);
  return static_cast<int>(cudaGetLastError());
}

const char* brov2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
