// K2: sliding-window endpoint evaluator of the thruster-input euler12
// model.  For every start s < N - H: H steps from X[s] under the commands
// U[s + t], each step being curve -> lag (fresh at every start) -> wrench
// map -> one Euler/RK4 step with tau held across its stages.  Writes the
// (N - H, 12) endpoint states or, fused, the one float32 sum over starts
// of |x_H(s) - X[s + H]|^2 (the per-rank body of K7 and the apps' RMSE).
//
// K4: sliding-window endpoints of the wrench-input euler12 model: H steps
// from X[s] under the body wrench TAU[s + t]; no curve and no lag.  The
// same two outputs.
//
// Replace, in the JAX package, ops/pallas_eval.py::
// _make_thruster_window_kernel (K2, through window_pallas_call /
// make_endpoint_final_pallas) and _make_wrench_window_kernel (K4, through
// make_endpoint_final_pallas_wrench), and with the fused sum the kernel,
// jnp.sum(d * d) and psum body of parallel/sharded.py::_shardmap_window_rmse
// (K7).  K3, the per-trajectory rollout, is in batched_rollout.cu.
//
// What bounds them on an H100: their work is operations (per start and
// Euler step ~156 flops, 2 divisions and 3 sincosf of the row step, plus
// ~300 flops of actuation in K2), but at the apps' shape (9,065 starts,
// H=100) one thread a start fills fewer than one warp a scheduler, and a
// lone warp issues every instruction of its 100 dependent steps in turn.
// The design: one thread per start, 12 states (and 24 lag states) in
// registers for all steps, inputs read directly (no pre-shifted copy):
// the rows of neighbouring starts are neighbouring, so a warp's reads
// coalesce; every row is reused from L1/L2 by the H starts that need it.
// A start split over 2, 4 or 8 lanes of a warp (each lane a share of the
// thrusters and of the three sincosf, shuffles handing them round) issued
// more work than it hid and measured slower at 9,065 and 44,800 starts
// (PERF.md), so K2 runs one thread a start.
//
// K4 has no actuation to share; what it can divide is the row step
// itself, and what holds a lone warp back is also its wait on each step's
// wrench row.  Up to kWrenchSplitStartsPerSm starts an SM its launch plan
// puts a start on a warp pair (window_rows.cuh): the kinematic warp steps
// the angles (the three sincosf, R, the gimbal clamp and its two
// divisions), the dynamic warp the position and body velocities, and the
// two exchange R and p, q, r through shared memory at every RHS
// evaluation; the pairs' warps land on the schedulers that one thread a
// start leaves idle.  Above the threshold the schedulers are busy already
// and the exchange only adds work, so K4 runs one thread a start there,
// with each block's wrench rows staged in shared memory.  Both the
// threshold and the forms are by measurement (PERF.md).
#include <cstdint>

#include "fossen_rows.cuh"
#include "window_rows.cuh"

namespace {

// Threads a block of K2 and of K4's one-thread form, mirrored by
// ops/cuda_eval.py::window_plan and WRENCH_CONSTS.
constexpr int kThreads = 64;
// K4's plan, mirrored by ops/cuda_eval.py::WRENCH_CONSTS: warp pairs a
// block of the pair form; the most starts an SM for which a start goes on
// a warp pair (3 blocks of the pair form an SM: with a 4th the staged
// one-thread form measured faster); the steps of TAU a block of the
// one-thread form stages at a time (4.6 KB of rows).
constexpr int kWrenchPairs = 2;
constexpr int kWrenchSplitStartsPerSm = 192;
constexpr int kWrenchTauChunk = 128;

// K2.  The fused form's threads past the end shadow the last start, so
// that every thread reaches the block sum, and add nothing; the endpoint
// form's return.
template <int METHOD, bool USE_LAG, bool SQ>
__global__ void window_eval_kernel(RowConsts k, ThrusterConsts c,
                                   const float* __restrict__ X, const float* __restrict__ U,
                                   float* __restrict__ out, int n_start, int H, SqScratch sq) {
  const int own = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = own < n_start;
  if (!SQ && !live) return;
  const int s = live ? own : n_start - 1;
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
  if constexpr (SQ) grid_sum<kThreads>(endpoint_sq<12>(x, X, s, H, live), sq);
  else write_endpoint<12>(x, out, s);
}

// K4's warp-pair and staged one-thread forms, with the same two epilogues.
template <int METHOD, bool SQ>
__global__ void __launch_bounds__(64 * kWrenchPairs)
    window_pair_wrench_kernel(RowConsts k, const float* __restrict__ X,
                              const float* __restrict__ TAU, float* __restrict__ out, int n_start,
                              int H, SqScratch sq) {
  window_pair_body<METHOD, SQ, kWrenchPairs>(k, X, TAU, out, n_start, H, sq);
}

template <int METHOD, bool SQ>
__global__ void window_staged_wrench_kernel(RowConsts k, const float* __restrict__ X,
                                            const float* __restrict__ TAU,
                                            float* __restrict__ out, int n_start, int H,
                                            SqScratch sq) {
  window_staged_body<12, METHOD, false, SQ, kThreads, kWrenchTauChunk>(k, X, TAU, out, n_start,
                                                                       H, sq);
}

int grid_of(int n_start) { return (n_start + kThreads - 1) / kThreads; }

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// K4's launch plan for n_start starts: warps a start, block, grid.
struct Plan {
  int warps, block, n_blocks;
};

Plan wrench_plan(int n_start) {
  if ((int64_t)n_start <= (int64_t)kWrenchSplitStartsPerSm * sm_count()) {
    constexpr int spb = 32 * kWrenchPairs;
    return {2, 64 * kWrenchPairs, (n_start + spb - 1) / spb};
  }
  return {1, kThreads, grid_of(n_start)};
}

using ThrusterKernel = void (*)(RowConsts, ThrusterConsts, const float*, const float*, float*,
                                int, int, SqScratch);

ThrusterKernel pick(int method, int use_lag, bool sq) {
  static const ThrusterKernel table[2][2][2] = {
      {{window_eval_kernel<0, false, false>, window_eval_kernel<0, false, true>},
       {window_eval_kernel<0, true, false>, window_eval_kernel<0, true, true>}},
      {{window_eval_kernel<1, false, false>, window_eval_kernel<1, false, true>},
       {window_eval_kernel<1, true, false>, window_eval_kernel<1, true, true>}}};
  return table[method != 0][use_lag != 0][sq];
}

// `sq` null: the endpoint form into `out`; else the fused form into `*sq`.
int launch_thruster(const void* row_consts, const void* thr_consts, const float* X,
                    const float* U, float* out, int n_start, int H, int method, int use_lag,
                    const SqScratch* sq, void* stream) {
  pick(method, use_lag, sq != nullptr)<<<grid_of(n_start), kThreads, 0,
                                             static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const RowConsts*>(row_consts), *static_cast<const ThrusterConsts*>(thr_consts),
      X, U, out, n_start, H, sq ? *sq : SqScratch{nullptr, nullptr, nullptr});
  return static_cast<int>(cudaGetLastError());
}

using WrenchKernel = void (*)(RowConsts, const float*, const float*, float*, int, int, SqScratch);

template <int METHOD, bool SQ>
WrenchKernel wrench_kernel(const Plan& plan) {
  if (plan.warps == 2) return window_pair_wrench_kernel<METHOD, SQ>;
  return window_staged_wrench_kernel<METHOD, SQ>;
}

WrenchKernel pick_wrench(const Plan& plan, int method, bool sq) {
  if (method == 0) return sq ? wrench_kernel<0, true>(plan) : wrench_kernel<0, false>(plan);
  return sq ? wrench_kernel<1, true>(plan) : wrench_kernel<1, false>(plan);
}

int launch_wrench(const void* row_consts, const float* X, const float* TAU, float* out,
                  int n_start, int H, int method, const SqScratch* sq, int n_partials,
                  void* stream) {
  const Plan plan = wrench_plan(n_start);
  if (sq && plan.n_blocks > n_partials) return static_cast<int>(cudaErrorInvalidValue);
  pick_wrench(plan, method, sq != nullptr)<<<plan.n_blocks, plan.block, 0,
                                             static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const RowConsts*>(row_consts), X, TAU, out, n_start, H,
      sq ? *sq : SqScratch{nullptr, nullptr, nullptr});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// U must be 16-byte aligned with rows of 8 floats (the wrapper checks).
int brov2_window_eval(const void* row_consts, const void* thr_consts, const float* X,
                      const float* U, float* out, int n_start, int H, int method,
                      int use_lag, void* stream) {
  return launch_thruster(row_consts, thr_consts, X, U, out, n_start, H, method, use_lag, nullptr,
                         stream);
}

// K2 fused: the sum of the squared endpoint errors into *sq.  `partials`
// holds n_partials floats (at least the grid); `ticket` is zero.
int brov2_window_sq(const void* row_consts, const void* thr_consts, const float* X,
                    const float* U, float* sq, float* partials, int n_partials,
                    unsigned* ticket, int n_start, int H, int method, int use_lag,
                    void* stream) {
  if (grid_of(n_start) > n_partials) return static_cast<int>(cudaErrorInvalidValue);
  const SqScratch scratch{sq, partials, ticket};
  return launch_thruster(row_consts, thr_consts, X, U, nullptr, n_start, H, method, use_lag,
                         &scratch, stream);
}

// The block size K2 launches, and the resident blocks per SM of its
// endpoint (sq = 0) or fused kernel.
int brov2_window_occupancy(int method, int use_lag, int sq, int* block, int* blocks_per_sm) {
  *block = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pick(method, use_lag, sq != 0), kThreads, 0));
}

// TAU must be 8-byte aligned with rows of 6 floats (the wrapper checks).
int brov2_window_eval_wrench(const void* row_consts, const float* X, const float* TAU,
                             float* out, int n_start, int H, int method, void* stream) {
  return launch_wrench(row_consts, X, TAU, out, n_start, H, method, nullptr, 0, stream);
}

// K4 fused, as brov2_window_sq; `partials` holds at least the plan's grid.
int brov2_window_sq_wrench(const void* row_consts, const float* X, const float* TAU, float* sq,
                           float* partials, int n_partials, unsigned* ticket, int n_start, int H,
                           int method, void* stream) {
  const SqScratch scratch{sq, partials, ticket};
  return launch_wrench(row_consts, X, TAU, nullptr, n_start, H, method, &scratch, n_partials,
                       stream);
}

// K4's plan for n_start starts and its endpoint (sq = 0) or fused kernel:
// plan[0..4] = warps a start, block, blocks, resident blocks per SM,
// static shared bytes.
int brov2_window_wrench_occupancy(int method, int sq, int n_start, int* plan) {
  const Plan p = wrench_plan(n_start);
  const WrenchKernel fn = pick_wrench(p, method, sq != 0);
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  plan[0] = p.warps;
  plan[1] = p.block;
  plan[2] = p.n_blocks;
  plan[4] = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(plan + 3, fn, p.block, 0));
}

const char* brov2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
