// K3: euler12 rollout of B trajectories for T steps, each under its own
// command sequence U (T, B, 8) from a fresh zero lag state; writes the
// (B, 12) final states.  Each step is the T200 curve -> lag -> wrench map
// -> one Euler/RK4 step with tau held across its stages (fossen_rows.cuh).
//
// Replaces ops/pallas_eval.py::make_batched_rollout_pallas of the JAX
// package.
//
// What bounds it on an H100: operations.  Per trajectory and RK4 step the
// row step does ~684 flops, 8 divisions and 12 exact sincosf, and the
// actuation ~330 flops; U is read once (1.05 GB at 65,536 x 500, 0.31 ms
// at 3.35 TB/s), under the operation bound.  The design:
// - one thread per trajectory, its 12 states and 24 lag states in
//   registers for all T steps;
// - a register double buffer: each thread loads its row of step t + 1
//   (two 16-byte loads; a warp's rows are contiguous, so they coalesce)
//   before it computes step t, so a load has a whole step (~3 us) to land
//   and no step waits on device memory.  Staging the rows through shared
//   memory by asynchronous copies (bulk copies from a producer warp, or
//   per-thread cp.async rings of depth 2-4) measured 1-4% slower than this
//   on the H100 (PERF.md): 8 registers hold everything in flight;
// - blocks of kBlock = 256 threads under __launch_bounds__(256, 2): at
//   most 128 registers a thread, so two blocks fit an SM and all 256
//   blocks of the bench shape are resident in one wave (64 and 128
//   threads measured about 3% slower).
// ops/cuda_eval.py stage_plan mirrors the constants.  No tensor cores: the
// work is a recurrence of scalar f32 operations with no matrix product to
// give them.
#include <cstdint>

#include "fossen_rows.cuh"

namespace {

constexpr int kBlock = 256;      // threads per block, one trajectory each
constexpr int kMinBlocks = 2;    // 65,536 / (2 x 256) = 128 registers a thread at most

// One step of one trajectory from its row of 8 commands: curve -> lag ->
// wrench map -> Euler/RK4.
template <int METHOD, bool USE_LAG>
__device__ __forceinline__ void actuated_step(const RowConsts& k, const ThrusterConsts& c,
                                              float* x, float (*L)[3], float4 lo, float4 hi) {
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

template <int METHOD, bool USE_LAG>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
batched_rollout_kernel(RowConsts k, ThrusterConsts c, const float* __restrict__ X,
                       const float* __restrict__ U, float* __restrict__ out, int B, int T) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= B) return;
  float x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = X[(int64_t)b * 12 + i];
  float L[8][3];
#pragma unroll
  for (int j = 0; j < 8; ++j) L[j][0] = L[j][1] = L[j][2] = 0.0f;
  // the row of step 0, and float4s from one step's row to the next.  Keep
  // this form: an equivalent one (the float4 pointer U offset by b * 2, hi
  // zero-filled for T = 0) gave 2 more SHF a step and measured 1.8% slower.
  const float4* row = reinterpret_cast<const float4*>(U + (int64_t)b * 8);
  const int64_t step = (int64_t)B * 2;
  float4 lo = T > 0 ? row[0] : make_float4(0, 0, 0, 0), hi = T > 0 ? row[1] : lo;
  for (int t = 0; t < T; ++t) {
    float4 nlo = lo, nhi = hi;
    if (t + 1 < T) {                        // step t + 1's row, in flight during step t
      nlo = row[(t + 1) * step];
      nhi = row[(t + 1) * step + 1];
    }
    actuated_step<METHOD, USE_LAG>(k, c, x, L, lo, hi);
    lo = nlo;
    hi = nhi;
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) out[(int64_t)b * 12 + i] = x[i];
}

using Kernel = void (*)(RowConsts, ThrusterConsts, const float*, const float*, float*, int, int);

Kernel pick(int method, int use_lag) {
  static const Kernel table[2][2] = {
      {batched_rollout_kernel<0, false>, batched_rollout_kernel<0, true>},
      {batched_rollout_kernel<1, false>, batched_rollout_kernel<1, true>}};
  return table[method != 0][use_lag != 0];
}

}  // namespace

extern "C" {

// x0 (B, 12), U (T, B, 8) with a 16-byte-aligned base (the wrapper checks).
int brov2_batched_rollout(const void* row_consts, const void* thr_consts, const float* x0,
                          const float* U, float* out, int B, int T, int method, int use_lag,
                          void* stream) {
  const dim3 grid((B + kBlock - 1) / kBlock);
  pick(method, use_lag)<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const RowConsts*>(row_consts), *static_cast<const ThrusterConsts*>(thr_consts),
      x0, U, out, B, T);
  return static_cast<int>(cudaGetLastError());
}

// The block size brov2_batched_rollout launches, and the resident blocks
// per SM of the kernel it picks.
int brov2_batched_rollout_occupancy(int method, int use_lag, int* block, int* blocks_per_sm) {
  *block = kBlock;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pick(method, use_lag), kBlock, 0));
}

const char* brov2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
