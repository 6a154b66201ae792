// K1: euler12 rollout of B starts for T steps under ONE shared command
// sequence, plus its prologue, the shared wrench sequence tau_seq (T, 6).
//
// Replaces ops/pallas_rollout.py::make_rollout_final_pallas (kernel body
// kernel_factory) of the JAX package, and the lax.scan shared_tau_sequence
// that feeds it.
//
// What bounds it on an H100: operations.  Per trajectory and RK4 step the
// row step does ~684 flops, 8 divisions and 12 exact sincosf (24 sines and
// cosines); the only traffic is x0 read once, xT written once and tau_seq
// (12 KB at T=500), so the FP32 pipes, not memory, set the floor.  The
// design keeps the 12 states of a trajectory in registers for all T steps
// (one thread per start) and stages tau_seq through shared memory in
// chunks, where every thread of the block reads the same word (a
// broadcast, no bank conflict).  Each angle's sine and cosine come from one
// range reduction (fossen_rows.cuh).  Blocks of kBlock = 256 threads (by
// measurement: 64 and 128 were 1-2% slower, PERF.md); __launch_bounds__
// holds the kernel to 128 registers, so all 65,536 trajectories of the
// bench shape are resident in one wave (2 x 256 threads on each of 132
// SMs).  No tensor cores: the work is a recurrence of scalar f32
// operations with no matrix product to give them.
//
// The prologue is one block: the curve runs over all (t, thruster) pairs in
// parallel, the lag scan is sequential in t but independent per thruster
// (one thread each), and the wrench map is parallel over (t, axis) again.
#include <cstdint>

#include "fossen_rows.cuh"

namespace {

constexpr int kTauChunk = 256;  // steps of tau_seq staged per pass (6 KB)
constexpr int kBlock = 256;     // threads per block
constexpr int kMinBlocks = 2;   // 65,536 / (2 x 256) = 128 registers a thread at most

__global__ void tau_seq_kernel(ThrusterConsts c, const float* __restrict__ U,
                               float* __restrict__ F, float* __restrict__ tau,
                               int T, int use_lag) {
  const int tid = threadIdx.x;
  for (int i = tid; i < T * 8; i += blockDim.x) F[i] = static_thrust_row(c, U[i]);
  __syncthreads();
  if (use_lag && tid < 8) {
    float L[3] = {0.0f, 0.0f, 0.0f};
    for (int t = 0; t < T; ++t) F[t * 8 + tid] = lag_row(c, L, F[t * 8 + tid]);
  }
  __syncthreads();
  for (int t = tid; t < T; t += blockDim.x) {
    float Ft[8], tt[6];
#pragma unroll
    for (int j = 0; j < 8; ++j) Ft[j] = F[t * 8 + j];
    wrench_rows(c, Ft, tt);
#pragma unroll
    for (int i = 0; i < 6; ++i) tau[t * 6 + i] = tt[i];
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

}  // namespace

extern "C" {

// F_scratch (T, 8) and tau (T, 6) are allocated by the caller.
int brov2_tau_seq(const void* consts, const float* U, float* F_scratch, float* tau,
                  int T, int use_lag, void* stream) {
  const ThrusterConsts c = *static_cast<const ThrusterConsts*>(consts);
  tau_seq_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(c, U, F_scratch, tau, T, use_lag);
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

// The block size brov2_rollout_final launches, and the resident blocks per
// SM of rollout_kernel<method> at that size.
int brov2_rollout_occupancy(int method, int* block, int* blocks_per_sm) {
  *block = kBlock;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, method == 0 ? rollout_kernel<0> : rollout_kernel<1>, kBlock, 0));
}

const char* brov2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
