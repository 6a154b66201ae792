// K8: ceiling probes.  Four kernels that measure what one H100 does per
// second for the operation mixes of the physics kernels, so that their
// bounds are priced by the card and not by estimates.  Each is the twin of
// one probe of the JAX package's bench.py and computes the same recurrence
// on each lane:
//
//   fma_peak_kernel   (measure_vpu_fma_peak):   8 independent streams of
//                     acc <- acc * (c - acc * d), 3 flops per stream-step;
//   sin_peak_kernel   (measure_vpu_transcendental_peak): 8 streams of
//                     acc <- sinf(acc) + 0.5 * acc, one exact sinf each;
//   fma_tree_kernel   (measure_vpu_fma_tree_peak): per iteration 8
//                     independent Horner chains of depth 64 seeded by the
//                     iteration index, summed into one accumulator;
//                     8 * 64 * 2 + 8 flops per iteration;
//   quat_mix_kernel   (measure_quat_mix_peak): per iteration the audited
//                     op budget of one quat13 step (Horner issue slots,
//                     rsqrtf, and a chain of abs/max/select/neg), built as
//                     bench.py builds it; one quat13 step per iteration.
//
// What bounds them: FP32 issue (FFMA, FMUL) and, for sinf and rsqrtf, the
// instruction sequences nvcc emits for them without fast math.  The
// design: one thread runs one lane (the TPU probes' (rows, 128) VMEM
// layout does not carry over), every accumulator in a register, the
// iteration loop kept as a loop so that cuobjdump shows one iteration's
// instructions, and every value wired into the output so that nothing
// folds.  Constants are float32 roundings of the same double expressions
// as the JAX probes'.
#include <cuda_runtime.h>

namespace {

constexpr int kStreams = 8;  // fma / sin probes
constexpr int kChains = 8;   // tree / mix probes
constexpr int kDepth = 64;   // tree probe

__global__ void fma_peak_kernel(const float* __restrict__ x, float* __restrict__ y, int lanes,
                                int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const float c = 1.0000001f, d = 1e-9f;
  const float a = x[i];
  float acc[kStreams];
#pragma unroll
  for (int s = 0; s < kStreams; ++s) acc[s] = a * (float)(1.0 + 0.01 * s);
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < kStreams; ++s) acc[s] = acc[s] * (c - acc[s] * d);
  }
  float out = acc[0];
#pragma unroll
  for (int s = 1; s < kStreams; ++s) out = out + acc[s];
  y[i] = out;
}

__global__ void sin_peak_kernel(const float* __restrict__ x, float* __restrict__ y, int lanes,
                                int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const float a = x[i];
  float acc[kStreams];
#pragma unroll
  for (int s = 0; s < kStreams; ++s) acc[s] = a * (float)(1.0 + 0.01 * s);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int s = 0; s < kStreams; ++s) acc[s] = sinf(acc[s]) + 0.5f * acc[s];
  }
  float out = acc[0];
#pragma unroll
  for (int s = 1; s < kStreams; ++s) out = out + acc[s];
  y[i] = out;
}

// One Horner chain of DEPTH fused steps t <- t * k + 1e-3 (d + 1).
template <int DEPTH>
__device__ __forceinline__ float horner(float t, float k) {
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) t = t * k + (float)(1e-3 * (d + 1));
  return t;
}

// kChains chains from v with SLOTS Horner steps in all, spread as evenly
// as bench.py spreads them (the first SLOTS % kChains chains one longer).
template <int SLOTS, int C = 0>
__device__ __forceinline__ void chains(float v, float* ts) {
  if constexpr (C < kChains) {
    ts[C] = horner<SLOTS / kChains + (C < SLOTS % kChains ? 1 : 0)>(v, (float)(0.99 + 0.0001 * C));
    chains<SLOTS, C + 1>(v, ts);
  }
}

// The seed of iteration i: v = a * (1 + 1e-7 i).
__device__ __forceinline__ float seed(float a, int i) {
  return a * (1.0f + 1e-7f * (float)i);
}

__global__ void fma_tree_kernel(const float* __restrict__ x, float* __restrict__ y, int lanes,
                                int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const float a = x[i];
  float acc = a;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    float ts[kChains];
    chains<kChains * kDepth>(seed(a, it), ts);
    float s = ts[0];
#pragma unroll
    for (int c = 1; c < kChains; ++c) s = s + ts[c];
    acc = acc + s * 1e-6f;
  }
  y[i] = acc;
}

// The cheap-op chain of bench.py measure_quat_mix_peak: step K works on
// value K % NCC; K % 3 == 0 takes abs, 1 max(., 0.1), 2 a compare and a
// select against v (two ops) or, where only one op is left, a negation.
template <int N_CHEAP, int NCC, int K = 0, int EMITTED = 0>
__device__ __forceinline__ void cheap_chain(float* us, float v) {
  if constexpr (EMITTED < N_CHEAP) {
    constexpr int lane = K % NCC;
    if constexpr (K % 3 == 0) {
      us[lane] = fabsf(us[lane]);
      cheap_chain<N_CHEAP, NCC, K + 1, EMITTED + 1>(us, v);
    } else if constexpr (K % 3 == 1) {
      us[lane] = fmaxf(us[lane], 0.1f);
      cheap_chain<N_CHEAP, NCC, K + 1, EMITTED + 1>(us, v);
    } else if constexpr (EMITTED + 2 <= N_CHEAP) {
      us[lane] = us[lane] < 0.5f ? us[lane] : v;
      cheap_chain<N_CHEAP, NCC, K + 1, EMITTED + 2>(us, v);
    } else {
      us[lane] = -us[lane];
      cheap_chain<N_CHEAP, NCC, K + 1, EMITTED + 1>(us, v);
    }
  }
}

// HORNER fused slots, N_RSQRT rsqrtf and N_CHEAP cheap ops per iteration
// (no divisions: neither audited quat13 budget has one).
template <int HORNER, int N_RSQRT, int N_CHEAP>
__global__ void quat_mix_kernel(const float* __restrict__ x, float* __restrict__ y, int lanes,
                                int iters) {
  constexpr int NCC = N_CHEAP < 4 ? N_CHEAP : 4;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const float a = x[i];
  float acc = a;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const float v = seed(a, it);
    float ts[kChains];
    chains<HORNER>(v, ts);
    float rs[N_RSQRT];
#pragma unroll
    for (int j = 0; j < N_RSQRT; ++j) rs[j] = rsqrtf(ts[j % kChains] * ts[j % kChains]);
    float us[NCC];
#pragma unroll
    for (int k = 0; k < NCC; ++k) us[k] = ts[k % kChains];
    cheap_chain<N_CHEAP, NCC>(us, v);
    float s = ts[0];
#pragma unroll
    for (int c = 1; c < kChains; ++c) s = s + ts[c];
#pragma unroll
    for (int j = 0; j < N_RSQRT; ++j) s = s + rs[j];
#pragma unroll
    for (int k = 0; k < NCC; ++k) s = s + us[k];
    acc = acc + s * 1e-6f;
  }
  y[i] = acc;
}

template <typename Kernel>
int launch(Kernel kernel, const float* x, float* y, int lanes, int iters, int block,
           void* stream) {
  const dim3 grid((lanes + block - 1) / block);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(x, y, lanes, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int brov2_probe_fma(const float* x, float* y, int lanes, int iters, int block, void* stream) {
  return launch(fma_peak_kernel, x, y, lanes, iters, block, stream);
}

int brov2_probe_sin(const float* x, float* y, int lanes, int iters, int block, void* stream) {
  return launch(sin_peak_kernel, x, y, lanes, iters, block, stream);
}

int brov2_probe_fma_tree(const float* x, float* y, int lanes, int iters, int block,
                         void* stream) {
  return launch(fma_tree_kernel, x, y, lanes, iters, block, stream);
}

// budget 0: the quat13 RK4 step (577 slots: 513 Horner, 5 rsqrt, 47 cheap);
// budget 1: the quat13 Euler step (146 slots: 118 Horner, 2 rsqrt, 14
// cheap), as ops/cuda_probes.py MIX_BUDGET names them; the tests hold both
// against the audited budgets of eval/op_counts.py.
int brov2_probe_quat_mix(const float* x, float* y, int lanes, int iters, int budget, int block,
                         void* stream) {
  if (budget == 0) return launch(quat_mix_kernel<513, 5, 47>, x, y, lanes, iters, block, stream);
  if (budget == 1) return launch(quat_mix_kernel<118, 2, 14>, x, y, lanes, iters, block, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* brov2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
