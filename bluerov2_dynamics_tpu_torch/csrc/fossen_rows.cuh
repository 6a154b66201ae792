// Shared device code of the port's physics kernels: the closed-form
// hydrodynamics shared by both state conventions, the euler12 and quat13
// RHSs, one Euler or RK4 step (with the quat13 renormalisation), the
// thruster actuation (T200 curve, third-order ZOH lag, wrench map), and the
// window kernels' fused epilogue (the grid-wide squared endpoint error).
//
// One copy of the arithmetic of ops/pallas_rollout.py::_make_hydro_rows /
// _make_rhs_rows / _rk4_rows, of ops/pallas_quat.py::_normalize_q_rows /
// _make_rhs_quat_rows / _quat_step_rows and of the thruster body of
// ops/pallas_eval.py::_make_thruster_window_kernel in the JAX package, and
// of their plain PyTorch versions in ops/cuda_rollout.py, cuda_eval.py and
// cuda_quat.py of this package.  The state of one trajectory lives in
// registers as float x[12] or x[13]; every loop over it unrolls, so no
// array ever reaches local memory.
//
// Numerics: f32 throughout, exact sincosf (never __sincosf, never
// --use_fast_math; its sine and cosine are sinf's and cosf's bits from one
// range reduction), IEEE division, and the same association order as the
// plain version.  nvcc contracts a*b+c into one FMA, which is the only
// source of last-bit differences against the plain version, apart from
// rsqrtf in the quaternion normalise (not correctly rounded; the plain
// version uses torch.rsqrt).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// Physical and integrator constants, rounded once from float64 on the host
// (the JAX kernels bake the same values as Python floats).  Passed by value
// at launch, so fitted coefficients never force a rebuild.
struct RowConsts {
  float mdiag[6];
  float minv[6];
  float gyro[3];
  float yz, zx, xy;      // Yvd - Zwd, Zwd - Xud, Xud - Yvd
  float d_lin[6];
  float d_quad[6];
  float WB, xbB, ybB, zbB;
  float cur[3];          // constant NED ocean current (zero is exact)
  float dt, half_dt, sixth_dt;
};

struct ThrusterConsts {
  float curve[5];        // c1, c3, c5, c7, c9
  float Ad[9];           // row-major (3, 3)
  float Bd[3];
  float c[3];
  float Wm[48];          // row-major (8, 6) wrench map
};

#define BROV2_GIMBAL_EPS 1e-7f

// Hydrodynamics shared by the euler12 and quat13 RHSs: from R = R_{b->n}
// (9 entries, row-major), the body velocities nu and the wrench tau, the
// NED position rates (px, py, pz) and nu_dot nd[6].
__device__ __forceinline__ void hydro_rows(const RowConsts& k, const float* R,
                                           const float* nu, const float* tau,
                                           float& px, float& py, float& pz, float* nd) {
  const float r00 = R[0], r01 = R[1], r02 = R[2];
  const float r10 = R[3], r11 = R[4], r12 = R[5];
  const float r20 = R[6], r21 = R[7], r22 = R[8];
  const float u = nu[0], v = nu[1], w = nu[2], pp = nu[3], q = nu[4], r = nu[5];

  // Coriolis C(nu) nu
  const float c0 = k.mdiag[2] * w * q - k.mdiag[1] * v * r;
  const float c1 = -k.mdiag[2] * w * pp + k.mdiag[0] * u * r;
  const float c2 = k.mdiag[1] * v * pp - k.mdiag[0] * u * q;
  const float c3 = k.gyro[0] * q * r + k.yz * v * w;
  const float c4 = k.gyro[1] * pp * r + k.zx * u * w;
  const float c5 = k.gyro[2] * pp * q + k.xy * u * v;

  // current-relative linear velocity v_r = nu - R^T v_c (damping only)
  const float ur = u - (r00 * k.cur[0] + r10 * k.cur[1] + r20 * k.cur[2]);
  const float vr = v - (r01 * k.cur[0] + r11 * k.cur[1] + r21 * k.cur[2]);
  const float wr = w - (r02 * k.cur[0] + r12 * k.cur[1] + r22 * k.cur[2]);
  const float d0 = (k.d_lin[0] + k.d_quad[0] * fabsf(ur)) * ur;
  const float d1 = (k.d_lin[1] + k.d_quad[1] * fabsf(vr)) * vr;
  const float d2 = (k.d_lin[2] + k.d_quad[2] * fabsf(wr)) * wr;
  const float d3 = (k.d_lin[3] + k.d_quad[3] * fabsf(pp)) * pp;
  const float d4 = (k.d_lin[4] + k.d_quad[4] * fabsf(q)) * q;
  const float d5 = (k.d_lin[5] + k.d_quad[5] * fabsf(r)) * r;

  // restoring wrench from the third DCM row (sin(theta) = -r20)
  const float s = -r20;
  const float g0 = k.WB * s;
  const float g1 = -k.WB * r21;
  const float g2 = -k.WB * r22;
  const float g3 = k.ybB * r22 - k.zbB * r21;
  const float g4 = -k.zbB * s - k.xbB * r22;
  const float g5 = k.xbB * r21 + k.ybB * s;

  nd[0] = (tau[0] - c0 - d0 - g0) * k.minv[0];
  nd[1] = (tau[1] - c1 - d1 - g1) * k.minv[1];
  nd[2] = (tau[2] - c2 - d2 - g2) * k.minv[2];
  nd[3] = (tau[3] - c3 - d3 - g3) * k.minv[3];
  nd[4] = (tau[4] - c4 - d4 - g4) * k.minv[4];
  nd[5] = (tau[5] - c5 - d5 - g5) * k.minv[5];

  px = r00 * u + r01 * v + r02 * w;
  py = r10 * u + r11 * v + r12 * w;
  pz = r20 * u + r21 * v + r22 * w;
}

// Closed-form euler12 RHS: dx = f(x, tau).
__device__ __forceinline__ void rhs_rows(const RowConsts& k, const float* x,
                                         const float* tau, float* dx) {
  const float phi = x[3], theta = x[4];
  const float pp = x[9], q = x[10], r = x[11];

  // one range reduction per angle: nvcc shares the fast path of a sinf and
  // a cosf of one argument but keeps a Payne-Hanek branch region for each
  float sphi, cphi, sth, cth, spsi, cpsi;
  sincosf(phi, &sphi, &cphi);
  sincosf(theta, &sth, &cth);
  sincosf(x[5], &spsi, &cpsi);

  const float R[9] = {
      cpsi * cth,
      -spsi * cphi + cpsi * sth * sphi,
      spsi * sphi + cpsi * cphi * sth,
      spsi * cth,
      cpsi * cphi + sphi * sth * spsi,
      -cpsi * sphi + sth * spsi * cphi,
      -sth,  // exact negation: hydro_rows' -r20 gives sth back bit for bit
      cth * sphi,
      cth * cphi,
  };
  hydro_rows(k, R, x + 6, tau, dx[0], dx[1], dx[2], dx + 6);

  // Euler-angle rates with the gimbal clamp (sign(0) = +1)
  const float sign = cth < 0.0f ? -1.0f : 1.0f;
  const float cth_c = fabsf(cth) < BROV2_GIMBAL_EPS ? BROV2_GIMBAL_EPS * sign : cth;
  const float tth = sth / cth_c;
  dx[3] = pp + sphi * tth * q + cphi * tth * r;
  dx[4] = cphi * q - sphi * r;
  dx[5] = (sphi * q + cphi * r) / cth_c;
}

#define BROV2_NORM_EPS2 1e-24f  // (1e-12)^2: the identity fallback of quat_normalize

// Quaternion normalise in place by one rsqrt of the squared norm, with the
// identity fallback below norm 1e-12.  The select comes before the product:
// rsqrtf(0) is inf, and 0 * inf would be NaN.
__device__ __forceinline__ void normalize_q_rows(float& qw, float& qx, float& qy, float& qz) {
  const float n2 = qw * qw + qx * qx + qy * qy + qz * qz;
  const bool small = n2 < BROV2_NORM_EPS2;
  const float inv = small ? 0.0f : rsqrtf(n2);
  const float one_if_small = small ? 1.0f : 0.0f;
  qw = qw * inv + one_if_small;
  qx = qx * inv;
  qy = qy * inv;
  qz = qz * inv;
}

// Closed-form quat13 RHS, x = [x, y, z, qw, qx, qy, qz, u, v, w, p, q, r]:
// the quaternion is normalised on entry (never hoisted out of the RK4
// stages), the DCM from it feeds kinematics, restoring and current.
__device__ __forceinline__ void rhs_quat_rows(const RowConsts& k, const float* x,
                                              const float* tau, float* dx) {
  float qw = x[3], qx = x[4], qy = x[5], qz = x[6];
  normalize_q_rows(qw, qx, qy, qz);
  const float pp = x[10], q = x[11], r = x[12];

  const float R[9] = {
      1.0f - 2.0f * (qy * qy + qz * qz),
      2.0f * (qx * qy - qz * qw),
      2.0f * (qx * qz + qy * qw),
      2.0f * (qx * qy + qz * qw),
      1.0f - 2.0f * (qx * qx + qz * qz),
      2.0f * (qy * qz - qx * qw),
      2.0f * (qx * qz - qy * qw),
      2.0f * (qy * qz + qx * qw),
      1.0f - 2.0f * (qx * qx + qy * qy),
  };
  hydro_rows(k, R, x + 7, tau, dx[0], dx[1], dx[2], dx + 7);

  dx[3] = 0.5f * (-qx * pp - qy * q - qz * r);
  dx[4] = 0.5f * (qw * pp + qy * r - qz * q);
  dx[5] = 0.5f * (qw * q - qx * r + qz * pp);
  dx[6] = 0.5f * (qw * r + qx * q - qy * pp);
}

// One integrator step in place on an N-state (12: euler12, 13: quat13);
// METHOD 0 = Euler, 1 = RK4.  tau is held across the RK4 stages.  The RK4
// sum is accumulated as ((k1 + 2 k2) + 2 k3) + k4, the association of the
// plain version.
template <int N>
__device__ __forceinline__ void rhs_n(const RowConsts& k, const float* x,
                                      const float* tau, float* dx) {
  if constexpr (N == 12) rhs_rows(k, x, tau, dx);
  else rhs_quat_rows(k, x, tau, dx);
}

template <int N, int METHOD>
__device__ __forceinline__ void integrate_rows(const RowConsts& k, float* x, const float* tau) {
  float kk[N];
  rhs_n<N>(k, x, tau, kk);
  if (METHOD == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = x[i] + k.dt * kk[i];
    return;
  }
  float acc[N], xs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) { acc[i] = kk[i]; xs[i] = x[i] + k.half_dt * kk[i]; }
  rhs_n<N>(k, xs, tau, kk);
#pragma unroll
  for (int i = 0; i < N; ++i) { acc[i] = acc[i] + 2.0f * kk[i]; xs[i] = x[i] + k.half_dt * kk[i]; }
  rhs_n<N>(k, xs, tau, kk);
#pragma unroll
  for (int i = 0; i < N; ++i) { acc[i] = acc[i] + 2.0f * kk[i]; xs[i] = x[i] + k.dt * kk[i]; }
  rhs_n<N>(k, xs, tau, kk);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x[i] + k.sixth_dt * (acc[i] + kk[i]);
}

// One euler12 step in place.
template <int METHOD>
__device__ __forceinline__ void step_rows(const RowConsts& k, float* x, const float* tau) {
  integrate_rows<12, METHOD>(k, x, tau);
}

// One quat13 step in place, then (RENORM) the quaternion renormalised.
template <int METHOD, bool RENORM>
__device__ __forceinline__ void step_quat_rows(const RowConsts& k, float* x, const float* tau) {
  integrate_rows<13, METHOD>(k, x, tau);
  if (RENORM) normalize_q_rows(x[3], x[4], x[5], x[6]);
}

// T200 odd polynomial in Horner form on V^2.
__device__ __forceinline__ float static_thrust_row(const ThrusterConsts& c, float V) {
  const float V2 = V * V;
  return V * (c.curve[0] + V2 * (c.curve[1] + V2 * (c.curve[2] + V2 * (c.curve[3] + V2 * c.curve[4]))));
}

// One lag sample for one thruster: N = Ad L + Bd F_cmd, L <- N; returns c.N.
__device__ __forceinline__ float lag_row(const ThrusterConsts& c, float* L, float f) {
  const float n0 = c.Ad[0] * L[0] + c.Ad[1] * L[1] + c.Ad[2] * L[2] + c.Bd[0] * f;
  const float n1 = c.Ad[3] * L[0] + c.Ad[4] * L[1] + c.Ad[5] * L[2] + c.Bd[1] * f;
  const float n2 = c.Ad[6] * L[0] + c.Ad[7] * L[1] + c.Ad[8] * L[2] + c.Bd[2] * f;
  L[0] = n0; L[1] = n1; L[2] = n2;
  return c.c[0] * n0 + c.c[1] * n1 + c.c[2] * n2;
}

// tau_i = sum_j Wm[j][i] F_j in ascending j, zero entries skipped.
__device__ __forceinline__ void wrench_rows(const ThrusterConsts& c, const float* F, float* tau) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float wji = c.Wm[j * 6 + i];
      if (wji != 0.0f) acc = acc + wji * F[j];
    }
    tau[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// The fused epilogue of the window kernels (K2, K4, K5 and, per rank, K7):
// the sum over starts of the squared endpoint error |x_H(s) - X[s + H]|^2.

#define BROV2_FULL_MASK 0xffffffffu

// Scratch from the wrapper: one float32 partial a block, a ticket that is
// zero before and after every launch, and the result.
struct SqScratch {
  float* out;          // the sum, one float32
  float* partials;     // gridDim.x floats
  unsigned* ticket;    // zero between launches
};

// Start s's squared endpoint error: the N-state x against the target row
// X[s + H]; zero on a thread that shadows a start past the end.
template <int N>
__device__ __forceinline__ float endpoint_sq(const float* x, const float* __restrict__ X,
                                             int s, int H, bool live) {
  const float* target = X + (int64_t)(s + H) * N;
  float e = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float d = x[i] - target[i];
    e = e + d * d;
  }
  return live ? e : 0.0f;
}

// The endpoint x of start s into row s of out.
template <int N>
__device__ __forceinline__ void write_endpoint(const float* x, float* __restrict__ out, int s) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[(int64_t)s * N + i] = x[i];
}

// Sum of one float a thread over the whole grid, into *sq.out.  Every
// thread of every block must call it.  Warp shuffles and then shared memory
// reduce a block to one float32 partial; each block stores its partial,
// fences, and takes a ticket by atomicInc with the limit gridDim.x - 1, so
// the last block to arrive sees gridDim.x - 1 and its increment leaves the
// ticket at zero for the next launch.  That block adds all the partials in
// float64 and writes the float32 result.
//
// Accuracy: the terms are non-negative, so each float32 sum errs by at most
// its number of additions times 2^-24 relative: a start's share (<= 13
// terms), 5 shuffle levels, <= 31 warp partials in turn; with float64
// across the blocks and one final rounding, the result is within
// (13 + 5 + 31 + 1) * 6e-8 = 3e-6 relative of the exact sum of the
// float32 squares, under the 1e-5 the callers are held to.  (A float32 sum
// of ~700 block partials in turn could drift by ~4e-5.)
// Determinism: every level adds in a fixed order, the last block reads the
// partials in the same order whichever block it is, and no float value
// goes through an atomic: the same inputs give the same bits.
template <int BLOCK>
__device__ __forceinline__ void grid_sum(float v, const SqScratch& sq) {
  static_assert(BLOCK % 32 == 0 && BLOCK <= 1024, "whole warps");
  constexpr int WARPS = BLOCK / 32;
  __shared__ float warp_f[WARPS];
  __shared__ double warp_d[WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(BROV2_FULL_MASK, v, o);
  if (lane == 0) warp_f[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = warp_f[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) b += warp_f[w];
    sq.partials[blockIdx.x] = b;
    __threadfence();
    last = atomicInc(sq.ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  double d = 0.0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += BLOCK) d += (double)__ldcg(sq.partials + i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d += __shfl_down_sync(BROV2_FULL_MASK, d, o);
  if (lane == 0) warp_d[warp] = d;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = warp_d[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) total += warp_d[w];
    *sq.out = (float)total;
  }
}
