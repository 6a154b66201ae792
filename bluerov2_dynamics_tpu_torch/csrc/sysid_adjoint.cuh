// Adjoint helpers of the sysid window kernel (sysid_window.cu): the fit's
// derived constants from its log-scales, the vector-Jacobian product of one
// euler12 Euler step of fossen_rows.cuh written out by hand, one window
// start's forward and reverse pass, and the chain rule from the derived
// constants back to the 23 log-scales.
//
// The forward is fossen_rows.cuh's own rows (T200 curve, ZOH lag, wrench
// map, rhs_rows with the gimbal clamp, an Euler step), fed constants that
// the kernel assembles on the device in the order of models/sysid.py::
// _assemble, in float32.  The reverse pass recomputes each step's rows from
// the state it stored and runs their adjoint; the gradient with respect to
// every derived constant the rows read is summed per thread in registers.
#pragma once

#include "fossen_rows.cuh"

// What the fit holds fixed: the nominal Table A1 vector, the centre of
// buoyancy, g and rho * g (each rounded once to float32, as PyTorch rounds a
// Python scalar against a float32 tensor) and the step.
struct SysidConsts {
  float nominal[23];
  float cb[3];
  float g, rho_g;
  float dt;
};

// Slots of the per-thread gradient sums: the loss, then the derived
// constants the rows read, then (with gains) the 8 log-gains, then (with a
// fitted current) the 3 current components.
enum : int {
  kGLoss = 0,
  kGMinv = 1,    // 6
  kGMdiag = 7,   // 3: mdiag[0..2] in the Coriolis rows (the rest reach only minv)
  kGGyro = 10,   // 3
  kGYz = 13,
  kGZx = 14,
  kGXy = 15,
  kGDlin = 16,   // 6
  kGDquad = 22,  // 6
  kGWB = 28,
  kGXbB = 29,
  kGYbB = 30,
  kGZbB = 31,
  kGRows = 32,
};

template <bool GAINS, bool CURRENT>
__host__ __device__ constexpr int grad_slots() {
  return kGRows + (GAINS ? 8 : 0) + (CURRENT ? 3 : 0);
}

template <bool GAINS>
__host__ __device__ constexpr int current_slot() { return kGRows + (GAINS ? 8 : 0); }

// Floats a start stores a step: the state before the step (12), its wrench
// (6) and, with gains, its thrusts (8).
template <bool GAINS>
__host__ __device__ constexpr int store_fields() { return GAINS ? 26 : 18; }

// The derived constants of _assemble from the 23 scaled coefficients c, in
// its order and in float32; cur is the NED current.
__device__ __forceinline__ void assemble_rows(const SysidConsts& sc, const float* c,
                                              const float* cur, RowConsts& k) {
  const float m = c[0], V = c[1];
  const float I0 = c[2], I1 = c[3], I2 = c[4];
  const float A0 = c[5], A1 = c[6], A2 = c[7], A3 = c[8], A4 = c[9], A5 = c[10];
  k.mdiag[0] = m - A0;
  k.mdiag[1] = m - A1;
  k.mdiag[2] = m - A2;
  k.mdiag[3] = I0 - A3;
  k.mdiag[4] = I1 - A4;
  k.mdiag[5] = I2 - A5;
#pragma unroll
  for (int i = 0; i < 6; ++i) k.minv[i] = 1.0f / k.mdiag[i];
  k.gyro[0] = I2 - I1 + A4 - A5;
  k.gyro[1] = I0 - I2 + A5 - A3;
  k.gyro[2] = I1 - I0 + A3 - A4;
  k.yz = A1 - A2;
  k.zx = A2 - A0;
  k.xy = A0 - A1;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    k.d_lin[i] = -c[11 + i];
    k.d_quad[i] = -c[17 + i];
  }
  const float W = m * sc.g, B = sc.rho_g * V;
  k.WB = W - B;
  k.xbB = sc.cb[0] * B;
  k.ybB = sc.cb[1] * B;
  k.zbB = sc.cb[2] * B;
#pragma unroll
  for (int i = 0; i < 3; ++i) k.cur[i] = cur[i];
  k.dt = sc.dt;
  k.half_dt = 0.5f * sc.dt;
  k.sixth_dt = sc.dt / 6.0f;
}

// The adjoint of rhs_rows at the state x under the wrench tau.  With a =
// the adjoint of dx (12), adds (d dx / d x)^T a into lam, (d dx / d k)^T a
// into the derived-constant slots of G, and writes mu = (d dx / d tau)^T a.
// Without CURRENT the current is zero and its rows are skipped.
template <bool CURRENT>
__device__ __forceinline__ void rhs_rows_vjp(const RowConsts& k, const float* x, const float* tau,
                                             const float* a, float* lam, float* G, float* Gcur,
                                             float* mu) {
  const float u = x[6], v = x[7], w = x[8], pp = x[9], q = x[10], r = x[11];
  float sphi, cphi, sth, cth, spsi, cpsi;
  sincosf(x[3], &sphi, &cphi);
  sincosf(x[4], &sth, &cth);
  sincosf(x[5], &spsi, &cpsi);
  const float R[9] = {
      cpsi * cth,
      -spsi * cphi + cpsi * sth * sphi,
      spsi * sphi + cpsi * cphi * sth,
      spsi * cth,
      cpsi * cphi + sphi * sth * spsi,
      -cpsi * sphi + sth * spsi * cphi,
      -sth,
      cth * sphi,
      cth * cphi,
  };

  // hydro_rows' terms at (x, tau)
  const float m0 = k.mdiag[0], m1 = k.mdiag[1], m2 = k.mdiag[2];
  const float c[6] = {
      m2 * w * q - m1 * v * r,
      -m2 * w * pp + m0 * u * r,
      m1 * v * pp - m0 * u * q,
      k.gyro[0] * q * r + k.yz * v * w,
      k.gyro[1] * pp * r + k.zx * u * w,
      k.gyro[2] * pp * q + k.xy * u * v,
  };
  float z[6] = {u, v, w, pp, q, r};  // the current-relative velocity the damping reads
  if (CURRENT) {
    z[0] = u - (R[0] * k.cur[0] + R[3] * k.cur[1] + R[6] * k.cur[2]);
    z[1] = v - (R[1] * k.cur[0] + R[4] * k.cur[1] + R[7] * k.cur[2]);
    z[2] = w - (R[2] * k.cur[0] + R[5] * k.cur[1] + R[8] * k.cur[2]);
  }
  const float s = -R[6];
  const float g[6] = {
      k.WB * s,
      -k.WB * R[7],
      -k.WB * R[8],
      k.ybB * R[8] - k.zbB * R[7],
      -k.zbB * s - k.xbB * R[8],
      k.xbB * R[7] + k.ybB * s,
  };

  // nu_dot_i = (tau_i - c_i - d_i - g_i) minv_i: b_i is the adjoint of
  // c_i, d_i and g_i alike; the damping's adjoint goes to its velocity dz
  float b[6], dz[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float az = fabsf(z[i]);
    const float d = (k.d_lin[i] + k.d_quad[i] * az) * z[i];
    G[kGMinv + i] += a[6 + i] * (tau[i] - c[i] - d - g[i]);
    mu[i] = a[6 + i] * k.minv[i];
    b[i] = -mu[i];
    G[kGDlin + i] += b[i] * z[i];
    G[kGDquad + i] += b[i] * az * z[i];
    dz[i] = b[i] * (k.d_lin[i] + 2.0f * k.d_quad[i] * az);
  }

  // Coriolis
  G[kGMdiag + 0] += b[1] * u * r - b[2] * u * q;
  G[kGMdiag + 1] += b[2] * v * pp - b[0] * v * r;
  G[kGMdiag + 2] += b[0] * w * q - b[1] * w * pp;
  G[kGGyro + 0] += b[3] * q * r;
  G[kGGyro + 1] += b[4] * pp * r;
  G[kGGyro + 2] += b[5] * pp * q;
  G[kGYz] += b[3] * v * w;
  G[kGZx] += b[4] * u * w;
  G[kGXy] += b[5] * u * v;
  float du = dz[0] + b[1] * m0 * r - b[2] * m0 * q + b[4] * k.zx * w + b[5] * k.xy * v;
  float dv = dz[1] - b[0] * m1 * r + b[2] * m1 * pp + b[3] * k.yz * w + b[5] * k.xy * u;
  float dw = dz[2] + b[0] * m2 * q - b[1] * m2 * pp + b[3] * k.yz * v + b[4] * k.zx * u;
  float dp = dz[3] - b[1] * m2 * w + b[2] * m1 * v + b[4] * k.gyro[1] * r + b[5] * k.gyro[2] * q;
  float dq = dz[4] + b[0] * m2 * w - b[2] * m0 * u + b[3] * k.gyro[0] * r + b[5] * k.gyro[2] * pp;
  float dr = dz[5] - b[0] * m1 * v + b[1] * m0 * u + b[3] * k.gyro[0] * q + b[4] * k.gyro[1] * pp;

  // the DCM's adjoint, from the current, restoring and kinematic rows
  float dR[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) dR[i] = 0.0f;
  if (CURRENT) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Gcur[j] -= dz[0] * R[3 * j] + dz[1] * R[3 * j + 1] + dz[2] * R[3 * j + 2];
#pragma unroll
      for (int i = 0; i < 3; ++i) dR[3 * j + i] -= dz[i] * k.cur[j];
    }
  }
  G[kGWB] += b[0] * s - b[1] * R[7] - b[2] * R[8];
  G[kGXbB] += b[5] * R[7] - b[4] * R[8];
  G[kGYbB] += b[3] * R[8] + b[5] * s;
  G[kGZbB] -= b[3] * R[7] + b[4] * s;
  float dsth = b[0] * k.WB - b[4] * k.zbB + b[5] * k.ybB;
  dR[7] += -b[1] * k.WB - b[3] * k.zbB + b[5] * k.xbB;
  dR[8] += -b[2] * k.WB + b[3] * k.ybB - b[4] * k.xbB;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dR[3 * i] += a[i] * u;
    dR[3 * i + 1] += a[i] * v;
    dR[3 * i + 2] += a[i] * w;
  }
  du += a[0] * R[0] + a[1] * R[3] + a[2] * R[6];
  dv += a[0] * R[1] + a[1] * R[4] + a[2] * R[7];
  dw += a[0] * R[2] + a[1] * R[5] + a[2] * R[8];

  // Euler-angle rates; the clamped cos(theta) is a constant where it clamps
  const float sign = cth < 0.0f ? -1.0f : 1.0f;
  const bool clamped = fabsf(cth) < BROV2_GIMBAL_EPS;
  const float cth_c = clamped ? BROV2_GIMBAL_EPS * sign : cth;
  const float tth = sth / cth_c;
  const float num = sphi * q + cphi * r;
  const float a5c = a[5] / cth_c;
  dp += a[3];
  dq += a[3] * sphi * tth + a[4] * cphi + a5c * sphi;
  dr += a[3] * cphi * tth - a[4] * sphi + a5c * cphi;
  float dsphi = a[3] * tth * q - a[4] * r + a5c * q;
  float dcphi = a[3] * tth * r + a[4] * q + a5c * r;
  const float dtth = a[3] * num;
  dsth += dtth / cth_c;
  float dcth = clamped ? 0.0f : -(a5c * num + dtth * tth) / cth_c;

  // the DCM's entries back to the sines and cosines, then to the angles
  const float dcpsi = dR[0] * cth + dR[1] * sth * sphi + dR[2] * cphi * sth + dR[4] * cphi -
                      dR[5] * sphi;
  const float dspsi = -dR[1] * cphi + dR[2] * sphi + dR[3] * cth + dR[4] * sphi * sth +
                      dR[5] * sth * cphi;
  dcth += dR[0] * cpsi + dR[3] * spsi + dR[7] * sphi + dR[8] * cphi;
  dsth += dR[1] * cpsi * sphi + dR[2] * cpsi * cphi + dR[4] * sphi * spsi + dR[5] * spsi * cphi -
          dR[6];
  dsphi += dR[1] * cpsi * sth + dR[2] * spsi + dR[4] * sth * spsi - dR[5] * cpsi + dR[7] * cth;
  dcphi += -dR[1] * spsi + dR[2] * cpsi * sth + dR[4] * cpsi + dR[5] * sth * spsi + dR[8] * cth;

  lam[3] += dsphi * cphi - dcphi * sphi;
  lam[4] += dsth * cth - dcth * sth;
  lam[5] += dspsi * cpsi - dcpsi * spsi;
  lam[6] += du;
  lam[7] += dv;
  lam[8] += dw;
  lam[9] += dp;
  lam[10] += dq;
  lam[11] += dr;
}

// One step's actuation from command row U[row]: curve, lag (when USE_LAG)
// and wrench map, as window_eval.cu's K2 runs them.
template <bool USE_LAG>
__device__ __forceinline__ void actuate_rows(const ThrusterConsts& tc, const float* __restrict__ U,
                                             int row, float (*L)[3], float* F, float* tau) {
  const float4* p = reinterpret_cast<const float4*>(U + (int64_t)row * 8);
  const float4 lo = p[0], hi = p[1];
  const float u8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float f = static_thrust_row(tc, u8[j]);
    F[j] = USE_LAG ? lag_row(tc, L[j], f) : f;
  }
  wrench_rows(tc, F, tau);
}

// Window start s: its squared error summed over the H inner steps into
// G[kGLoss], and that sum's gradient with respect to the derived constants
// (and gains and current) added into G.  The state starts at X[s] and the
// lag at L0 (24 floats; zero where L0 is null); step t reads U[s + t +
// delay] and scores against X[s + t + 1].
//
// The reverse pass runs over segments of at most `seg` steps, last segment
// first.  A segment's steps store their state and wrench into `store`
// (field f of slot i at store[(i * store_fields + f) * ld]); the forward
// pass that sums the error stores the last segment, and each earlier
// segment is recomputed from the start, bit for bit the same rows.  At H <=
// seg that is one pass each way.  The adjoint is carried halved: the 2 of
// d(e^2)/de goes into the final scale.
template <bool USE_LAG, bool GAINS, bool CURRENT>
__device__ __forceinline__ void window_start_vjp(const RowConsts& k, const ThrusterConsts& tc,
                                                 const float* __restrict__ X,
                                                 const float* __restrict__ U,
                                                 const float* __restrict__ L0, int s, int H,
                                                 int delay, int seg, float* store, int ld,
                                                 float* G) {
  constexpr int NF = store_fields<GAINS>();
  float x[12], L[8][3], F[8], tau[6];
  auto restart = [&]() {
#pragma unroll
    for (int i = 0; i < 12; ++i) x[i] = X[(int64_t)s * 12 + i];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 3; ++i) L[j][i] = L0 ? L0[(int64_t)s * 24 + j * 3 + i] : 0.0f;
  };
  auto save = [&](int slot) {
    float* p = store + slot * NF * ld;
#pragma unroll
    for (int i = 0; i < 12; ++i) p[i * ld] = x[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) p[(12 + i) * ld] = tau[i];
    if (GAINS) {
#pragma unroll
      for (int j = 0; j < 8; ++j) p[(18 + j) * ld] = F[j];
    }
  };

  const int n_seg = (H + seg - 1) / seg;
  const int last0 = (n_seg - 1) * seg;
  restart();
  float loss = 0.0f;
  for (int t = 0; t < H; ++t) {
    actuate_rows<USE_LAG>(tc, U, s + t + delay, L, F, tau);
    if (t >= last0) save(t - last0);
    step_rows<0>(k, x, tau);
    const float* target = X + (int64_t)(s + t + 1) * 12;
    float e = 0.0f;
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const float d = x[i] - target[i];
      e = e + d * d;
    }
    loss = loss + e;
  }
  G[kGLoss] += loss;

  float lam[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) lam[i] = x[i] - X[(int64_t)(s + H) * 12 + i];
  for (int sg = n_seg - 1; sg >= 0; --sg) {
    const int t0 = sg * seg, t1 = min(H, t0 + seg);
    if (sg != n_seg - 1) {
      restart();
      for (int t = 0; t < t1; ++t) {
        actuate_rows<USE_LAG>(tc, U, s + t + delay, L, F, tau);
        if (t >= t0) save(t - t0);
        step_rows<0>(k, x, tau);
      }
    }
    for (int t = t1 - 1; t >= t0; --t) {
      const float* p = store + (t - t0) * NF * ld;
      float xs[12], ts[6], a[12], mu[6];
#pragma unroll
      for (int i = 0; i < 12; ++i) xs[i] = p[i * ld];
#pragma unroll
      for (int i = 0; i < 6; ++i) ts[i] = p[(12 + i) * ld];
#pragma unroll
      for (int i = 0; i < 12; ++i) a[i] = k.dt * lam[i];
      rhs_rows_vjp<CURRENT>(k, xs, ts, a, lam, G, G + current_slot<GAINS>(), mu);
      if (GAINS) {
        // tau_i = sum_j W'_ji F_j with W'_ji = Wm_ji exp(g_j): d/dg_j = F_j sum_i W'_ji mu_i
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const float wji = tc.Wm[j * 6 + i];
            if (wji != 0.0f) acc = acc + wji * mu[i];
          }
          G[kGRows + j] += p[(18 + j) * ld] * acc;
        }
      }
      if (t >= 1) {
        const float* target = X + (int64_t)(s + t) * 12;
#pragma unroll
        for (int i = 0; i < 12; ++i) lam[i] += xs[i] - target[i];
      }
    }
  }
}

// The gradient with respect to the 23 log-scales (and gains and current)
// from the grid's sums T (float64, in the slots above), by the chain rule
// through _assemble and c = nominal * exp(s); `scale` is 1 / (n_start * 12
// * H), the loss's mean.  Writes grad[0..22] (log-scales), grad[23..30]
// (gains) and grad[31..33] (current) where fitted.
template <bool GAINS, bool CURRENT>
__device__ __forceinline__ void chain_to_log_scales(const SysidConsts& sc, const float* c,
                                                    const RowConsts& k, const double* T,
                                                    double scale, float* grad) {
  double gmd[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const double md = k.mdiag[i];
    gmd[i] = (i < 3 ? T[kGMdiag + i] : 0.0) - T[kGMinv + i] / (md * md);
  }
  const double gyro0 = T[kGGyro], gyro1 = T[kGGyro + 1], gyro2 = T[kGGyro + 2];
  const double gW = T[kGWB];
  const double gB = -T[kGWB] + sc.cb[0] * T[kGXbB] + sc.cb[1] * T[kGYbB] + sc.cb[2] * T[kGZbB];
  double gc[23];
  gc[0] = gmd[0] + gmd[1] + gmd[2] + (double)sc.g * gW;
  gc[1] = (double)sc.rho_g * gB;
  gc[2] = gmd[3] + gyro1 - gyro2;
  gc[3] = gmd[4] - gyro0 + gyro2;
  gc[4] = gmd[5] + gyro0 - gyro1;
  gc[5] = -gmd[0] - T[kGZx] + T[kGXy];
  gc[6] = -gmd[1] + T[kGYz] - T[kGXy];
  gc[7] = -gmd[2] - T[kGYz] + T[kGZx];
  gc[8] = -gmd[3] - gyro1 + gyro2;
  gc[9] = -gmd[4] + gyro0 - gyro2;
  gc[10] = -gmd[5] - gyro0 + gyro1;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    gc[11 + i] = -T[kGDlin + i];
    gc[17 + i] = -T[kGDquad + i];
  }
  const double two_scale = 2.0 * scale;
#pragma unroll
  for (int i = 0; i < 23; ++i) grad[i] = (float)(two_scale * gc[i] * (double)c[i]);
  if (GAINS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) grad[23 + j] = (float)(two_scale * T[kGRows + j]);
  }
  if (CURRENT) {
#pragma unroll
    for (int j = 0; j < 3; ++j) grad[31 + j] = (float)(two_scale * T[current_slot<GAINS>() + j]);
  }
}
