// The bodies of the wrench-input window kernels K4 (euler12) and K5
// (quat13): one thread a start with the block's input rows staged in
// shared memory, and K4's warp-pair form.
//
// What held the one-thread kernels back at the apps' shape (9,065 starts,
// H=100): fewer than one warp a scheduler, each step of a lone warp
// waiting on the global load of its wrench row; one new row a step
// reaches a warp from L2.  Both bodies here take that load off the step.
//
// Staged (K5 always, K4 above its split threshold): a block stages the TAU
// rows its starts read, CHUNK steps at a time, in shared memory before it
// steps (rows s0 .. s0 + THREADS + CHUNK - 2 for its starts s0 ..
// s0 + THREADS - 1).  A float2 read at the 24-byte row stride falls on
// distinct banks within a half-warp (6i mod 32 for i < 16).
//
// Warp pair (K4 up to its split threshold): a pair of warps serves the same
// 32 starts, one lane a start in each, and divides the row step:
//   - the kinematic warp owns the Euler angles: their three sincosf, R, the
//     gimbal clamp and its two divisions, the angle rates;
//   - the dynamic warp owns the position and the body velocities:
//     Coriolis, damping, restoring, nd, and the position rates R nu.
// Every RHS evaluation (one an Euler step, four an RK4 step) exchanges
// state through shared memory, double-buffered by the exchange's parity:
// the kinematic warp sends R, the dynamic warp p, q, r.  Each pair orders
// its exchanges with its own named barrier (bar.sync with an immediate id
// and 64 threads), so a block holds at most 15 pairs.  One barrier an
// exchange is enough with two buffers: a warp rewrites a buffer two
// exchanges later, after the barrier that the other warp reaches only once
// it has read that buffer.  The pair's extra warps land on the schedulers
// that one thread a start leaves idle; with many starts they are busy
// already and the exchange only adds work, hence the threshold.
//
// Numerics: each row is computed with the expressions and association
// order of fossen_rows.cuh (hydro_rows, rhs_rows, integrate_rows, and
// step_rows / step_quat_rows themselves in the staged body); only the
// thread that computes a row changes.  In the fused form each warp of a
// pair adds the squared errors of its own rows, so a start's share of the
// sum is two partial sums.
#pragma once

#include "fossen_rows.cuh"

// Stage rows r0 .. r0 + n_rows - 1 of TAU (6 floats a row, 8-byte
// aligned) into s_tau, all threads of the block together.
__device__ __forceinline__ void stage_tau(float2* s_tau, const float* __restrict__ TAU, int r0,
                                          int n_rows) {
  const float2* src = reinterpret_cast<const float2*>(TAU + (int64_t)r0 * 6);
  for (int j = threadIdx.x; j < n_rows * 3; j += blockDim.x) s_tau[j] = src[j];
}

// A row of 6 floats as three float2 loads (global or shared).
__device__ __forceinline__ void tau_row(const float2* row, float* tau) {
  const float2 a = row[0], b = row[1], d = row[2];
  tau[0] = a.x; tau[1] = a.y; tau[2] = b.x; tau[3] = b.y; tau[4] = d.x; tau[5] = d.y;
}

// One thread a start, THREADS a block, the block's TAU rows staged CHUNK
// steps at a time.  Threads past the end shadow the last start in both
// forms (they must reach the block's barriers) and write and add nothing.
template <int N, int METHOD, bool RENORM, bool SQ, int THREADS, int CHUNK>
__device__ __forceinline__ void window_staged_body(const RowConsts& k,
                                                   const float* __restrict__ X,
                                                   const float* __restrict__ TAU,
                                                   float* __restrict__ out, int n_start, int H,
                                                   const SqScratch& sq) {
  __shared__ float2 s_tau[(THREADS + CHUNK - 1) * 3];
  const int s0 = blockIdx.x * THREADS;
  const int own = s0 + threadIdx.x;
  const bool live = own < n_start;
  const int s = live ? own : n_start - 1;
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = X[(int64_t)s * N + i];
  for (int t0 = 0; t0 < H; t0 += CHUNK) {
    const int n = min(CHUNK, H - t0);
    __syncthreads();  // the last chunk's rows are read
    // rows past n_start + H - 2 are no start's
    stage_tau(s_tau, TAU, s0 + t0, min(THREADS + n - 1, n_start + H - 1 - (s0 + t0)));
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      float tau[6];
      tau_row(s_tau + ((s - s0) + t) * 3, tau);
      if constexpr (N == 12) step_rows<METHOD>(k, x, tau);
      else step_quat_rows<METHOD, RENORM>(k, x, tau);
    }
  }
  if constexpr (SQ) grid_sum<THREADS>(endpoint_sq<N>(x, X, s, H, live), sq);
  else if (live) write_endpoint<N>(x, out, s);
}

// ---------------------------------------------------------------------------
// K4's warp-pair form.

// The rows of the euler12 state the kinematic warp owns: the angles.
__host__ __device__ constexpr bool kin_row(int i) { return i >= 3 && i < 6; }

// A block's exchange buffers, [pair][parity][float4][lane]: a float4 a
// lane at a 16-byte stride, so each access is free of bank conflicts.  R
// goes in three float4s (the last holds r22 alone), p, q, r in one.
template <int PAIRS>
struct PairExchange {
  float4 kd[PAIRS][2][3][32];  // kinematic -> dynamic
  float4 dk[PAIRS][2][1][32];  // dynamic -> kinematic
};

// Both warps of pair `pair` arrive and wait at barrier pair + 1 (0 is
// __syncthreads's).  The id is an immediate, chosen by a warp-uniform
// branch: with an id in a register ptxas reserves all 16 barriers of a
// block, and an SM then holds only 4 blocks.  The memory clobber keeps the
// exchange's shared loads and stores on their side of it.
template <int PAIRS, int ID = 1>
__device__ __forceinline__ void pair_sync(int pair) {
  if constexpr (ID < PAIRS) {
    if (pair != ID - 1) {
      pair_sync<PAIRS, ID + 1>(pair);
      return;
    }
  }
  asm volatile("bar.sync %0, 64;" ::"n"(ID) : "memory");
}

// The kinematic warp's share of one RHS evaluation (rhs_rows): from the
// angles x[3..5], R for the dynamic warp, and dx's angle rates.
template <int PAIRS>
__device__ __forceinline__ void kin_rhs(const float* x, float* dx, PairExchange<PAIRS>& ex,
                                        int pair, int lane, int& ph) {
  float sphi, cphi, sth, cth, spsi, cpsi;
  sincosf(x[3], &sphi, &cphi);
  sincosf(x[4], &sth, &cth);
  sincosf(x[5], &spsi, &cpsi);
  ex.kd[pair][ph][0][lane] = make_float4(cpsi * cth, -spsi * cphi + cpsi * sth * sphi,
                                         spsi * sphi + cpsi * cphi * sth, spsi * cth);
  ex.kd[pair][ph][1][lane] = make_float4(cpsi * cphi + sphi * sth * spsi,
                                         -cpsi * sphi + sth * spsi * cphi, -sth, cth * sphi);
  ex.kd[pair][ph][2][lane] = make_float4(cth * cphi, 0.0f, 0.0f, 0.0f);
  const float sign = cth < 0.0f ? -1.0f : 1.0f;
  const float cth_c = fabsf(cth) < BROV2_GIMBAL_EPS ? BROV2_GIMBAL_EPS * sign : cth;
  const float tth = sth / cth_c;
  pair_sync<PAIRS>(pair);
  const float4 a = ex.dk[pair][ph][0][lane];
  ph ^= 1;
  const float pp = a.x, q = a.y, r = a.z;
  dx[3] = pp + sphi * tth * q + cphi * tth * r;
  dx[4] = cphi * q - sphi * r;
  dx[5] = (sphi * q + cphi * r) / cth_c;
}

// The dynamic warp's share: hydro_rows with R received, dx's position and
// velocity rows.  tau is held across the RK4 stages.
template <int PAIRS>
__device__ __forceinline__ void dyn_rhs(const RowConsts& k, const float* x, const float* tau,
                                        float* dx, PairExchange<PAIRS>& ex, int pair, int lane,
                                        int& ph) {
  ex.dk[pair][ph][0][lane] = make_float4(x[9], x[10], x[11], 0.0f);
  pair_sync<PAIRS>(pair);
  const float4 a = ex.kd[pair][ph][0][lane], b = ex.kd[pair][ph][1][lane],
               c = ex.kd[pair][ph][2][lane];
  ph ^= 1;
  const float R[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
  hydro_rows(k, R, x + 6, tau, dx[0], dx[1], dx[2], dx + 6);
}

// One Euler or RK4 step of a warp's own rows of x (integrate_rows'
// association), `rhs(xs, dx)` being that warp's share of the RHS.
template <int METHOD, bool KIN, class Rhs>
__device__ __forceinline__ void pair_step(const RowConsts& k, float* x, Rhs rhs) {
  float kk[12];
  rhs(x, kk);
  if (METHOD == 0) {
#pragma unroll
    for (int i = 0; i < 12; ++i)
      if (kin_row(i) == KIN) x[i] = x[i] + k.dt * kk[i];
    return;
  }
  float acc[12], xs[12];
#pragma unroll
  for (int i = 0; i < 12; ++i)
    if (kin_row(i) == KIN) { acc[i] = kk[i]; xs[i] = x[i] + k.half_dt * kk[i]; }
  rhs(xs, kk);
#pragma unroll
  for (int i = 0; i < 12; ++i)
    if (kin_row(i) == KIN) { acc[i] = acc[i] + 2.0f * kk[i]; xs[i] = x[i] + k.half_dt * kk[i]; }
  rhs(xs, kk);
#pragma unroll
  for (int i = 0; i < 12; ++i)
    if (kin_row(i) == KIN) { acc[i] = acc[i] + 2.0f * kk[i]; xs[i] = x[i] + k.dt * kk[i]; }
  rhs(xs, kk);
#pragma unroll
  for (int i = 0; i < 12; ++i)
    if (kin_row(i) == KIN) x[i] = x[i] + k.sixth_dt * (acc[i] + kk[i]);
}

// K4's warp-pair body: PAIRS pairs a block, 32 starts a pair, blocks of
// 64 * PAIRS threads; warp 2j of a block is pair j's kinematic warp, 2j + 1
// its dynamic warp.  The lanes of a pair past the end shadow the last start
// (they must reach the pair's barriers) and write and add nothing; a pair
// wholly past the end skips the steps.
template <int METHOD, bool SQ, int PAIRS>
__device__ __forceinline__ void window_pair_body(const RowConsts& k, const float* __restrict__ X,
                                                 const float* __restrict__ TAU,
                                                 float* __restrict__ out, int n_start, int H,
                                                 const SqScratch& sq) {
  static_assert(PAIRS >= 1 && PAIRS <= 15, "a named barrier a pair, ids 1..15");
  __shared__ PairExchange<PAIRS> ex;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, pair = warp >> 1;
  const bool kin = (warp & 1) == 0;
  const int first = (blockIdx.x * PAIRS + pair) * 32;
  const int own = first + lane;
  const bool live = own < n_start;
  const int s = live ? own : n_start - 1;

  float x[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) x[i] = kin_row(i) == kin ? X[(int64_t)s * 12 + i] : 0.0f;

  int ph = 0;
  if (first < n_start) {
    if (kin) {
      for (int t = 0; t < H; ++t)
        pair_step<METHOD, true>(k, x, [&](const float* xs, float* dx) {
          kin_rhs<PAIRS>(xs, dx, ex, pair, lane, ph);
        });
    } else {
      for (int t = 0; t < H; ++t) {
        float tau[6];
        tau_row(reinterpret_cast<const float2*>(TAU + (int64_t)(s + t) * 6), tau);
        pair_step<METHOD, false>(k, x, [&](const float* xs, float* dx) {
          dyn_rhs<PAIRS>(k, xs, tau, dx, ex, pair, lane, ph);
        });
      }
    }
  }

  if constexpr (SQ) {
    const float* target = X + (int64_t)(s + H) * 12;
    float e = 0.0f;
#pragma unroll
    for (int i = 0; i < 12; ++i)
      if (kin_row(i) == kin) {
        const float d = x[i] - target[i];
        e = e + d * d;
      }
    grid_sum<64 * PAIRS>(live ? e : 0.0f, sq);
  } else if (live) {
#pragma unroll
    for (int i = 0; i < 12; ++i)
      if (kin_row(i) == kin) out[(int64_t)s * 12 + i] = x[i];
  }
}
