// Closed-loop rollout step and the line-search phases, per lane
// (counterpart of the rollout bodies of ilqr_tpu/ops/pallas_rollout.py
// _kernel/_ls_kernel and ilqr_tpu/ops/pallas_iter.py rollout_step,
// ref src/ilqr_core.cpp:184-226, :305-337).
//
// The line-search phases are shared by the line-search kernel and the
// whole-iteration kernel; they differ only in where the gains are read
// from (struct Gains).
#pragma once

#include "acrobot.cuh"
#include "sweep_step.cuh"

namespace rollout {

using acrobot::N;
using acrobot::Params;

// Gains k_t (T,1,B-strided) and K_t rows (T,1,N,B-strided) in device memory.
struct Gains {
  const float* k;
  const float* K;
  size_t k_tstride;  // elements between k_t and k_{t+1}
  size_t K_tstride;  // elements between K_t and K_{t+1}; rows are B apart
  size_t B;

  __device__ __forceinline__ void load(int t, int lane, float* kv,
                                       float Kv[N]) const {
    *kv = k[t * k_tstride + lane];
#pragma unroll
    for (int i = 0; i < N; ++i) Kv[i] = K[t * K_tstride + i * B + lane];
  }
};

// One step: u = u_ff + K (x − x̄) (u_ff already holds u + α·k where the
// caller has one), optional box clamp, running cost, Euler x += f·dt.
// Advances x in place; returns the running cost.
__device__ __forceinline__ float step(const Params& p, float x[N], float u_ff,
                                      const float xsr[N], const float Krow[N],
                                      bool clamp, float* u_out) {
  float u = u_ff;
#pragma unroll
  for (int i = 0; i < N; ++i) u = u + Krow[i] * (x[i] - xsr[i]);
  if (clamp) u = sweep::clip(u, p.u_min, p.u_max);
  const float c = acrobot::cost(p, x, u);
  float dx[N];
  acrobot::dynamics(p, x, u, dx);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x[i] + dx[i] * p.dt;
  *u_out = u;
  return c;
}

// Line-search phase 1: all A candidates advanced together from x0, each row
// of (us, x̄, k, K) read once per timestep for every candidate. The
// candidate states and running costs stay in registers: every index into
// them is a compile-time constant after unrolling (a < MAX_A, guarded by
// a < A).
template <int MAX_A>
__device__ __forceinline__ void candidate_costs(
    const Params& p, const float x0[N], const float* __restrict__ us,
    const float* __restrict__ xs, const Gains& g, const float al[MAX_A],
    int A, int T, size_t B, int lane, bool clamp, float cand[MAX_A]) {
  float xa[MAX_A][N];
#pragma unroll
  for (int a = 0; a < MAX_A; ++a) {
#pragma unroll
    for (int i = 0; i < N; ++i) xa[a][i] = x0[i];
    cand[a] = 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    const float u_row = us[t * B + lane];
    float xsr[N], Kr[N], kr;
#pragma unroll
    for (int i = 0; i < N; ++i) xsr[i] = xs[(t * N + i) * B + lane];
    g.load(t, lane, &kr, Kr);
#pragma unroll
    for (int a = 0; a < MAX_A; ++a) {
      if (a < A) {
        float u;
        const float c = step(p, xa[a], u_row + al[a] * kr, xsr, Kr, clamp, &u);
        cand[a] = cand[a] + c;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < MAX_A; ++a)
    if (a < A) cand[a] = cand[a] + acrobot::final_cost(p, xa[a]);
}

struct Selection {
  float alpha, cost, dcost, expected, accepted;
};

// jnp.sign: keeps ±0 and NaN
__device__ __forceinline__ float sign_of(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d);
}

// First accepted α: z = dcost/expected against z_min (ref :199-213), with
// z = sign(dcost) where expected ≤ 0 — a branch, so no division by zero
// is ever evaluated.
template <int MAX_A>
__device__ __forceinline__ Selection select(const float cand[MAX_A],
                                            const float al[MAX_A], int A,
                                            float cprev, float dv0, float dv1,
                                            float z_min) {
  Selection s;
  s.alpha = al[0];
  s.cost = cand[0];
  s.dcost = cprev - cand[0];
  s.expected = -al[0] * (dv0 + al[0] * dv1);
  s.accepted = 0.0f;
  bool chosen = false;
#pragma unroll
  for (int a = 0; a < MAX_A; ++a) {
    if (a < A) {
      const float dcost = cprev - cand[a];
      const float expected = -al[a] * (dv0 + al[a] * dv1);
      const float z = expected > 0.0f ? dcost / expected : sign_of(dcost);
      const bool acc = z > z_min;
      if (acc && !chosen) {
        s.alpha = al[a];
        s.cost = cand[a];
        s.dcost = dcost;
        s.expected = expected;
      }
      if (acc) {
        chosen = true;
        s.accepted = 1.0f;
      }
    }
  }
  return s;
}

// Line-search phase 2: roll out the selected α with predicated writes.
// Lanes that take the step get the new trajectory, the others re-emit the
// current one; keep lanes get the new gains, the others the previous ones
// (which are then the only ones read).
__device__ __forceinline__ void emit(
    const Params& p, const float x0[N], const float* __restrict__ us,
    const float* __restrict__ xs, const float* __restrict__ xterm,
    const Gains& g, const float* __restrict__ kold,
    const float* __restrict__ Kold, float alpha, bool take, bool keep, int T,
    size_t B, int lane, bool clamp, float* __restrict__ xs_out,
    float* __restrict__ us_out, float* __restrict__ k_out,
    float* __restrict__ K_out, float* __restrict__ xfin_out) {
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x0[i];
  for (int t = 0; t < T; ++t) {
    const float u_row = us[t * B + lane];
    float xsr[N], Kr[N], kr;
#pragma unroll
    for (int i = 0; i < N; ++i) xsr[i] = xs[(t * N + i) * B + lane];
    g.load(t, lane, &kr, Kr);
#pragma unroll
    for (int i = 0; i < N; ++i)
      xs_out[(t * N + i) * B + lane] = take ? x[i] : xsr[i];
    float u;
    step(p, x, u_row + alpha * kr, xsr, Kr, clamp, &u);
    us_out[t * B + lane] = take ? u : u_row;
    k_out[t * B + lane] = keep ? kr : kold[t * B + lane];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const size_t o = (t * N + i) * B + lane;
      K_out[o] = keep ? Kr[i] : Kold[o];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    xfin_out[i * B + lane] = take ? x[i] : xterm[i * B + lane];
}

}  // namespace rollout
