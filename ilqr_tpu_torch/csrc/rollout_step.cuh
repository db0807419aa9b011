// Closed-loop rollout step and the line-search phases, per lane, for a
// model given as a traits struct (acrobot.cuh Model): counterpart of the
// rollout bodies of ilqr_tpu/ops/pallas_rollout.py _kernel/_ls_kernel and
// ilqr_tpu/ops/pallas_iter.py rollout_step, ref src/ilqr_core.cpp:184-226,
// :305-337.
//
// The line-search phases are shared by the line-search kernel and the
// whole-iteration kernel; they differ only in where the gains are read
// from (struct Gains).
#pragma once

#include "integrate.cuh"
#include "jnp.cuh"

namespace rollout {

// Gains k_t (M rows) and K_t (M·N rows) in device memory, each row B apart.
template <class Model>
struct Gains {
  static constexpr int N = Model::N, M = Model::M;
  const float* k;
  const float* K;
  size_t k_tstride;  // elements between k_t and k_{t+1}
  size_t K_tstride;  // elements between K_t and K_{t+1}
  size_t B;

  __device__ __forceinline__ void load(int t, int lane, float kv[M],
                                       float Kv[M][N]) const {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      kv[j] = k[t * k_tstride + j * B + lane];
#pragma unroll
      for (int i = 0; i < N; ++i)
        Kv[j][i] = K[t * K_tstride + (j * N + i) * B + lane];
    }
  }
};

// One step: u = u_ff + K (x − x̄) (u_ff already holds u + α·k where the
// caller has one), optional box clamp, running cost, then the Euler or RK4
// step (integrate.cuh, kScheme). Advances x in place; returns the running
// cost.
template <class Model, int kScheme>
__device__ __forceinline__ float step(const typename Model::Params& p,
                                      float x[Model::N],
                                      const float u_ff[Model::M],
                                      const float xsr[Model::N],
                                      const float Krow[Model::M][Model::N],
                                      bool clamp, float u[Model::M]) {
  constexpr int N = Model::N, M = Model::M;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    float acc = u_ff[j];
#pragma unroll
    for (int i = 0; i < N; ++i) acc = acc + Krow[j][i] * (x[i] - xsr[i]);
    if (clamp) acc = jnp::clip(acc, Model::u_lo(p, j), Model::u_hi(p, j));
    u[j] = acc;
  }
  const float c = Model::cost(p, x, u);
  integrate::step_as<Model, kScheme>(p, x, u, x);
  return c;
}

// Line-search phase 1: all A candidates advanced together from x0, each row
// of (us, x̄, k, K) read once per timestep for every candidate. The
// candidate states and running costs stay in registers (or spill to local
// memory for large models): every index into them is a compile-time
// constant after unrolling (a < MAX_A, guarded by a < A).
template <class Model, int MAX_A, int kScheme>
__device__ __forceinline__ void candidate_costs(
    const typename Model::Params& p, const float x0[Model::N],
    const float* __restrict__ us, const float* __restrict__ xs,
    const Gains<Model>& g, const float al[MAX_A], int A, int T, size_t B,
    int lane, bool clamp, float cand[MAX_A]) {
  constexpr int N = Model::N, M = Model::M;
  float xa[MAX_A][N];
#pragma unroll
  for (int a = 0; a < MAX_A; ++a) {
#pragma unroll
    for (int i = 0; i < N; ++i) xa[a][i] = x0[i];
    cand[a] = 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    float u_row[M], xsr[N], Kr[M][N], kr[M];
#pragma unroll
    for (int j = 0; j < M; ++j) u_row[j] = us[(t * M + j) * B + lane];
#pragma unroll
    for (int i = 0; i < N; ++i) xsr[i] = xs[(t * N + i) * B + lane];
    g.load(t, lane, kr, Kr);
#pragma unroll
    for (int a = 0; a < MAX_A; ++a) {
      if (a < A) {
        float uff[M], u[M];
#pragma unroll
        for (int j = 0; j < M; ++j) uff[j] = u_row[j] + al[a] * kr[j];
        cand[a] =
            cand[a] + step<Model, kScheme>(p, xa[a], uff, xsr, Kr, clamp, u);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < MAX_A; ++a)
    if (a < A) cand[a] = cand[a] + Model::final_cost(p, xa[a]);
}

// Phase 1 with the scheme chosen at run time, once for the whole loop.
template <class Model, int MAX_A>
__device__ __forceinline__ void candidate_costs(
    const typename Model::Params& p, const float x0[Model::N],
    const float* __restrict__ us, const float* __restrict__ xs,
    const Gains<Model>& g, const float al[MAX_A], int A, int T, size_t B,
    int lane, bool clamp, int scheme, float cand[MAX_A]) {
  if (scheme == integrate::kRK4)
    candidate_costs<Model, MAX_A, integrate::kRK4>(p, x0, us, xs, g, al, A,
                                                   T, B, lane, clamp, cand);
  else
    candidate_costs<Model, MAX_A, integrate::kEuler>(p, x0, us, xs, g, al, A,
                                                     T, B, lane, clamp, cand);
}

struct Selection {
  float alpha, cost, dcost, expected, accepted;
  int index;   // the selected candidate (0 where none is accepted)
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
  s.index = 0;
  bool chosen = false;
#pragma unroll
  for (int a = 0; a < MAX_A; ++a) {
    if (a < A) {
      const float dcost = cprev - cand[a];
      const float expected = -al[a] * (dv0 + al[a] * dv1);
      const float z = expected > 0.0f ? dcost / expected : sign_of(dcost);
      const bool acc = z > z_min;
      if (acc && !chosen) {
        s.index = a;
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
template <class Model, int kScheme>
__device__ __forceinline__ void emit(
    const typename Model::Params& p, const float x0[Model::N],
    const float* __restrict__ us, const float* __restrict__ xs,
    const float* __restrict__ xterm, const Gains<Model>& g,
    const float* __restrict__ kold, const float* __restrict__ Kold,
    float alpha, bool take, bool keep, int T, size_t B, int lane, bool clamp,
    float* __restrict__ xs_out, float* __restrict__ us_out,
    float* __restrict__ k_out, float* __restrict__ K_out,
    float* __restrict__ xfin_out) {
  constexpr int N = Model::N, M = Model::M;
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x0[i];
  for (int t = 0; t < T; ++t) {
    float u_row[M], xsr[N], Kr[M][N], kr[M];
#pragma unroll
    for (int j = 0; j < M; ++j) u_row[j] = us[(t * M + j) * B + lane];
#pragma unroll
    for (int i = 0; i < N; ++i) xsr[i] = xs[(t * N + i) * B + lane];
    g.load(t, lane, kr, Kr);
#pragma unroll
    for (int i = 0; i < N; ++i)
      xs_out[(t * N + i) * B + lane] = take ? x[i] : xsr[i];
    float uff[M], u[M];
#pragma unroll
    for (int j = 0; j < M; ++j) uff[j] = u_row[j] + alpha * kr[j];
    step<Model, kScheme>(p, x, uff, xsr, Kr, clamp, u);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const size_t o = (t * M + j) * B + lane;
      us_out[o] = take ? u[j] : u_row[j];
      k_out[o] = keep ? kr[j] : kold[o];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const size_t oK = ((t * M + j) * N + i) * B + lane;
        K_out[oK] = keep ? Kr[j][i] : Kold[oK];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    xfin_out[i * B + lane] = take ? x[i] : xterm[i * B + lane];
}

// Phase 2 with the scheme chosen at run time, once for the whole loop.
template <class Model, class... Args>
__device__ __forceinline__ void emit(int scheme, Args&&... args) {
  if (scheme == integrate::kRK4)
    emit<Model, integrate::kRK4>(args...);
  else
    emit<Model, integrate::kEuler>(args...);
}

}  // namespace rollout
