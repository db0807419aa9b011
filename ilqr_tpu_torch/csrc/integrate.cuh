// The discrete step x_{t+1} = F(x_t, u_t) of a model given as a traits
// struct (acrobot.cuh Model), per lane: counterpart of
// ilqr_tpu/ops/pallas_rollout.py _integrate and of the step_fn of
// ilqr_tpu/ops/pallas_sweep.py _model_closures, in their operation order.
//
// The scheme is a runtime argument of the kernels, so that each model's
// kernels are instantiated once for both schemes; the rollout and line
// search branch on it once, outside their time loops, into loops with the
// scheme fixed at compile time (step_as): a branch inside the line
// search's unrolled candidates would keep their independent chains from
// interleaving. dt is the f32 the packed params carry.
#pragma once

namespace integrate {

enum Scheme : int { kEuler = 0, kRK4 = 1 };

// out ← F(x, u) with the scheme a compile-time constant; out may alias x.
//   Euler: x + f(x, u)·dt
//   RK4:   k1 = f(x), k2 = f(x + (0.5·dt)·k1), k3 = f(x + (0.5·dt)·k2),
//          k4 = f(x + dt·k3), x + (dt/6)·(((k1 + 2·k2) + 2·k3) + k4)
// (Python evaluates 0.5 * dt * k1 and the sum of the four stages left to
// right.) S is the scalar: float, or the dual numbers of dual.cuh, with
// which the step is differentiated through all its stages (the JAX
// kernels' jax.jvp of step_fn); dt and the stage weights are constants.
template <class Model, int kScheme, class S = float>
__device__ __forceinline__ void step_as(const typename Model::Params& p,
                                        const S x[Model::N],
                                        const S u[Model::M],
                                        S out[Model::N]) {
  constexpr int N = Model::N;
  S k1[N];
  Model::dynamics(p, x, u, k1);
  if constexpr (kScheme == kEuler) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = x[i] + k1[i] * p.dt;
  } else {
    const float h = 0.5f * p.dt;
    S xt[N], k2[N], k3[N], k4[N];
#pragma unroll
    for (int i = 0; i < N; ++i) xt[i] = x[i] + h * k1[i];
    Model::dynamics(p, xt, u, k2);
#pragma unroll
    for (int i = 0; i < N; ++i) xt[i] = x[i] + h * k2[i];
    Model::dynamics(p, xt, u, k3);
#pragma unroll
    for (int i = 0; i < N; ++i) xt[i] = x[i] + p.dt * k3[i];
    Model::dynamics(p, xt, u, k4);
    const float s = p.dt / 6.0f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = x[i] + s * (((k1[i] + 2.0f * k2[i]) + 2.0f * k3[i]) + k4[i]);
  }
}

// The same with the scheme chosen at run time (the stencils' and the
// directions' loops, which are runtime loops already).
template <class Model, class S = float>
__device__ __forceinline__ void step(const typename Model::Params& p,
                                     const S x[Model::N],
                                     const S u[Model::M], int scheme,
                                     S out[Model::N]) {
  if (scheme == kRK4)
    step_as<Model, kRK4, S>(p, x, u, out);
  else
    step_as<Model, kEuler, S>(p, x, u, out);
}

}  // namespace integrate
