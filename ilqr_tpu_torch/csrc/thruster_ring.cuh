// Thruster-ring device functions (counterpart of the SoA functions of
// ilqr_tpu/models/thruster_ring.py build_ring_model and
// ilqr_tpu_torch/models/thruster_ring.py), as the fused kernels take a model
// (see acrobot.cuh Model): one traits template on the ring size M, the
// registered rings being Model<12> (thruster_ring) and Model<16/20/24>
// (thruster_ring16/20/24), one csrc/kernels_<model>.cu each. Every
// expression keeps the operation order of the Python SoA code; the trig is
// the full-accuracy sincosf.
//
// Geometry<M> holds the JAX package's _ring_geometry(M) as f32 literals:
// the thrust directions (d0, d1) and torque arms, each the Python float
// rounded to f32 as the JAX package rounds it at use
// (tests/test_torch_models.py holds them bit for bit). Zero coefficients
// are skipped in the force and torque sums, as the JAX package skips them
// at trace time; the rotated B columns multiply by them all the same
// (ct·0 is live there).
#pragma once

#include "cost_pattern.cuh"

namespace thruster_ring {

template <int M>
struct Geometry;

template <>
struct Geometry<12> {
  __host__ __device__ static constexpr float d0(int i) {
    constexpr float v[12] = {
        -1.0f, -0.5f, -0.5f, 1.0f, 0.5f, -0.5f, 1.0f, -0.5f, 0.5f, 1.0f,
        -0.5f, -0.5f
    };
    return v[i];
  }
  __host__ __device__ static constexpr float d1(int i) {
    constexpr float v[12] = {
        0.0f, 0.8660254f, -0.8660254f, 0.0f, -0.8660254f, -0.8660254f, 0.0f,
        0.8660254f, 0.8660254f, 0.0f, 0.8660254f, -0.8660254f
    };
    return v[i];
  }
  __host__ __device__ static constexpr float arm(int i) {
    constexpr float v[12] = {
        0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f, 0.0f,
        -0.5f
    };
    return v[i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return "............"
           "............"
           "............"
           "xxxxxxxxxxxx"
           "xxxxxxxxxxxx"
           ".x.x.x.x.x.x"[r * 12 + j];
  }
};

template <>
struct Geometry<16> {
  __host__ __device__ static constexpr float d0(int i) {
    constexpr float v[16] = {
        -1.0f, -0.38268343f, -0.70710677f, 0.9238795f, 0.0f, -0.9238795f,
        0.70710677f, 0.38268343f, 1.0f, 0.38268343f, 0.70710677f, -0.9238795f,
        0.0f, 0.9238795f, -0.70710677f, -0.38268343f
    };
    return v[i];
  }
  __host__ __device__ static constexpr float d1(int i) {
    constexpr float v[16] = {
        0.0f, 0.9238795f, -0.70710677f, -0.38268343f, -1.0f, -0.38268343f,
        -0.70710677f, 0.9238795f, 0.0f, -0.9238795f, 0.70710677f, 0.38268343f,
        1.0f, 0.38268343f, 0.70710677f, -0.9238795f
    };
    return v[i];
  }
  __host__ __device__ static constexpr float arm(int i) {
    constexpr float v[16] = {
        0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f, 0.0f,
        -0.5f, 0.0f, 0.5f, 0.0f, -0.5f
    };
    return v[i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return "................"
           "................"
           "................"
           "xxxxxxxxxxxxxxxx"
           "xxxxxxxxxxxxxxxx"
           ".x.x.x.x.x.x.x.x"[r * 16 + j];
  }
};

template <>
struct Geometry<20> {
  __host__ __device__ static constexpr float d0(int i) {
    constexpr float v[20] = {
        -1.0f, -0.309017f, -0.809017f, 0.809017f, -0.309017f, -1.0f,
        0.309017f, 0.809017f, 0.809017f, -0.309017f, 1.0f, -0.309017f,
        0.809017f, 0.809017f, 0.309017f, -1.0f, -0.309017f, 0.809017f,
        -0.809017f, -0.309017f
    };
    return v[i];
  }
  __host__ __device__ static constexpr float d1(int i) {
    constexpr float v[20] = {
        0.0f, 0.95105654f, -0.58778524f, -0.58778524f, -0.95105654f, 0.0f,
        -0.95105654f, 0.58778524f, -0.58778524f, -0.95105654f, 0.0f,
        0.95105654f, 0.58778524f, -0.58778524f, 0.95105654f, 0.0f,
        0.95105654f, 0.58778524f, 0.58778524f, -0.95105654f
    };
    return v[i];
  }
  __host__ __device__ static constexpr float arm(int i) {
    constexpr float v[20] = {
        0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f, 0.0f,
        -0.5f, 0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f, 0.0f, -0.5f
    };
    return v[i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return "...................."
           "...................."
           "...................."
           "xxxxxxxxxxxxxxxxxxxx"
           "xxxxxxxxxxxxxxxxxxxx"
           ".x.x.x.x.x.x.x.x.x.x"[r * 20 + j];
  }
};

template <>
struct Geometry<24> {
  __host__ __device__ static constexpr float d0(int i) {
    constexpr float v[24] = {
        -1.0f, -0.25881904f, -0.8660254f, 0.70710677f, -0.5f, -0.9659258f,
        0.0f, 0.9659258f, 0.5f, -0.70710677f, 0.8660254f, 0.25881904f, 1.0f,
        0.25881904f, 0.8660254f, -0.70710677f, 0.5f, 0.9659258f, 0.0f,
        -0.9659258f, -0.5f, 0.70710677f, -0.8660254f, -0.25881904f
    };
    return v[i];
  }
  __host__ __device__ static constexpr float d1(int i) {
    constexpr float v[24] = {
        0.0f, 0.9659258f, -0.5f, -0.70710677f, -0.8660254f, 0.25881904f,
        -1.0f, 0.25881904f, -0.8660254f, -0.70710677f, -0.5f, 0.9659258f,
        0.0f, -0.9659258f, 0.5f, 0.70710677f, 0.8660254f, -0.25881904f, 1.0f,
        -0.25881904f, 0.8660254f, 0.70710677f, 0.5f, -0.9659258f
    };
    return v[i];
  }
  __host__ __device__ static constexpr float arm(int i) {
    constexpr float v[24] = {
        0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f, 0.0f,
        -0.5f, 0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f, 0.0f, -0.5f, 0.0f, 0.5f,
        0.0f, -0.5f
    };
    return v[i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return "........................"
           "........................"
           "........................"
           "xxxxxxxxxxxxxxxxxxxxxxxx"
           "xxxxxxxxxxxxxxxxxxxxxxxx"
           ".x.x.x.x.x.x.x.x.x.x.x.x"[r * 24 + j];
  }
};

template <int kM>
struct Model : cost::DiagonalHessians {
  static constexpr int N = 6;   // [px, py, θ, vx, vy, ω]
  static constexpr int M = kM;  // one thrust per ring thruster
  using G = Geometry<kM>;

  // Packed params: the params leaves in field order, then dt.
  struct Params {
    float goal[N], mass, inertia, drag, drag_w, w_state[N], w_control[M],
        w_fuel, w_final[N], u_min[M], u_max[M], dt;
  };

  // Structural pattern of jac(): '.' zero, '1' one, 'x' live.
  __host__ __device__ static constexpr char a_kind(int r, int i) {
    return "...1.."
           "....1."
           ".....1"
           "..xx.."
           "..x.x."
           ".....x"[r * N + i];
  }
  __host__ __device__ static constexpr char b_kind(int r, int j) {
    return G::b_kind(r, j);
  }

  __device__ __forceinline__ static Params load(const float* __restrict__ p) {
    Params q;
    for (int i = 0; i < N; ++i) q.goal[i] = p[i];
    q.mass = p[6];
    q.inertia = p[7];
    q.drag = p[8];
    q.drag_w = p[9];
    for (int i = 0; i < N; ++i) q.w_state[i] = p[10 + i];
    for (int j = 0; j < M; ++j) q.w_control[j] = p[16 + j];
    q.w_fuel = p[16 + M];
    for (int i = 0; i < N; ++i) q.w_final[i] = p[17 + M + i];
    for (int j = 0; j < M; ++j) q.u_min[j] = p[23 + M + j];
    for (int j = 0; j < M; ++j) q.u_max[j] = p[23 + 2 * M + j];
    q.dt = p[23 + 3 * M];
    return q;
  }
  __device__ __forceinline__ static float u_lo(const Params& p, int j) {
    return p.u_min[j];
  }
  __device__ __forceinline__ static float u_hi(const Params& p, int j) {
    return p.u_max[j];
  }

  // body-frame force Σᵢ dᵢ·uᵢ over the nonzero coefficients, in i order
  __device__ __forceinline__ static void body_force(const float u[M],
                                                    float& fb0, float& fb1) {
    bool live0 = false, live1 = false;
    fb0 = 0.0f;
    fb1 = 0.0f;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (G::d0(i) != 0.0f) {
        const float t = G::d0(i) * u[i];
        fb0 = live0 ? fb0 + t : t;
        live0 = true;
      }
      if (G::d1(i) != 0.0f) {
        const float t = G::d1(i) * u[i];
        fb1 = live1 ? fb1 + t : t;
        live1 = true;
      }
    }
  }

  __device__ __forceinline__ static void dynamics(const Params& p,
                                                  const float x[N],
                                                  const float u[M],
                                                  float dx[N]) {
    float st, ct;
    sincosf(x[2], &st, &ct);
    float fb0, fb1;
    body_force(u, fb0, fb1);
    const float inv_m = 1.0f / p.mass;
    float aw = 0.0f;
    bool live = false;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (G::arm(i) != 0.0f) {
        const float t = G::arm(i) * u[i];
        aw = live ? aw + t : t;
        live = true;
      }
    }
    dx[0] = x[3];
    dx[1] = x[4];
    dx[2] = x[5];
    dx[3] = (ct * fb0 - st * fb1) * inv_m - p.drag * x[3];
    dx[4] = (st * fb0 + ct * fb1) * inv_m - p.drag * x[4];
    dx[5] = aw / p.inertia - p.drag_w * x[5];
  }
  __device__ __forceinline__ static float weighted_sq(const Params& p,
                                                      const float w[N],
                                                      const float x[N]) {
    float e = p.goal[0] - x[0];
    float acc = e * w[0] * e;
#pragma unroll
    for (int i = 1; i < N; ++i) {
      e = p.goal[i] - x[i];
      acc = acc + e * w[i] * e;
    }
    return acc;
  }
  __device__ __forceinline__ static float cost(const Params& p,
                                               const float x[N],
                                               const float u[M]) {
    float acc = weighted_sq(p, p.w_state, x);
#pragma unroll
    for (int j = 0; j < M; ++j)
      acc = acc + u[j] * (p.w_control[j] * u[j] + p.w_fuel);
    return acc;
  }
  __device__ __forceinline__ static float final_cost(const Params& p,
                                                     const float x[N]) {
    return weighted_sq(p, p.w_final, x);
  }

  // Continuous-time Jacobians (jac_soa); only the entries a_kind/b_kind
  // mark live are set.
  __device__ __forceinline__ static void jac(const Params& p,
                                             const float x[N],
                                             const float u[M], float A[N][N],
                                             float Bu[N][M]) {
    float st, ct;
    sincosf(x[2], &st, &ct);
    float fb0, fb1;
    body_force(u, fb0, fb1);
    const float inv_m = 1.0f / p.mass;
    A[3][2] = (-st * fb0 - ct * fb1) * inv_m;
    A[4][2] = (ct * fb0 - st * fb1) * inv_m;
    A[3][3] = -1.0f * p.drag;
    A[4][4] = -1.0f * p.drag;
    A[5][5] = -1.0f * p.drag_w;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float d0 = G::d0(i), d1 = G::d1(i);
      Bu[3][i] = (ct * d0 - st * d1) * inv_m;
      Bu[4][i] = (st * d0 + ct * d1) * inv_m;
      if (G::arm(i) != 0.0f) Bu[5][i] = G::arm(i) / p.inertia;
    }
  }
  __device__ __forceinline__ static void cost_derivs(
      const Params& p, const float x[N], const float u[M], float cx[N],
      float cu[M], float cxx[N][N], float /*cxu*/[N][M],
      float cuu[M][M]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cx[i] = -2.0f * p.w_state[i] * (p.goal[i] - x[i]);
      cxx[i][i] = 2.0f * p.w_state[i];
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      cu[j] = 2.0f * p.w_control[j] * u[j] + p.w_fuel;
      cuu[j][j] = 2.0f * p.w_control[j];
    }
  }
  __device__ __forceinline__ static void final_cost_derivs(
      const Params& p, const float x[N], float cx[N], float cxx[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      cx[i] = -2.0f * p.w_final[i] * (p.goal[i] - x[i]);
      cxx[i] = 2.0f * p.w_final[i];
    }
  }
};

}  // namespace thruster_ring

