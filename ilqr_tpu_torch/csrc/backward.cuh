// The m = 1 backward recursion from precomputed derivatives, for Hopper
// (sm_90a), a template on the state dimension N: backward.cu instantiates
// it for N = 2 (pendulum) and N = 4 (acrobot, cartpole), a custom model's
// library (ops/_build.py build_model) for its own n. It compiles for any N.
//
// Replaces: ilqr_tpu/ops/pallas_backward.py backward_sweep_packed (_kernel).
// Per lane, in reverse time: the Q-terms from fx, fu, cx, cu, cxx, cxu, cuu
// and V_{t+1}, QuuF = Quu + λ, the closed-form box QP clamp(−Qu/QuuF) on
// [lo, hi], K zeroed on a clamped control or a divergent step, dV, the V
// update and a latched divergence flag (ref src/ilqr_core.cpp:350-401).
//
// This is not the merged sweep's step (sweep_step.cuh): it follows the TPU
// kernel's own arithmetic — the dense fx, all n×n entries of Qxx and Vxx
// computed independently (so Vxx is not exactly symmetric), the divisions
// −Qu/q and −Qux_j/q, dV[1] as 0.5·k·Quu·k, and the accumulation order of
// pallas_backward.py:72-153.
//
// Bound on this card: bytes. Per lane-step it reads 2n² + 3n + 4 floats of
// derivatives and limits and writes n + 1 (48 and 5 at n = 4, ~0.87 GB at
// B = 8192, T = 499) against ~330 flops at n = 4. The one-thread kernel it
// replaces (one thread a lane, blocks of 64) started each step's loads only
// when the step began, so a block had one step's loads in flight and every
// step waited out device-memory latency and then its dependent chain; at
// B = 1024 it used 16 of the 132 SMs.
// Design:
//  - A team of kWidth<N> threads (the least power of two ≥ n, at most a
//    warp) serves one lane; a warp serves 32 / W lanes (8 at n = 3 and 4,
//    16 at n = 2) and a block two warps where that still gives every SM
//    two blocks, else one (warps_for): B = 8192 at n = 4 is 512 blocks of
//    two warps, B = 1024 128 blocks of one.
//  - The inputs of the next kStages − 1 chunks of kChunk steps are copied
//    into a ring of kStages shared-memory stages by cp.async, one commit
//    group a chunk, while the team computes the current chunk's steps. A
//    block's L lanes are L contiguous floats of each (T·rows, B) input
//    row: 16-byte copies where L and B are multiples of 4 and every input
//    is 16-byte aligned, else 4-byte ones (any B, any lane offset); a lane
//    past B copies the last full vector or lane B − 1. Each thread works
//    out its share of a step's copies (Feed) once, so a step costs it a
//    few copy instructions and no address arithmetic beyond t·stride.
//  - Thread j of a team owns column j of Vxx, of Vxx·fx and of Qxx, Qux_j,
//    Qx_j, the new Vx_j and K_j (columns j, j + W, … where n > W). Every
//    thread holds Vx, fuᵀVxx, Qux and K whole, gathered by __shfl_sync, and
//    computes qu, quu, the QP, dV and the latch itself, identically. Vxx is
//    gathered whole once a step for Vxx·fx.
//  - Timed on an H100 (700 W) at the rows' shapes by
//    tools/backward_geometry.py, twelve readings of each in turns (PERF.md
//    §6). 16-byte copies against 4-byte ones, two warps: 0.340-0.349
//    against 0.613-0.623 ms (acrobot, B = 8192, T = 499), 0.174-0.176
//    against 0.255-0.258 (cartpole, B = 1024, T = 299), 0.092-0.099 against
//    0.106-0.110 (pendulum). Two warps against one: 0.340-0.349 against
//    0.475-0.486 (acrobot); but one against two 0.156-0.158 against
//    0.174-0.176 (cartpole: 128 SMs busy, not 64), and tied on the pendulum
//    and unicycle_heading (n = 3). Four warps read tied or slower than two
//    on every row. The Feed is there because on one or a few warps an SM
//    every copy instruction lies on the step's critical path: copies
//    addressed element by element read 1.3 ms (acrobot) and 0.42 ms
//    (pendulum, slower than one thread a lane).
// A shuffle moves a value and never sums one: every output element is
// computed by one thread with the one-thread kernel's operations in its
// order (--fmad=false), so the results are that kernel's, and the plain
// version's, bit for bit. Every thread of a block runs every step (a lane
// past B on lane B − 1's inputs, writing nothing), so the block meets every
// barrier and every shuffle has the full warp.
//
// Layout (lane last): fx (T, n, n, B), fu/cx/cxu (T, n, B),
// cu/cuu/lo/hi (T, B), lam (B,), cxT (n, B), cxxT (n, n, B) → k (T, B),
// K (T, n, B), dv (2, B), diverged (B,) f32 0/1.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace backward {

constexpr int kChunk = 2;   // time steps a stage holds
constexpr int kStages = 4;  // stages in the ring: three chunks in flight

// Threads per lane: the least power of two ≥ N, at most a warp
template <int N>
constexpr int kWidth = N <= 1   ? 1
                       : N <= 2 ? 2
                       : N <= 4 ? 4
                       : N <= 8 ? 8
                       : N <= 16 ? 16
                                 : 32;
// Threads and lanes of a block of WARPS warps
template <int WARPS>
constexpr int kThreads = 32 * WARPS;
template <int N, int WARPS>
constexpr int kLanes = kThreads<WARPS> / kWidth<N>;
// Columns a thread owns
template <int N>
constexpr int kCols = (N + kWidth<N> - 1) / kWidth<N>;
// Input rows a time step: fx, fu, cx, cxx, cxu, then cu, cuu, lo, hi
template <int N>
constexpr int kRows = 2 * N * N + 3 * N + 4;
// Floats of one stage and of the ring, a block
template <int N, int WARPS>
constexpr int kStageFloats = kChunk * kRows<N> * kLanes<N, WARPS>;
template <int N, int WARPS>
constexpr size_t kSmemBytes =
    sizeof(float) * kStages * kStageFloats<N, WARPS>;

// jnp.maximum / jnp.minimum / jnp.clip: NaN-propagating
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// VEC floats from device memory into shared memory, asynchronously
template <int VEC>
__device__ __forceinline__ void copy(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the newest kStages − 2 has landed (this thread's copies)
__device__ __forceinline__ void wait_chunk() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

struct Inputs {
  const float *fx, *fu, *cx, *cu, *cxx, *cxu, *cuu, *lo, *hi;
};

// Row r of a time step's inputs: its array and rows per time step there
template <int N>
__device__ __forceinline__ const float* row_of(const Inputs& in, int r,
                                               int& per_t, int& rr) {
  constexpr int NN = N * N;
  if (r < NN) { per_t = NN; rr = r; return in.fx; }
  r -= NN;
  if (r < N) { per_t = N; rr = r; return in.fu; }
  r -= N;
  if (r < N) { per_t = N; rr = r; return in.cx; }
  r -= N;
  if (r < NN) { per_t = NN; rr = r; return in.cxx; }
  r -= NN;
  if (r < N) { per_t = N; rr = r; return in.cxu; }
  r -= N;
  per_t = 1;
  rr = 0;
  return r == 0 ? in.cu : r == 1 ? in.cuu : r == 2 ? in.lo : in.hi;
}

// This thread's share of one time step's copies, worked out once: the
// step's R rows of L lanes are R·L/VEC units of VEC floats (VEC = 4: 16
// bytes, where every input row of the block starts 16-byte aligned; else 1),
// unit u = r·(L/VEC) + v the lanes v·VEC … of row r; this thread copies
// units tid, tid + P, … of a block of P threads. A unit past B copies the
// block's last full vector (VEC = 4: B is a multiple of 4) or lane B − 1.
template <int N, int VEC, int WARPS>
struct Feed {
  static constexpr int L = kLanes<N, WARPS>, R = kRows<N>, PER_ROW = L / VEC;
  static constexpr int U = R * PER_ROW, P = kThreads<WARPS>;
  static constexpr int K = (U + P - 1) / P;
  const float* src[K];  // the unit's first float at t = 0
  int stride[K];        // floats from one time step to the next
  int dst[K];           // its offset in a step's stage slab; −1: no unit

  __device__ __forceinline__ Feed(const Inputs& in, size_t B, int lane0,
                                  int B_) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int u = threadIdx.x + k * P;
      dst[k] = -1;
      src[k] = in.fx;
      stride[k] = 0;
      if (u < U) {
        const int r = u / PER_ROW, v = u % PER_ROW;
        int per_t, rr;
        const float* a = row_of<N>(in, r, per_t, rr);
        const int ln = VEC == 4 ? min(lane0 + v * 4, B_ - 4)
                                : min(lane0 + v, B_ - 1);
        src[k] = a + rr * B + ln;
        stride[k] = per_t * B_;
        dst[k] = r * L + v * VEC;
      }
    }
  }
  // step t's units into its slab of a stage
  __device__ __forceinline__ void fetch(float* slab, int t) const {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (dst[k] >= 0)
        copy<VEC>(slab + dst[k], src[k] + static_cast<size_t>(t) * stride[k]);
  }
};

template <int N, int VEC, int WARPS>
__global__ void __launch_bounds__(kThreads<WARPS>)
backward_team_kernel(Inputs in, const float* __restrict__ lam,
                     const float* __restrict__ cxT,
                     const float* __restrict__ cxxT,
                     float* __restrict__ k_out, float* __restrict__ K_out,
                     float* __restrict__ dv_out, float* __restrict__ div_out,
                     int T, int B_) {
  constexpr int W = kWidth<N>, L = kLanes<N, WARPS>, C = kCols<N>;
  constexpr int R = kRows<N>, SF = kStageFloats<N, WARPS>;
  constexpr int NN = N * N;
  extern __shared__ float ring[];
  const int rank = threadIdx.x % W;
  const int lane0 = blockIdx.x * L;
  const int lane = lane0 + threadIdx.x / W;
  const bool valid = lane < B_;
  const int ln = valid ? lane : B_ - 1;  // where a team past B reads
  const int slot = threadIdx.x / W;      // the lane's place in a stage row
  const size_t B = B_;
  auto shfl = [](float v, int src) { return __shfl_sync(0xffffffffu, v, src, W); };
  // column c of this thread, and the column it reads (a thread past n
  // repeats column n − 1 and its results are never gathered)
  auto col = [&](int c) { return rank + c * W; };
  auto rcol = [&](int c) { return min(rank + c * W, N - 1); };

  float vx[N], vcol[C][N];  // Vx whole; the owned columns of Vxx
#pragma unroll
  for (int i = 0; i < N; ++i) vx[i] = cxT[i * B + ln];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int i = 0; i < N; ++i) vcol[c][i] = cxxT[(i * N + rcol(c)) * B + ln];
  float dv0 = 0.0f, dv1 = 0.0f, div = 0.0f;
  const float lm = lam[ln];

  const Feed<N, VEC, WARPS> feed(in, B, lane0, B_);
  // chunk c's steps t = T − 1 − c·kChunk − s, s < kChunk, into its stage,
  // row-major (s, row, lane); one commit group a chunk, empty or not
  auto fetch_chunk = [&](int c) {
    float* stage = ring + (c % kStages) * SF;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const int t = T - 1 - c * kChunk - s;
      if (t >= 0) feed.fetch(stage + s * R * L, t);
    }
    commit();
  };
  const int nchunks = (T + kChunk - 1) / kChunk;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) fetch_chunk(c);
  for (int c = 0; c < nchunks; ++c) {
    wait_chunk();
    __syncthreads();  // chunk c landed; chunk c − 1's stage read by all
    fetch_chunk(c + kStages - 1);
    const float* stage = ring + (c % kStages) * SF;
    for (int s = 0; s < kChunk; ++s) {
      const int t = T - 1 - c * kChunk - s;
      if (t < 0) break;
      const float* st = stage + s * R * L + slot;
      // the step's rows: element (row r) of this lane at st[r * L]
      auto f = [&](int i, int j) { return st[(i * N + j) * L]; };
      auto fu = [&](int i) { return st[(NN + i) * L]; };
      auto cx = [&](int i) { return st[(NN + N + i) * L]; };
      auto cxx = [&](int i, int j) { return st[(NN + 2 * N + i * N + j) * L]; };
      auto cxu = [&](int i) { return st[(2 * NN + 2 * N + i) * L]; };
      const float cu_t = st[(2 * NN + 3 * N) * L];
      const float cuu_t = st[(2 * NN + 3 * N + 1) * L];
      const float lo_t = st[(2 * NN + 3 * N + 2) * L];
      const float hi_t = st[(2 * NN + 3 * N + 3) * L];
      float fuv[N];
#pragma unroll
      for (int i = 0; i < N; ++i) fuv[i] = fu(i);

      // --- Q-terms (ref ilqr_core.cpp:359-367)
      float fvv[N];  // (fuᵀ Vxx)_j: the owned columns, then gathered
      {
        float own[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float acc = fuv[0] * vcol[c][0];
#pragma unroll
          for (int i = 1; i < N; ++i) acc = acc + fuv[i] * vcol[c][i];
          own[c] = acc;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) fvv[j] = shfl(own[j / W], j % W);
      }
      float qu = cu_t;
#pragma unroll
      for (int i = 0; i < N; ++i) qu = qu + fuv[i] * vx[i];
      float quu = cuu_t;
#pragma unroll
      for (int j = 0; j < N; ++j) quu = quu + fvv[j] * fuv[j];
      const float quuF = quu + lm;

      float qux_own[C], qx_own[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = rcol(c);
        float acc = cxu(j);
#pragma unroll
        for (int i = 0; i < N; ++i) acc = acc + fvv[i] * f(i, j);
        qux_own[c] = acc;
        acc = cx(j);
#pragma unroll
        for (int i = 0; i < N; ++i) acc = acc + f(i, j) * vx[i];
        qx_own[c] = acc;
      }
      // Vxx whole, for column j of Vxx fx: w[kk][j] = Σ_l vxx[kk][l] f[l][j]
      float vxx[N][N];
#pragma unroll
      for (int kk = 0; kk < N; ++kk)
#pragma unroll
        for (int l = 0; l < N; ++l) vxx[kk][l] = shfl(vcol[l / W][kk], l % W);
      float qxx[C][N];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = rcol(c);
        float w[N];
#pragma unroll
        for (int kk = 0; kk < N; ++kk) {
          float acc = vxx[kk][0] * f(0, j);
#pragma unroll
          for (int l = 1; l < N; ++l) acc = acc + vxx[kk][l] * f(l, j);
          w[kk] = acc;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float acc = cxx(i, j);
#pragma unroll
          for (int kk = 0; kk < N; ++kk) acc = acc + f(kk, i) * w[kk];
          qxx[c][i] = acc;
        }
      }

      // --- closed-form 1-D box QP; a NaN QuuF is not "bad", exactly as
      // the JAX comparison quuF <= 0 reads it
      const bool bad = quuF <= 0.0f;
      const float q_safe = bad ? 1.0f : quuF;
      const float x1 = nan_min(nan_max(-qu / q_safe, lo_t), hi_t);
      const float gk = quuF * x1 + qu;
      const bool clamped =
          (x1 <= lo_t && gk > 0.0f) || (x1 >= hi_t && gk < 0.0f);
      const float k = bad ? 0.0f : x1;
      const bool zero_K = clamped || bad;
      float K_own[C];  // K of the owned columns, then K whole, gathered
#pragma unroll
      for (int c = 0; c < C; ++c)
        K_own[c] = zero_K ? 0.0f : -qux_own[c] / q_safe;
      float qux[N], Kr[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        qux[j] = shfl(qux_own[j / W], j % W);
        Kr[j] = shfl(K_own[j / W], j % W);
      }

      div = nan_max(div, bad ? 1.0f : 0.0f);
      dv0 = dv0 + k * qu;
      dv1 = dv1 + 0.5f * k * quu * k;

      // --- V update (ref :391-393), every entry computed on its own
      const float kq = k * quu;
      float vx_own[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float Kj = K_own[c], quxj = qux_own[c];
        vx_own[c] = qx_own[c] + Kj * kq + Kj * qu + quxj * k;
#pragma unroll
        for (int i = 0; i < N; ++i)
          vcol[c][i] = qxx[c][i] + Kr[i] * quu * Kj + Kr[i] * quxj
                       + qux[i] * Kj;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) vx[j] = shfl(vx_own[j / W], j % W);

      if (valid) {
        if (rank == 0) k_out[t * B + lane] = k;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (col(c) < N)
            K_out[(static_cast<size_t>(t) * N + col(c)) * B + lane] =
                K_own[c];
      }
    }
  }
  if (valid && rank == 0) {
    dv_out[lane] = dv0;
    dv_out[B + lane] = dv1;
    div_out[lane] = div;
  }
}

// The dynamic shared memory allowance of a kernel, set once where its
// stage ring passes the 48 KB default; the status of that call
template <int N, int VEC, int WARPS>
inline int prepare() {
  static const int err =
      kSmemBytes<N, WARPS> > 48 * 1024
          ? (int)cudaFuncSetAttribute(
                backward_team_kernel<N, VEC, WARPS>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)kSmemBytes<N, WARPS>)
          : 0;
  return err;
}

// Warps a block for B lanes: two where that still gives every SM two
// blocks (longer runs of each input row a block), else one (more SMs busy)
template <int N>
inline int warps_for(int B) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
                   == cudaSuccess
               ? n
               : 132;
  }();
  return (B + kLanes<N, 2> - 1) / kLanes<N, 2> >= 2 * sms ? 2 : 1;
}

// f(vec, warps) for the kernel that B lanes take, as integral constants:
// warps_for's warps, and 16-byte copies (vec 4) where the block's lanes
// and B are multiples of 4 and the inputs are 16-byte aligned, else 4-byte
// ones (vec 1)
template <int N, class F>
inline int with_kernel(int B, bool aligned, F&& f) {
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  using Four = std::integral_constant<int, 4>;
  const bool vec = aligned && B % 4 == 0;
  if (warps_for<N>(B) == 2) {
    if constexpr (kLanes<N, 2> % 4 == 0)
      if (vec) return f(Four{}, Two{});
    return f(One{}, Two{});
  }
  if constexpr (kLanes<N, 1> % 4 == 0)
    if (vec) return f(Four{}, One{});
  return f(One{}, One{});
}

template <int N>
inline int launch(const void* fx, const void* fu, const void* cx,
                  const void* cu, const void* cxx, const void* cxu,
                  const void* cuu, const void* lo, const void* hi,
                  const void* lam, const void* cxT, const void* cxxT,
                  void* k, void* K, void* dv, void* div, int T, int B,
                  void* stream) {
  const Inputs in{(const float*)fx,  (const float*)fu,  (const float*)cx,
                  (const float*)cu,  (const float*)cxx, (const float*)cxu,
                  (const float*)cuu, (const float*)lo,  (const float*)hi};
  bool aligned = true;
  for (const float* p : {in.fx, in.fu, in.cx, in.cu, in.cxx, in.cxu, in.cuu,
                         in.lo, in.hi})
    aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return with_kernel<N>(B, aligned, [&](auto vec, auto warps) {
    constexpr int VEC = decltype(vec)::value, WARPS = decltype(warps)::value;
    const int err = prepare<N, VEC, WARPS>();
    if (err != 0) return err;
    constexpr int L = kLanes<N, WARPS>;
    backward_team_kernel<N, VEC, WARPS>
        <<<(B + L - 1) / L, kThreads<WARPS>, kSmemBytes<N, WARPS>,
           (cudaStream_t)stream>>>(in, (const float*)lam, (const float*)cxT,
                                   (const float*)cxxT, (float*)k, (float*)K,
                                   (float*)dv, (float*)div, T, B);
    return (int)cudaGetLastError();
  });
}

// Blocks an SM holds at once of the kernel that launch<N> launches for B
// lanes on 16-byte aligned inputs, and that kernel's threads a block,
// dynamic shared memory bytes a block and bytes a copy (16 or 4); -1 where
// a CUDA call fails
template <int N>
inline int blocks_per_sm(int B, int* threads, int* smem_bytes,
                         int* copy_bytes) {
  return with_kernel<N>(B, true, [&](auto vec, auto warps) {
    constexpr int VEC = decltype(vec)::value, WARPS = decltype(warps)::value;
    *threads = kThreads<WARPS>;
    *smem_bytes = (int)kSmemBytes<N, WARPS>;
    *copy_bytes = 4 * VEC;
    if (prepare<N, VEC, WARPS>() != 0) return -1;
    int n = 0;
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, backward_team_kernel<N, VEC, WARPS>, kThreads<WARPS>,
        kSmemBytes<N, WARPS>);
    return occ == cudaSuccess ? n : -1;
  });
}

}  // namespace backward

// ilqr_backward_n<N>: the instantiation for n = N;
// ilqr_backward_n<N>_blocks_per_sm(int B, int* threads, int* smem_bytes,
// int* copy_bytes): the occupancy of the kernel it launches for B lanes
// (backward::blocks_per_sm)
#define ILQR_BACKWARD_LAUNCHER(N)                                           \
  extern "C" int ilqr_backward_n##N(                                        \
      const void* fx, const void* fu, const void* cx, const void* cu,       \
      const void* cxx, const void* cxu, const void* cuu, const void* lo,    \
      const void* hi, const void* lam, const void* cxT, const void* cxxT,   \
      void* k, void* K, void* dv, void* div, int T, int B, void* stream) {  \
    return backward::launch<N>(fx, fu, cx, cu, cxx, cxu, cuu, lo, hi, lam,  \
                               cxT, cxxT, k, K, dv, div, T, B, stream);     \
  }                                                                         \
  extern "C" int ilqr_backward_n##N##_blocks_per_sm(                        \
      int B, int* threads, int* smem_bytes, int* copy_bytes) {              \
    return backward::blocks_per_sm<N>(B, threads, smem_bytes, copy_bytes);  \
  }
