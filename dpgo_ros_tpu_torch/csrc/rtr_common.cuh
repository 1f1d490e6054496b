// Device code shared by two hand-written Hopper kernels of the solver: K1
// (rtr_block.cu, one masked block solve per launch) and K3 (asapp_tick.cu,
// one asynchronous ASAPP tick per launch). K1 calls rtr_solve_block, the
// masked Riemannian trust-region (RTR + Steihaug tCG) solve of the lifted
// pose-graph problem, from one 256-thread block; K3 calls rgd_step. K2
// (rtr_run.cu) and K4 (rtr_window.cu) solve on windows with the cluster
// version of this code, rtr_cluster.cuh.
//
// It computes what dpgo_ros_tpu/ops/fused_rtr.py::make_edge_alg and
// make_rtr_solve compute inside the Pallas kernels: cost and Euclidean
// gradient over all edges, the Riemannian Hessian-vector product (the same
// linear edge map plus the sym(YᵀG) curvature term), tangent projection,
// block-Jacobi preconditioning, truncated CG, the ρ-test and radius update,
// and the 20-step Newton–Schulz polar retraction. Plain version:
// dpgo_ros_tpu_torch/models/local_solvers.py::rtr_solve.
//
// What bounds it: every tCG iteration is a chain of dependent steps over the
// whole state (~200 KB of X per vector at sphere2500 size): an edge pass,
// a pose pass, and three scalar reductions whose results decide the next
// step. The work per iteration is tiny (~5k edges x ~100 flops), so the
// time goes to block-wide barriers and reduction latency, not to bytes or
// flops.
//
// Design: a single 256-thread block runs the whole solve, so every barrier
// is a __syncthreads() and no host sync or second launch is needed. State
// and CG vectors live in a device workspace the wrapper allocates (~2.4 MB
// at sphere2500 size; it stays in L2). An edge pass is two phases without
// atomics: threads over edges write each edge's src/dst contribution rows,
// then, after a barrier, threads over poses sum their rows through the CSR
// pull index in a fixed order, so results are deterministic. Inner products
// are reduced by a fixed-order warp-shuffle + shared-memory tree and
// broadcast through shared memory, so every thread takes the same branch at
// every loop test; no __syncthreads() sits under a branch that threads
// could disagree on. Pose-local passes keep one pose -> thread mapping, so
// a pose written by a thread in one pass is read by the same thread in the
// next without a barrier; only edge passes read other threads' poses, and
// each starts with a barrier. Every helper is inlined and a pass keeps at
// most four pose blocks live (elementwise updates stream through memory),
// so at 256 threads (up to 255 registers each) the blocks stay in
// registers instead of local memory. rtr_cluster.cuh spreads a window's
// solve over a thread-block cluster; K1's full-width solve is not on it.
//
// Layout: X is (n, r, d+1) row-major (the public layout of the port).
// fp32 only; d is a template parameter (2 or 3), r is a runtime value <= 8.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {


constexpr int THREADS = 256;  // see the design note above
constexpr int NWARPS = THREADS / 32;
static_assert(THREADS % 32 == 0 && NWARPS <= 32, "block size");
constexpr int RMAX = 8;
constexpr int KMAX = 4;  // widest multi-value reduction
constexpr float EPS = 1e-30f;  // fp32 division guard, as in the TPU kernel

struct Problem {
  int n, E, D, r, num_robots;
  const float* X0;
  const float* mask;
  const float* Pinv;  // (n, d+1, d+1)
  const int64_t* src;
  const int64_t* dst;
  const float* R;   // (E, d, d)
  const float* t;   // (E, d)
  const float* kw;  // (E,) effective rotation weight
  const float* tw;  // (E,) effective translation weight
  const int* pull;  // (n, D); 2E = zero row
  const int* robot_off;  // (num_robots + 1,)
  float* X;      // (n, r, d+1) output, also the current iterate
  float* stats;  // (6 + 2 * num_robots,)
  // workspace
  float* G;
  float* Xt;
  float* Gt;
  float* eta;
  float* Heta;
  float* res;
  float* z;
  float* delta;
  float* Hd;
  float* g;
  float* Ssym;     // (n, d, d)
  float* contrib;  // (2E + 1, r, d+1)
};

struct Params {
  int max_iterations, max_tcg;
  float gradnorm_tol, initial_radius, max_radius, tcg_kappa, tcg_theta;
};

template <int DD>
struct Blk {
  float v[RMAX][DD + 1];
};

struct SumOp {
  static constexpr float identity = 0.f;
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct MaxOp {
  static constexpr float identity = -FLT_MAX;
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Reduce K per-thread values over the block; every thread gets the same
// bits (lane 0's tree result, broadcast through shared memory).
template <int K, class Op>
__device__ __forceinline__ void block_reduce(float (&v)[K], float* sh, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float x = v[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) sh[q * NWARPS + warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      float x = lane < NWARPS ? sh[q * NWARPS + lane] : Op::identity;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
      if (lane == 0) sh[K * NWARPS + q] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = sh[K * NWARPS + q];
  __syncthreads();  // sh is reused by the next reduction
}

template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* sh) {
  block_reduce<K>(v, sh, SumOp());
}

template <int DD>
__device__ __forceinline__ void load(const float* base, int i, int r, Blk<DD>& out) {
  const float* p = base + (size_t)i * r * (DD + 1);
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
    if (a < r)
#pragma unroll
      for (int b = 0; b <= DD; ++b) out.v[a][b] = p[a * (DD + 1) + b];
}

template <int DD>
__device__ __forceinline__ void store(float* base, int i, int r, const Blk<DD>& in) {
  float* p = base + (size_t)i * r * (DD + 1);
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
    if (a < r)
#pragma unroll
      for (int b = 0; b <= DD; ++b) p[a * (DD + 1) + b] = in.v[a][b];
}

template <int DD>
__device__ __forceinline__ float dot(const Blk<DD>& A, const Blk<DD>& B, int r) {
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
    if (a < r)
#pragma unroll
      for (int b = 0; b <= DD; ++b) s += A.v[a][b] * B.v[a][b];
  return s;
}

// Tangent projection at X: V_Y − Y sym(Yᵀ V_Y); translation unchanged.
// out may alias V.
template <int DD>
__device__ __forceinline__ void proj(const Blk<DD>& X, const Blk<DD>& V, int r, Blk<DD>& out) {
  float S[DD][DD];
#pragma unroll
  for (int k = 0; k < DD; ++k)
#pragma unroll
    for (int l = 0; l < DD; ++l) {
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < RMAX; ++a)
        if (a < r) s += X.v[a][k] * V.v[a][l];
      S[k][l] = s;
    }
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
    if (a < r) {
#pragma unroll
      for (int l = 0; l < DD; ++l) {
        float acc = V.v[a][l];
#pragma unroll
        for (int k = 0; k < DD; ++k) acc -= X.v[a][k] * (0.5f * (S[k][l] + S[l][k]));
        out.v[a][l] = acc;
      }
      out.v[a][DD] = V.v[a][DD];
    }
}

// mask · proj(X, V · P⁻¹) for pose i.
template <int DD>
__device__ __forceinline__ void prec_tangent(const Problem& p, int i, float m, const Blk<DD>& X,
                                             const Blk<DD>& V, Blk<DD>& out) {
  const float* P = p.Pinv + (size_t)i * (DD + 1) * (DD + 1);
  float Pl[DD + 1][DD + 1];
#pragma unroll
  for (int b = 0; b <= DD; ++b)
#pragma unroll
    for (int c = 0; c <= DD; ++c) Pl[b][c] = P[b * (DD + 1) + c];
  Blk<DD> W;
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
    if (a < p.r)
#pragma unroll
      for (int c = 0; c <= DD; ++c) {
        float acc = V.v[a][0] * Pl[0][c];
#pragma unroll
        for (int b = 1; b <= DD; ++b) acc += V.v[a][b] * Pl[b][c];
        W.v[a][c] = acc;
      }
  proj<DD>(X, W, p.r, out);
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
    if (a < p.r)
#pragma unroll
      for (int b = 0; b <= DD; ++b) out.v[a][b] *= m;
}

// Edge phase of the linear map V ↦ egrad(V): each edge writes its src row
// (−kr1 Rᵀ − tr2 tᵀ, −tr2) and dst row (kr1, tr2) of the contribution
// table. Returns this thread's share of the cost when WITH_F.
template <int DD, bool WITH_F>
__device__ __forceinline__ float edge_phase(const Problem& p, const float* V) {
  const int r = p.r, C = r * (DD + 1);
  float f = 0.f;
  for (int e = threadIdx.x; e < p.E; e += THREADS) {
    Blk<DD> Vi, Vj;
    load<DD>(V, (int)p.src[e], r, Vi);
    load<DD>(V, (int)p.dst[e], r, Vj);
    float Rm[DD][DD], tv[DD];
#pragma unroll
    for (int k = 0; k < DD; ++k) {
#pragma unroll
      for (int b = 0; b < DD; ++b) Rm[k][b] = p.R[(size_t)e * DD * DD + k * DD + b];
      tv[k] = p.t[(size_t)e * DD + k];
    }
    const float kwe = p.kw[e], twe = p.tw[e];
    float* ci = p.contrib + (size_t)e * C;
    float* cj = p.contrib + (size_t)(p.E + e) * C;
#pragma unroll
    for (int a = 0; a < RMAX; ++a)
      if (a < r) {
        float kr1[DD];
#pragma unroll
        for (int b = 0; b < DD; ++b) {
          float acc = Vj.v[a][b];
#pragma unroll
          for (int k = 0; k < DD; ++k) acc -= Vi.v[a][k] * Rm[k][b];
          if (WITH_F) f += kwe * (acc * acc);
          kr1[b] = 2.f * kwe * acc;
        }
        float r2 = Vj.v[a][DD] - Vi.v[a][DD];
#pragma unroll
        for (int k = 0; k < DD; ++k) r2 -= Vi.v[a][k] * tv[k];
        if (WITH_F) f += twe * (r2 * r2);
        const float tr2 = 2.f * twe * r2;
#pragma unroll
        for (int k = 0; k < DD; ++k) {
          float acc = tr2 * tv[k];
#pragma unroll
          for (int b = 0; b < DD; ++b) acc += kr1[b] * Rm[k][b];
          ci[a * (DD + 1) + k] = -acc;
          cj[a * (DD + 1) + k] = kr1[k];
        }
        ci[a * (DD + 1) + DD] = -tr2;
        cj[a * (DD + 1) + DD] = tr2;
      }
  }
  return f;
}

// Gather phase: pose i's sum of contribution rows, in pull-index order.
template <int DD>
__device__ __forceinline__ void gather(const Problem& p, int i, Blk<DD>& out) {
  const int r = p.r, C = r * (DD + 1);
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
    if (a < r)
#pragma unroll
      for (int b = 0; b <= DD; ++b) out.v[a][b] = 0.f;
  for (int q = 0; q < p.D; ++q) {
    const float* row = p.contrib + (size_t)p.pull[(size_t)i * p.D + q] * C;
#pragma unroll
    for (int a = 0; a < RMAX; ++a)
      if (a < r)
#pragma unroll
        for (int b = 0; b <= DD; ++b) out.v[a][b] += row[a * (DD + 1) + b];
  }
}

// G = egrad(V) for all poses; returns f(V). Starts with a barrier: V may
// have been written by other threads' pose passes.
template <int DD>
__device__ __forceinline__ float egrad_cost(const Problem& p, const float* V, float* Gout,
                                            float* sh) {
  __syncthreads();
  float f[1] = {edge_phase<DD, true>(p, V)};
  __syncthreads();
  for (int i = threadIdx.x; i < p.n; i += THREADS) {
    Blk<DD> Gi;
    gather<DD>(p, i, Gi);
    store<DD>(Gout, i, p.r, Gi);
  }
  block_sum<1>(f, sh);  // also keeps the next edge phase off contrib
  return f[0];
}

// Newton–Schulz polar retraction of pose i (translation moves Euclidean).
template <int DD>
__device__ __forceinline__ void retract(const Blk<DD>& X, const Blk<DD>& V, int r, Blk<DD>& out) {
  float tr = 0.f;
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
    if (a < r)
#pragma unroll
      for (int b = 0; b < DD; ++b) {
        const float A = X.v[a][b] + V.v[a][b];
        out.v[a][b] = A;
        tr += A * A;
      }
  const float s = 1.f / sqrtf(fmaxf(tr, 1e-12f));
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
    if (a < r)
#pragma unroll
      for (int b = 0; b < DD; ++b) out.v[a][b] *= s;
  for (int it = 0; it < 20; ++it) {
    float G3[DD][DD];
#pragma unroll
    for (int k = 0; k < DD; ++k)
#pragma unroll
      for (int l = 0; l < DD; ++l) {
        float acc = 0.f;
#pragma unroll
        for (int a = 0; a < RMAX; ++a)
          if (a < r) acc += out.v[a][k] * out.v[a][l];
        G3[k][l] = acc;
      }
#pragma unroll
    for (int a = 0; a < RMAX; ++a)
      if (a < r) {
        float row[DD];
#pragma unroll
        for (int l = 0; l < DD; ++l) {
          float acc = 3.f * out.v[a][l];
#pragma unroll
          for (int k = 0; k < DD; ++k) acc -= out.v[a][k] * G3[k][l];
          row[l] = 0.5f * acc;
        }
#pragma unroll
        for (int l = 0; l < DD; ++l) out.v[a][l] = row[l];
      }
  }
#pragma unroll
  for (int a = 0; a < RMAX; ++a)
    if (a < r) out.v[a][DD] = X.v[a][DD] + V.v[a][DD];
}

// ‖mask · proj(X, G)‖² share of this thread.
template <int DD>
__device__ __forceinline__ float masked_rgrad_sq(const Problem& p, const float* Xb,
                                                 const float* Gb) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < p.n; i += THREADS) {
    Blk<DD> X, G;
    load<DD>(Xb, i, p.r, X);
    load<DD>(Gb, i, p.r, G);
    proj<DD>(X, G, p.r, G);
    const float m = p.mask[i];
    acc += m * m * dot<DD>(G, G, p.r);
  }
  return acc;
}

// Result of one block solve (every thread holds the same values).
struct SolveOut {
  float f0, f, gn0, gn;
  int k, ktot;  // TR iterations, tCG iterations
};

// One masked RTR solve of the block p.mask, from p.X0 into p.X (every pose
// of p.X is written; unmasked poses come out of the retraction, so callers
// that need them exact copy them back). Called by all threads of the block.
template <int DD>
__device__ __forceinline__ SolveOut rtr_solve_block(const Problem& p, const Params& q,
                                                    float* sh) {
  const int r = p.r, C = r * (DD + 1), tid = threadIdx.x;

  // contribution row 2E is the pull index's zero row
  for (int c = tid; c < C; c += THREADS) p.contrib[(size_t)2 * p.E * C + c] = 0.f;
  for (int i = tid; i < p.n; i += THREADS)
    for (int c = 0; c < C; ++c) p.X[(size_t)i * C + c] = p.X0[(size_t)i * C + c];

  float f = egrad_cost<DD>(p, p.X, p.G, sh);
  const float f0 = f;
  float gn;
  {
    float acc[1] = {masked_rgrad_sq<DD>(p, p.X, p.G)};
    block_sum<1>(acc, sh);
    gn = sqrtf(fmaxf(acc[0], 0.f));
  }
  const float gn0 = gn;
  float radius = q.initial_radius;
  int k = 0, ktot = 0;
  bool done = gn0 <= q.gradnorm_tol;

  while (!done && k < q.max_iterations) {
    // ---- truncated CG: g, sym(YᵀG), r0 = g, z0 = prec(r0), δ = −z0 ----
    float s2[2] = {0.f, 0.f};
    for (int i = tid; i < p.n; i += THREADS) {
      const size_t o = (size_t)i * C;
      const float m = p.mask[i];
      Blk<DD> X, g;
      load<DD>(p.X, i, r, X);
      {
        Blk<DD> G;
        load<DD>(p.G, i, r, G);
        float* S = p.Ssym + (size_t)i * DD * DD;
#pragma unroll
        for (int kk = 0; kk < DD; ++kk)
#pragma unroll
          for (int l = 0; l < DD; ++l) {
            float skl = 0.f, slk = 0.f;
#pragma unroll
            for (int a = 0; a < RMAX; ++a)
              if (a < r) {
                skl += X.v[a][kk] * G.v[a][l];
                slk += X.v[a][l] * G.v[a][kk];
              }
            S[kk * DD + l] = 0.5f * (skl + slk);
          }
        proj<DD>(X, G, r, g);
      }
#pragma unroll
      for (int a = 0; a < RMAX; ++a)
        if (a < r)
#pragma unroll
          for (int b = 0; b <= DD; ++b) g.v[a][b] *= m;
      store<DD>(p.g, i, r, g);
      store<DD>(p.res, i, r, g);
      Blk<DD> z;
      prec_tangent<DD>(p, i, m, X, g, z);
      s2[0] += dot<DD>(g, z, r);
      s2[1] += dot<DD>(g, g, r);
      store<DD>(p.z, i, r, z);
      for (int c = 0; c < C; ++c) {
        p.delta[o + c] = -p.z[o + c];
        p.eta[o + c] = 0.f;
        p.Heta[o + c] = 0.f;
      }
    }
    block_sum<2>(s2, sh);
    float r_z = s2[0];
    const float r0n = sqrtf(fmaxf(s2[1], EPS));
    const float target = q.tcg_theta == 1.f ? r0n * fminf(q.tcg_kappa, r0n)
                                            : r0n * fminf(q.tcg_kappa, powf(r0n, q.tcg_theta));
    bool tdone = r0n <= 0.f;
    int kt = 0;
    while (!tdone && kt < q.max_tcg) {
      // Hd = mask · proj(X, egrad(δ) − [δ_Y sym(YᵀG_Y), 0])
      __syncthreads();
      edge_phase<DD, false>(p, p.delta);
      __syncthreads();
      float s1[1] = {0.f};
      for (int i = tid; i < p.n; i += THREADS) {
        Blk<DD> X, dl, EH;
        load<DD>(p.X, i, r, X);
        load<DD>(p.delta, i, r, dl);
        gather<DD>(p, i, EH);
        const float* S = p.Ssym + (size_t)i * DD * DD;
#pragma unroll
        for (int a = 0; a < RMAX; ++a)
          if (a < r)
#pragma unroll
            for (int b = 0; b < DD; ++b) {
              float acc = EH.v[a][b];
#pragma unroll
              for (int kk = 0; kk < DD; ++kk) acc -= dl.v[a][kk] * S[kk * DD + b];
              EH.v[a][b] = acc;
            }
        proj<DD>(X, EH, r, EH);
        const float m = p.mask[i];
#pragma unroll
        for (int a = 0; a < RMAX; ++a)
          if (a < r)
#pragma unroll
            for (int b = 0; b <= DD; ++b) EH.v[a][b] *= m;
        store<DD>(p.Hd, i, r, EH);
        s1[0] += dot<DD>(dl, EH, r);
      }
      block_sum<1>(s1, sh);
      const float dHd = s1[0];
      const float alpha = r_z / (dHd > 0.f ? dHd : 1.f);

      float s4[4] = {0.f, 0.f, 0.f, 0.f};  // ‖η+αδ‖², ‖η‖², <η,δ>, ‖δ‖²
      for (int i = tid; i < p.n; i += THREADS) {
        const size_t o = (size_t)i * C;
        for (int c = 0; c < C; ++c) {
          const float e = p.eta[o + c], d = p.delta[o + c], tr = e + alpha * d;
          s4[0] += tr * tr;
          s4[1] += e * e;
          s4[2] += e * d;
          s4[3] += d * d;
        }
      }
      block_sum<4>(s4, sh);
      const bool hit = (dHd <= 0.f) || (s4[0] >= radius * radius);
      const float ee = s4[1], ed = s4[2], dd = fmaxf(s4[3], EPS);
      const float disc = fmaxf(ed * ed + dd * (radius * radius - ee), 0.f);
      const float tau = (-ed + sqrtf(disc)) / dd;
      const float step = hit ? tau : alpha;

      float s2b[2] = {0.f, 0.f};  // ‖r‖², <r,z>
      for (int i = tid; i < p.n; i += THREADS) {
        const size_t o = (size_t)i * C;
        for (int c = 0; c < C; ++c) {
          p.eta[o + c] += step * p.delta[o + c];
          p.Heta[o + c] += step * p.Hd[o + c];
        }
        Blk<DD> X, rr, z;
        load<DD>(p.X, i, r, X);
        load<DD>(p.res, i, r, rr);
        const float* Hd = p.Hd + o;
#pragma unroll
        for (int a = 0; a < RMAX; ++a)
          if (a < r)
#pragma unroll
            for (int b = 0; b <= DD; ++b) rr.v[a][b] += alpha * Hd[a * (DD + 1) + b];
        prec_tangent<DD>(p, i, p.mask[i], X, rr, z);
        s2b[0] += dot<DD>(rr, rr, r);
        s2b[1] += dot<DD>(rr, z, r);
        store<DD>(p.res, i, r, rr);
        store<DD>(p.z, i, r, z);
      }
      block_sum<2>(s2b, sh);
      const bool conv = sqrtf(fmaxf(s2b[0], 0.f)) <= target;
      const float beta = s2b[1] / fmaxf(r_z, EPS);
      tdone = hit || conv;
      ++kt;
      if (!tdone) {
        r_z = s2b[1];
        for (int i = tid; i < p.n; i += THREADS) {
          const size_t o = (size_t)i * C;
          for (int c = 0; c < C; ++c) p.delta[o + c] = -p.z[o + c] + beta * p.delta[o + c];
        }
      }
    }
    ktot += kt;

    // ---- model decrease, retraction, ρ-test ----
    float s3[3] = {0.f, 0.f, 0.f};  // <g,η>, <η,Hη>, ‖η‖²
    for (int i = tid; i < p.n; i += THREADS) {
      const size_t o = (size_t)i * C;
      for (int c = 0; c < C; ++c) {
        const float e = p.eta[o + c];
        s3[0] += p.g[o + c] * e;
        s3[1] += e * p.Heta[o + c];
        s3[2] += e * e;
      }
      Blk<DD> X, et, Xn;
      load<DD>(p.X, i, r, X);
      load<DD>(p.eta, i, r, et);
      retract<DD>(X, et, r, Xn);
      store<DD>(p.Xt, i, r, Xn);
    }
    block_sum<3>(s3, sh);
    const float pred = -(s3[0] + 0.5f * s3[1]);
    const float eta_n = sqrtf(fmaxf(s3[2], 0.f));
    const float f_try = egrad_cost<DD>(p, p.Xt, p.Gt, sh);
    const float rho = (f - f_try) / (fabsf(pred) > EPS ? pred : EPS);
    const bool accept = (rho > 0.1f) && (pred > 0.f);
    if (rho < 0.25f)
      radius = 0.25f * radius;
    else if (rho > 0.75f && eta_n >= 0.99f * radius)
      radius = fminf(2.f * radius, q.max_radius);
    if (accept) {
      f = f_try;
      for (int i = tid; i < p.n; i += THREADS) {
        const size_t o = (size_t)i * C;
        for (int c = 0; c < C; ++c) {
          p.X[o + c] = p.Xt[o + c];
          p.G[o + c] = p.Gt[o + c];
        }
      }
    }
    float sg[1] = {masked_rgrad_sq<DD>(p, p.X, p.G)};
    block_sum<1>(sg, sh);
    gn = sqrtf(fmaxf(sg[0], 0.f));
    ++k;
    done = gn <= q.gradnorm_tol;
  }
  return SolveOut{f0, f, gn0, gn, k, ktot};
}

// One projected-gradient step on the block p.mask, from p.X0 into p.X:
// X ← Retr(X, −s · m·proj(X, (m·proj(X, ∇f)) P⁻¹)), or without PRECOND
// X ← Retr(X, −s · m·proj(X, ∇f)). Every pose of p.X is written, unless
// KEEP_UNMASKED: then poses with mask 0 are skipped, so a caller that steps
// in place (p.X == p.X0) keeps them exact. Pose-local after the gradient,
// so in-place use is safe; the gradient starts with a barrier.
template <int DD, bool PRECOND = true, bool KEEP_UNMASKED = false>
__device__ __forceinline__ void rgd_step(const Problem& p, float stepsize, float* sh) {
  egrad_cost<DD>(p, p.X0, p.G, sh);
  for (int i = threadIdx.x; i < p.n; i += THREADS) {
    const float m = p.mask[i];
    if constexpr (KEEP_UNMASKED)
      if (m == 0.f) continue;
    Blk<DD> X, g, z;
    load<DD>(p.X0, i, p.r, X);
    load<DD>(p.G, i, p.r, g);
    proj<DD>(X, g, p.r, g);
#pragma unroll
    for (int a = 0; a < RMAX; ++a)
      if (a < p.r)
#pragma unroll
        for (int b = 0; b <= DD; ++b) g.v[a][b] *= m;
    if constexpr (PRECOND)
      prec_tangent<DD>(p, i, m, X, g, z);
    else
      z = g;
#pragma unroll
    for (int a = 0; a < RMAX; ++a)
      if (a < p.r)
#pragma unroll
        for (int b = 0; b <= DD; ++b) z.v[a][b] *= -stepsize;
    retract<DD>(X, z, p.r, g);
    store<DD>(p.X, i, p.r, g);
  }
}

// Floats of workspace one solve needs (10 state vectors, sym(YᵀG), the
// contribution table), and their assignment to p's workspace pointers.
inline long long solve_workspace_floats(int d, int r, int n, int E) {
  const long long C = (long long)r * (d + 1);
  return 10LL * n * C + (long long)n * d * d + (2LL * E + 1) * C;
}

inline void bind_solve_workspace(Problem& p, float* w, int d) {
  const size_t V = (size_t)p.n * p.r * (d + 1);
  p.G = w; w += V;
  p.Xt = w; w += V;
  p.Gt = w; w += V;
  p.eta = w; w += V;
  p.Heta = w; w += V;
  p.res = w; w += V;
  p.z = w; w += V;
  p.delta = w; w += V;
  p.Hd = w; w += V;
  p.g = w; w += V;
  p.Ssym = w; w += (size_t)p.n * d * d;
  p.contrib = w;
}

}  // namespace
