// Device code of the cluster window solve, shared by every solver kernel:
// K1 (rtr_block.cu, one masked block solve per launch on the mask's
// window, with the world's cost), K2 (rtr_run.cu, many solver steps per
// launch, each on its bank row's window), K3 (asapp_tick.cu, one ASAPP
// tick: a cluster per robot, RGD steps on the robot's window) and K4
// (rtr_window.cu, one robot's block solve per launch).
//
// It computes what dpgo_ros_tpu/ops/fused_rtr.py::make_rtr_solve computes
// inside the Pallas kernels, restricted to a window (the block's poses,
// the edges that touch the block and the separator poses at their far
// ends, built by dpgo_ros_tpu_torch/ops/hbm_rtr.py): the masked Riemannian
// trust-region solve (RTR + Steihaug tCG) with block-Jacobi
// preconditioning, the rho-test and radius update and the 20-step
// Newton-Schulz polar retraction, or (K2's RGD variant) one
// preconditioned gradient step. Plain version:
// dpgo_ros_tpu_torch/models/local_solvers.py::rtr_solve on the window.
//
// What bounds it on an H100: every tCG iteration is a chain of dependent
// passes over the window (a Hessian-vector product over the edges, then
// pose-local updates) separated by three inner products whose values
// decide the next step. The work per iteration is small (a 3,573-pose
// window at r = 5 is ~0.3 MB per vector, ~6,500 edges x ~100 flops), so
// the time goes to the latency of the passes and of the reductions, not
// to bytes or flops. On the one 256-thread block of the first design every
// thread walked its ~14 poses serially through ~11 __syncthreads() per
// iteration.
//
// Design: one launch is a thread-block cluster of up to 16 CTAs on
// neighbouring SMs (the host picks the size from the window, ~256 poses a
// CTA, so a thread owns about one pose).
// - Ownership: each CTA owns a contiguous slice of the window's local
//   poses, cut on the host by work (incident edges + the pose-local
//   passes, hbm_rtr.POSE_WORK edges' worth), and each thread
//   keeps the same poses in every pass, so a pose-local pass needs no
//   barrier. The vectors only the owner reads (G, G at the trial point,
//   eta, H eta, the residual, z, H delta, the gradient, sym(Y^T G) and
//   P^-1) live in the CTA's shared memory as structure-of-arrays (thread
//   t reads word t: no bank conflicts); where they do not fit (r = 8 on
//   the 50,000-pose windows) the same layout lives in a global workspace
//   slice. The vectors other CTAs read (X, X at the trial point, delta)
//   stay pose-major in the global workspace (L2): a far endpoint is one
//   contiguous r(d+1)-float row, 16-byte loads for d = 3.
// - Hessian-vector product and gradient: the owner of a pose walks its
//   pull row (the same contributions in the same order as the full-width
//   kernel) and computes each incident edge's contribution itself from
//   both endpoints. The first design's (2E+1)-row contribution table, its
//   barrier and its second L2 round trip are gone; sums still add in
//   pull-index order, without atomics. An edge's cost is added by the
//   owner of its source pose.
// - Reductions: each warp reduces its values with shuffles and one lane
//   per CTA stores the warp's partial into every CTA's shared memory
//   (distributed shared memory), then one cluster barrier; every warp of
//   every CTA then sums the same partials in the same order, so every
//   thread holds the same bits and takes the same branch at every loop
//   test. No cluster barrier sits under a branch on which threads could
//   disagree. The partial buffers alternate between two halves: a CTA
//   overwrites a half only after the next reduction's barrier, which no
//   CTA passes before it has read that half. One cluster barrier per
//   reduction, one more before each Hessian-vector product reads delta:
//   four per tCG iteration.
// - r is a template value (1..8), so a pose block is exactly r(d+1)
//   registers and nothing is indexed at run time.
//
// fp32 only; d is 2 or 3.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int CLUSTER_MAX = 16;  // non-portable cluster size of Hopper
constexpr int KMAX = 4;          // widest reduction
constexpr int RED_SLOT = CLUSTER_MAX * NWARPS;  // warp partials of one value
constexpr int RED_FLOATS = 2 * KMAX * RED_SLOT;  // two alternating halves
constexpr int EDATA = 16;  // floats per gathered edge: R, t, kappa w, tau w
constexpr float EPS = 1e-30f;  // fp32 division guard, as in the TPU kernel
// dynamic shared memory a CTA may take beside the static reduction buffer
constexpr long long SMEM_DYN_MAX = 232448 - 4LL * RED_FLOATS - 1024;

// the owner-only vectors, in this order in a CTA's region
enum { O_G, O_GT, O_ETA, O_HETA, O_RES, O_Z, O_HD, O_GRAD, O_NVEC };

struct Params {
  int max_iterations, max_tcg;
  float gradnorm_tol, initial_radius, max_radius, tcg_kappa, tcg_theta;
};

struct SolveOut {
  float f0, f, gn0, gn;
  int k, ktot;  // TR iterations, tCG iterations
};

// The world's operands the windows index by global id.
struct World {
  float* X;  // (n, r, d+1): K4 reads it; K2 updates block poses in place
  const float* Pinv;  // (n, d+1, d+1)
  const float* R;     // (E, d, d)
  const float* t;     // (E, d)
  const float* kw;    // (E,) effective rotation weight
  const float* tw;    // (E,) effective translation weight
};

// One window as a CTA sees it. Local poses 0..nb-1 are the block (mask
// 1), the rest its separators (mask 0); this CTA owns [lo, hi).
struct Win {
  int nw, ew, nb, D;
  const int* poses;  // (nw,) global pose ids
  const int* edges;  // (ew,) global edge ids
  const int* lsrc;   // (ew,) local endpoints
  const int* ldst;
  const int* pull;   // (nw, D) local pull index; 2*ew pads
  int lo, hi;
};

// Workspace of one launch.
struct Work {
  float* edata;  // (ew, EDATA) gathered edge data
  float* X;      // (nw, r, d+1) current iterate, pose-major
  float* Xt;     // trial point
  float* dl;     // tCG direction delta
  float* own;    // this CTA's owner-only vectors: [v][c][P]
  int P;         // slice capacity: the stride of `own`
  float* pv;     // P^-1 of the slice ([c][P]); null: its place in `own`
};

// Floats of a CTA's owner-only region for slices of at most P poses.
inline long long own_floats(int d, int r, int P) {
  return (long long)P * (O_NVEC * r * (d + 1) + d * d + (d + 1) * (d + 1));
}

template <int DD, int RR>
struct Blk {
  float v[RR][DD + 1];
};

// pose i of a pose-major vector (16-byte loads when d = 3)
template <int DD, int RR>
__device__ __forceinline__ void ld_pose(const float* base, int i, Blk<DD, RR>& o) {
  constexpr int C = RR * (DD + 1);
  const float* p = base + (size_t)i * C;
  if constexpr (DD == 3) {
#pragma unroll
    for (int a = 0; a < RR; ++a) {
      const float4 q = reinterpret_cast<const float4*>(p)[a];
      o.v[a][0] = q.x;
      o.v[a][1] = q.y;
      o.v[a][2] = q.z;
      o.v[a][3] = q.w;
    }
  } else {
#pragma unroll
    for (int a = 0; a < RR; ++a)
#pragma unroll
      for (int b = 0; b <= DD; ++b) o.v[a][b] = p[a * (DD + 1) + b];
  }
}

template <int DD, int RR>
__device__ __forceinline__ void st_pose(float* base, int i, const Blk<DD, RR>& o) {
  constexpr int C = RR * (DD + 1);
  float* p = base + (size_t)i * C;
  if constexpr (DD == 3) {
#pragma unroll
    for (int a = 0; a < RR; ++a)
      reinterpret_cast<float4*>(p)[a] = make_float4(o.v[a][0], o.v[a][1], o.v[a][2], o.v[a][3]);
  } else {
#pragma unroll
    for (int a = 0; a < RR; ++a)
#pragma unroll
      for (int b = 0; b <= DD; ++b) p[a * (DD + 1) + b] = o.v[a][b];
  }
}

// local pose li of an owner-only vector ([c][P] layout)
template <int DD, int RR>
__device__ __forceinline__ void ld_own(const float* base, int P, int li, Blk<DD, RR>& o) {
#pragma unroll
  for (int a = 0; a < RR; ++a)
#pragma unroll
    for (int b = 0; b <= DD; ++b) o.v[a][b] = base[(size_t)(a * (DD + 1) + b) * P + li];
}

template <int DD, int RR>
__device__ __forceinline__ void st_own(float* base, int P, int li, const Blk<DD, RR>& o) {
#pragma unroll
  for (int a = 0; a < RR; ++a)
#pragma unroll
    for (int b = 0; b <= DD; ++b) base[(size_t)(a * (DD + 1) + b) * P + li] = o.v[a][b];
}

template <int DD, int RR>
__device__ __forceinline__ void zero(Blk<DD, RR>& o) {
#pragma unroll
  for (int a = 0; a < RR; ++a)
#pragma unroll
    for (int b = 0; b <= DD; ++b) o.v[a][b] = 0.f;
}

template <int DD, int RR>
__device__ __forceinline__ void scale(Blk<DD, RR>& o, float s) {
#pragma unroll
  for (int a = 0; a < RR; ++a)
#pragma unroll
    for (int b = 0; b <= DD; ++b) o.v[a][b] *= s;
}

template <int DD, int RR>
__device__ __forceinline__ float dot(const Blk<DD, RR>& A, const Blk<DD, RR>& B) {
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < RR; ++a)
#pragma unroll
    for (int b = 0; b <= DD; ++b) s += A.v[a][b] * B.v[a][b];
  return s;
}

// Tangent projection at X: V_Y − Y sym(Yᵀ V_Y); translation unchanged.
// out may alias V.
template <int DD, int RR>
__device__ __forceinline__ void proj(const Blk<DD, RR>& X, const Blk<DD, RR>& V,
                                     Blk<DD, RR>& out) {
  float S[DD][DD];
#pragma unroll
  for (int k = 0; k < DD; ++k)
#pragma unroll
    for (int l = 0; l < DD; ++l) {
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < RR; ++a) s += X.v[a][k] * V.v[a][l];
      S[k][l] = s;
    }
#pragma unroll
  for (int a = 0; a < RR; ++a) {
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

// The slice's P^-1: wk.pv (K3 keeps nothing else), else its place after
// the owner-only vectors and sym(Y^T G).
template <int DD, int RR>
__device__ __forceinline__ float* pinv_region(const Work& wk) {
  return wk.pv ? wk.pv : wk.own + (size_t)(O_NVEC * RR * (DD + 1) + DD * DD) * wk.P;
}

// P^-1 of local pose li from the owner region
template <int DD>
__device__ __forceinline__ void ld_pinv(const float* Pv, int P, int li, float (&Pl)[DD + 1][DD + 1]) {
#pragma unroll
  for (int b = 0; b <= DD; ++b)
#pragma unroll
    for (int c = 0; c <= DD; ++c) Pl[b][c] = Pv[(size_t)(b * (DD + 1) + c) * P + li];
}

// m · proj(X, V · P⁻¹)
template <int DD, int RR>
__device__ __forceinline__ void prec_tangent(const float (&Pl)[DD + 1][DD + 1], float m,
                                             const Blk<DD, RR>& X, const Blk<DD, RR>& V,
                                             Blk<DD, RR>& out) {
  Blk<DD, RR> W;
#pragma unroll
  for (int a = 0; a < RR; ++a)
#pragma unroll
    for (int c = 0; c <= DD; ++c) {
      float acc = V.v[a][0] * Pl[0][c];
#pragma unroll
      for (int b = 1; b <= DD; ++b) acc += V.v[a][b] * Pl[b][c];
      W.v[a][c] = acc;
    }
  proj<DD, RR>(X, W, out);
  scale<DD, RR>(out, m);
}

// Newton–Schulz polar retraction (translation moves Euclidean).
template <int DD, int RR>
__device__ __forceinline__ void retract(const Blk<DD, RR>& X, const Blk<DD, RR>& V,
                                        Blk<DD, RR>& out) {
  float tr = 0.f;
#pragma unroll
  for (int a = 0; a < RR; ++a)
#pragma unroll
    for (int b = 0; b < DD; ++b) {
      const float A = X.v[a][b] + V.v[a][b];
      out.v[a][b] = A;
      tr += A * A;
    }
  const float s = 1.f / sqrtf(fmaxf(tr, 1e-12f));
#pragma unroll
  for (int a = 0; a < RR; ++a)
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
        for (int a = 0; a < RR; ++a) acc += out.v[a][k] * out.v[a][l];
        G3[k][l] = acc;
      }
#pragma unroll
    for (int a = 0; a < RR; ++a) {
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
  for (int a = 0; a < RR; ++a) out.v[a][DD] = X.v[a][DD] + V.v[a][DD];
}

// Sum K per-thread values over the whole cluster; every thread of every
// CTA gets the same bits. Called by all threads of all CTAs (it holds one
// cluster barrier); `par` alternates the halves of `red`.
template <int K>
__device__ __forceinline__ void cluster_sum(float (&v)[K], float* red, int& par) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nc = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  float* half = red + par * (KMAX * RED_SLOT);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float x = v[q];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane < nc) cl.map_shared_rank(half, lane)[q * RED_SLOT + rank * NWARPS + warp] = x;
  }
  cl.sync();
  const int tot = nc * NWARPS;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    float x = 0.f;
    for (int j = lane; j < tot; j += 32) x += half[q * RED_SLOT + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    v[q] = x;
  }
  par ^= 1;
}

// Gathered data of local edge e: R (d×d), t (d), κw, τw.
template <int DD>
__device__ __forceinline__ void ld_edge(const float* edata, int e, float (&Rm)[DD][DD],
                                        float (&tv)[DD], float& kwe, float& twe) {
  float q[EDATA];
  const float4* p = reinterpret_cast<const float4*>(edata + (size_t)e * EDATA);
#pragma unroll
  for (int j = 0; j < EDATA / 4; ++j) {
    const float4 v = p[j];
    q[4 * j] = v.x;
    q[4 * j + 1] = v.y;
    q[4 * j + 2] = v.z;
    q[4 * j + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < DD; ++k) {
#pragma unroll
    for (int b = 0; b < DD; ++b) Rm[k][b] = q[k * DD + b];
    tv[k] = q[DD * DD + k];
  }
  kwe = q[DD * DD + DD];
  twe = q[DD * DD + DD + 1];
}

// egrad(V) at local pose i (value Vi): the sum of its incident edges'
// contributions in pull-row order, each computed here from both endpoints:
// as source (−kr1 Rᵀ − tr2 tᵀ, −tr2), as destination (kr1, tr2), with
// kr1 = 2κw(V_j,Y − V_i,Y R), tr2 = 2τw(t_j − t_i − V_i,Y t). WITH_F adds
// the cost of the edges whose source is i to f.
template <int DD, int RR, bool WITH_F>
__device__ __forceinline__ void pose_egrad(const Win& w, const float* edata, const float* V,
                                           int i, const Blk<DD, RR>& Vi, Blk<DD, RR>& out,
                                           float& f) {
  zero<DD, RR>(out);
  const int pad = 2 * w.ew;
  const int* row = w.pull + (size_t)i * w.D;
  for (int q = 0; q < w.D; ++q) {
    const int id = row[q];
    if (id >= pad) break;  // a row's padding is at its end
    const bool s = id < w.ew;
    const int e = s ? id : id - w.ew;
    Blk<DD, RR> Vj;
    ld_pose<DD, RR>(V, s ? w.ldst[e] : w.lsrc[e], Vj);
    float Rm[DD][DD], tv[DD], kwe, twe;
    ld_edge<DD>(edata, e, Rm, tv, kwe, twe);
#pragma unroll
    for (int a = 0; a < RR; ++a) {
      float A[DD + 1], B[DD + 1];  // the source's and the destination's row a
#pragma unroll
      for (int b = 0; b <= DD; ++b) {
        A[b] = s ? Vi.v[a][b] : Vj.v[a][b];
        B[b] = s ? Vj.v[a][b] : Vi.v[a][b];
      }
      float kr1[DD];
#pragma unroll
      for (int b = 0; b < DD; ++b) {
        float acc = B[b];
#pragma unroll
        for (int k = 0; k < DD; ++k) acc -= A[k] * Rm[k][b];
        if (WITH_F && s) f += kwe * (acc * acc);
        kr1[b] = 2.f * kwe * acc;
      }
      float r2 = B[DD] - A[DD];
#pragma unroll
      for (int k = 0; k < DD; ++k) r2 -= A[k] * tv[k];
      if (WITH_F && s) f += twe * (r2 * r2);
      const float tr2 = 2.f * twe * r2;
      if (s) {
#pragma unroll
        for (int k = 0; k < DD; ++k) {
          float acc = tr2 * tv[k];
#pragma unroll
          for (int b = 0; b < DD; ++b) acc += kr1[b] * Rm[k][b];
          out.v[a][k] += -acc;
        }
        out.v[a][DD] += -tr2;
      } else {
#pragma unroll
        for (int k = 0; k < DD; ++k) out.v[a][k] += kr1[k];
        out.v[a][DD] += tr2;
      }
    }
  }
}

// G = egrad(V) on this CTA's slice (owner region); returns f(V) over the
// window (a cluster reduction). Needs every CTA's V written before the
// call and a cluster barrier between.
template <int DD, int RR>
__device__ __forceinline__ float egrad_cost(const Win& w, const Work& wk, const float* V,
                                            float* G, float* red, int& par) {
  float f[1] = {0.f};
  for (int i = w.lo + (int)threadIdx.x; i < w.hi; i += THREADS) {
    Blk<DD, RR> Vi, Gi;
    ld_pose<DD, RR>(V, i, Vi);
    pose_egrad<DD, RR, true>(w, wk.edata, V, i, Vi, Gi, f[0]);
    st_own<DD, RR>(G, wk.P, i - w.lo, Gi);
  }
  cluster_sum<1>(f, red, par);
  return f[0];
}

// ‖mask · proj(X, G)‖² of this thread's poses
template <int DD, int RR>
__device__ __forceinline__ float masked_rgrad_sq(const Win& w, const Work& wk, const float* X,
                                                 const float* G) {
  float acc = 0.f;
  for (int i = w.lo + (int)threadIdx.x; i < w.hi; i += THREADS) {
    Blk<DD, RR> Xi, Gi;
    ld_pose<DD, RR>(X, i, Xi);
    ld_own<DD, RR>(G, wk.P, i - w.lo, Gi);
    proj<DD, RR>(Xi, Gi, Gi);
    const float m = i < w.nb ? 1.f : 0.f;
    acc += m * m * dot<DD, RR>(Gi, Gi);
  }
  return acc;
}

// Phase 1 of a window solve: this CTA's poses of the world's X (into
// wk.X) and their P⁻¹ (into the owner region), and a cluster-strided
// share of the window's edge data. With `stale` (K3), the separators come
// from that state instead, into wk.Xt as well: RGD steps write block poses
// only, so both buffers must hold them. The caller passes a cluster
// barrier before the solve reads them.
template <int DD, int RR>
__device__ __forceinline__ void gather(const Win& w, const World& g, const Work& wk,
                                       const float* stale = nullptr) {
  constexpr int P2 = (DD + 1) * (DD + 1);
  cg::cluster_group cl = cg::this_cluster();
  float* Pv = pinv_region<DD, RR>(wk);
  for (int i = w.lo + (int)threadIdx.x; i < w.hi; i += THREADS) {
    const int gi = w.poses[i];
    const bool sep = stale != nullptr && i >= w.nb;
    Blk<DD, RR> Xi;
    ld_pose<DD, RR>(sep ? stale : g.X, gi, Xi);
    st_pose<DD, RR>(wk.X, i, Xi);
    if (sep) st_pose<DD, RR>(wk.Xt, i, Xi);
#pragma unroll
    for (int k = 0; k < P2; ++k) Pv[(size_t)k * wk.P + (i - w.lo)] = g.Pinv[(size_t)gi * P2 + k];
  }
  const int stride = (int)cl.num_blocks() * THREADS;
  for (int e = (int)cl.block_rank() * THREADS + (int)threadIdx.x; e < w.ew; e += stride) {
    const size_t ge = (size_t)w.edges[e];
    float q[EDATA];
#pragma unroll
    for (int k = 0; k < EDATA; ++k) q[k] = 0.f;
#pragma unroll
    for (int k = 0; k < DD * DD; ++k) q[k] = g.R[ge * DD * DD + k];
#pragma unroll
    for (int k = 0; k < DD; ++k) q[DD * DD + k] = g.t[ge * DD + k];
    q[DD * DD + DD] = g.kw[ge];
    q[DD * DD + DD + 1] = g.tw[ge];
    float4* p = reinterpret_cast<float4*>(wk.edata + (size_t)e * EDATA);
#pragma unroll
    for (int j = 0; j < EDATA / 4; ++j)
      p[j] = make_float4(q[4 * j], q[4 * j + 1], q[4 * j + 2], q[4 * j + 3]);
  }
}

// One masked RTR solve of the window's block from wk.X (gathered, behind a
// cluster barrier). Every pose of the window is retracted (separators by
// η = 0, as the full-width solve does); on return wk.X holds the iterate
// (X and Xt swap on each accepted step). Called by all threads of all CTAs.
template <int DD, int RR>
__device__ __forceinline__ SolveOut solve(const Win& w, Work& wk, const Params& q, float* red,
                                          int& par) {
  constexpr int C = RR * (DD + 1);
  const int P = wk.P, tid = threadIdx.x;
  float* own = wk.own;
  float* G = own + (size_t)O_G * C * P;
  float* Gt = own + (size_t)O_GT * C * P;
  float* eta = own + (size_t)O_ETA * C * P;
  float* Heta = own + (size_t)O_HETA * C * P;
  float* res = own + (size_t)O_RES * C * P;
  float* z = own + (size_t)O_Z * C * P;
  float* Hd = own + (size_t)O_HD * C * P;
  float* gr = own + (size_t)O_GRAD * C * P;
  float* Ss = own + (size_t)O_NVEC * C * P;
  const float* Pv = Ss + (size_t)DD * DD * P;
  float* X = wk.X;
  float* Xt = wk.Xt;
  float* dl = wk.dl;

  float f = egrad_cost<DD, RR>(w, wk, X, G, red, par);
  const float f0 = f;
  float gn;
  {
    float acc[1] = {masked_rgrad_sq<DD, RR>(w, wk, X, G)};
    cluster_sum<1>(acc, red, par);
    gn = sqrtf(fmaxf(acc[0], 0.f));
  }
  const float gn0 = gn;
  float radius = q.initial_radius;
  int k = 0, ktot = 0;
  bool done = gn0 <= q.gradnorm_tol;

  while (!done && k < q.max_iterations) {
    // ---- truncated CG: g, sym(YᵀG), r0 = g, z0 = prec(r0), δ = −z0 ----
    float s2[2] = {0.f, 0.f};
    for (int i = w.lo + tid; i < w.hi; i += THREADS) {
      const int li = i - w.lo;
      const float m = i < w.nb ? 1.f : 0.f;
      Blk<DD, RR> Xi, g;
      ld_pose<DD, RR>(X, i, Xi);
      {
        Blk<DD, RR> Gi;
        ld_own<DD, RR>(G, P, li, Gi);
#pragma unroll
        for (int kk = 0; kk < DD; ++kk)
#pragma unroll
          for (int l = 0; l < DD; ++l) {
            float skl = 0.f, slk = 0.f;
#pragma unroll
            for (int a = 0; a < RR; ++a) {
              skl += Xi.v[a][kk] * Gi.v[a][l];
              slk += Xi.v[a][l] * Gi.v[a][kk];
            }
            Ss[(size_t)(kk * DD + l) * P + li] = 0.5f * (skl + slk);
          }
        proj<DD, RR>(Xi, Gi, g);
      }
      scale<DD, RR>(g, m);
      st_own<DD, RR>(gr, P, li, g);
      st_own<DD, RR>(res, P, li, g);
      float Pl[DD + 1][DD + 1];
      ld_pinv<DD>(Pv, P, li, Pl);
      Blk<DD, RR> zi;
      prec_tangent<DD, RR>(Pl, m, Xi, g, zi);
      s2[0] += dot<DD, RR>(g, zi);
      s2[1] += dot<DD, RR>(g, g);
      st_own<DD, RR>(z, P, li, zi);
      scale<DD, RR>(zi, -1.f);
      st_pose<DD, RR>(dl, i, zi);
      Blk<DD, RR> z0;
      zero<DD, RR>(z0);
      st_own<DD, RR>(eta, P, li, z0);
      st_own<DD, RR>(Heta, P, li, z0);
    }
    cluster_sum<2>(s2, red, par);  // also publishes δ
    float r_z = s2[0];
    const float r0n = sqrtf(fmaxf(s2[1], EPS));
    const float target = q.tcg_theta == 1.f ? r0n * fminf(q.tcg_kappa, r0n)
                                            : r0n * fminf(q.tcg_kappa, powf(r0n, q.tcg_theta));
    bool tdone = r0n <= 0.f;
    int kt = 0;
    while (!tdone && kt < q.max_tcg) {
      if (kt > 0) cg::this_cluster().sync();  // δ of the last iteration published
      // Hd = mask · proj(X, egrad(δ) − [δ_Y sym(YᵀG_Y), 0])
      float s1[1] = {0.f};
      for (int i = w.lo + tid; i < w.hi; i += THREADS) {
        const int li = i - w.lo;
        Blk<DD, RR> Xi, di, EH;
        ld_pose<DD, RR>(dl, i, di);
        float unused = 0.f;
        pose_egrad<DD, RR, false>(w, wk.edata, dl, i, di, EH, unused);
        ld_pose<DD, RR>(X, i, Xi);
#pragma unroll
        for (int a = 0; a < RR; ++a)
#pragma unroll
          for (int b = 0; b < DD; ++b) {
            float acc = EH.v[a][b];
#pragma unroll
            for (int kk = 0; kk < DD; ++kk) acc -= di.v[a][kk] * Ss[(size_t)(kk * DD + b) * P + li];
            EH.v[a][b] = acc;
          }
        proj<DD, RR>(Xi, EH, EH);
        scale<DD, RR>(EH, i < w.nb ? 1.f : 0.f);
        st_own<DD, RR>(Hd, P, li, EH);
        s1[0] += dot<DD, RR>(di, EH);
      }
      cluster_sum<1>(s1, red, par);
      const float dHd = s1[0];
      const float alpha = r_z / (dHd > 0.f ? dHd : 1.f);

      float s4[4] = {0.f, 0.f, 0.f, 0.f};  // ‖η+αδ‖², ‖η‖², <η,δ>, ‖δ‖²
      for (int i = w.lo + tid; i < w.hi; i += THREADS) {
        Blk<DD, RR> e, di;
        ld_own<DD, RR>(eta, P, i - w.lo, e);
        ld_pose<DD, RR>(dl, i, di);
#pragma unroll
        for (int a = 0; a < RR; ++a)
#pragma unroll
          for (int b = 0; b <= DD; ++b) {
            const float ev = e.v[a][b], dv = di.v[a][b], tr = ev + alpha * dv;
            s4[0] += tr * tr;
            s4[1] += ev * ev;
            s4[2] += ev * dv;
            s4[3] += dv * dv;
          }
      }
      cluster_sum<4>(s4, red, par);
      const bool hit = (dHd <= 0.f) || (s4[0] >= radius * radius);
      const float ee = s4[1], ed = s4[2], dd = fmaxf(s4[3], EPS);
      const float disc = fmaxf(ed * ed + dd * (radius * radius - ee), 0.f);
      const float tau = (-ed + sqrtf(disc)) / dd;
      const float step = hit ? tau : alpha;

      float s2b[2] = {0.f, 0.f};  // ‖r‖², <r,z>
      for (int i = w.lo + tid; i < w.hi; i += THREADS) {
        const int li = i - w.lo;
        Blk<DD, RR> di, hdi, v;
        ld_pose<DD, RR>(dl, i, di);
        ld_own<DD, RR>(Hd, P, li, hdi);
        ld_own<DD, RR>(eta, P, li, v);
#pragma unroll
        for (int a = 0; a < RR; ++a)
#pragma unroll
          for (int b = 0; b <= DD; ++b) v.v[a][b] += step * di.v[a][b];
        st_own<DD, RR>(eta, P, li, v);
        ld_own<DD, RR>(Heta, P, li, v);
#pragma unroll
        for (int a = 0; a < RR; ++a)
#pragma unroll
          for (int b = 0; b <= DD; ++b) v.v[a][b] += step * hdi.v[a][b];
        st_own<DD, RR>(Heta, P, li, v);
        Blk<DD, RR> Xi, rr, zi;
        ld_pose<DD, RR>(X, i, Xi);
        ld_own<DD, RR>(res, P, li, rr);
#pragma unroll
        for (int a = 0; a < RR; ++a)
#pragma unroll
          for (int b = 0; b <= DD; ++b) rr.v[a][b] += alpha * hdi.v[a][b];
        float Pl[DD + 1][DD + 1];
        ld_pinv<DD>(Pv, P, li, Pl);
        prec_tangent<DD, RR>(Pl, i < w.nb ? 1.f : 0.f, Xi, rr, zi);
        s2b[0] += dot<DD, RR>(rr, rr);
        s2b[1] += dot<DD, RR>(rr, zi);
        st_own<DD, RR>(res, P, li, rr);
        st_own<DD, RR>(z, P, li, zi);
      }
      cluster_sum<2>(s2b, red, par);
      const bool conv = sqrtf(fmaxf(s2b[0], 0.f)) <= target;
      const float beta = s2b[1] / fmaxf(r_z, EPS);
      tdone = hit || conv;
      ++kt;
      if (!tdone) {
        r_z = s2b[1];
        for (int i = w.lo + tid; i < w.hi; i += THREADS) {
          Blk<DD, RR> zi, di;
          ld_own<DD, RR>(z, P, i - w.lo, zi);
          ld_pose<DD, RR>(dl, i, di);
#pragma unroll
          for (int a = 0; a < RR; ++a)
#pragma unroll
            for (int b = 0; b <= DD; ++b) di.v[a][b] = -zi.v[a][b] + beta * di.v[a][b];
          st_pose<DD, RR>(dl, i, di);
        }
      }
    }
    ktot += kt;

    // ---- model decrease, retraction, ρ-test ----
    float s3[3] = {0.f, 0.f, 0.f};  // <g,η>, <η,Hη>, ‖η‖²
    for (int i = w.lo + tid; i < w.hi; i += THREADS) {
      const int li = i - w.lo;
      Blk<DD, RR> e, v, Xi, Xn;
      ld_own<DD, RR>(eta, P, li, e);
      ld_own<DD, RR>(gr, P, li, v);
      s3[0] += dot<DD, RR>(v, e);
      ld_own<DD, RR>(Heta, P, li, v);
      s3[1] += dot<DD, RR>(e, v);
      s3[2] += dot<DD, RR>(e, e);
      ld_pose<DD, RR>(X, i, Xi);
      retract<DD, RR>(Xi, e, Xn);
      st_pose<DD, RR>(Xt, i, Xn);
    }
    cluster_sum<3>(s3, red, par);  // also publishes Xt
    const float pred = -(s3[0] + 0.5f * s3[1]);
    const float eta_n = sqrtf(fmaxf(s3[2], 0.f));
    const float f_try = egrad_cost<DD, RR>(w, wk, Xt, Gt, red, par);
    const float rho = (f - f_try) / (fabsf(pred) > EPS ? pred : EPS);
    const bool accept = (rho > 0.1f) && (pred > 0.f);
    if (rho < 0.25f)
      radius = 0.25f * radius;
    else if (rho > 0.75f && eta_n >= 0.99f * radius)
      radius = fminf(2.f * radius, q.max_radius);
    if (accept) {  // uniform: every thread swaps; only owners read X, G next
      f = f_try;
      float* tX = X;
      X = Xt;
      Xt = tX;
      float* tG = G;
      G = Gt;
      Gt = tG;
    }
    float sg[1] = {masked_rgrad_sq<DD, RR>(w, wk, X, G)};
    cluster_sum<1>(sg, red, par);
    gn = sqrtf(fmaxf(sg[0], 0.f));
    ++k;
    done = gn <= q.gradnorm_tol;
  }
  wk.X = X;
  wk.Xt = Xt;
  return SolveOut{f0, f, gn0, gn, k, ktot};
}

// One projected-gradient step of the block from wk.X (gathered, behind a
// cluster barrier): X ← Retr(X, −s · proj(X, proj(X, ∇f) P⁻¹)) on the
// block poses, or without PRECOND X ← Retr(X, −s · proj(X, ∇f)), into
// wk.Xt; then wk.X and wk.Xt swap. Separators are not stepped (the caller
// writes back block poses only). A second step reads the first's block
// poses of other CTAs: the caller puts a cluster barrier between.
template <int DD, int RR, bool PRECOND = true>
__device__ __forceinline__ void rgd_step(const Win& w, Work& wk, float stepsize) {
  const int P = wk.P;
  const float* Pv = pinv_region<DD, RR>(wk);
  for (int i = w.lo + (int)threadIdx.x; i < w.hi && i < w.nb; i += THREADS) {
    const int li = i - w.lo;
    Blk<DD, RR> Xi, g, z, Xn;
    ld_pose<DD, RR>(wk.X, i, Xi);
    float unused = 0.f;
    pose_egrad<DD, RR, false>(w, wk.edata, wk.X, i, Xi, g, unused);
    proj<DD, RR>(Xi, g, g);
    if constexpr (PRECOND) {
      float Pl[DD + 1][DD + 1];
      ld_pinv<DD>(Pv, P, li, Pl);
      prec_tangent<DD, RR>(Pl, 1.f, Xi, g, z);
    } else {
      z = g;
    }
    scale<DD, RR>(z, -stepsize);
    retract<DD, RR>(Xi, z, Xn);
    st_pose<DD, RR>(wk.Xt, i, Xn);
  }
  float* t = wk.X;
  wk.X = wk.Xt;
  wk.Xt = t;
}

// moved of the row's robots (`robots`, `nrow` of them), KMAX at a time:
// the block holds their poses in row order (a robot's block bounds from
// robot_off), and d2[i − w.lo] each of this CTA's block poses' squared
// displacement. Fixed-order cluster reductions; thread 0 of every CTA
// writes moved_out[rb] = sqrt(Σ d2) and upd_out[rb] = 1 where given.
// Called by all threads of all CTAs.
__device__ __forceinline__ void row_moved(const Win& w, const float* d2, const int* robots,
                                          int nrow, const int* robot_off, float* red, int& par,
                                          float* moved_out, float* upd_out) {
  int lb = 0;
  for (int jc = 0; jc < nrow; jc += KMAX) {
    float mv[KMAX];
    int lo[KMAX], hi[KMAX];
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      mv[q] = 0.f;
      lo[q] = hi[q] = lb;
      if (jc + q < nrow) {
        const int rb = robots[jc + q];
        hi[q] = lb + (robot_off[rb + 1] - robot_off[rb]);
        lb = hi[q];
      }
    }
    for (int i = w.lo + (int)threadIdx.x; i < w.hi && i < w.nb; i += THREADS) {
      const float v = d2[i - w.lo];
#pragma unroll
      for (int q = 0; q < KMAX; ++q)
        if (i >= lo[q] && i < hi[q]) mv[q] += v;
    }
    cluster_sum<KMAX>(mv, red, par);
    if (threadIdx.x == 0 && moved_out != nullptr)
      for (int q = 0; q < KMAX && jc + q < nrow; ++q) {
        const int rb = robots[jc + q];
        moved_out[rb] = sqrtf(mv[q]);
        upd_out[rb] = 1.f;
      }
  }
}

// Whether global pose p lies in one of the row robots' blocks.
__device__ __forceinline__ bool in_rows(int p, const int* robots, int nrow,
                                        const int* robot_off) {
  for (int j = 0; j < nrow; ++j) {
    const int rb = robots[j];
    if (p >= robot_off[rb] && p < robot_off[rb + 1]) return true;
  }
  return false;
}

// This thread's share of the cost, at the world's X, of the world's edges
// with no endpoint in the row robots' blocks (edges strided over the
// cluster's threads in global order): the part of the world's cost a
// window solve does not see and does not move. The caller reduces it.
template <int DD, int RR>
__device__ __forceinline__ float outside_cost(const World& g, const int64_t* src,
                                              const int64_t* dst, int E, const int* robots,
                                              int nrow, const int* robot_off) {
  cg::cluster_group cl = cg::this_cluster();
  const int stride = (int)cl.num_blocks() * THREADS;
  float f = 0.f;
  for (int e = (int)cl.block_rank() * THREADS + (int)threadIdx.x; e < E; e += stride) {
    const int s = (int)src[e], t = (int)dst[e];
    if (in_rows(s, robots, nrow, robot_off) || in_rows(t, robots, nrow, robot_off)) continue;
    Blk<DD, RR> A, B;
    ld_pose<DD, RR>(g.X, s, A);
    ld_pose<DD, RR>(g.X, t, B);
    const float* Rm = g.R + (size_t)e * DD * DD;
    const float* tv = g.t + (size_t)e * DD;
    const float kwe = g.kw[e], twe = g.tw[e];
#pragma unroll
    for (int a = 0; a < RR; ++a) {
#pragma unroll
      for (int b = 0; b < DD; ++b) {
        float acc = B.v[a][b];
#pragma unroll
        for (int k = 0; k < DD; ++k) acc -= A.v[a][k] * Rm[k * DD + b];
        f += kwe * (acc * acc);
      }
      float r2 = B.v[a][DD] - A.v[a][DD];
#pragma unroll
      for (int k = 0; k < DD; ++k) r2 -= A.v[a][k] * tv[k];
      f += twe * (r2 * r2);
    }
  }
  return f;
}

// Floats of workspace one launch needs for windows of at most nw poses
// and ew edges, nc CTAs with slices of at most P poses, owner regions in
// shared memory or (own_global) in the workspace.
inline long long cluster_workspace_floats(int d, int r, int nw, int ew, int nc, int P,
                                          bool own_global) {
  const long long C = (long long)r * (d + 1);
  return (long long)ew * EDATA + 3LL * nw * C + (own_global ? nc * own_floats(d, r, P) : 0);
}

// Whether the owner regions fit in shared memory.
inline bool own_in_smem(int d, int r, int P) { return 4LL * own_floats(d, r, P) <= SMEM_DYN_MAX; }

__host__ __device__ inline Work bind_work(float* w, int d, int r, int nw, int ew, int P) {
  const size_t C = (size_t)r * (d + 1);
  Work k;
  k.edata = w;
  w += (size_t)ew * EDATA;
  k.X = w;
  w += (size_t)nw * C;
  k.Xt = w;
  w += (size_t)nw * C;
  k.dl = w;
  w += (size_t)nw * C;
  k.own = w;  // the owner regions' base when they live in the workspace
  k.P = P;
  k.pv = nullptr;
  return k;
}

// Launch `kern` as `clusters` independent clusters of nc CTAs each
// (cudaLaunchKernelEx with a cluster dimension; CTA b is rank b mod nc of
// cluster b / nc), dynamic shared memory smem; returns a cudaError_t, or
// -1 when no cluster of that shape fits on the card (never a smaller
// launch in its place). Clusters that do not fit at once run in waves.
template <class A>
int launch_cluster(void (*kern)(A), const A& args, int nc, size_t smem, cudaStream_t s,
                   int clusters = 1) {
  cudaError_t e;
  if (nc < 2 || nc > CLUSTER_MAX || clusters < 1) return (int)cudaErrorInvalidValue;
  if (nc > 8) {
    e = cudaFuncSetAttribute((const void*)kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaFuncSetAttribute((const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * clusters, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = nc;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, (const void*)kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return -1;
  e = cudaLaunchKernelEx(&cfg, kern, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Instantiate F<DD, RR> for d in {2, 3} and r in 1..8; returns F's value.
#define DPGO_DISPATCH_DR(d, r, F, ...)                                     \
  ([&]() -> int {                                                          \
    switch ((d) * 16 + (r)) {                                              \
      case 33: return F<2, 1>(__VA_ARGS__);                                \
      case 34: return F<2, 2>(__VA_ARGS__);                                \
      case 35: return F<2, 3>(__VA_ARGS__);                                \
      case 36: return F<2, 4>(__VA_ARGS__);                                \
      case 37: return F<2, 5>(__VA_ARGS__);                                \
      case 38: return F<2, 6>(__VA_ARGS__);                                \
      case 39: return F<2, 7>(__VA_ARGS__);                                \
      case 40: return F<2, 8>(__VA_ARGS__);                                \
      case 49: return F<3, 1>(__VA_ARGS__);                                \
      case 50: return F<3, 2>(__VA_ARGS__);                                \
      case 51: return F<3, 3>(__VA_ARGS__);                                \
      case 52: return F<3, 4>(__VA_ARGS__);                                \
      case 53: return F<3, 5>(__VA_ARGS__);                                \
      case 54: return F<3, 6>(__VA_ARGS__);                                \
      case 55: return F<3, 7>(__VA_ARGS__);                                \
      case 56: return F<3, 8>(__VA_ARGS__);                                \
      default: return (int)cudaErrorInvalidValue;                         \
    }                                                                      \
  }())
