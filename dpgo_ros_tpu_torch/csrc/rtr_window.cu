// K4: one masked RTR + tCG block solve of ONE robot's block on a window
// gathered out of the whole world's state, as ONE kernel launch on an
// NVIDIA Hopper GPU.
//
// Replaces: dpgo_ros_tpu/ops/hbm_rtr.py::_make_hbm_kernel (the Pallas
// kernel launched by rtr_solve_hbm), the JAX package's large-world block
// solve; here it takes every RoundRobin block solve, at any size. What it
// computes is K1's solve restricted to what the block needs: the block's
// poses, the edges with at least one endpoint in the block (in global edge
// order) and the poses at their far ends (the separators, mask 0). Its
// cost per tCG iteration therefore follows the block, not the world: at
// 50,000 poses and 16 robots a window holds <= 3,573 poses and 6,475
// edges against the world's 50,000 and 99,775, which a full-width K1 solve
// walks in every pass.
//
// The TPU kernel's layout (a contiguous 256-aligned lane window with a
// halo, 8-row DMA padding, chain/diagonal edge classes, banded graphs
// only) routed around Mosaic. Here the window is a gather through host-
// built tables (dpgo_ros_tpu_torch/ops/hbm_rtr.py::prepare_windows): any
// graph, banded or not. The tables hold structure only; R, t, kappa*w and
// tau*w are read through the global edge ids at every launch, so a GNC
// weight round needs no rebuild.
//
// Three phases in one 256-thread block (K1's design; the solve, what
// bounds it and the reductions are in rtr_common.cuh):
//   1. gather the window's X, the block's P^-1 and the incident edges'
//      data into the workspace (sized by the largest window, never by n);
//      the local pull index lists each block pose's contributions in the
//      same order as its global row, so the gather-sums add in K1's order;
//   2. rtr_solve_block<DD> on the window, mask 1 on the block, 0 on the
//      separators (unchanged device code, shared with K1-K3);
//   3. write the block's poses into X_out (a copy of X the wrapper made:
//      separators and every other pose stay bit-identical, as the TPU
//      kernel restores its halo lanes) and the block displacement.
// Latency on one SM bounds it, as K1; spreading it over all SMs is later
// work. Stats: [f0, f, gn0, gn, TR iterations, tCG iterations, moved],
// with f the window's LOCAL cost (edges incident to the block only).
// Plain version: dpgo_ros_tpu_torch/ops/hbm_rtr.py::rtr_solve_hbm_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include "rtr_common.cuh"

namespace {

// The window of one robot: device tables of prepare_windows, sliced to the
// robot by the wrapper, and the global operands they index.
struct Window {
  int nb;            // block poses: local 0 .. nb-1; separators follow
  const float* X;    // (n, r, d+1) global state
  const float* Pinv;  // (n, d+1, d+1)
  const float* R;    // (E, d, d) global edges
  const float* t;    // (E, d)
  const float* kw;   // (E,) effective weights
  const float* tw;
  const int* poses;  // (nw,) global pose id of each local pose
  const int* edges;  // (ew,) global edge id of each local edge
  const int* lsrc;   // (ew,) local endpoints
  const int* ldst;
  float* X_out;      // (n, r, d+1): a copy of X; the block is written
};

template <int DD>
__global__ void __launch_bounds__(THREADS) rtr_window_kernel(Window w, Problem p, Params q) {
  __shared__ float sh[KMAX * NWARPS + KMAX];
  const int C = p.r * (DD + 1), tid = threadIdx.x;
  constexpr int P2 = (DD + 1) * (DD + 1);

  // ---- 1. gather the window ----
  float* X0 = const_cast<float*>(p.X0);
  float* mask = const_cast<float*>(p.mask);
  float* Pinv = const_cast<float*>(p.Pinv);
  for (int i = tid; i < p.n; i += THREADS) {
    const size_t g = (size_t)w.poses[i];
    for (int c = 0; c < C; ++c) X0[(size_t)i * C + c] = w.X[g * C + c];
    for (int c = 0; c < P2; ++c) Pinv[(size_t)i * P2 + c] = w.Pinv[g * P2 + c];
    mask[i] = i < w.nb ? 1.f : 0.f;
  }
  int64_t* src = const_cast<int64_t*>(p.src);
  int64_t* dst = const_cast<int64_t*>(p.dst);
  float* R = const_cast<float*>(p.R);
  float* t = const_cast<float*>(p.t);
  float* kw = const_cast<float*>(p.kw);
  float* tw = const_cast<float*>(p.tw);
  for (int e = tid; e < p.E; e += THREADS) {
    const size_t g = (size_t)w.edges[e];
    src[e] = w.lsrc[e];
    dst[e] = w.ldst[e];
    for (int c = 0; c < DD * DD; ++c) R[(size_t)e * DD * DD + c] = w.R[g * DD * DD + c];
    for (int c = 0; c < DD; ++c) t[(size_t)e * DD + c] = w.t[g * DD + c];
    kw[e] = w.kw[g];
    tw[e] = w.tw[g];
  }
  __syncthreads();

  // ---- 2. the block solve on the window ----
  const SolveOut s = rtr_solve_block<DD>(p, q, sh);
  __syncthreads();

  // ---- 3. write the block back; its displacement ----
  float mv[1] = {0.f};
  for (int i = tid; i < w.nb; i += THREADS) {
    const size_t g = (size_t)w.poses[i];
    for (int c = 0; c < C; ++c) {
      const float v = p.X[(size_t)i * C + c];
      const float dv = v - p.X0[(size_t)i * C + c];
      w.X_out[g * C + c] = v;
      mv[0] += dv * dv;
    }
  }
  block_sum<1>(mv, sh);
  if (tid == 0) {
    p.stats[0] = s.f0;
    p.stats[1] = s.f;
    p.stats[2] = s.gn0;
    p.stats[3] = s.gn;
    p.stats[4] = (float)s.k;
    p.stats[5] = (float)s.ktot;
    p.stats[6] = sqrtf(mv[0]);
  }
}

// Window operands carved from the workspace after the solve's own share;
// the int64 endpoints first, so they stay 8-byte aligned.
inline long long window_floats(int d, int r, int nw, int ew) {
  const long long C = (long long)r * (d + 1);
  return 4LL * ew + 2LL * nw * C + nw + (long long)nw * (d + 1) * (d + 1) +
         (long long)ew * (d * d + d + 2);
}

}  // namespace

extern "C" {

// Floats of workspace one window solve needs, for a window of at most
// `nw` poses and `ew` edges.
long long dpgo_rtr_window_workspace_floats(int d, int r, int nw, int ew) {
  return window_floats(d, r, nw, ew) + solve_workspace_floats(d, r, nw, ew);
}

// Launches one window solve on `stream`; returns cudaGetLastError().
int dpgo_rtr_window_solve(int d, int r, int nw, int ew, int nb, int D, const float* X,
                          const float* Pinv, const float* R, const float* t, const float* kw,
                          const float* tw, const int* poses, const int* edges, const int* lsrc,
                          const int* ldst, const int* lpull, float* X_out, float* stats,
                          float* work, int max_iterations, int max_tcg, float gradnorm_tol,
                          float initial_radius, float max_radius, float tcg_kappa,
                          float tcg_theta, void* stream) {
  if (r < 1 || r > RMAX || nw < 1 || nb < 1 || nb > nw || ew < 1 || (d != 2 && d != 3))
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)r * (d + 1);
  Window w;
  w.nb = nb;
  w.X = X;
  w.Pinv = Pinv;
  w.R = R;
  w.t = t;
  w.kw = kw;
  w.tw = tw;
  w.poses = poses;
  w.edges = edges;
  w.lsrc = lsrc;
  w.ldst = ldst;
  w.X_out = X_out;
  Problem p;
  p.n = nw;
  p.E = ew;
  p.D = D;
  p.r = r;
  p.num_robots = 1;
  p.robot_off = nullptr;
  p.pull = lpull;
  p.stats = stats;
  int64_t* iw = reinterpret_cast<int64_t*>(work);
  p.src = iw;
  p.dst = iw + ew;
  float* fw = work + 4LL * ew;
  p.X0 = fw;
  fw += nw * C;
  p.X = fw;
  fw += nw * C;
  p.mask = fw;
  fw += nw;
  p.Pinv = fw;
  fw += (long long)nw * (d + 1) * (d + 1);
  p.R = fw;
  fw += (long long)ew * d * d;
  p.t = fw;
  fw += (long long)ew * d;
  p.kw = fw;
  fw += ew;
  p.tw = fw;
  fw += ew;
  bind_solve_workspace(p, fw, d);
  Params q;
  q.max_iterations = max_iterations;
  q.max_tcg = max_tcg;
  q.gradnorm_tol = gradnorm_tol;
  q.initial_radius = initial_radius;
  q.max_radius = max_radius;
  q.tcg_kappa = tcg_kappa;
  q.tcg_theta = tcg_theta;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 3)
    rtr_window_kernel<3><<<1, THREADS, 0, s>>>(w, p, q);
  else
    rtr_window_kernel<2><<<1, THREADS, 0, s>>>(w, p, q);
  return (int)cudaGetLastError();
}

}  // extern "C"
