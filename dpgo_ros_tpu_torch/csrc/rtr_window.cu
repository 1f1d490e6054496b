// K4: one masked RTR + tCG block solve of ONE robot's block on a window
// gathered out of the whole world's state, as ONE launch of a thread-block
// cluster on an NVIDIA Hopper GPU.
//
// Replaces: dpgo_ros_tpu/ops/hbm_rtr.py::_make_hbm_kernel (the Pallas
// kernel launched by rtr_solve_hbm), the JAX package's large-world block
// solve; here it takes every RoundRobin and Uniform block solve, at any
// size. What it computes is the full-width solve restricted to what the
// block needs: the block's poses, the edges with at least one endpoint in
// the block (in global edge order) and the poses at their far ends (the
// separators, mask 0). At 50,000 poses and 16 robots a window holds <=
// 3,573 poses and 6,475 edges against the world's 50,000 and 99,775.
//
// The TPU kernel's layout (a contiguous 256-aligned lane window with a
// halo, 8-row DMA padding, banded graphs only) routed around Mosaic. Here
// the window is a gather through host-built tables
// (dpgo_ros_tpu_torch/ops/hbm_rtr.py::prepare_windows): any graph. The
// tables hold structure only; R, t, kappa*w and tau*w are read through the
// global edge ids at every launch, so a GNC weight round needs no rebuild.
//
// What bounds it: latency, not bytes or flops (rtr_cluster.cuh says why).
// Until this design it ran on one 256-thread block on one SM, ~0.19 us per
// window pose per tCG iteration. Now one launch is a cluster of up to 16
// CTAs (about one window pose per thread), each owning a work-balanced
// slice of the window, with the shared solve of rtr_cluster.cuh:
//   1. gather this CTA's poses of X and P^-1 and a share of the edges'
//      data, then one cluster barrier;
//   2. the masked RTR solve on the window, mask 1 on the block, 0 on the
//      separators;
//   3. write the block's poses into X_out (a copy of X the wrapper made:
//      separators and every other pose stay bit-identical, as the TPU
//      kernel restores its halo lanes) and reduce the block displacement.
// Stats: [f0, f, gn0, gn, TR iterations, tCG iterations, moved], with f
// the window's LOCAL cost (edges incident to the block only). The sums
// run in a fixed order, so a repeated launch gives the same bits.
// Plain version: dpgo_ros_tpu_torch/ops/hbm_rtr.py::rtr_solve_hbm_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include "rtr_cluster.cuh"

namespace {

struct WindowArgs {
  World g;
  Win w;         // lo/hi set per CTA from part
  const int* part;  // (nc + 1,) slice bounds of the window's local poses
  Work wk;
  float* own_global;  // owner regions when they do not fit in shared memory
  long long own_stride;
  int own_smem;
  float* X_out;  // (n, r, d+1): a copy of X; the block is written
  float* stats;  // (7,)
  Params q;
};

template <int DD, int RR>
__global__ void __launch_bounds__(THREADS, 1) rtr_window_kernel(WindowArgs a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ float red[RED_FLOATS];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), tid = threadIdx.x;
  Win w = a.w;
  w.lo = a.part[rank];
  w.hi = a.part[rank + 1];
  Work wk = a.wk;
  wk.own = a.own_smem ? dyn : a.own_global + rank * a.own_stride;
  int par = 0;

  // ---- 1. gather ----
  gather<DD, RR>(w, a.g, wk);
  cl.sync();

  // ---- 2. the block solve on the window ----
  const SolveOut s = solve<DD, RR>(w, wk, a.q, red, par);

  // ---- 3. write the block back; its displacement ----
  float mv[1] = {0.f};
  for (int i = w.lo + tid; i < w.hi && i < w.nb; i += THREADS) {
    const size_t gi = (size_t)w.poses[i];
    Blk<DD, RR> v, x0;
    ld_pose<DD, RR>(wk.X, i, v);
    ld_pose<DD, RR>(a.g.X, (int)gi, x0);
    st_pose<DD, RR>(a.X_out, (int)gi, v);
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int b = 0; b <= DD; ++b) {
        const float dv = v.v[r][b] - x0.v[r][b];
        mv[0] += dv * dv;
      }
  }
  cluster_sum<1>(mv, red, par);  // the last access to another CTA's memory
  if (rank == 0 && tid == 0) {
    a.stats[0] = s.f0;
    a.stats[1] = s.f;
    a.stats[2] = s.gn0;
    a.stats[3] = s.gn;
    a.stats[4] = (float)s.k;
    a.stats[5] = (float)s.ktot;
    a.stats[6] = sqrtf(mv[0]);
  }
}

template <int DD, int RR>
int launch_window(WindowArgs a, int nc, cudaStream_t s) {
  const size_t smem = a.own_smem ? (size_t)(4 * own_floats(DD, RR, a.wk.P)) : 0;
  return launch_cluster(rtr_window_kernel<DD, RR>, a, nc, smem, s);
}

}  // namespace

extern "C" {

// Floats of workspace one window solve needs, for windows of at most `nw`
// poses and `ew` edges on `nc` CTAs with slices of at most `P` poses.
long long dpgo_rtr_window_workspace_floats(int d, int r, int nw, int ew, int nc, int P) {
  return cluster_workspace_floats(d, r, nw, ew, nc, P, !own_in_smem(d, r, P));
}

// Dynamic shared memory of each CTA for slices of at most `P` poses: the
// owner-only vectors where they fit, else 0 (they live in the workspace).
long long dpgo_rtr_window_smem_bytes(int d, int r, int P) {
  return own_in_smem(d, r, P) ? 4 * own_floats(d, r, P) : 0;
}

// Launches one window solve as a cluster of `nc` CTAs on `stream`; returns
// a cudaError_t, or -1 when no such cluster fits on the card.
int dpgo_rtr_window_solve(int d, int r, int nw, int ew, int nb, int D, int nc, int P,
                          const float* X, const float* Pinv, const float* R, const float* t,
                          const float* kw, const float* tw, const int* poses, const int* edges,
                          const int* lsrc, const int* ldst, const int* lpull, const int* part,
                          float* X_out, float* stats, float* work, int max_iterations,
                          int max_tcg, float gradnorm_tol, float initial_radius,
                          float max_radius, float tcg_kappa, float tcg_theta, void* stream) {
  if (r < 1 || r > 8 || nw < 1 || nb < 1 || nb > nw || ew < 1 || (d != 2 && d != 3) || P < 1)
    return (int)cudaErrorInvalidValue;
  WindowArgs a;
  a.g.X = const_cast<float*>(X);
  a.g.Pinv = Pinv;
  a.g.R = R;
  a.g.t = t;
  a.g.kw = kw;
  a.g.tw = tw;
  a.w.nw = nw;
  a.w.ew = ew;
  a.w.nb = nb;
  a.w.D = D;
  a.w.poses = poses;
  a.w.edges = edges;
  a.w.lsrc = lsrc;
  a.w.ldst = ldst;
  a.w.pull = lpull;
  a.w.lo = a.w.hi = 0;
  a.part = part;
  a.wk = bind_work(work, d, r, nw, ew, P);
  a.own_smem = own_in_smem(d, r, P) ? 1 : 0;
  a.own_global = a.wk.own;
  a.own_stride = own_floats(d, r, P);
  a.X_out = X_out;
  a.stats = stats;
  a.q.max_iterations = max_iterations;
  a.q.max_tcg = max_tcg;
  a.q.gradnorm_tol = gradnorm_tol;
  a.q.initial_radius = initial_radius;
  a.q.max_radius = max_radius;
  a.q.tcg_kappa = tcg_kappa;
  a.q.tcg_theta = tcg_theta;
  cudaStream_t s = (cudaStream_t)stream;
  return DPGO_DISPATCH_DR(d, r, launch_window, a, nc, s);
}

}  // extern "C"
