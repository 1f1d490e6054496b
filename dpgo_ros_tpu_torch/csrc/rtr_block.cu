// K1: one masked Riemannian trust-region (RTR + Steihaug tCG) block solve
// of the lifted pose-graph problem, as ONE launch of a thread-block cluster
// on an NVIDIA Hopper GPU, on the window of the mask's block.
//
// Replaces: dpgo_ros_tpu/ops/fused_rtr.py::_make_rtr_kernel (the Pallas
// kernel launched by rtr_solve_fused). The TPU kernel walks the whole world
// under a mask. Here the mask is a 0/1 block that is a union of robots'
// blocks (a robot, a Parallel colour class, all robots), and the launch
// solves that block's window (its poses, the edges that touch it, their far
// endpoints as separators; dpgo_ros_tpu_torch/ops/hbm_rtr.py builds the
// tables, prepare_row_windows or prepare_mask_window) with the cluster
// solve of rtr_cluster.cuh, which K2 and K4 share:
//   1. gather this CTA's poses of X and P^-1 and a share of the window's
//      edge data; beside it, a cluster-strided pass over the world's edges
//      sums the cost of those with no endpoint in the block (the part of
//      the world's cost the solve neither sees nor moves), reduced in a
//      fixed order; its barrier publishes the gather;
//   2. the masked RTR solve on the window, mask 1 on the block, 0 on the
//      separators;
//   3. write the block's poses into X_out (a copy of X the wrapper made, so
//      every other pose stays bit-identical) and reduce each row robot's
//      displacement, KMAX robots per cluster reduction.
// Stats: [f0, f, gn0, gn, TR iterations, tCG iterations, moved_0..R-1,
// updated_0..R-1] with f0 and f the WORLD's cost (the window's plus the
// outside edges'), moved_k the robot's block displacement and updated_k 1
// for the row's robots, 0 for the others. Sums run in a fixed order, so a
// repeated launch gives the same bits.
//
// What bounds it: the latency of the solve's dependent passes and
// reductions (rtr_cluster.cuh). Until this design K1 was one 256-thread
// CTA on one SM walking the whole world under the mask, ~11 __syncthreads()
// per tCG iteration: 10.9 ms per sphere2500 robot solve on the H100.
// Plain version: dpgo_ros_tpu_torch/ops/fused_rtr.py::rtr_solve_fused_ref
// (full-width under the mask; the same function).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include "rtr_cluster.cuh"

namespace {

struct BlockArgs {
  World g;
  Win w;            // lo/hi set per CTA from part
  const int* part;  // (nc + 1,) slice bounds of the window's local poses
  Work wk;
  float* own_global;  // owner regions when they do not fit in shared memory
  long long own_stride;
  int own_smem;
  const int64_t* src;  // (E,) the world's edges, for the cost outside the window
  const int64_t* dst;
  int E;
  const int* robot_off;   // (R + 1,) robot block bounds
  const int* row_robots;  // (nrow,) the robots whose blocks make the block, ascending
  int nrow, R;
  float* X_out;  // (n, r, d+1): a copy of X; the block is written
  float* stats;  // (6 + 2R,)
  Params q;
};

template <int DD, int RR>
__global__ void __launch_bounds__(THREADS, 1) rtr_block_kernel(BlockArgs a) {
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

  // ---- 1. gather; the world's cost outside the window ----
  gather<DD, RR>(w, a.g, wk);
  float out[1] = {outside_cost<DD, RR>(a.g, a.src, a.dst, a.E, a.row_robots, a.nrow,
                                       a.robot_off)};
  cluster_sum<1>(out, red, par);  // also publishes the gather

  // ---- 2. the block solve on the window ----
  const SolveOut s = solve<DD, RR>(w, wk, a.q, red, par);

  // ---- 3. the block into X_out; each robot's displacement ----
  float* d2 = wk.own;  // the owner region's first vector, free after the solve
  for (int i = w.lo + tid; i < w.hi && i < w.nb; i += THREADS) {
    const int gi = w.poses[i];
    Blk<DD, RR> v, x0;
    ld_pose<DD, RR>(wk.X, i, v);
    ld_pose<DD, RR>(a.g.X, gi, x0);
    st_pose<DD, RR>(a.X_out, gi, v);
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int b = 0; b <= DD; ++b) {
        const float dv = v.v[r][b] - x0.v[r][b];
        acc += dv * dv;
      }
    d2[i - w.lo] = acc;
  }
  if (rank == 0)
    for (int j = tid; j < 2 * a.R; j += THREADS) a.stats[6 + j] = 0.f;
  // the robots outside the row stay 0; row_moved's barriers order these
  // stores before its own
  row_moved(w, d2, a.row_robots, a.nrow, a.robot_off, red, par,
            rank == 0 ? a.stats + 6 : nullptr, a.stats + 6 + a.R);
  if (rank == 0 && tid == 0) {
    a.stats[0] = s.f0 + out[0];
    a.stats[1] = s.f + out[0];
    a.stats[2] = s.gn0;
    a.stats[3] = s.gn;
    a.stats[4] = (float)s.k;
    a.stats[5] = (float)s.ktot;
  }
}

template <int DD, int RR>
int launch_block(BlockArgs a, int nc, cudaStream_t s) {
  const size_t smem = a.own_smem ? (size_t)(4 * own_floats(DD, RR, a.wk.P)) : 0;
  return launch_cluster(rtr_block_kernel<DD, RR>, a, nc, smem, s);
}

}  // namespace

extern "C" {

// Floats of workspace one block solve needs, for windows of at most `nw`
// poses and `ew` edges on `nc` CTAs with slices of at most `P` poses.
long long dpgo_rtr_block_workspace_floats(int d, int r, int nw, int ew, int nc, int P) {
  return cluster_workspace_floats(d, r, nw, ew, nc, P, !own_in_smem(d, r, P));
}

// Launches one block solve on the window as a cluster of `nc` CTAs on
// `stream`; returns a cudaError_t, or -1 when no such cluster fits.
int dpgo_rtr_block_solve(int d, int r, int nw, int ew, int nb, int D, int nc, int P, int E,
                         int nrow, int num_robots, const float* X, const float* Pinv,
                         const float* R, const float* t, const float* kw, const float* tw,
                         const int64_t* src, const int64_t* dst, const int* poses,
                         const int* edges, const int* lsrc, const int* ldst, const int* lpull,
                         const int* part, const int* robot_off, const int* row_robots,
                         float* X_out, float* stats, float* work, int max_iterations,
                         int max_tcg, float gradnorm_tol, float initial_radius,
                         float max_radius, float tcg_kappa, float tcg_theta, void* stream) {
  if (r < 1 || r > 8 || nw < 1 || nb < 1 || nb > nw || ew < 1 || (d != 2 && d != 3) || P < 1 ||
      E < ew || nrow < 1 || nrow > num_robots)
    return (int)cudaErrorInvalidValue;
  BlockArgs a;
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
  a.src = src;
  a.dst = dst;
  a.E = E;
  a.robot_off = robot_off;
  a.row_robots = row_robots;
  a.nrow = nrow;
  a.R = num_robots;
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
  return DPGO_DISPATCH_DR(d, r, launch_block, a, nc, s);
}

}  // extern "C"
