// K2: many RBCD solver steps in ONE launch of a persistent thread-block
// cluster on an NVIDIA Hopper GPU, each step on its bank row's window.
//
// Replaces: dpgo_ros_tpu/ops/fused_rtr.py::_make_rtr_multistep_kernel (the
// Pallas kernel launched by rtr_run_fused). Plain version (full-width, the
// same function): dpgo_ros_tpu_torch/ops/fused_rtr.py::rtr_run_fused_ref.
//
// Step `it` solves bank row sched[it] (one robot for RoundRobin and
// Uniform, a colour class for Parallel) on that row's window (the row's
// block, the edges touching it and their far endpoints; tables from
// dpgo_ros_tpu_torch/ops/hbm_rtr.py::prepare_row_windows): one masked RTR
// solve, or, when rgd_stepsize > 0, one preconditioned Riemannian-gradient
// step and its retraction (rtr_cluster.cuh), which keeps the carried cost
// unless rgd_cost is set (as the Pallas kernel does; the engine's one-step
// RGD launches set it, for two more cost passes over the window). The window is gathered from
// the current X at every step. Only the block's poses are written back,
// in place, so every other pose stays bit-exact. Each row robot's
// displacement `moved` reduces over its block poses; `updated` is 1 for
// the row's robots and 0 for the others; the neighbours' relative change
// is bumped through the robot adjacency, rel = updated ? moved : max(rel,
// (moved·updated) @ adj), and the history row of the absolute iteration
// is written. The carried cost moves by the window's f − f0 (the global
// cost moves by exactly that, since only block poses move). After each
// step, at it2 = it + 1, the run stops on termination (max rel < tol and
// no GNC round pending), at it_cap, or when a GNC weight round must fire
// (pending and use_inner_tol ? max rel < inner_tol or it2 − last_wu ≥
// inner : it2 % inner == 0). An input that has already terminated runs
// zero steps.
//
// What bounds it: the solves' latency (rtr_cluster.cuh). Until this design
// one 256-thread block solved every step full-width under a mask (all n
// poses, every edge) and copied all n poses twice per step; at 2,500 poses
// a windowed solve took 2.8 ms against 10.8 ms full-width on the card.
// Now the cluster (sized for the largest window) solves each step on its
// window, the per-robot reductions cover the block only, and the step-loop
// logic (rel change, bump, stop tests) runs in warp 0 of every CTA on the
// same reduced values, so every CTA takes the same branch without a
// broadcast; only CTA 0 writes the outputs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include "rtr_cluster.cuh"

namespace {

struct RunArgs {
  World g;           // g.X: the state, updated in place (block poses)
  int D;             // pull width of every window
  const int* meta;   // (m+1, 4) per row: pose_off, edge_off, block size, row_off
  const int* poses;  // window tables (CSR by meta)
  const int* edges;
  const int* lsrc;
  const int* ldst;
  const int* pull;
  const int* part;        // (m, nc+1) slice bounds
  const int* row_robots;  // robots of each row (CSR by meta's row_off)
  const int* robot_off;   // (R+1,) global block bounds
  Work wk;
  float* own_global;
  long long own_stride;
  int own_smem;
  const int* sched;    // (it_cap,) bank row of each absolute iteration
  const float* adj;    // (R, R) robot adjacency
  const float* rel0;   // (R,) incoming relative change
  const float* cost0;  // (1,) cost of X
  float* rel;          // (R,) out
  float* stats;        // (4,) cost, iteration, steps, tCG iterations
  float* rel_hist;     // (it_cap, R) or null
  float* relw;         // (nc, 3R): each CTA's rel, moved, updated
  int R, it0, last_wu, gnc_pending, gnc, inner, use_inner_tol, it_cap;
  float inner_tol, tol, rgd_stepsize;
  int rgd_cost;  // RGD steps move the carried cost by the window's f − f0
  Params q;
};

// Largest of v[0..R), by warp 0 in a fixed order, broadcast through this
// CTA's shared memory. Called by all threads of the CTA.
__device__ __forceinline__ float max_rel(const float* v, int R, float* bcast) {
  if (threadIdx.x < 32) {
    float x = -FLT_MAX;
    for (int j = threadIdx.x; j < R; j += 32) x = fmaxf(x, v[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (threadIdx.x == 0) *bcast = x;
  }
  __syncthreads();
  const float out = *bcast;
  __syncthreads();  // bcast is reused
  return out;
}

template <int DD, int RR>
__global__ void __launch_bounds__(THREADS, 1) rtr_run_kernel(RunArgs a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ float red[RED_FLOATS];
  __shared__ float bcast;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), nc = (int)cl.num_blocks(), tid = threadIdx.x;
  const int R = a.R;
  float* own = a.own_smem ? dyn : a.own_global + rank * a.own_stride;
  float* rel = a.relw + (size_t)rank * 3 * R;
  float* moved = rel + R;
  float* upd = moved + R;
  int par = 0;

  if (tid < 32)
    for (int j = tid; j < R; j += 32) rel[j] = a.rel0[j];
  __syncthreads();

  float cost = a.cost0[0];
  int it = a.it0, tcg = 0;
  bool stop = max_rel(rel, R, &bcast) < a.tol && !(a.gnc && a.gnc_pending);
  while (!stop && it < a.it_cap) {
    const int row = a.sched[it];
    const int* m0 = a.meta + 4 * row;
    const int* m1 = m0 + 4;
    Win w;
    w.nw = m1[0] - m0[0];
    w.ew = m1[1] - m0[1];
    w.nb = m0[2];
    w.D = a.D;
    w.poses = a.poses + m0[0];
    w.pull = a.pull + (size_t)m0[0] * a.D;
    w.edges = a.edges + m0[1];
    w.lsrc = a.lsrc + m0[1];
    w.ldst = a.ldst + m0[1];
    w.lo = a.part[row * (nc + 1) + rank];
    w.hi = a.part[row * (nc + 1) + rank + 1];
    Work wk = a.wk;
    wk.own = own;
    if (tid < 32)
      for (int j = tid; j < R; j += 32) moved[j] = upd[j] = 0.f;

    gather<DD, RR>(w, a.g, wk);  // from the current X
    cl.sync();
    if (a.rgd_stepsize > 0.f) {
      float f0 = 0.f;
      if (a.rgd_cost) {
        // the window's cost before the step (the gradient goes to the
        // owner region's first vector, which the step does not use), and
        // the separators into the step's output buffer, where the cost
        // after the step reads them (the step writes block poses only)
        f0 = egrad_cost<DD, RR>(w, wk, wk.X, own, red, par);
        for (int i = (w.lo > w.nb ? w.lo : w.nb) + tid; i < w.hi; i += THREADS) {
          Blk<DD, RR> v;
          ld_pose<DD, RR>(wk.X, i, v);
          st_pose<DD, RR>(wk.Xt, i, v);
        }
      }
      rgd_step<DD, RR>(w, wk, a.rgd_stepsize);
      if (a.rgd_cost) {
        cl.sync();  // every CTA's stepped block poses are written
        cost += egrad_cost<DD, RR>(w, wk, wk.X, own, red, par) - f0;
      }
      tcg += 1;
    } else {
      const SolveOut s = solve<DD, RR>(w, wk, a.q, red, par);
      cost += s.f - s.f0;
      tcg += s.ktot;
    }

    // the block back into X, in place; each pose's squared displacement
    // into the owner region's first vector (free after the solve)
    for (int i = w.lo + tid; i < w.hi && i < w.nb; i += THREADS) {
      const int gi = w.poses[i];
      Blk<DD, RR> v, x0;
      ld_pose<DD, RR>(wk.X, i, v);
      ld_pose<DD, RR>(a.g.X, gi, x0);
      st_pose<DD, RR>(a.g.X, gi, v);
      float d2 = 0.f;
#pragma unroll
      for (int r = 0; r < RR; ++r)
#pragma unroll
        for (int b = 0; b <= DD; ++b) {
          const float dv = v.v[r][b] - x0.v[r][b];
          d2 += dv * dv;
        }
      own[i - w.lo] = d2;
    }
    // moved of the row's robots (these reductions also publish the new X)
    row_moved(w, own, a.row_robots + m0[3], m1[3] - m0[3], a.robot_off, red, par, moved, upd);
    __syncthreads();

    // neighbour bump and relative change (warp 0 of every CTA, R x R)
    if (tid < 32) {
      for (int j = tid; j < R; j += 32) {
        float b = 0.f;
        for (int k = 0; k < R; ++k) b += moved[k] * upd[k] * a.adj[(size_t)k * R + j];
        const float rel2 = upd[j] > 0.f ? moved[j] : fmaxf(rel[j], b);
        rel[j] = rel2;
        if (rank == 0 && a.rel_hist != nullptr) a.rel_hist[(size_t)it * R + j] = rel2;
      }
    }
    __syncthreads();
    const float maxrel = max_rel(rel, R, &bcast);
    const int it2 = it + 1;
    if (a.gnc) {
      const bool term = maxrel < a.tol && !a.gnc_pending;
      const bool fire = a.use_inner_tol ? (maxrel < a.inner_tol || it2 - a.last_wu >= a.inner)
                                        : (it2 % a.inner == 0);
      stop = term || (fire && a.gnc_pending);
    } else {
      stop = maxrel < a.tol;
    }
    it = it2;
  }
  if (rank == 0) {
    if (tid < 32)
      for (int j = tid; j < R; j += 32) a.rel[j] = rel[j];
    if (tid == 0) {
      a.stats[0] = cost;
      a.stats[1] = (float)it;
      a.stats[2] = (float)(it - a.it0);
      a.stats[3] = (float)tcg;
    }
  }
  // a CTA's shared memory must outlive the other CTAs' last stores into it
  cl.sync();
}

template <int DD, int RR>
int launch_run(RunArgs a, int nc, cudaStream_t s) {
  const size_t smem = a.own_smem ? (size_t)(4 * own_floats(DD, RR, a.wk.P)) : 0;
  return launch_cluster(rtr_run_kernel<DD, RR>, a, nc, smem, s);
}

}  // namespace

extern "C" {

// Floats of workspace one run needs: the cluster solve's for windows of at
// most `nw` poses and `ew` edges on `nc` CTAs with slices of at most `P`
// poses, and each CTA's rel / moved / updated values.
long long dpgo_rtr_run_workspace_floats(int d, int r, int nw, int ew, int num_robots, int nc,
                                        int P) {
  return cluster_workspace_floats(d, r, nw, ew, nc, P, !own_in_smem(d, r, P)) +
         3LL * nc * num_robots;
}

// Launches one multi-step run as a cluster of `nc` CTAs on `stream`,
// updating X in place; returns a cudaError_t, or -1 when no such cluster
// fits on the card.
int dpgo_rtr_run(int d, int r, int D, int num_robots, int m_rows, int it_cap, int nc, int P,
                 int max_nw, int max_ew, float* X, const int* sched, const float* Pinv,
                 const float* R, const float* t, const float* kw, const float* tw,
                 const int* robot_off, const int* meta, const int* poses, const int* edges,
                 const int* lsrc, const int* ldst, const int* pull, const int* part,
                 const int* row_robots, const float* adj, const float* rel0,
                 const float* cost0, float* rel, float* stats, float* rel_hist, float* work,
                 int it0, int last_wu, int gnc_pending, int gnc, int inner, int use_inner_tol,
                 float inner_tol, float tol, float rgd_stepsize, int rgd_cost,
                 int max_iterations,
                 int max_tcg, float gradnorm_tol, float initial_radius, float max_radius,
                 float tcg_kappa, float tcg_theta, void* stream) {
  if (r < 1 || r > 8 || (d != 2 && d != 3) || num_robots < 1 || m_rows < 1 || it_cap < 0 ||
      P < 1 || max_nw < 1 || max_ew < 1 || (gnc && inner < 1))
    return (int)cudaErrorInvalidValue;
  RunArgs a;
  a.g.X = X;
  a.g.Pinv = Pinv;
  a.g.R = R;
  a.g.t = t;
  a.g.kw = kw;
  a.g.tw = tw;
  a.D = D;
  a.meta = meta;
  a.poses = poses;
  a.edges = edges;
  a.lsrc = lsrc;
  a.ldst = ldst;
  a.pull = pull;
  a.part = part;
  a.row_robots = row_robots;
  a.robot_off = robot_off;
  a.wk = bind_work(work, d, r, max_nw, max_ew, P);
  a.own_smem = own_in_smem(d, r, P) ? 1 : 0;
  a.own_global = a.wk.own;
  a.own_stride = own_floats(d, r, P);
  a.relw = work + cluster_workspace_floats(d, r, max_nw, max_ew, nc, P, !a.own_smem);
  a.sched = sched;
  a.adj = adj;
  a.rel0 = rel0;
  a.cost0 = cost0;
  a.rel = rel;
  a.stats = stats;
  a.rel_hist = rel_hist;
  a.R = num_robots;
  a.it0 = it0;
  a.last_wu = last_wu;
  a.gnc_pending = gnc_pending;
  a.gnc = gnc;
  a.inner = inner;
  a.use_inner_tol = use_inner_tol;
  a.it_cap = it_cap;
  a.inner_tol = inner_tol;
  a.tol = tol;
  a.rgd_stepsize = rgd_stepsize;
  a.rgd_cost = rgd_cost;
  a.q.max_iterations = max_iterations;
  a.q.max_tcg = max_tcg;
  a.q.gradnorm_tol = gradnorm_tol;
  a.q.initial_radius = initial_radius;
  a.q.max_radius = max_radius;
  a.q.tcg_kappa = tcg_kappa;
  a.q.tcg_theta = tcg_theta;
  (void)m_rows;
  cudaStream_t s = (cudaStream_t)stream;
  return DPGO_DISPATCH_DR(d, r, launch_run, a, nc, s);
}

}  // extern "C"
