// K3: one asynchronous (ASAPP) tick of every robot as ONE kernel launch on an
// NVIDIA Hopper GPU: one thread-block cluster per robot, each on its robot's
// window.
//
// Replaces: dpgo_ros_tpu/ops/fused_asapp.py::_make_asapp_kernel (the Pallas
// kernel launched by asapp_tick_fused). Plain version:
// dpgo_ros_tpu_torch/ops/fused_asapp.py::asapp_tick_fused_ref; the
// semantics are those of dpgo_ros_tpu/parallel/asapp.py::_tick_impl.
//
// For each robot k:
//   Z = robot k's block fresh from X, every other pose from the ring slot
//       delay_k mod (K+1);
//   steps times: Z ← Retr(Z, −γ·proj(Z, proj(Z, ∇f(Z)) P⁻¹)) on the block
//       (without the preconditioner −γ·proj(Z, ∇f(Z))), every other pose
//       exact;
//   X_new takes robot k's block from Z;
//   moved_k = sqrt(Σ ‖X_new[i] − X[i]‖²) over the block.
// A robot's step reads only its block and the separators (the far ends of
// the edges that touch the block), so cluster k works on robot k's window
// (dpgo_ros_tpu_torch/ops/hbm_rtr.py::prepare_windows): block poses from X,
// separators from the stale slot, the window's edges gathered once.
// The ring-buffer write of the pre-tick X (slot tick mod (K+1)) is NOT done
// here: another robot may read that slot as its stale view in this tick, so
// the caller writes it after the launch, on the same stream.
//
// Stop flag: with `live` (a device int), a tick whose flag is 0 copies X's
// block to X_new and keeps moved_k at rel[k]; the caller's device-side stop
// test sets the flag, so a run needs no host read per tick.
//
// What bounds it: neither bytes nor flops (a tick at the asapp_demo size
// moves ~1 MB and does ~13 MFLOP, under 1 µs of the card's rates). Until
// this design each robot was one 256-thread CTA that copied all n poses,
// ran the gradient over all E edges through a contribution table and
// retracted full-width under a mask: 0.33 ms per tick, 5 of 132 SMs busy.
// Now cluster k (grid = R × nc CTAs, clusters independent, so they may run
// in waves) owns a work-balanced slice of robot k's window per CTA, about
// one pose per thread, and runs the RGD variant of rtr_cluster.cuh (the
// gradient through the pull index, owner-computes, no atomics); an RGD
// step needs no reduction, so the only cluster barriers are one after the
// gather, one between steps and the movement's reduction. P⁻¹ of the slice
// sits in shared memory. Sums run in a fixed order, so a repeated tick
// gives the same bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include "rtr_cluster.cuh"

namespace {

struct TickArgs {
  World g;             // g.X: the state at the start of the tick
  const float* hist;   // (Kp1, n, r, d+1) ring buffer of past states
  const int* delays;   // (R,) stale slot of each robot (taken mod Kp1)
  const int* live;     // () 0 when the run has stopped; null: always live
  const float* rel;    // (R,) movement kept when not live
  int D;               // pull width of every window
  const int* meta;     // (R+1, 4) per robot: pose_off, edge_off, block size, -
  const int* poses;    // window tables (CSR by meta)
  const int* edges;
  const int* lsrc;
  const int* ldst;
  const int* pull;
  const int* part;     // (R, nc+1) slice bounds
  float* work;         // R × per_cluster floats
  long long per_cluster;
  int n, Kp1, steps, max_nw, max_ew, P;
  float gamma;
  float* X_out;  // (n, r, d+1): every robot writes its block
  float* moved;  // (R,)
};

template <int DD, int RR, bool PRECOND>
__global__ void __launch_bounds__(THREADS, 1) asapp_tick_kernel(TickArgs a) {
  extern __shared__ __align__(16) float dyn[];  // this slice's P⁻¹
  __shared__ float red[RED_FLOATS];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), nc = (int)cl.num_blocks(), tid = threadIdx.x;
  const int k = (int)blockIdx.x / nc;  // this cluster's robot
  const int* m0 = a.meta + 4 * k;
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
  w.lo = a.part[k * (nc + 1) + rank];
  w.hi = a.part[k * (nc + 1) + rank + 1];

  if (a.live != nullptr && *a.live == 0) {  // stopped: X_new = X, moved kept
    for (int i = w.lo + tid; i < w.hi && i < w.nb; i += THREADS) {
      const int gi = w.poses[i];
      Blk<DD, RR> v;
      ld_pose<DD, RR>(a.g.X, gi, v);
      st_pose<DD, RR>(a.X_out, gi, v);
    }
    if (rank == 0 && tid == 0) a.moved[k] = a.rel[k];
    return;  // uniform over the cluster: every CTA read the same flag
  }

  Work wk = bind_work(a.work + (size_t)k * a.per_cluster, DD, RR, a.max_nw, a.max_ew, a.P);
  wk.pv = dyn;
  int par = 0;
  int slot = a.delays[k] % a.Kp1;
  if (slot < 0) slot += a.Kp1;
  const float* stale = a.hist + (size_t)slot * a.n * RR * (DD + 1);

  gather<DD, RR>(w, a.g, wk, stale);
  cl.sync();
  for (int s = 0; s < a.steps; ++s) {
    if (s > 0) cl.sync();  // the last step's block poses published
    rgd_step<DD, RR, PRECOND>(w, wk, a.gamma);
  }

  float mv[1] = {0.f};
  for (int i = w.lo + tid; i < w.hi && i < w.nb; i += THREADS) {
    const int gi = w.poses[i];
    Blk<DD, RR> v, x0;
    ld_pose<DD, RR>(wk.X, i, v);
    ld_pose<DD, RR>(a.g.X, gi, x0);
    st_pose<DD, RR>(a.X_out, gi, v);
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int b = 0; b <= DD; ++b) {
        const float dv = v.v[r][b] - x0.v[r][b];
        mv[0] += dv * dv;
      }
  }
  cluster_sum<1>(mv, red, par);  // the last access to another CTA's memory
  if (rank == 0 && tid == 0) a.moved[k] = sqrtf(mv[0]);
}

// One cluster's workspace: the cluster solve's, without owner regions.
inline long long per_cluster_floats(int d, int r, int nw, int ew, int nc, int P) {
  return cluster_workspace_floats(d, r, nw, ew, nc, P, false);
}

template <int DD, int RR>
int launch_tick(TickArgs a, int nc, int R, int use_precond, cudaStream_t s) {
  const size_t smem = (size_t)4 * (DD + 1) * (DD + 1) * a.P;
  if (use_precond) return launch_cluster(asapp_tick_kernel<DD, RR, true>, a, nc, smem, s, R);
  return launch_cluster(asapp_tick_kernel<DD, RR, false>, a, nc, smem, s, R);
}

}  // namespace

extern "C" {

// Floats of workspace one tick needs: one cluster's per robot, for windows
// of at most `nw` poses and `ew` edges on `nc` CTAs with slices of at most
// `P` poses.
long long dpgo_asapp_tick_workspace_floats(int d, int r, int nw, int ew, int nc, int P,
                                           int num_robots) {
  return (long long)num_robots * per_cluster_floats(d, r, nw, ew, nc, P);
}

// Launches one tick as `num_robots` clusters of `nc` CTAs on `stream`;
// returns a cudaError_t, or -1 when no such cluster fits on the card.
int dpgo_asapp_tick(int d, int r, int n, int D, int num_robots, int nc, int P, int max_nw,
                    int max_ew, int Kp1, int steps, int use_precond, const float* X,
                    const float* hist, const int* delays, const float* Pinv, const float* R,
                    const float* t, const float* kw, const float* tw, const int* meta,
                    const int* poses, const int* edges, const int* lsrc, const int* ldst,
                    const int* pull, const int* part, const int* live, const float* rel,
                    float gamma, float* X_out, float* moved, float* work, void* stream) {
  if (r < 1 || r > 8 || (d != 2 && d != 3) || n < 1 || num_robots < 1 || Kp1 < 1 ||
      steps < 0 || P < 1 || max_nw < 1 || max_ew < 1 || (live != nullptr && rel == nullptr))
    return (int)cudaErrorInvalidValue;
  TickArgs a;
  a.g.X = const_cast<float*>(X);
  a.g.Pinv = Pinv;
  a.g.R = R;
  a.g.t = t;
  a.g.kw = kw;
  a.g.tw = tw;
  a.hist = hist;
  a.delays = delays;
  a.live = live;
  a.rel = rel;
  a.D = D;
  a.meta = meta;
  a.poses = poses;
  a.edges = edges;
  a.lsrc = lsrc;
  a.ldst = ldst;
  a.pull = pull;
  a.part = part;
  a.work = work;
  a.per_cluster = per_cluster_floats(d, r, max_nw, max_ew, nc, P);
  a.n = n;
  a.Kp1 = Kp1;
  a.steps = steps;
  a.max_nw = max_nw;
  a.max_ew = max_ew;
  a.P = P;
  a.gamma = gamma;
  a.X_out = X_out;
  a.moved = moved;
  cudaStream_t s = (cudaStream_t)stream;
  return DPGO_DISPATCH_DR(d, r, launch_tick, a, nc, num_robots, use_precond, s);
}

}  // extern "C"
