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

// A window row's launch, fixed once (dpgo_rtr_window_record): the
// kernel of its (d, r), the cluster and its shared memory, the card.
struct WindowRec {
  WindowArgs a;  // X, X_out, stats and the workspace set per launch
  void (*kern)(WindowArgs);
  size_t smem;
  int device, d, r, nc, P;
};

cudaLaunchConfig_t launch_config(const WindowRec& c, cudaLaunchAttribute* at, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.nc, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = s;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = c.nc;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// Picks the kernel of the record's (d, r) and checks, on the current
// card, that one cluster of the record's shape fits (launch_cluster's
// check, once per record).
template <int DD, int RR>
int record_window(WindowRec& c) {
  c.kern = rtr_window_kernel<DD, RR>;
  cudaError_t e;
  if (c.nc > 8) {
    e = cudaFuncSetAttribute((const void*)c.kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaFuncSetAttribute((const void*)c.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)c.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg = launch_config(c, at, 0);
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, (const void*)c.kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  return active < 1 ? -1 : 0;
}

// One launch of a record's kernel. The shared-memory limit is set at every
// launch: records of other windows may have set another on the same kernel.
int launch_record(const WindowRec& c, const WindowArgs& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute((const void*)c.kern,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg = launch_config(c, at, s);
  e = cudaLaunchKernelEx(&cfg, c.kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// f() with `device` the current card, then the caller's again.
template <class F>
int on_device(int device, F f) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int rc = f();
  if (prev != device) cudaSetDevice(prev);
  return rc;
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

// The launch record of one window row (ops/hbm_rtr.py keeps it in a
// buffer of dpgo_rtr_window_record_bytes() bytes, one per row): its
// kernel, sizes and tables (dpgo_rtr_window_record, once), the world's
// operands and the solve's parameters (dpgo_rtr_window_bind, when they
// change); a launch then passes only X, X_out, stats, the workspace and
// the stream.
long long dpgo_rtr_window_record_bytes() { return (long long)sizeof(WindowRec); }

// Fills the record of a window of `nw` poses (`nb` of them the block) and
// `ew` edges on `nc` CTAs with slices of at most `P` poses, for card
// `device`, and checks there, once, that such a cluster fits; returns a
// cudaError_t, or -1 when no such cluster fits on the card.
int dpgo_rtr_window_record(void* rec, int device, int d, int r, int nw, int ew, int nb,
                           int D, int nc, int P, const int* poses, const int* edges,
                           const int* lsrc, const int* ldst, const int* lpull,
                           const int* part) {
  if (r < 1 || r > 8 || nw < 1 || nb < 1 || nb > nw || ew < 1 || (d != 2 && d != 3) || P < 1 ||
      nc < 2 || nc > CLUSTER_MAX)
    return (int)cudaErrorInvalidValue;
  WindowRec& c = *(WindowRec*)rec;
  c = WindowRec{};
  c.device = device;
  c.d = d;
  c.r = r;
  c.nc = nc;
  c.P = P;
  WindowArgs& a = c.a;
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
  a.own_smem = own_in_smem(d, r, P) ? 1 : 0;
  a.own_stride = own_floats(d, r, P);
  c.smem = a.own_smem ? (size_t)(4 * a.own_stride) : 0;
  return on_device(device, [&] { return DPGO_DISPATCH_DR(d, r, record_window, c); });
}

// Binds the world's operands and the solve's parameters into a record.
void dpgo_rtr_window_bind(void* rec, const float* Pinv, const float* R, const float* t,
                          const float* kw, const float* tw, int max_iterations, int max_tcg,
                          float gradnorm_tol, float initial_radius, float max_radius,
                          float tcg_kappa, float tcg_theta) {
  WindowArgs& a = ((WindowRec*)rec)->a;
  a.g.Pinv = Pinv;
  a.g.R = R;
  a.g.t = t;
  a.g.kw = kw;
  a.g.tw = tw;
  a.q.max_iterations = max_iterations;
  a.q.max_tcg = max_tcg;
  a.q.gradnorm_tol = gradnorm_tol;
  a.q.initial_radius = initial_radius;
  a.q.max_radius = max_radius;
  a.q.tcg_kappa = tcg_kappa;
  a.q.tcg_theta = tcg_theta;
}

// Launches one window solve of a bound record on its card, in `stream`;
// returns a cudaError_t.
int dpgo_rtr_window_launch(const void* rec, const float* X, float* X_out, float* stats,
                           float* work, void* stream) {
  const WindowRec& c = *(const WindowRec*)rec;
  WindowArgs a = c.a;
  a.g.X = const_cast<float*>(X);
  a.wk = bind_work(work, c.d, c.r, a.w.nw, a.w.ew, c.P);
  a.own_global = a.wk.own;
  a.X_out = X_out;
  a.stats = stats;
  return on_device(c.device, [&] { return launch_record(c, a, (cudaStream_t)stream); });
}

}  // extern "C"
