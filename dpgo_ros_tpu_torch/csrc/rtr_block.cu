// K1: one masked Riemannian trust-region (RTR + Steihaug tCG) block solve
// of the lifted pose-graph problem, as ONE kernel launch on an NVIDIA
// Hopper GPU.
//
// Replaces: dpgo_ros_tpu/ops/fused_rtr.py::_make_rtr_kernel (the Pallas
// kernel launched by rtr_solve_fused). The solve itself, what bounds it and
// the design (one 256-thread block, fixed-order reductions, pull-index
// gather-sums without atomics) are in rtr_common.cuh, which K2
// (rtr_run.cu) shares. This file adds the per-robot stats of one solve.
// Plain version: dpgo_ros_tpu_torch/ops/fused_rtr.py::rtr_solve_fused_ref.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include "rtr_common.cuh"

namespace {

template <int DD>
__global__ void __launch_bounds__(THREADS) rtr_block_kernel(Problem p, Params q) {
  __shared__ float sh[KMAX * NWARPS + KMAX];
  const int C = p.r * (DD + 1), tid = threadIdx.x;
  const SolveOut s = rtr_solve_block<DD>(p, q, sh);
  const float f0 = s.f0, f = s.f, gn0 = s.gn0, gn = s.gn;
  const int k = s.k, ktot = s.ktot;

  // ---- stats: f0, f, gn0, gn, TR iterations, tCG iterations, then per
  // robot the masked block displacement and the "updated" flag ----
  if (tid == 0) {
    p.stats[0] = f0;
    p.stats[1] = f;
    p.stats[2] = gn0;
    p.stats[3] = gn;
    p.stats[4] = (float)k;
    p.stats[5] = (float)ktot;
  }
  for (int rb = 0; rb < p.num_robots; ++rb) {
    float mv[1] = {0.f}, up[1] = {0.f};
    for (int i = p.robot_off[rb] + tid; i < p.robot_off[rb + 1]; i += THREADS) {
      const size_t o = (size_t)i * C;
      const float m = p.mask[i];
      for (int c = 0; c < C; ++c) {
        const float dv = (p.X[o + c] - p.X0[o + c]) * m;
        mv[0] += dv * dv;
      }
      up[0] = fmaxf(up[0], m);
    }
    block_sum<1>(mv, sh);
    block_reduce<1>(up, sh, MaxOp());
    if (tid == 0) {
      p.stats[6 + rb] = sqrtf(mv[0]);
      p.stats[6 + p.num_robots + rb] = up[0];
    }
  }
}

}  // namespace

extern "C" {

// Floats of workspace one block solve needs.
long long dpgo_rtr_block_workspace_floats(int d, int r, int n, int E) {
  return solve_workspace_floats(d, r, n, E);
}

// Launches one block solve on `stream`; returns cudaGetLastError().
int dpgo_rtr_block_solve(int d, int r, int n, int E, int D, int num_robots,
                         const float* X0, const float* mask, const float* Pinv,
                         const int64_t* src, const int64_t* dst, const float* R,
                         const float* t, const float* kw, const float* tw, const int* pull,
                         const int* robot_off, float* X, float* stats, float* work,
                         int max_iterations, int max_tcg, float gradnorm_tol,
                         float initial_radius, float max_radius, float tcg_kappa,
                         float tcg_theta, void* stream) {
  if (r < 1 || r > RMAX || n < 1) return (int)cudaErrorInvalidValue;
  Problem p;
  p.n = n;
  p.E = E;
  p.D = D;
  p.r = r;
  p.num_robots = num_robots;
  p.X0 = X0;
  p.mask = mask;
  p.Pinv = Pinv;
  p.src = src;
  p.dst = dst;
  p.R = R;
  p.t = t;
  p.kw = kw;
  p.tw = tw;
  p.pull = pull;
  p.robot_off = robot_off;
  p.X = X;
  p.stats = stats;
  bind_solve_workspace(p, work, d);
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
    rtr_block_kernel<3><<<1, THREADS, 0, s>>>(p, q);
  else if (d == 2)
    rtr_block_kernel<2><<<1, THREADS, 0, s>>>(p, q);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
