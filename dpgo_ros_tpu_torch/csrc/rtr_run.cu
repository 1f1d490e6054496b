// K2: many RBCD solver steps in ONE kernel launch on an NVIDIA Hopper GPU.
//
// Replaces: dpgo_ros_tpu/ops/fused_rtr.py::_make_rtr_multistep_kernel (the
// Pallas kernel launched by rtr_run_fused). Plain version:
// dpgo_ros_tpu_torch/ops/fused_rtr.py::rtr_run_fused_ref.
//
// Step `it` solves the block bank[sched[it]]: one masked RTR solve
// (rtr_solve_block of rtr_common.cuh, the code K1 runs), or, when
// rgd_stepsize > 0, one preconditioned Riemannian-gradient step and its
// retraction (rgd_step of rtr_common.cuh, the step K3 runs). Then it copies
// the unmasked poses back from the step's input (exact, whatever the
// retraction did to them), reduces each robot's masked
// displacement `moved` and `updated` flag, bumps the neighbours' relative
// change through the robot adjacency, rel = updated ? moved :
// max(rel, (moved·updated) @ adj), and writes the history row of the
// absolute iteration. After each step, at it2 = it + 1, the run stops on
// termination (max rel < tol and no GNC round pending), at it_cap, or when
// a GNC weight round must fire (pending and use_inner_tol ? max rel <
// inner_tol or it2 − last_wu ≥ inner : it2 % inner == 0). An input that
// has already terminated runs zero steps.
//
// What bounds it: the solves, as in K1 (barriers and reduction latency on
// one SM). The step loop adds R block reductions per step for the
// per-robot stats and R×R work for one warp; the launch overhead it saves
// against one K1 launch per step is microseconds on this card.
//
// Design: one 256-thread block, as K1. Every step-loop test (stop, GNC
// fire, it < it_cap) reads values that all threads take from one
// shared-memory broadcast of a fixed-order reduction, so no __syncthreads()
// sits under a branch that threads could disagree on. The state ping-pongs
// between the output buffer and one workspace buffer; the last step's
// buffer is copied to the output if needed.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include "rtr_common.cuh"

namespace {

struct Run {
  const float* Xin;    // (n, r, d+1) state at it0
  const float* bank;   // (m_rows, n) mask rows
  const int* sched;    // (it_cap,) bank row of each absolute iteration
  const float* adj;    // (R, R) robot adjacency
  const float* rel0;   // (R,) incoming relative change
  const float* cost0;  // (1,) cost of Xin
  float* Xout;         // (n, r, d+1)
  float* rel;          // (R,)
  float* stats;        // (4,) cost, iteration, steps, tCG iterations
  float* rel_hist;     // (it_cap, R) or null
  float* Xalt;         // (n, r, d+1) workspace
  float* moved;        // (R,) workspace
  float* upd;          // (R,) workspace
  int it0, last_wu, gnc_pending, gnc, inner, use_inner_tol, it_cap;
  float inner_tol, tol, rgd_stepsize;
};

// Largest of v[0..R), by warp 0 in a fixed order (lane j reads the entries
// it wrote), broadcast through shared memory. Called by all threads.
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

// Minimum one block per SM: without it ptxas caps the d = 3 instance at 128
// registers (4,120 B stack); with it 255 (3,616 B), which ran 3 % faster
// per step on an H100 (2,500-pose sphere, 10 RoundRobin steps).
template <int DD>
__global__ void __launch_bounds__(THREADS, 1) rtr_run_kernel(Problem p, Params q, Run u) {
  __shared__ float sh[KMAX * NWARPS + KMAX];
  __shared__ float bcast;
  const int C = p.r * (DD + 1), tid = threadIdx.x, R = p.num_robots;
  const size_t NC = (size_t)p.n * C;

  for (int c = tid; c < C; c += THREADS) p.contrib[(size_t)2 * p.E * C + c] = 0.f;
  for (size_t i = tid; i < NC; i += THREADS) u.Xout[i] = u.Xin[i];
  if (tid < 32)
    for (int j = tid; j < R; j += 32) u.rel[j] = u.rel0[j];
  __syncthreads();

  float cost = u.cost0[0];
  int it = u.it0, tcg = 0;
  bool stop = max_rel(u.rel, R, &bcast) < u.tol && !(u.gnc && u.gnc_pending);
  float* cur = u.Xout;
  float* nxt = u.Xalt;
  while (!stop && it < u.it_cap) {
    const float* mask = u.bank + (size_t)u.sched[it] * p.n;
    Problem ps = p;
    ps.mask = mask;
    ps.X0 = cur;
    ps.X = nxt;
    if (u.rgd_stepsize > 0.f) {
      rgd_step<DD>(ps, u.rgd_stepsize, sh);
      tcg += 1;
    } else {
      const SolveOut s = rtr_solve_block<DD>(ps, q, sh);
      cost = s.f;
      tcg += s.ktot;
    }
    __syncthreads();

    // unmasked poses back from the step's input; per-robot moved, updated
    for (int rb = 0; rb < R; ++rb) {
      float mv[1] = {0.f}, up[1] = {0.f};
      for (int i = p.robot_off[rb] + tid; i < p.robot_off[rb + 1]; i += THREADS) {
        const size_t o = (size_t)i * C;
        const float m = mask[i];
        if (m > 0.f) {
          for (int c = 0; c < C; ++c) {
            const float dv = (nxt[o + c] - cur[o + c]) * m;
            mv[0] += dv * dv;
          }
        } else {
          for (int c = 0; c < C; ++c) nxt[o + c] = cur[o + c];
        }
        up[0] = fmaxf(up[0], m);
      }
      block_sum<1>(mv, sh);
      block_reduce<1>(up, sh, MaxOp());
      if (tid == 0) {
        u.moved[rb] = sqrtf(mv[0]);
        u.upd[rb] = up[0];
      }
    }
    __syncthreads();

    // neighbour bump and relative change (one warp, R x R)
    if (tid < 32) {
      for (int j = tid; j < R; j += 32) {
        float b = 0.f;
        for (int k = 0; k < R; ++k) b += u.moved[k] * u.upd[k] * u.adj[(size_t)k * R + j];
        const float rel2 = u.upd[j] > 0.f ? u.moved[j] : fmaxf(u.rel[j], b);
        u.rel[j] = rel2;
        if (u.rel_hist != nullptr) u.rel_hist[(size_t)it * R + j] = rel2;
      }
    }
    const float maxrel = max_rel(u.rel, R, &bcast);
    const int it2 = it + 1;
    if (u.gnc) {
      const bool term = maxrel < u.tol && !u.gnc_pending;
      const bool fire = u.use_inner_tol
                            ? (maxrel < u.inner_tol || it2 - u.last_wu >= u.inner)
                            : (it2 % u.inner == 0);
      stop = term || (fire && u.gnc_pending);
    } else {
      stop = maxrel < u.tol;
    }
    it = it2;
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  __syncthreads();
  if (cur != u.Xout)
    for (size_t i = tid; i < NC; i += THREADS) u.Xout[i] = cur[i];
  if (tid == 0) {
    u.stats[0] = cost;
    u.stats[1] = (float)it;
    u.stats[2] = (float)(it - u.it0);
    u.stats[3] = (float)tcg;
  }
}

}  // namespace

extern "C" {

// Floats of workspace one run needs: a block solve's, the second state
// buffer, and the per-robot moved / updated values.
long long dpgo_rtr_run_workspace_floats(int d, int r, int n, int E, int num_robots) {
  return solve_workspace_floats(d, r, n, E) + (long long)n * r * (d + 1) +
         2LL * num_robots;
}

// Launches one multi-step run on `stream`; returns cudaGetLastError().
int dpgo_rtr_run(int d, int r, int n, int E, int D, int num_robots, int m_rows, int it_cap,
                 const float* X0, const float* bank, const int* sched, const float* Pinv,
                 const int64_t* src, const int64_t* dst, const float* R, const float* t,
                 const float* kw, const float* tw, const int* pull, const int* robot_off,
                 const float* adj, const float* rel0, const float* cost0, float* X,
                 float* rel, float* stats, float* rel_hist, float* work, int it0,
                 int last_wu, int gnc_pending, int gnc, int inner, int use_inner_tol,
                 float inner_tol, float tol, float rgd_stepsize, int max_iterations,
                 int max_tcg, float gradnorm_tol, float initial_radius, float max_radius,
                 float tcg_kappa, float tcg_theta, void* stream) {
  if (r < 1 || r > RMAX || n < 1 || num_robots < 1 || m_rows < 1 || it_cap < 0 ||
      (gnc && inner < 1))
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.n = n;
  p.E = E;
  p.D = D;
  p.r = r;
  p.num_robots = num_robots;
  p.X0 = X0;
  p.mask = bank;
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
  float* w = work + solve_workspace_floats(d, r, n, E);
  Run u;
  u.Xin = X0;
  u.bank = bank;
  u.sched = sched;
  u.adj = adj;
  u.rel0 = rel0;
  u.cost0 = cost0;
  u.Xout = X;
  u.rel = rel;
  u.stats = stats;
  u.rel_hist = rel_hist;
  u.Xalt = w;
  w += (size_t)n * r * (d + 1);
  u.moved = w;
  u.upd = w + num_robots;
  u.it0 = it0;
  u.last_wu = last_wu;
  u.gnc_pending = gnc_pending;
  u.gnc = gnc;
  u.inner = inner;
  u.use_inner_tol = use_inner_tol;
  u.it_cap = it_cap;
  u.inner_tol = inner_tol;
  u.tol = tol;
  u.rgd_stepsize = rgd_stepsize;
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
    rtr_run_kernel<3><<<1, THREADS, 0, s>>>(p, q, u);
  else if (d == 2)
    rtr_run_kernel<2><<<1, THREADS, 0, s>>>(p, q, u);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
