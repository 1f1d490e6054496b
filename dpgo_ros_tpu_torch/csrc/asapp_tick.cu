// K3: one asynchronous (ASAPP) tick of every robot as ONE kernel launch on an
// NVIDIA Hopper GPU.
//
// Replaces: dpgo_ros_tpu/ops/fused_asapp.py::_make_asapp_kernel (the Pallas
// kernel launched by asapp_tick_fused). Plain version:
// dpgo_ros_tpu_torch/ops/fused_asapp.py::asapp_tick_fused_ref; the
// semantics are those of dpgo_ros_tpu/parallel/asapp.py::_tick_impl.
//
// For each robot k (block k of the grid):
//   Z = mask_k > 0 ? X : hist[delay_k mod (K+1)]   (own block fresh,
//       neighbours from the stale ring slot the robot's delay selects);
//   steps times: Z ← Retr(Z, −γ·m·proj(Z, (m·proj(Z, ∇f(Z))) P⁻¹)) on the
//       poses with mask_k > 0 (without the preconditioner the inner
//       m·proj(Z, ∇f(Z)) is the step); poses with mask 0 stay exact;
//   X_new takes robot k's poses, [robot_off[k], robot_off[k+1]), from Z
//       (where mask_k > 0, else X);
//   moved_k = sqrt(Σ_i mask_k[i] ‖X_new[i] − X[i]‖²) over those poses.
// The ring-buffer write of the pre-tick X (slot tick mod (K+1)) is NOT done
// here: another robot may read that slot as its stale view in this tick, so
// the wrapper's caller writes it after the launch, on the same stream.
//
// What bounds it on this card: neither bytes nor flops. One tick at the
// asapp_demo size (2,500 poses, 4,949 edges, 5 robots) must move ~2 MB and
// do a few MFLOP, well under 5 µs of the card's bandwidth or fp32 rate. Each
// robot's step is a dependent chain inside one block — edge pass, barrier,
// pull-index gather, block reduction, pose pass — so the time is barrier and
// reduction latency on one SM, and only R of the 132 SMs are busy.
//
// Design: one 256-thread block per robot, grid = R. Robots do not
// communicate inside a tick (each reads only X, the ring buffer and its own
// workspace), so no grid-wide sync is needed; this runs the R robot steps
// concurrently on R SMs where the TPU kernel unrolled them one after another
// on one core. Each block gets its own Z, G and contribution table in a
// workspace the wrapper allocates (R × ((2E+1)·C + 2·n·C) floats, ~6 MB at
// asapp_demo size; it stays in L2). The step is rgd_step of rtr_common.cuh
// (K2's RGD variant), run in place on Z with the unmasked poses kept exact.
// moved_k is a fixed-order block reduction, so the kernel is deterministic.
// The TPU kernel's transposed (C, n_pad) layout, 8-row slot padding, 256-lane
// windows and KernelGraph tables are not carried over: X and the ring buffer
// keep the public (n, r, d+1) and (K+1, n, r, d+1) layouts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include "rtr_common.cuh"

namespace {

struct Tick {
  const float* X;      // (n, r, d+1) state at the start of the tick
  const float* hist;   // (Kp1, n, r, d+1) ring buffer of past states
  const float* masks;  // (R, n) robot masks
  const int* delays;   // (R,) stale slot of each robot (taken mod Kp1)
  float* Xout;         // (n, r, d+1)
  float* moved;        // (R,)
  float* work;         // R × per_robot floats
  long long per_robot;
  int Kp1, steps;
  float gamma;
};

// Floats of one robot's workspace: Z, G and the contribution table.
inline long long robot_workspace_floats(int d, int r, int n, int E) {
  const long long C = (long long)r * (d + 1);
  return 2LL * n * C + (2LL * E + 1) * C;
}

template <int DD, bool PRECOND>
__global__ void __launch_bounds__(THREADS, 1) asapp_tick_kernel(Problem p, Tick u) {
  __shared__ float sh[KMAX * NWARPS + KMAX];
  const int k = blockIdx.x, tid = threadIdx.x, C = p.r * (DD + 1);
  const size_t NC = (size_t)p.n * C;
  float* Z = u.work + (size_t)k * u.per_robot;
  Problem q = p;
  q.mask = u.masks + (size_t)k * p.n;
  q.X0 = Z;
  q.X = Z;
  q.G = Z + NC;
  q.contrib = Z + 2 * NC;
  int slot = u.delays[k] % u.Kp1;
  if (slot < 0) slot += u.Kp1;
  const float* stale = u.hist + (size_t)slot * NC;

  // contribution row 2E is the pull index's zero row
  for (int c = tid; c < C; c += THREADS) q.contrib[(size_t)2 * p.E * C + c] = 0.f;
  for (int i = tid; i < p.n; i += THREADS) {
    const float* src = q.mask[i] > 0.f ? u.X : stale;
    const size_t o = (size_t)i * C;
    for (int c = 0; c < C; ++c) Z[o + c] = src[o + c];
  }
  // rgd_step's gradient starts with a barrier, so Z is complete before use
  for (int s = 0; s < u.steps; ++s) rgd_step<DD, PRECOND, true>(q, u.gamma, sh);
  __syncthreads();

  float mv[1] = {0.f};
  for (int i = p.robot_off[k] + tid; i < p.robot_off[k + 1]; i += THREADS) {
    const float m = q.mask[i];
    const size_t o = (size_t)i * C;
    float d2 = 0.f;
    for (int c = 0; c < C; ++c) {
      const float x = u.X[o + c], xn = m > 0.f ? Z[o + c] : x;
      u.Xout[o + c] = xn;
      d2 += (xn - x) * (xn - x);
    }
    mv[0] += m * d2;
  }
  block_sum<1>(mv, sh);
  if (tid == 0) u.moved[k] = sqrtf(mv[0]);
}

}  // namespace

extern "C" {

// Floats of workspace one tick needs.
long long dpgo_asapp_tick_workspace_floats(int d, int r, int n, int E, int num_robots) {
  return (long long)num_robots * robot_workspace_floats(d, r, n, E);
}

// Launches one tick on `stream`; returns cudaGetLastError().
int dpgo_asapp_tick(int d, int r, int n, int E, int D, int num_robots, int Kp1, int steps,
                    int use_precond, const float* X, const float* hist, const float* masks,
                    const int* delays, const float* Pinv, const int64_t* src,
                    const int64_t* dst, const float* R, const float* t, const float* kw,
                    const float* tw, const int* pull, const int* robot_off, float gamma,
                    float* Xout, float* moved, float* work, void* stream) {
  if (r < 1 || r > RMAX || n < 1 || num_robots < 1 || Kp1 < 1 || steps < 0)
    return (int)cudaErrorInvalidValue;
  Problem p = {};
  p.n = n;
  p.E = E;
  p.D = D;
  p.r = r;
  p.num_robots = num_robots;
  p.Pinv = Pinv;
  p.src = src;
  p.dst = dst;
  p.R = R;
  p.t = t;
  p.kw = kw;
  p.tw = tw;
  p.pull = pull;
  p.robot_off = robot_off;
  Tick u;
  u.X = X;
  u.hist = hist;
  u.masks = masks;
  u.delays = delays;
  u.Xout = Xout;
  u.moved = moved;
  u.work = work;
  u.per_robot = robot_workspace_floats(d, r, n, E);
  u.Kp1 = Kp1;
  u.steps = steps;
  u.gamma = gamma;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(num_robots);
  if (d == 3 && use_precond)
    asapp_tick_kernel<3, true><<<grid, THREADS, 0, s>>>(p, u);
  else if (d == 3)
    asapp_tick_kernel<3, false><<<grid, THREADS, 0, s>>>(p, u);
  else if (d == 2 && use_precond)
    asapp_tick_kernel<2, true><<<grid, THREADS, 0, s>>>(p, u);
  else if (d == 2)
    asapp_tick_kernel<2, false><<<grid, THREADS, 0, s>>>(p, u);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
