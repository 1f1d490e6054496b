// Probe of the synchronisation cost inside the cluster window solve of
// rtr_cluster.cuh (K2, K4). Not a kernel of any path and no port of a TPU
// kernel: it runs the solve's barriers and reductions with every pass over
// the window stubbed out, so that the time of a tCG iteration can be split
// into its synchronisation and its passes.
//
// One launch is one cluster of nc CTAs of THREADS threads, as the solve's,
// looping `iters` times over one of three bodies:
//   mode 0: four bare cluster barriers (cg::this_cluster().sync());
//   mode 1: one tCG iteration's synchronisation as solve() runs it: the
//           barrier that publishes delta, then cluster_sum of 1 (dHd), 4
//           (the trust-region norms) and 2 (the residual) values, each
//           value chained to the last so that nothing folds away;
//   mode 2: one cluster_sum of one value (a reduction outside tCG: f, the
//           gradient norm).
// The time per iteration is the slope of the launch time over `iters`
// (scripts/cluster_barrier.py), so the launch's fixed cost cancels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include "rtr_cluster.cuh"

namespace {

struct BarrierArgs {
  float* out;  // (nc,) one value per CTA, so the loop has an effect
  int iters;
  int mode;
};

__global__ void __launch_bounds__(THREADS, 1) cluster_barrier_kernel(BarrierArgs a) {
  __shared__ float red[RED_FLOATS];
  cg::cluster_group cl = cg::this_cluster();
  int par = 0;
  float acc = 1e-3f * (float)threadIdx.x;
  for (int it = 0; it < a.iters; ++it) {
    if (a.mode == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) cl.sync();
    } else if (a.mode == 1) {
      cl.sync();
      float s1[1] = {acc};
      cluster_sum<1>(s1, red, par);
      float s4[4] = {s1[0] * 1e-6f, acc, 2.f * acc, 3.f * acc};
      cluster_sum<4>(s4, red, par);
      float s2[2] = {s4[0] * 1e-6f, s4[3] * 1e-6f};
      cluster_sum<2>(s2, red, par);
      acc = 1e-3f * (float)threadIdx.x + 1e-9f * s2[0];
    } else {
      float s1[1] = {acc};
      cluster_sum<1>(s1, red, par);
      acc = 1e-3f * (float)threadIdx.x + 1e-9f * s1[0];
    }
  }
  if (threadIdx.x == 0) a.out[cl.block_rank()] = acc;
}

}  // namespace

extern "C" {

// Launches one probe cluster of `nc` CTAs on `stream`; returns a
// cudaError_t, or -1 when no such cluster fits on the card.
int dpgo_cluster_barrier(int nc, int iters, int mode, float* out, void* stream) {
  if (iters < 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  BarrierArgs a;
  a.out = out;
  a.iters = iters;
  a.mode = mode;
  return launch_cluster(cluster_barrier_kernel, a, nc, 0, (cudaStream_t)stream);
}

}  // extern "C"
