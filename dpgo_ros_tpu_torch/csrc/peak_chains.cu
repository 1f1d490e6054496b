// K5 and K6: the roofline's two calibration chains, elementwise fp32 work
// that the compiler cannot fold, timed over trip counts to give an
// attainable fp32 rate on the card.
//
// Replaces: scripts/measure_peaks.py::_chain (:42-66, K5, the logistic map
// x <- 3.9*x*(1-x)) and ::_chain_cml (:112-145, K6, the coupled-map lattice
// v = 0.99*x[i] + 0.51*x[(i+1) % 8], x <- v - floor(0.25*v)*4), the Pallas
// kernels behind the JAX package's roofline (scripts/roofline.py). Both
// read 8 slabs of (256, 512) fp32, run `n_iter` steps of the map on each
// element of each slab, and write the sum of the 8 slabs in order
// x0 + x1 + ... + x7, a (256, 512) fp32 output.
//
// Bound by operations: 4.7 MB cross the memory bus once per launch, while
// 500 steps already do 1.6 GFLOP (K5, 3 flop per element and step) or 3.1
// GFLOP (K6, counted 6 as the JAX package counts them). The arithmetic is
// written with __fmul_rn / __fadd_rn / __fsub_rn and floorf, in the TPU
// kernel's operation order, so nvcc contracts nothing into an FMA: each
// counted flop is one issued instruction, which keeps the flop counts that
// measure_peaks divides by true and makes each kernel bit-identical to its
// plain version (dpgo_ros_tpu_torch/ops/peak_chains.py::chain_ref,
// ::chain_cml_ref) at every trip count; both maps are chaotic, so no
// weaker oracle holds past a few steps. With one flop per instruction the
// ceiling is half of the card's 67 TFLOP/s FMA peak, about 33.5 TFLOP/s
// (132 SMs x 128 fp32 lanes x 1.98 GHz at the full power limit).
//
// Layout: one thread per output element, 131,072 threads in 512 blocks of
// 256 (about 3.9 blocks per SM). Each thread keeps its 8 chain values in
// registers for the whole loop: 8 independent chains per thread hide the
// fp32 pipeline's latency, and 32 warps per SM hide the rest. The trip
// count is a runtime argument: one kernel per witness, where JAX builds
// one per trip count.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include <cuda_runtime.h>

namespace {

constexpr int NCHAIN = 8;
constexpr int THREADS = 256;

// K5: x <- (3.9*x)*(1-x) on each of the 8 chains.
__global__ void __launch_bounds__(THREADS)
    logistic_chain(const float* __restrict__ x, float* __restrict__ out, int m, int n_iter) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  float v[NCHAIN];
#pragma unroll
  for (int c = 0; c < NCHAIN; ++c) v[c] = x[(long long)c * m + i];
  for (int it = 0; it < n_iter; ++it) {
#pragma unroll
    for (int c = 0; c < NCHAIN; ++c) v[c] = __fmul_rn(__fmul_rn(3.9f, v[c]), __fsub_rn(1.0f, v[c]));
  }
  float acc = v[0];
#pragma unroll
  for (int c = 1; c < NCHAIN; ++c) acc = __fadd_rn(acc, v[c]);
  out[i] = acc;
}

// K6: every chain steps from the old values of itself and its successor,
// v = (0.99*x[c]) + (0.51*x[(c+1) % 8]), then x[c] <- v - floor(0.25*v)*4.
__global__ void __launch_bounds__(THREADS)
    coupled_map_chain(const float* __restrict__ x, float* __restrict__ out, int m, int n_iter) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  float v[NCHAIN];
#pragma unroll
  for (int c = 0; c < NCHAIN; ++c) v[c] = x[(long long)c * m + i];
  for (int it = 0; it < n_iter; ++it) {
    float w[NCHAIN];
#pragma unroll
    for (int c = 0; c < NCHAIN; ++c) {
      const float s = __fadd_rn(__fmul_rn(v[c], 0.99f), __fmul_rn(v[(c + 1) % NCHAIN], 0.51f));
      w[c] = __fsub_rn(s, __fmul_rn(floorf(__fmul_rn(s, 0.25f)), 4.0f));
    }
#pragma unroll
    for (int c = 0; c < NCHAIN; ++c) v[c] = w[c];
  }
  float acc = v[0];
#pragma unroll
  for (int c = 1; c < NCHAIN; ++c) acc = __fadd_rn(acc, v[c]);
  out[i] = acc;
}

template <typename Kernel>
int launch(Kernel kernel, const float* x, float* out, int m, int n_iter, void* stream) {
  if (m < 1 || n_iter < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (m + THREADS - 1) / THREADS;
  kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(x, out, m, n_iter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (8*m,) fp32, the 8 slabs one after another; out: (m,) fp32. Launches
// on `stream`; returns cudaGetLastError().
int dpgo_peak_chain(const float* x, float* out, int m, int n_iter, void* stream) {
  return launch(logistic_chain, x, out, m, n_iter, stream);
}

int dpgo_peak_chain_cml(const float* x, float* out, int m, int n_iter, void* stream) {
  return launch(coupled_map_chain, x, out, m, n_iter, stream);
}

}  // extern "C"
