// K7: the accelerated block update's extrapolation, one thread a pose.
//
// Replaces no pallas_call: the JAX package leaves this code to XLA
// (dpgo_ros_tpu/parallel/rbcd.py:494-509, `_block_update`'s `accept`). In
// the port it was a composition of PyTorch ops over every pose of the
// world (parallel/rbcd.py, `_accelerated_update`): the select of X_acc,
// stiefel.proj_tangent, stiefel.retract_polar_ns's 20 Newton–Schulz steps
// of two batched GEMMs and three elementwise ops each, and the select of V,
// some 120 kernel launches an update. Its plain version, op for op that
// composition, is dpgo_ros_tpu_torch/ops/nesterov.py::extrapolate_ref.
//
// For each pose i, with m = mask[i] and Y, p the rotation and translation
// columns of a pose (X = [Y | p], r x (d+1)):
//   X_acc[i] = m > 0 ? Z[i] : X[i]
//   V_new[i] = V[i] where m <= 0, else, from W = m * (X_acc[i] - X_prev[i]):
//     T   = W_Y - Y sym(Y^T W_Y)                  (tangent projection at X_acc)
//     A   = Y + beta * T, scaled by rsqrt(max(||A||_F^2, 1e-12))
//     Zn <- 0.5 * Zn (3I - Zn^T Zn), exactly NS_STEPS = 20 times
//     V_new[i] = [Zn | p + beta * W_p]
// the same mathematics, step count, scaling floor and fp32 precision as the
// composition; only the order of the sums inside each small product
// differs. beta is read from the device (one float), so the θ-sequence's
// beta = (θ - 1)/θ' needs no host read.
//
// Bound by bytes: 4 operands read and 2 written, r*(d+1) floats a pose, so
// ~1.2 MB an update at n = 2,500, r = 5, d = 3 (~0.36 µs at 3.35 TB/s);
// ~10 MFLOP over all poses if every pose extrapolated, ~2 over a 500-pose
// block. At that size the kernel is bound by its launch latency, by
// design: one launch replaces ~120. Each thread holds its pose in
// registers (at most 8 x 4 floats for each of X_acc, W and Zn); a block
// of 64 threads spreads a robot's ~500 contiguous poses over ~8 SMs, so the
// 20 dependent Newton–Schulz steps of different poses run side by side.
// Poses outside the mask only copy X and V.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (plain C interface, bound with ctypes).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int NS_STEPS = 20;

template <int D, int R>
__global__ void __launch_bounds__(THREADS)
    nesterov_extrapolate_kernel(const float* __restrict__ Z, const float* __restrict__ X,
                                const float* __restrict__ Xp, const float* __restrict__ V,
                                const float* __restrict__ mask,
                                const float* __restrict__ beta, float* __restrict__ X_acc,
                                float* __restrict__ V_new, int n) {
  constexpr int W = D + 1;  // floats a row of a pose
  constexpr int S = R * W;  // floats a pose
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long o = (long long)i * S;
  const float m = mask[i];
  if (!(m > 0.f)) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      X_acc[o + k] = X[o + k];
      V_new[o + k] = V[o + k];
    }
    return;
  }
  const float b = *beta;
  float xa[R][W], w[R][W];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const float z = Z[o + a * W + c];
      xa[a][c] = z;
      X_acc[o + a * W + c] = z;
      w[a][c] = m * (z - Xp[o + a * W + c]);
    }
  }
  // sym(Y^T W_Y), d x d
  float s[D][D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < R; ++a) acc += xa[a][j] * w[a][k];
      s[j][k] = acc;
    }
  }
  float sy[D][D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
#pragma unroll
    for (int k = 0; k < D; ++k) sy[j][k] = 0.5f * (s[j][k] + s[k][j]);
  }
  // A = Y + beta * (W_Y - Y sym), and ||A||_F^2
  float zn[R][D];
  float tr = 0.f;
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float ys = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) ys += xa[a][j] * sy[j][k];
      const float v = xa[a][k] + b * (w[a][k] - ys);
      zn[a][k] = v;
      tr += v * v;
    }
  }
  const float sc = rsqrtf(fmaxf(tr, 1e-12f));
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int k = 0; k < D; ++k) zn[a][k] *= sc;
  }
  // Newton–Schulz: Zn <- 0.5 * Zn (3I - Zn^T Zn)
#pragma unroll 2
  for (int it = 0; it < NS_STEPS; ++it) {
    float g[D][D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int a = 0; a < R; ++a) acc += zn[a][j] * zn[a][k];
        g[j][k] = (j == k ? 3.f : 0.f) - acc;
      }
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      float row[D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < D; ++j) acc += zn[a][j] * g[j][k];
        row[k] = 0.5f * acc;
      }
#pragma unroll
      for (int k = 0; k < D; ++k) zn[a][k] = row[k];
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int k = 0; k < D; ++k) V_new[o + a * W + k] = zn[a][k];
    V_new[o + a * W + D] = xa[a][D] + b * w[a][D];
  }
}

template <int D, int R>
int launch(int n, const float* Z, const float* X, const float* Xp, const float* V,
           const float* mask, const float* beta, float* X_acc, float* V_new,
           cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  nesterov_extrapolate_kernel<D, R>
      <<<blocks, THREADS, 0, stream>>>(Z, X, Xp, V, mask, beta, X_acc, V_new, n);
  return (int)cudaGetLastError();
}

template <int D>
int launch_rank(int r, int n, const float* Z, const float* X, const float* Xp,
                const float* V, const float* mask, const float* beta, float* X_acc,
                float* V_new, cudaStream_t s) {
  switch (r) {
    case 1: return launch<D, 1>(n, Z, X, Xp, V, mask, beta, X_acc, V_new, s);
    case 2: return launch<D, 2>(n, Z, X, Xp, V, mask, beta, X_acc, V_new, s);
    case 3: return launch<D, 3>(n, Z, X, Xp, V, mask, beta, X_acc, V_new, s);
    case 4: return launch<D, 4>(n, Z, X, Xp, V, mask, beta, X_acc, V_new, s);
    case 5: return launch<D, 5>(n, Z, X, Xp, V, mask, beta, X_acc, V_new, s);
    case 6: return launch<D, 6>(n, Z, X, Xp, V, mask, beta, X_acc, V_new, s);
    case 7: return launch<D, 7>(n, Z, X, Xp, V, mask, beta, X_acc, V_new, s);
    case 8: return launch<D, 8>(n, Z, X, Xp, V, mask, beta, X_acc, V_new, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Z, X, X_prev, V, X_acc, V_new: (n, r, d+1) fp32, contiguous; mask: (n,)
// fp32; beta: one fp32 on the card. Launches on `stream` on card `device`
// (the caller's current card is set back after); returns a cudaError_t.
int dpgo_nesterov_extrapolate(int device, int d, int r, int n, const float* Z, const float* X,
                              const float* Xp, const float* V, const float* mask,
                              const float* beta, float* X_acc, float* V_new, void* stream) {
  if (n < 1 || r < 1 || r > 8 || (d != 2 && d != 3)) return (int)cudaErrorInvalidValue;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = d == 2 ? launch_rank<2>(r, n, Z, X, Xp, V, mask, beta, X_acc, V_new, s)
                        : launch_rank<3>(r, n, Z, X, Xp, V, mask, beta, X_acc, V_new, s);
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

}  // extern "C"
