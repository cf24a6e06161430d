// K2: the fused training step of the failure-prediction MLP.
//
// Replaces manatee_tpu/health/predictor.py::_loss + train_step (:69-83),
// which XLA compiled for the TPU: mean stable binary cross-entropy of
// the logits, value_and_grad over the six tensors, SGD p - lr * g.
//
// Two kernels:
//   K2a mlp_train_partials: windows [B,16,5], labels [B], weights
//       -> partials [ceil(B/64), 3682]: each block's un-normalised sums
//          of the 3,681 gradient entries (w1 b1 w2 b2 w3 b3, row-major)
//          and of the loss;
//   K2b mlp_sgd_apply: partials [n, 3682] -> sums [3682] = scale * the
//       sum over n in block order, and, when asked, p - lr * sums for
//       each parameter, written to new tensors.
// No float atomics anywhere, so a rerun gives the same bits.
//
// dL/dz is JAX's, tie included: m(z) - y - s(z) e/(1+e), e = exp(-|z|),
// m = 1, 1/2, 0 for z >, =, < 0 (jnp.maximum splits a tie), s = +1 for
// z >= 0 and -1 below (JAX's d|z|/dz at 0): -y at z = 0.  Hidden ReLUs
// pass no gradient at 0 (jax.nn.relu's rule).
//
// Bound on an H100 SXM: a row reads 81 floats (324 bytes) and costs
// ~16,600 fp32 operations (the forward's 7,232, the weight gradients'
// 7,232, the hidden delta's 2,048, the biases' and the loss's ~100);
// each block of 64 rows writes 3,682 floats (230 bytes a row).  About
// 30 operations a byte against the card's 20: bound by operations.
//
// Design (right and simple first):
// * K2a: 128 threads a block, 64 rows.  All weights (3,681 floats) and
//   the tile's inputs are staged in shared memory.  Phase 1: one thread
//   per row runs the forward pass in registers as K1 does, then the
//   row's own backward (dz, the layer-2 delta d2 = dz w3 relu'(h2), the
//   layer-1 delta d1 = (d2 W2^T) relu'(h1)), and leaves x, h1, h2, d1,
//   d2, dz and the loss term in shared memory.  Phase 2: each thread
//   owns output entries and sums the tile's rows for each in row order
//   (x_m d1_k for w1, h1_k d2_j for w2, h2_j dz for w3, the deltas for
//   the biases).  Every region of the flat layout starts at a multiple
//   of 32 entries, so a warp never straddles two; within a warp one
//   operand is a broadcast and the other 32 consecutive words.
//   Row tiles use an odd pitch so a warp's per-row accesses hit 32 banks.
// * Sums run in double (phase 2 and K2b): with float32 sums in a fixed
//   order, 65,537 like rows drifted 1.2e-5 from the plain version's
//   pairwise sums (measured on an H100), past the 1e-5 tolerance.
// * K2b: one thread per entry reads the partials down its column
//   (coalesced across the warp), in block order.
//
// Plain C entry points, loaded with ctypes
// (manatee_tpu_torch/kernels/mlp_train.py).

#include <cuda_runtime.h>

namespace {

constexpr int kIn = 16 * 5;
constexpr int kHidden = 32;
constexpr int kRows = 64;            // rows per K2a block
constexpr int kThreads = 128;        // threads per K2a block
constexpr int kPX = kIn + 1;         // odd pitches: conflict-free row access
constexpr int kPH = kHidden + 1;

// flat layout of the weights, and of the gradient; the loss sum follows
constexpr int kW1 = 0;
constexpr int kB1 = kW1 + kIn * kHidden;
constexpr int kW2 = kB1 + kHidden;
constexpr int kB2 = kW2 + kHidden * kHidden;
constexpr int kW3 = kB2 + kHidden;
constexpr int kB3 = kW3 + kHidden;
constexpr int kParams = kB3 + 1;     // 3,681
constexpr int kOut = kParams + 1;    // 3,682 entries a block
static_assert(kW2 % 4 == 0, "W2 must stay float4-aligned in shared memory");
static_assert(kB1 % 32 == 0 && kW2 % 32 == 0 && kB2 % 32 == 0 &&
              kW3 % 32 == 0 && kB3 % 32 == 0,
              "regions of the flat layout start on a warp boundary");

// shared memory of K2a, in floats
constexpr int kSW = 0;
constexpr int kSX = (kParams + 3) / 4 * 4;
constexpr int kSH1 = kSX + kRows * kPX;
constexpr int kSH2 = kSH1 + kRows * kPH;
constexpr int kSD1 = kSH2 + kRows * kPH;
constexpr int kSD2 = kSD1 + kRows * kPH;
constexpr int kSDZ = kSD2 + kRows * kPH;
constexpr int kSLoss = kSDZ + kRows;
constexpr int kSmemFloats = kSLoss + kRows;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);   // 69,776

__global__ void __launch_bounds__(kThreads)
mlp_train_partials_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const float* __restrict__ w2,
                          const float* __restrict__ b2,
                          const float* __restrict__ w3,
                          const float* __restrict__ b3,
                          float* __restrict__ partials, int batch) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem + kSW;
  float* sx = smem + kSX;
  float* sh1 = smem + kSH1;
  float* sh2 = smem + kSH2;
  float* sd1 = smem + kSD1;
  float* sd2 = smem + kSD2;
  float* sdz = smem + kSDZ;
  float* sloss = smem + kSLoss;

  const int t = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kRows), batch - row0));

  for (int i = t; i < kIn * kHidden; i += kThreads) sw[kW1 + i] = w1[i];
  for (int i = t; i < kHidden * kHidden; i += kThreads) sw[kW2 + i] = w2[i];
  if (t < kHidden) {
    sw[kB1 + t] = b1[t];
    sw[kB2 + t] = b2[t];
    sw[kW3 + t] = w3[t];
  }
  if (t == 0) sw[kB3] = b3[0];
  const float* tile = x + row0 * kIn;
  for (int i = t; i < rows * kIn; i += kThreads)
    sx[(i / kIn) * kPX + i % kIn] = tile[i];
  __syncthreads();

  // phase 1: one thread per row, forward and the row's own backward
  if (t < rows) {
    const float* xr = sx + t * kPX;
    float h1[kHidden];
#pragma unroll
    for (int j = 0; j < kHidden; ++j) h1[j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kIn; ++k) {
      const float xk = xr[k];
      const float4* wr =
          reinterpret_cast<const float4*>(sw + kW1 + k * kHidden);
#pragma unroll
      for (int q = 0; q < kHidden / 4; ++q) {
        const float4 w = wr[q];
        h1[4 * q + 0] = fmaf(xk, w.x, h1[4 * q + 0]);
        h1[4 * q + 1] = fmaf(xk, w.y, h1[4 * q + 1]);
        h1[4 * q + 2] = fmaf(xk, w.z, h1[4 * q + 2]);
        h1[4 * q + 3] = fmaf(xk, w.w, h1[4 * q + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < kHidden; ++j) {
      h1[j] = fmaxf(h1[j] + sw[kB1 + j], 0.f);
      sh1[t * kPH + j] = h1[j];
    }

    float h2[kHidden];
#pragma unroll
    for (int j = 0; j < kHidden; ++j) h2[j] = 0.f;
#pragma unroll
    for (int k = 0; k < kHidden; ++k) {
      const float4* wr =
          reinterpret_cast<const float4*>(sw + kW2 + k * kHidden);
#pragma unroll
      for (int q = 0; q < kHidden / 4; ++q) {
        const float4 w = wr[q];
        h2[4 * q + 0] = fmaf(h1[k], w.x, h2[4 * q + 0]);
        h2[4 * q + 1] = fmaf(h1[k], w.y, h2[4 * q + 1]);
        h2[4 * q + 2] = fmaf(h1[k], w.z, h2[4 * q + 2]);
        h2[4 * q + 3] = fmaf(h1[k], w.w, h2[4 * q + 3]);
      }
    }
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < kHidden; ++j) {
      h2[j] = fmaxf(h2[j] + sw[kB2 + j], 0.f);
      sh2[t * kPH + j] = h2[j];
      z = fmaf(h2[j], sw[kW3 + j], z);
    }
    z += sw[kB3];

    // the loss term and dL/dz with JAX's tie rule
    const float label = y[row0 + t];
    const float e = expf(-fabsf(z));
    sloss[t] = (fmaxf(z, 0.f) - z * label) + log1pf(e);
    const float m = z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f);
    const float s = z >= 0.f ? 1.f : -1.f;
    const float dz = (m - label) - s * (e / (1.f + e));
    sdz[t] = dz;

    float d2[kHidden];
#pragma unroll
    for (int j = 0; j < kHidden; ++j) {
      d2[j] = h2[j] > 0.f ? dz * sw[kW3 + j] : 0.f;
      sd2[t * kPH + j] = d2[j];
    }
#pragma unroll
    for (int k = 0; k < kHidden; ++k) {
      const float4* wr =
          reinterpret_cast<const float4*>(sw + kW2 + k * kHidden);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kHidden / 4; ++q) {
        const float4 w = wr[q];
        acc = fmaf(d2[4 * q + 0], w.x, acc);
        acc = fmaf(d2[4 * q + 1], w.y, acc);
        acc = fmaf(d2[4 * q + 2], w.z, acc);
        acc = fmaf(d2[4 * q + 3], w.w, acc);
      }
      sd1[t * kPH + k] = h1[k] > 0.f ? acc : 0.f;
    }
  }
  __syncthreads();

  // phase 2: each thread owns entries and sums the tile's rows in order,
  // in double: a float32 product is exact there, so a partial carries one
  // rounding, whatever the rows
  float* out = partials + static_cast<long long>(blockIdx.x) * kOut;
  for (int e = t; e < kOut; e += kThreads) {
    double acc = 0.0;
    if (e < kB1) {                               // w1[m][k]: x_m d1_k
      const int m = e / kHidden, k = e % kHidden;
      for (int r = 0; r < rows; ++r)
        acc = fma(double(sx[r * kPX + m]), double(sd1[r * kPH + k]), acc);
    } else if (e < kW2) {                        // b1[k]: d1_k
      for (int r = 0; r < rows; ++r) acc += sd1[r * kPH + (e - kB1)];
    } else if (e < kB2) {                        // w2[k][j]: h1_k d2_j
      const int k = (e - kW2) / kHidden, j = (e - kW2) % kHidden;
      for (int r = 0; r < rows; ++r)
        acc = fma(double(sh1[r * kPH + k]), double(sd2[r * kPH + j]), acc);
    } else if (e < kW3) {                        // b2[j]: d2_j
      for (int r = 0; r < rows; ++r) acc += sd2[r * kPH + (e - kB2)];
    } else if (e < kB3) {                        // w3[j]: h2_j dz
      for (int r = 0; r < rows; ++r)
        acc = fma(double(sh2[r * kPH + (e - kW3)]), double(sdz[r]), acc);
    } else if (e == kB3) {                       // b3: dz
      for (int r = 0; r < rows; ++r) acc += sdz[r];
    } else {                                     // the loss
      for (int r = 0; r < rows; ++r) acc += sloss[r];
    }
    out[e] = static_cast<float>(acc);
  }
}

struct Params {
  const float* p[6];
  float* out[6];
};

__global__ void mlp_sgd_apply_kernel(const float* __restrict__ partials,
                                     float* __restrict__ sums, int n,
                                     float scale, float lr, int apply,
                                     Params params) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kOut) return;
  // in double, in block order: the sum of many like partials (rows that
  // look alike) does not drift, and a rerun gives the same bits
  double acc = 0.0;
  for (int b = 0; b < n; ++b)
    acc += partials[static_cast<long long>(b) * kOut + e];
  // then one rounding per operation, as the plain version's torch ops
  const float g = __fmul_rn(static_cast<float>(acc), scale);
  sums[e] = g;
  if (!apply || e >= kParams) return;
  // constant indices only: the parameter struct stays in registers
  int i, at;
  if (e < kB1) { i = 0; at = e - kW1; }
  else if (e < kW2) { i = 1; at = e - kB1; }
  else if (e < kB2) { i = 2; at = e - kW2; }
  else if (e < kW3) { i = 3; at = e - kB2; }
  else if (e < kB3) { i = 4; at = e - kW3; }
  else { i = 5; at = e - kB3; }
  const float* p = i == 0 ? params.p[0] : i == 1 ? params.p[1]
                 : i == 2 ? params.p[2] : i == 3 ? params.p[3]
                 : i == 4 ? params.p[4] : params.p[5];
  float* q = i == 0 ? params.out[0] : i == 1 ? params.out[1]
           : i == 2 ? params.out[2] : i == 3 ? params.out[3]
           : i == 4 ? params.out[4] : params.out[5];
  q[at] = __fsub_rn(p[at], __fmul_rn(lr, g));
}

// Runs launch() with `device` current and makes the caller's device current
// again on every return path, so that a process driving several cards keeps
// its own current device across a launch.  Returns launch()'s cudaError_t,
// or the error of getting or setting the device.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return static_cast<int>(err);
  const int rc = launch();
  if (prev != device && (err = cudaSetDevice(prev)) != cudaSuccess && rc == 0)
    return static_cast<int>(err);
  return rc;
}

}  // namespace

// Launches K2a on `stream` (a cudaStream_t) of `device` over `batch` >= 1
// rows: x [batch, 80], y [batch] and the reference-layout weights are
// contiguous fp32 device buffers, partials [ceil(batch/64), 3682].
// Returns the cudaError_t of the launch; it does not synchronise.
extern "C" int mlp_train_partials_launch(
    const float* x, const float* y, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    float* partials, int batch, int device, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(batch) + kRows - 1) / kRows);
  return on_device(device, [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_train_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    mlp_train_partials_kernel<<<blocks, kThreads, kSmemBytes,
                                static_cast<cudaStream_t>(stream)>>>(
        x, y, w1, b1, w2, b2, w3, b3, partials, batch);
    return static_cast<int>(cudaGetLastError());
  });
}

// Launches K2b: sums [3682] = scale * the sum of partials [n, 3682] over
// n; when `apply` is non-zero, out_i = p_i - lr * (its slice of sums)
// for the six parameters p0..p5 (reference layout) into out0..out5.
extern "C" int mlp_sgd_apply_launch(
    const float* partials, float* sums, int n, float scale, float lr,
    int apply, const float* p0, const float* p1, const float* p2,
    const float* p3, const float* p4, const float* p5, float* out0,
    float* out1, float* out2, float* out3, float* out4, float* out5,
    int device, void* stream) {
  const Params params{{p0, p1, p2, p3, p4, p5},
                      {out0, out1, out2, out3, out4, out5}};
  constexpr int kThreadsApply = 256;
  return on_device(device, [&] {
    mlp_sgd_apply_kernel<<<(kOut + kThreadsApply - 1) / kThreadsApply,
                           kThreadsApply, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        partials, sums, n, scale, lr, apply, params);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* mlp_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
