// K1: fused forward pass of the failure-prediction MLP.
//
// Replaces manatee_tpu/health/predictor.py::_logits + predict (:55-66),
// which XLA compiled for the TPU:
//
//   windows [B, 16, 5] fp32, read as [B, 80]
//   -> relu(x W1[80x32] + b1) -> relu(. W2[32x32] + b2) -> . W3[32x1] + b3
//   -> sigmoid -> [B] fp32
//
// Bound on an H100 SXM: each row costs 324 bytes of device memory (80
// inputs read, one output written) and 7,232 fp32 FLOP (2 * (80*32 +
// 32*32 + 32)), about 22 FLOP a byte against the card's 20 (67 TFLOP/s
// of non-tensor fp32 over 3.35 TB/s).  So the kernel sits at the ridge,
// slightly on the operations side: the FMAs and the operand traffic that
// feeds them matter as much as the input stream.
//
// Design (right and simple first):
// * every block stages all weights (3,681 floats, 14.7 KB) in shared
//   memory, and its tile of kRows input rows with coalesced loads;
// * one thread per row computes all three layers in fp32 FMAs held in
//   registers; weight reads are warp-uniform (shared-memory broadcast,
//   float4 wide), row reads use an odd pitch so a warp's 32 rows fall in
//   32 different banks;
// * no tensor cores: the reference computes in IEEE fp32, and TF32 would
//   not hold the 1e-5 tolerance against it;
// * the grid is ceil(B / kRows); the last block masks its tail.
//
// Plain C entry point, so the library is built by nvcc alone and loaded
// with ctypes (manatee_tpu_torch/kernels/mlp_forward.py).

#include <cuda_runtime.h>

namespace {

constexpr int kIn = 16 * 5;        // WINDOW * N_FEATURES
constexpr int kHidden = 32;
constexpr int kRows = 64;          // rows, and threads, per block
constexpr int kPitch = kIn + 1;    // odd: conflict-free per-thread row reads

// offsets of the staged weights; W1 and W2 start 16-byte aligned
constexpr int kW1 = 0;
constexpr int kB1 = kW1 + kIn * kHidden;
constexpr int kW2 = kB1 + kHidden;
constexpr int kB2 = kW2 + kHidden * kHidden;
constexpr int kW3 = kB2 + kHidden;
constexpr int kB3 = kW3 + kHidden;
constexpr int kWeights = kB3 + 1;
static_assert(kW2 % 4 == 0, "W2 must stay float4-aligned in shared memory");

__global__ void __launch_bounds__(kRows)
mlp_forward_kernel(const float* __restrict__ x,
                   const float* __restrict__ w1, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ w3, const float* __restrict__ b3,
                   float* __restrict__ out, int batch) {
  __shared__ __align__(16) float sw[kWeights];
  __shared__ float sx[kRows * kPitch];

  const int t = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kRows), batch - row0));

  for (int i = t; i < kIn * kHidden; i += kRows) sw[kW1 + i] = w1[i];
  for (int i = t; i < kHidden * kHidden; i += kRows) sw[kW2 + i] = w2[i];
  if (t < kHidden) {
    sw[kB1 + t] = b1[t];
    sw[kB2 + t] = b2[t];
    sw[kW3 + t] = w3[t];
  }
  if (t == 0) sw[kB3] = b3[0];

  const float* tile = x + row0 * kIn;
  for (int i = t; i < rows * kIn; i += kRows)
    sx[(i / kIn) * kPitch + i % kIn] = tile[i];
  __syncthreads();
  if (t >= rows) return;

  // layer 1: the sum over k first, the bias after, as x @ w1 + b1 does
  const float* xr = sx + t * kPitch;
  float h1[kHidden];
#pragma unroll
  for (int j = 0; j < kHidden; ++j) h1[j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < kIn; ++k) {
    const float xk = xr[k];
    const float4* wr = reinterpret_cast<const float4*>(sw + kW1 + k * kHidden);
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
  for (int j = 0; j < kHidden; ++j) h1[j] = fmaxf(h1[j] + sw[kB1 + j], 0.f);

  // layer 2: fully unrolled so h1 and h2 stay in registers
  float h2[kHidden];
#pragma unroll
  for (int j = 0; j < kHidden; ++j) h2[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kHidden; ++k) {
    const float4* wr = reinterpret_cast<const float4*>(sw + kW2 + k * kHidden);
#pragma unroll
    for (int q = 0; q < kHidden / 4; ++q) {
      const float4 w = wr[q];
      h2[4 * q + 0] = fmaf(h1[k], w.x, h2[4 * q + 0]);
      h2[4 * q + 1] = fmaf(h1[k], w.y, h2[4 * q + 1]);
      h2[4 * q + 2] = fmaf(h1[k], w.z, h2[4 * q + 2]);
      h2[4 * q + 3] = fmaf(h1[k], w.w, h2[4 * q + 3]);
    }
  }

  // layer 3 and the sigmoid, as torch.sigmoid computes it in fp32
  float z = 0.f;
#pragma unroll
  for (int j = 0; j < kHidden; ++j)
    z = fmaf(fmaxf(h2[j] + sw[kB2 + j], 0.f), sw[kW3 + j], z);
  z += sw[kB3];
  out[row0 + t] = 1.f / (1.f + expf(-z));
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

// Launches K1 on `stream` (a cudaStream_t) of `device` over `batch` >= 1
// rows; every pointer is a contiguous fp32 device buffer in the
// reference layout (w1 [80,32], b1 [32], w2 [32,32], b2 [32], w3 [32,1],
// b3 [1], out [batch]).  Returns the cudaError_t of the launch; it does
// not synchronise.
extern "C" int mlp_forward_launch(const float* x, const float* w1,
                                  const float* b1, const float* w2,
                                  const float* b2, const float* w3,
                                  const float* b3, float* out, int batch,
                                  int device, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(batch) + kRows - 1) / kRows);
  return on_device(device, [&] {
    mlp_forward_kernel<<<blocks, kRows, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        x, w1, b1, w2, b2, w3, b3, out, batch);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* mlp_forward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
