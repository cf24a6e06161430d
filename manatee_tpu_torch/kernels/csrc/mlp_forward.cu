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
// of non-tensor fp32 over 3.35 TB/s).  So at bulk the kernel sits at the
// ridge, slightly on the operations side.  At the batches the scoring
// path gives it (one window a tick, a trace's few hundred) no bound of
// bytes or FLOP applies: a launch is latency.
//
// Every output is one fixed chain of fp32 operations, the same in both
// launch shapes below: h1[j] is an fmaf chain over k = 0..79 from 0,
// then relu(. + b1[j]); h2[j] the same over k = 0..31; z an fmaf chain
// over j = 0..31 of relu(h2[j] + b2[j]) * w3[j] from 0, then + b3 and
// 1 / (1 + exp(-z)).  The shapes differ in which thread runs which
// chain and where its operands live, never in the chain, so they give
// the same bits.  No tensor cores: the reference computes in IEEE fp32.
//
// Two launch shapes, chosen by the wrapper from the batch
// (manatee_tpu_torch/kernels/mlp_forward.py):
// * rows (shape 0), for small batches: one warp per row.  Lane j owns
//   hidden unit j and keeps its column of W1 and W2 in registers, read
//   straight from global memory (coalesced across lanes, L2-resident
//   between launches).  The row's inputs, then h1, then relu(h2 + b2)
//   go through the warp's own slice of shared memory and reach every
//   lane as float4 broadcasts.  No block barrier (__syncwarp only), so
//   the first FMA waits only for the loads.  A warp loops over rows when
//   the grid is capped.
// * tiles (shape 1), for bulk: a persistent grid.  Each block stages
//   the weights in shared memory once (by cp.async, with its first input
//   chunk), then walks its row tiles of 128 rows, a row a thread.
//   The inputs arrive 16 columns at a time by cp.async into a ring of
//   five chunk buffers, four chunks ahead of the one computed: a whole
//   tile is in flight at once, and the next tile's first chunks arrive
//   while this tile's last are computed.
//   Weight reads are warp-uniform float4 broadcasts; input reads use an
//   odd pitch, so a warp's 32 rows fall in 32 banks.  Layer 2 runs in
//   groups of 8 outputs, each folded into z at once, in j order, so only
//   32 + 8 accumulators are live.
// The crossover between the shapes comes from the card's timing of both
// (kernels/mlp_forward.py).
//
// Plain C entry point, so the library is built by nvcc alone and loaded
// with ctypes (manatee_tpu_torch/kernels/mlp_forward.py).

#include <cuda_runtime.h>

namespace {

constexpr int kIn = 16 * 5;        // WINDOW * N_FEATURES
constexpr int kHidden = 32;

// rows shape: a warp's shared slice holds x, h1, relu(h2 + b2) and w3
constexpr int kRowWarps = 4;       // warps, and rows in flight, per block
constexpr int kSliceH1 = kIn;
constexpr int kSliceR2 = kSliceH1 + kHidden;
constexpr int kSliceW3 = kSliceR2 + kHidden;
constexpr int kSlice = kSliceW3 + kHidden;
static_assert(kIn % 4 == 0 && kSliceH1 % 4 == 0 && kSliceR2 % 4 == 0 &&
              kSliceW3 % 4 == 0, "float4 reads of the slice");

// tiles shape
constexpr int kTileThreads = 128;
constexpr int kChunk = 16;         // input columns per pipeline stage
constexpr int kChunks = kIn / kChunk;
constexpr int kCPitch = kChunk + 1;  // odd: conflict-free per-thread reads
constexpr int kStages = kChunks;   // stage buffers: a whole tile in flight
static_assert(kIn % kChunk == 0 && kChunk % 4 == 0, "whole float4 chunks");

// offsets of the staged weights; W1 and W2 start 16-byte aligned
constexpr int kW1 = 0;
constexpr int kB1 = kW1 + kIn * kHidden;
constexpr int kW2 = kB1 + kHidden;
constexpr int kB2 = kW2 + kHidden * kHidden;
constexpr int kW3 = kB2 + kHidden;
constexpr int kB3 = kW3 + kHidden;
constexpr int kWeights = kB3 + 1;
constexpr int kWeightsPad = (kWeights + 3) / 4 * 4;
static_assert(kW2 % 4 == 0, "W2 must stay float4-aligned in shared memory");

__global__ void __launch_bounds__(kRowWarps * 32)
mlp_forward_rows(const float* __restrict__ x,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 float* __restrict__ out, int batch) {
  // each warp's slice: the row's inputs, h1, relu(h2 + b2) and w3
  __shared__ __align__(16) float slices[kRowWarps][kSlice];
  const int lane = threadIdx.x & 31;
  float* sl = slices[threadIdx.x >> 5];
  const long long warps = static_cast<long long>(gridDim.x) * kRowWarps;
  long long row = static_cast<long long>(blockIdx.x) * kRowWarps +
                  (threadIdx.x >> 5);
  if (row >= batch) return;        // uniform across the warp

  // lane j: column j of W1 and W2, b1[j], b2[j]; w3 in the slice
  float c1[kIn], c2[kHidden];
#pragma unroll
  for (int k = 0; k < kIn; ++k) c1[k] = w1[k * kHidden + lane];
#pragma unroll
  for (int k = 0; k < kHidden; ++k) c2[k] = w2[k * kHidden + lane];
  const float bias1 = b1[lane], bias2 = b2[lane], bias3 = b3[0];
  sl[kSliceW3 + lane] = w3[lane];

  for (; row < batch; row += warps) {
    const float* xr = x + row * kIn;
    sl[lane] = xr[lane];
    sl[32 + lane] = xr[32 + lane];
    if (lane < kIn - 64) sl[64 + lane] = xr[64 + lane];
    __syncwarp();

    // layer 1: the sum over k first, the bias after, as x @ w1 + b1 does
    float h = 0.f;
#pragma unroll
    for (int k = 0; k < kIn; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(sl + k);
      h = fmaf(v.x, c1[k + 0], h);
      h = fmaf(v.y, c1[k + 1], h);
      h = fmaf(v.z, c1[k + 2], h);
      h = fmaf(v.w, c1[k + 3], h);
    }
    sl[kSliceH1 + lane] = fmaxf(h + bias1, 0.f);
    __syncwarp();

    // layer 2
    float g = 0.f;
#pragma unroll
    for (int k = 0; k < kHidden; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(sl + kSliceH1 + k);
      g = fmaf(v.x, c2[k + 0], g);
      g = fmaf(v.y, c2[k + 1], g);
      g = fmaf(v.z, c2[k + 2], g);
      g = fmaf(v.w, c2[k + 3], g);
    }
    sl[kSliceR2 + lane] = fmaxf(g + bias2, 0.f);
    __syncwarp();

    // layer 3 and the sigmoid, as torch.sigmoid computes it in fp32;
    // every lane runs the chain on broadcast values
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < kHidden; j += 4) {
      const float4 r = *reinterpret_cast<const float4*>(sl + kSliceR2 + j);
      const float4 w = *reinterpret_cast<const float4*>(sl + kSliceW3 + j);
      z = fmaf(r.x, w.x, z);
      z = fmaf(r.y, w.y, z);
      z = fmaf(r.z, w.z, z);
      z = fmaf(r.w, w.w, z);
    }
    z += bias3;
    if (lane == 0) out[row] = 1.f / (1.f + expf(-z));
    __syncwarp();                  // the slice is refilled for the next row
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(addr), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

constexpr int kTileSmemFloats = kWeightsPad + kStages * kTileThreads * kCPitch;

__global__ void __launch_bounds__(kTileThreads)
mlp_forward_tiles(const float* __restrict__ x,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ w3, const float* __restrict__ b3,
                  float* __restrict__ out, int batch) {
  constexpr int kTile = kTileThreads;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  float* sx = smem + kWeightsPad;  // kStages buffers of kTile * kCPitch

  const int t = threadIdx.x;
  const long long tiles = (static_cast<long long>(batch) + kTile - 1) / kTile;
  const long long mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long stages = mine * kChunks;

  // stage s: chunk s % kChunks of this block's tile s / kChunks, into
  // buffer s % kStages; every thread commits one group per stage, empty
  // or not, so that the wait below counts stages
  auto fetch = [&](long long s) {
    if (s < stages) {
      const long long row0 =
          (blockIdx.x + (s / kChunks) * gridDim.x) * kTile;
      const int rows = static_cast<int>(
          min(static_cast<long long>(kTile), batch - row0));
      const float* src = x + row0 * kIn + (s % kChunks) * kChunk;
      float* dst = sx + (s % kStages) * (kTile * kCPitch);
      for (int i = t; i < rows * kChunk; i += kTileThreads)
        cp_async4(dst + (i / kChunk) * kCPitch + i % kChunk,
                  src + static_cast<long long>(i / kChunk) * kIn +
                      i % kChunk);
    }
    cp_async_commit();
  };

  // the weights by cp.async too, in stage 0's group: no thread waits on
  // a load before the first wait below
  auto stage = [&](int at, const float* src, int n) {
    for (int i = t; i < n; i += kTileThreads) cp_async4(sw + at + i, src + i);
  };
  stage(kW1, w1, kIn * kHidden);
  stage(kB1, b1, kHidden);
  stage(kW2, w2, kHidden * kHidden);
  stage(kB2, b2, kHidden);
  stage(kW3, w3, kHidden);
  stage(kB3, b3, 1);
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  float h1[kHidden];
  for (long long s = 0; s < stages; ++s) {
    fetch(s + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();               // stage s has landed (and, at 0, sw)
    const int chunk = static_cast<int>(s % kChunks);
    const float* buf = sx + (s % kStages) * (kTile * kCPitch);

    if (chunk == 0) {
#pragma unroll
      for (int j = 0; j < kHidden; ++j) h1[j] = 0.f;
    }
    // layer 1 over this chunk's columns, k in order
#pragma unroll 4
    for (int kk = 0; kk < kChunk; ++kk) {
      const float xk = buf[t * kCPitch + kk];
      const float4* wr = reinterpret_cast<const float4*>(
          sw + kW1 + (chunk * kChunk + kk) * kHidden);
#pragma unroll
      for (int q = 0; q < kHidden / 4; ++q) {
        const float4 w = wr[q];
        h1[4 * q + 0] = fmaf(xk, w.x, h1[4 * q + 0]);
        h1[4 * q + 1] = fmaf(xk, w.y, h1[4 * q + 1]);
        h1[4 * q + 2] = fmaf(xk, w.z, h1[4 * q + 2]);
        h1[4 * q + 3] = fmaf(xk, w.w, h1[4 * q + 3]);
      }
    }

    if (chunk == kChunks - 1) {
#pragma unroll
      for (int j = 0; j < kHidden; ++j)
        h1[j] = fmaxf(h1[j] + sw[kB1 + j], 0.f);

      // layer 2 in groups of 8 outputs, each folded into z in j order
      float z = 0.f;
#pragma unroll
      for (int g = 0; g < kHidden; g += 8) {
        float a[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) a[jj] = 0.f;
#pragma unroll
        for (int k = 0; k < kHidden; ++k) {
          const float4* wr =
              reinterpret_cast<const float4*>(sw + kW2 + k * kHidden + g);
          const float4 u = wr[0], v = wr[1];
          a[0] = fmaf(h1[k], u.x, a[0]);
          a[1] = fmaf(h1[k], u.y, a[1]);
          a[2] = fmaf(h1[k], u.z, a[2]);
          a[3] = fmaf(h1[k], u.w, a[3]);
          a[4] = fmaf(h1[k], v.x, a[4]);
          a[5] = fmaf(h1[k], v.y, a[5]);
          a[6] = fmaf(h1[k], v.z, a[6]);
          a[7] = fmaf(h1[k], v.w, a[7]);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          z = fmaf(fmaxf(a[jj] + sw[kB2 + g + jj], 0.f), sw[kW3 + g + jj], z);
      }

      const long long row =
          (blockIdx.x + (s / kChunks) * gridDim.x) * kTile + t;
      z += sw[kB3];
      if (row < batch) out[row] = 1.f / (1.f + expf(-z));
    }
    __syncthreads();               // buffer s % kStages is refilled next
  }
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
// rows, in launch shape `shape` (0: a warp per row; 1: tiles of 128
// rows, a row a thread) on a grid of `blocks` >= 1 blocks; every
// pointer is a contiguous fp32 device buffer in the reference layout
// (w1 [80,32], b1 [32], w2 [32,32], b2 [32], w3 [32,1], b3 [1], out
// [batch]).  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for another shape or no blocks); it does not synchronise.
extern "C" int mlp_forward_launch(const float* x, const float* w1,
                                  const float* b1, const float* w2,
                                  const float* b2, const float* w3,
                                  const float* b3, float* out, int batch,
                                  int shape, int blocks, int device,
                                  void* stream) {
  if (batch < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    switch (shape) {
      case 0:
        mlp_forward_rows<<<blocks, kRowWarps * 32, 0, s>>>(
            x, w1, b1, w2, b2, w3, b3, out, batch);
        return static_cast<int>(cudaGetLastError());
      case 1: {
        constexpr size_t bytes = kTileSmemFloats * sizeof(float);
        const cudaError_t err = cudaFuncSetAttribute(
            mlp_forward_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
        mlp_forward_tiles<<<blocks, kTileThreads, bytes, s>>>(
            x, w1, b1, w2, b2, w3, b3, out, batch);
        return static_cast<int>(cudaGetLastError());
      }
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

extern "C" const char* mlp_forward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
