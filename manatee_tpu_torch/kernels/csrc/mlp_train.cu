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
// ~9,300 fp32 operations (the forward's 7,232, the hidden delta's 2,048,
// d2, dz and the loss term) and ~7,300 fp64 ones (the weight gradients'
// 3,616 FMAs and the bias and loss sums); each block of 64 rows writes
// 3,682 floats (230 bytes a row).  At 34 TFLOP/s of fp64 the sums bound
// it: operations, not bytes.
//
// Every output is one fixed chain of operations: each activation and
// delta an fmaf chain in index order (h1, h2 over k; z over j; d1[k] over
// j), each gradient entry a double fma chain over the tile's rows in row
// order, rounded once to float.  The design fixes which thread runs
// which chain and where its operands live, never the chain itself.
//
// Design:
// * K2a: a block is one 64-row tile (kRows) and one slice of the 3,682
//   entries; the grid is tiles x slices (blockIdx.y), so a small batch
//   still spreads over the card (B = 256: 4 tiles x 15 slices).  Each
//   block stages all weights and its tile's inputs in shared memory, by
//   cp.async, so every thread's loads are in flight at once.
//   Phase 1, a warp per row: each of the 8 warps runs 8 rows at once, lane
//   j owning hidden unit j (h1[j], h2[j], d2[j]) and, for the hidden
//   delta, lane k owning d1[k]; the inputs and h1, h2, d2 reach every
//   lane as float4 broadcasts from shared memory, W2 is staged with an
//   odd pitch so that both its columns (forward) and rows (d1) read
//   conflict-free, and lane i < 8 runs row i's z, loss and dz.  Phase 1
//   leaves x, h1, h2, d1, d2, dz and the loss term in shared memory.
//   Phase 2: each thread owns entries of the block's slice and sums the
//   tile's rows for each in row order (x_m d1_k for w1, h1_k d2_j for
//   w2, h2_j dz for w3, the deltas for the biases).  Slices are whole
//   multiples of 256 entries and every region of the flat layout starts
//   at a multiple of 32, so a warp never straddles two; within a warp
//   one operand is a broadcast and the other 32 consecutive words.
//   Every slice's block recomputes its tile's phase 1, which keeps K2a
//   one launch with its arguments as they were (a second kernel would
//   add a launch and device-memory scratch for the activations).  Slices
//   shrink as tiles grow, so at bulk a tile has one block and nothing is
//   recomputed.
// * Sums run in double (phase 2 and K2b): with float32 sums in a fixed
//   order, 65,537 like rows drifted 1.2e-5 from the plain version's
//   pairwise sums (measured on an H100), past the 1e-5 tolerance.
// * K2b: an entry's sum is one double chain over the n partials in
//   block order, so one thread runs it.  Bound: bytes (n x 14,728 read).
//   A thread an entry reads its parameter before its sum, then its
//   column in whole groups of kApplyWide rows and the rest kApplyGroup
//   rows at a time (every path sends 1 row, the mesh step, or 4, a
//   training step), a group's loads all before its first add.  Block
//   size and group widths are a sweep's on an H100 (PERF.md).
//
// Plain C entry points, loaded with ctypes
// (manatee_tpu_torch/kernels/mlp_train.py).

#include <cuda_runtime.h>

namespace {

constexpr int kIn = 16 * 5;
constexpr int kHidden = 32;
constexpr int kRows = 64;            // rows per K2a tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;  // threads per K2a block
constexpr int kWarpRows = kRows / kWarps;  // rows each warp runs at once
constexpr int kPW2 = kHidden + 1;    // odd pitch of the staged W2
constexpr int kPH = kHidden + 4;     // 16-byte rows; 8 rows hit 8 bank quads
constexpr unsigned kAll = 0xffffffffu;

// flat layout of the weights, and of the gradient; the loss sum follows
constexpr int kW1 = 0;
constexpr int kB1 = kW1 + kIn * kHidden;
constexpr int kW2 = kB1 + kHidden;
constexpr int kB2 = kW2 + kHidden * kHidden;
constexpr int kW3 = kB2 + kHidden;
constexpr int kB3 = kW3 + kHidden;
constexpr int kParams = kB3 + 1;     // 3,681
constexpr int kOut = kParams + 1;    // 3,682 entries a block
constexpr int kSlice = kThreads;     // entries a slice takes per pass
constexpr int kMaxSlices = (kOut + kSlice - 1) / kSlice;   // 15
// tiles x slices aimed at: two blocks on each of an H100's 132 SMs
constexpr int kTargetBlocks = 264;
static_assert(kB1 % 32 == 0 && kW2 % 32 == 0 && kB2 % 32 == 0 &&
              kW3 % 32 == 0 && kB3 % 32 == 0 && kSlice % 32 == 0,
              "regions of the flat layout start on a warp boundary");
static_assert(kWarpRows == 8, "lane i < 8 runs row i's z");

// shared memory of K2a, in floats
constexpr int kSW1 = 0;
constexpr int kSW2 = kSW1 + kIn * kHidden;
constexpr int kSB1 = kSW2 + kHidden * kPW2;
constexpr int kSB2 = kSB1 + kHidden;
constexpr int kSW3 = kSB2 + kHidden;
constexpr int kSB3 = kSW3 + kHidden;
constexpr int kSX = (kSB3 + 1 + 3) / 4 * 4;
constexpr int kSH1 = kSX + kRows * kIn;
constexpr int kSH2 = kSH1 + kRows * kPH;
constexpr int kSD1 = kSH2 + kRows * kPH;
constexpr int kSD2 = kSD1 + kRows * kPH;
constexpr int kSDZ = kSD2 + kRows * kPH;
constexpr int kSLoss = kSDZ + kRows;
constexpr int kSmemFloats = kSLoss + kRows;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);   // 72,720
static_assert(kSW3 % 4 == 0 && kSX % 4 == 0 && kSH1 % 4 == 0 &&
              kSH2 % 4 == 0 && kSD2 % 4 == 0 && kPH % 4 == 0,
              "float4 broadcasts read 16-byte aligned rows");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(addr), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

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
  float* sw1 = smem + kSW1;
  float* sw2 = smem + kSW2;
  float* sb1 = smem + kSB1;
  float* sb2 = smem + kSB2;
  float* sw3 = smem + kSW3;
  float* sx = smem + kSX;
  float* sh1 = smem + kSH1;
  float* sh2 = smem + kSH2;
  float* sd1 = smem + kSD1;
  float* sd2 = smem + kSD2;
  float* sdz = smem + kSDZ;
  float* sloss = smem + kSLoss;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(
      min(static_cast<long long>(kRows), batch - row0));

  // staged by cp.async: every thread's copies are in flight at once
  for (int i = t; i < kIn * kHidden; i += kThreads) cp_async4(sw1 + i, w1 + i);
  for (int i = t; i < kHidden * kHidden; i += kThreads)
    cp_async4(sw2 + (i / kHidden) * kPW2 + i % kHidden, w2 + i);
  if (t < kHidden) {
    cp_async4(sb1 + t, b1 + t);
    cp_async4(sb2 + t, b2 + t);
    cp_async4(sw3 + t, w3 + t);
  }
  if (t == 0) cp_async4(smem + kSB3, b3);
  const float* tile = x + row0 * kIn;
  for (int i = t; i < kRows * kIn; i += kThreads) {
    if (i < rows * kIn) cp_async4(sx + i, tile + i);
    else sx[i] = 0.f;
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // phase 1: warp w runs rows 8w .. 8w+7 at once, a row across the lanes
  const int first = warp * kWarpRows;
  float acc[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) acc[i] = 0.f;
#pragma unroll 2
  for (int k4 = 0; k4 < kIn; k4 += 4) {
    float4 xv[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i)
      xv[i] = *reinterpret_cast<const float4*>(sx + (first + i) * kIn + k4);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float w = sw1[(k4 + c) * kHidden + lane];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
        acc[i] = fmaf(lane4(xv[i], c), w, acc[i]);
    }
  }
  float h1[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    h1[i] = fmaxf(acc[i] + sb1[lane], 0.f);
    sh1[(first + i) * kPH + lane] = h1[i];
    acc[i] = 0.f;
  }
  __syncwarp();

#pragma unroll 2
  for (int k4 = 0; k4 < kHidden; k4 += 4) {
    float4 hv[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i)
      hv[i] = *reinterpret_cast<const float4*>(sh1 + (first + i) * kPH + k4);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float w = sw2[(k4 + c) * kPW2 + lane];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
        acc[i] = fmaf(lane4(hv[i], c), w, acc[i]);
    }
  }
  float h2[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    h2[i] = fmaxf(acc[i] + sb2[lane], 0.f);
    sh2[(first + i) * kPH + lane] = h2[i];
  }
  __syncwarp();

  // z, the loss term and dL/dz (JAX's tie rule) of row `mine`, in every
  // lane; lane i < 8 keeps row i's
  const int mine = first + (lane & (kWarpRows - 1));
  float z = 0.f;
#pragma unroll
  for (int j4 = 0; j4 < kHidden; j4 += 4) {
    const float4 hv =
        *reinterpret_cast<const float4*>(sh2 + mine * kPH + j4);
    const float4 wv = *reinterpret_cast<const float4*>(sw3 + j4);
    z = fmaf(hv.x, wv.x, z);
    z = fmaf(hv.y, wv.y, z);
    z = fmaf(hv.z, wv.z, z);
    z = fmaf(hv.w, wv.w, z);
  }
  z += smem[kSB3];
  const float label = mine < rows ? y[row0 + mine] : 0.f;
  const float e = expf(-fabsf(z));
  const float loss = (fmaxf(z, 0.f) - z * label) + log1pf(e);
  const float m = z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f);
  const float s = z >= 0.f ? 1.f : -1.f;
  const float dz = (m - label) - s * (e / (1.f + e));
  if (lane < kWarpRows) {
    sloss[mine] = loss;
    sdz[mine] = dz;
  }

  // d2[j] in lane j; then d1[k] = (d2 W2^T)[k] relu'(h1[k]) in lane k
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const float dzi = __shfl_sync(kAll, dz, i);
    sd2[(first + i) * kPH + lane] = h2[i] > 0.f ? dzi * sw3[lane] : 0.f;
    acc[i] = 0.f;
  }
  __syncwarp();
#pragma unroll 2
  for (int j4 = 0; j4 < kHidden; j4 += 4) {
    float4 dv[kWarpRows];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i)
      dv[i] = *reinterpret_cast<const float4*>(sd2 + (first + i) * kPH + j4);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float w = sw2[lane * kPW2 + j4 + c];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
        acc[i] = fmaf(lane4(dv[i], c), w, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
    sd1[(first + i) * kPH + lane] = h1[i] > 0.f ? acc[i] : 0.f;
  __syncthreads();

  // phase 2: each thread owns entries of this block's slice and sums the
  // tile's rows in order, in double: a float32 product is exact there,
  // so a partial carries one rounding, whatever the rows
  float* out = partials + static_cast<long long>(blockIdx.x) * kOut;
  for (int at = blockIdx.y * kSlice + t; at < kOut;
       at += gridDim.y * kSlice) {
    double sum = 0.0;
    if (at < kB1) {                              // w1[m][k]: x_m d1_k
      const int mi = at / kHidden, k = at % kHidden;
      for (int r = 0; r < rows; ++r)
        sum = fma(double(sx[r * kIn + mi]), double(sd1[r * kPH + k]), sum);
    } else if (at < kW2) {                       // b1[k]: d1_k
      for (int r = 0; r < rows; ++r) sum += sd1[r * kPH + (at - kB1)];
    } else if (at < kB2) {                       // w2[k][j]: h1_k d2_j
      const int k = (at - kW2) / kHidden, j = (at - kW2) % kHidden;
      for (int r = 0; r < rows; ++r)
        sum = fma(double(sh1[r * kPH + k]), double(sd2[r * kPH + j]), sum);
    } else if (at < kW3) {                       // b2[j]: d2_j
      for (int r = 0; r < rows; ++r) sum += sd2[r * kPH + (at - kB2)];
    } else if (at < kB3) {                       // w3[j]: h2_j dz
      for (int r = 0; r < rows; ++r)
        sum = fma(double(sh2[r * kPH + (at - kW3)]), double(sdz[r]), sum);
    } else if (at == kB3) {                      // b3: dz
      for (int r = 0; r < rows; ++r) sum += sdz[r];
    } else {                                     // the loss
      for (int r = 0; r < rows; ++r) sum += sloss[r];
    }
    out[at] = static_cast<float>(sum);
  }
}

// entry slices per tile: enough blocks to fill the card, one slice a
// tile once the tiles alone do
int train_slices(long long tiles) {
  const long long want = (kTargetBlocks + tiles - 1) / tiles;
  return static_cast<int>(want < 1 ? 1 : want > kMaxSlices ? kMaxSlices
                                                           : want);
}

struct Params {
  const float* p[6];
  float* out[6];
};

// K2b: a thread an entry, kApplyThreads a block; partial rows read
// kApplyWide at a time while whole groups last, then kApplyGroup
constexpr int kApplyThreads = 256;
constexpr int kApplyWide = 32;
constexpr int kApplyGroup = 4;

// The parameter entry e updates, in the reference layout: the tensor,
// its new tensor and the offset in both; constant indices only, so the
// parameter struct stays in registers.
struct Entry {
  const float* p;
  float* q;
  int at;
};

__device__ __forceinline__ Entry entry_of(int e, const Params& params) {
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
  return {p, q, at};
}

__global__ void __launch_bounds__(kApplyThreads)
mlp_sgd_apply_kernel(const float* __restrict__ partials,
                     float* __restrict__ sums, int n, float scale, float lr,
                     int apply, Params params) {
  const int e = blockIdx.x * kApplyThreads + threadIdx.x;
  if (e >= kOut) return;
  // the parameter, read before the sum needs it
  Entry to{nullptr, nullptr, 0};
  float old = 0.f;
  if (apply && e < kParams) {
    to = entry_of(e, params);
    old = to.p[to.at];
  }
  // in double, in block order: the sum of many like partials (rows that
  // look alike) does not drift, and a rerun gives the same bits.  A
  // group's loads all go before its first add; its array is indexed by
  // constants only (PERF.md: ptxas and run-time indices)
  const float* col = partials + e;
  double acc = 0.0;
  int r0 = 0;
  for (; r0 + kApplyWide <= n; r0 += kApplyWide) {
    float x[kApplyWide];
#pragma unroll
    for (int r = 0; r < kApplyWide; ++r)
      x[r] = col[static_cast<long long>(r0 + r) * kOut];
#pragma unroll
    for (int r = 0; r < kApplyWide; ++r) acc += x[r];
  }
  for (; r0 < n; r0 += kApplyGroup) {
    float x[kApplyGroup];
#pragma unroll
    for (int r = 0; r < kApplyGroup; ++r)
      x[r] = r0 + r < n ? col[static_cast<long long>(r0 + r) * kOut] : 0.f;
#pragma unroll
    for (int r = 0; r < kApplyGroup; ++r)
      if (r0 + r < n) acc += x[r];
  }
  // then one rounding per operation, as the plain version's torch ops
  const float g = __fmul_rn(static_cast<float>(acc), scale);
  sums[e] = g;
  if (to.q != nullptr) to.q[to.at] = __fsub_rn(old, __fmul_rn(lr, g));
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
// contiguous fp32 device buffers, partials [ceil(batch/64), 3682].  The
// grid is ceil(batch/64) tiles x train_slices() entry slices.
// Returns the cudaError_t of the launch; it does not synchronise.
extern "C" int mlp_train_partials_launch(
    const float* x, const float* y, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    float* partials, int batch, int device, void* stream) {
  const long long tiles = (static_cast<long long>(batch) + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(train_slices(tiles)));
  return on_device(device, [&] {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_train_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    mlp_train_partials_kernel<<<grid, kThreads, kSmemBytes,
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    mlp_sgd_apply_kernel<<<(kOut + kApplyThreads - 1) / kApplyThreads,
                           kApplyThreads, 0, st>>>(
        partials, sums, n, scale, lr, apply, params);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* mlp_train_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
