// K4: the synthetic training batch of the failure predictor.
//
// Replaces the device part of manatee_tpu/health/predictor.py::
// synthetic_batch (:110-185), which XLA compiled for the TPU: from the
// random draws (drawn outside, as jax.random is outside the reference's
// device function) it makes each window's label, the latency and lag
// ramps, the timeout/stall/flap coins, the status-cadence carry of
// (lag, stall) across the 16 ticks (the reference's lax.scan) and the
// restart pad.
//
//   label_u [B], noise [B,16,5], latency_u/lag_u/flap_u/pad_u [B,1] fp32,
//   phase/pad_len [B,1] int64, trend [16] fp32
//   -> windows [B,16,5] fp32, labels [B] fp32
//
// Bound on an H100 SXM: each row reads 360 bytes (noise 320, five
// floats, two int64s) and writes 324; ~35 operations per tick, ~560 a
// row, under one a byte.  So it is bound by bytes at bulk batches, and by
// latency at the training path's 249 rows, where the bytes take 0.05 us.
//
// It must equal the plain version (kernels/synthetic_batch.py) bit for
// bit: a comparison such as noise < lab*trend*0.6 that moves by one ulp
// changes a window by 1.0.  So every product and sum is written with
// __fmul_rn/__fadd_rn, one rounding per torch operator and in torch's
// order (nvcc never contracts these into an FMA); the constants are the
// floats torch casts its Python scalars to; and the ramp `trend` is
// torch.linspace's own output, passed in, not recomputed.
//
// Design: one thread per (window, tick), 16 lanes a window, two windows a
// warp, kWindowsPerBlock windows a block, so that the training path's
// 249 rows spread over 32 SMs and no thread runs a serial chain of more
// than one tick.  Each lane loads its tick's five noise floats
// (neighbouring lanes, neighbouring addresses) and its window's scalars
// (one address a half-warp), computes its tick, and finds the (lag,
// stall) its tick carries with a 16-lane max-scan of "the last observed
// tick at or before mine" and one shuffle from that lane: a selection,
// no arithmetic, so the bits are the serial carry's.  Rows past the
// batch stay in every shuffle with their loads and stores predicated
// off.  No shared memory.
//
// Plain C entry point, loaded with ctypes
// (manatee_tpu_torch/kernels/synthetic_batch.py).

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 16;
constexpr int kFeatures = 5;
constexpr int kRowFloats = kWindow * kFeatures;
constexpr int kWindowsPerBlock = 8;        // two a warp
constexpr int kThreads = kWindowsPerBlock * kWindow;
constexpr int kStatusEvery = 3;
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float clamp01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

__global__ void __launch_bounds__(kThreads)
synthetic_batch_kernel(const float* __restrict__ label_u,
                       const float* __restrict__ noise,
                       const float* __restrict__ latency_u,
                       const float* __restrict__ lag_u,
                       const float* __restrict__ flap_u,
                       const long long* __restrict__ phase,
                       const float* __restrict__ pad_u,
                       const long long* __restrict__ pad_len,
                       const float* __restrict__ trend,
                       float* __restrict__ windows,
                       float* __restrict__ labels, int batch) {
  const int k = threadIdx.x % kWindow;                 // the tick
  const long long row = static_cast<long long>(blockIdx.x) * kWindowsPerBlock
                        + threadIdx.x / kWindow;
  const bool valid = row < batch;

  float x[kFeatures] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float lab = 0.f, lat_f = 0.f, lag_f = 0.f, flap = 0.f;
  long long ph = 0, pad = 0;
  if (valid) {
    const float* src = noise + row * kRowFloats + k * kFeatures;
#pragma unroll
    for (int f = 0; f < kFeatures; ++f) x[f] = src[f];
    lab = label_u[row] > 0.5f ? 1.f : 0.f;
    // the per-window factors, each one torch operator on [B, 1]
    lat_f = __fadd_rn(__fmul_rn(0.7f, latency_u[row]), 0.3f);
    lag_f = __fadd_rn(__fmul_rn(0.6f, lag_u[row]), 0.4f);
    flap = flap_u[row];
    ph = phase[row];
    pad = pad_u[row] < 0.35f ? pad_len[row] : 0;
  }
  const float lt = __fmul_rn(lab, valid ? trend[k] : 0.f);   // lab * trend
  const float latency = __fadd_rn(
      __fadd_rn(__fmul_rn(0.03f, x[0]), 0.005f), __fmul_rn(lt, lat_f));
  const float timed_out = x[1] < __fmul_rn(lt, 0.6f) ? 1.f : 0.f;
  const float lag = clamp01(__fadd_rn(__fmul_rn(0.01f, x[2]),
                                      __fmul_rn(lt, lag_f)));
  const float stall = x[3] < __fmul_rn(lt, 0.5f) ? 1.f : 0.f;
  const float flaps = fminf(
      __fadd_rn(__fmul_rn(__fmul_rn(lt, flap), 0.8f),
                __fmul_rn(0.02f, x[4])), 1.f);

  // status cadence: the last tick <= k with an observation supplies
  // (lag, stall); with none yet, both are 0
  int last = (k % kStatusEvery == ph && timed_out < 0.5f) ? k : -1;
#pragma unroll
  for (int d = 1; d < kWindow; d <<= 1) {
    const int up = __shfl_up_sync(kFullWarp, last, d, kWindow);
    if (k >= d) last = max(last, up);
  }
  const int from = last < 0 ? k : last;
  const float got_lag = __shfl_sync(kFullWarp, lag, from, kWindow);
  const float got_stall = __shfl_sync(kFullWarp, stall, from, kWindow);
  const float prev_lag = last < 0 ? 0.f : got_lag;
  const float prev_stall = last < 0 ? 0.f : got_stall;

  if (!valid) return;                     // after the last shuffle
  const bool keep = k >= pad;             // restart pad
  float* dst = windows + row * kRowFloats + k * kFeatures;
  dst[0] = keep ? clamp01(latency) : 0.f;
  dst[1] = keep ? timed_out : 0.f;
  dst[2] = keep ? prev_lag : 0.f;
  dst[3] = keep ? prev_stall : 0.f;
  dst[4] = keep ? flaps : 0.f;
  if (k == 0) labels[row] = lab;
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

// Launches K4 on `stream` (a cudaStream_t) of `device` over `batch` >= 1
// windows; every pointer is a contiguous device buffer of the shape and
// type listed above.  Returns the cudaError_t of the launch; it does not
// synchronise.
extern "C" int synthetic_batch_launch(
    const float* label_u, const float* noise, const float* latency_u,
    const float* lag_u, const float* flap_u, const long long* phase,
    const float* pad_u, const long long* pad_len, const float* trend,
    float* windows, float* labels, int batch, int device, void* stream) {
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(batch) + kWindowsPerBlock - 1)
      / kWindowsPerBlock);
  return on_device(device, [&] {
    synthetic_batch_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        label_u, noise, latency_u, lag_u, flap_u, phase, pad_u, pad_len,
        trend, windows, labels, batch);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* synthetic_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
