// K7: the model checker's device-side dedup, around one stable sort.
//
// Replaces manatee_tpu/state/mc_array.py::_build_dedup (:1320-1348),
// which XLA compiled: a 32-bit semantic hash of every row, a stable sort
// with invalid rows pushed to the back, and a full-row compare of each
// sorted row with the one before it:
//
//   rows int32 (N, W), valid bool (N,)
//   -> keep bool (N,) over the sorted order, order int64 (N,)
//
// Two kernels here; the stable sort between them is torch.sort (the one
// step left to a library call, as the reference leaves it to XLA):
// * mc_hash_kernel writes the sort key  (!valid << 32) | key  as int64,
//   key = sum_k (uint32)row[k] * (((k+1) * 2654435761 mod 2^32) | 1)
//   mod 2^32 (unsigned arithmetic wraps natively).  One stable sort on
//   it orders rows as the reference's two stable argsorts do: valid
//   first, then by key, then by index;
// * mc_keep_kernel: keep[j] = valid[order[j]] and (j == 0 or row
//   order[j] != row order[j-1]).  Stability keeps the minimum linear
//   index of every distinct state; a hash collision only splits a run,
//   so no state is ever dropped.
//
// Bound on an H100 SXM: bytes.  The hash reads N*W*4 bytes and writes
// N*8; the compare reads up to 2*N*W*4 (each valid row and the one
// before it) and writes N.  One thread per row in both: simple first.
//
// Plain C entry points, built by nvcc alone and loaded with ctypes
// (manatee_tpu_torch/kernels/mc_dedup.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kGolden = 2654435761u;

__global__ void __launch_bounds__(kThreads)
mc_hash_kernel(const int* __restrict__ rows,
               const unsigned char* __restrict__ valid,
               long long* __restrict__ keys, int n, int w) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= n) return;
  const int* row = rows + j * w;
  uint32_t key = 0;
  for (int k = 0; k < w; ++k)
    key += static_cast<uint32_t>(row[k]) *
           ((static_cast<uint32_t>(k + 1) * kGolden) | 1u);
  keys[j] = (static_cast<long long>(valid[j] ? 0 : 1) << 32) |
            static_cast<long long>(key);
}

__global__ void __launch_bounds__(kThreads)
mc_keep_kernel(const int* __restrict__ rows,
               const unsigned char* __restrict__ valid,
               const long long* __restrict__ order,
               unsigned char* __restrict__ keep, int n, int w) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (j >= n) return;
  const long long oj = order[j];
  bool k = valid[oj] != 0;
  if (k && j > 0) {
    const int* a = rows + oj * w;
    const int* b = rows + order[j - 1] * w;
    bool same = true;
    for (int c = 0; c < w && same; ++c) same = a[c] == b[c];
    k = !same;
  }
  keep[j] = k ? 1 : 0;
}

unsigned blocks_for(int n) {
  return static_cast<unsigned>((static_cast<long long>(n) + kThreads - 1) /
                               kThreads);
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

// Launches the hash kernel on `stream` of `device`: rows (n, w) int32,
// valid (n,) bool, keys (n,) int64, contiguous device buffers, n >= 1.
// Returns the cudaError_t of the launch; it does not synchronise.
extern "C" int mc_hash_launch(const int* rows, const unsigned char* valid,
                              long long* keys, int n, int w, int device,
                              void* stream) {
  return on_device(device, [&] {
    mc_hash_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(rows, valid, keys,
                                                          n, w);
    return static_cast<int>(cudaGetLastError());
  });
}

// Launches the keep kernel likewise: order (n,) int64 (a permutation of
// the rows), keep (n,) bool.
extern "C" int mc_keep_launch(const int* rows, const unsigned char* valid,
                              const long long* order, unsigned char* keep,
                              int n, int w, int device, void* stream) {
  return on_device(device, [&] {
    mc_keep_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(rows, valid, order,
                                                          keep, n, w);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* mc_dedup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
