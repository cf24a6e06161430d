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
// Two kernels here; the stable sort between them is the radix sort of
// mc_sort.cu:
// * mc_hash_kernel writes the sort key  (!valid << 32) | key  as int64,
//   key = sum_k (uint32)row[k] * (((k+1) * 2654435761 mod 2^32) | 1)
//   mod 2^32.  One stable sort on it orders rows as the reference's two
//   stable argsorts do: valid first, then by key, then by index;
// * mc_keep_kernel: keep[j] = valid[order[j]] and (j == 0 or row
//   order[j] != row order[j-1]).  Stability keeps the minimum linear
//   index of every distinct state; a hash collision only splits a run,
//   so no state is ever dropped.
//
// Bound on an H100 SXM: bytes.  The hash reads N*W*4 bytes and writes
// N*8; the keep reads the N sorted keys and the order and writes N, plus
// the rows it must compare.
//
// Design (exact results: one differing element is a wrong answer):
// * hash: a warp a row, the lanes reading consecutive words, so each
//   load instruction of a warp covers 128 contiguous bytes (4-byte loads:
//   at P = 3 a row is 508 bytes and rows are not 16-byte aligned), every
//   load of a row issued before the first product.  Each lane sums its
//   own words' products, then the warp sums the lanes with shuffles.
//   Wrapping uint32 addition is associative and commutative, so any
//   order of summation gives the same 32 key bits as a sum in row
//   order.  A grid of at most kHashBlocks blocks walks the rows.
// * keep: kCmpLanes lanes a sorted position, keys before rows.  The sort
//   key says valid (its bit 32 is 0), and valid rows sort before invalid
//   ones, so for a valid j > 0 the predecessor is valid too: a different
//   key then means a different 32-bit hash, which means different rows,
//   and keep[j] is 1 without reading a row.  Only a valid j whose key
//   equals its predecessor's needs the full-row compare (in the probe's
//   chunks ~42% of the valid rows, ~5% of all rows); its lanes compare
//   the two rows on consecutive words (32-byte sectors), a chunk of
//   loads in flight at once, the verdict from one warp ballot.  A row of
//   176 words takes two chunks of 12 words a lane: at 32 registers twice
//   the warps stay resident as with one chunk of 24 (64 registers), which
//   measured faster (PERF.md).  The valid rows all sort to the front, so
//   a position a group spreads them over the whole grid, and
//   neighbouring positions of a warp read the row they share at about
//   the same time.
//
// Plain C entry points, built by nvcc alone and loaded with ctypes
// (manatee_tpu_torch/kernels/mc_dedup.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHashThreads = 256;           // 8 warps, a row each at a time
constexpr int kHashBlocks = 132 * 8;        // an H100's SMs x 8 resident
constexpr int kHashChunk = 8;               // words a lane loads at once
constexpr int kKeepThreads = 256;
constexpr int kCmpLanes = 8;                // lanes a sorted position
constexpr int kCmpChunk = 12;               // words of each row a lane
                                            // loads at once
constexpr uint32_t kGolden = 2654435761u;
constexpr unsigned kFull = 0xffffffffu;

static_assert(32 % kCmpLanes == 0 && kKeepThreads % 32 == 0,
              "a warp holds whole positions");

__global__ void __launch_bounds__(kHashThreads)
mc_hash_kernel(const int* __restrict__ rows,
               const unsigned char* __restrict__ valid,
               long long* __restrict__ keys, int n, int w) {
  const int lane = threadIdx.x & 31;
  const long long warps =
      static_cast<long long>(gridDim.x) * (kHashThreads / 32);
  for (long long j = static_cast<long long>(blockIdx.x) * (kHashThreads / 32)
                     + (threadIdx.x >> 5);
       j < n; j += warps) {
    const int* row = rows + j * w;
    uint32_t key = 0;
    for (int k0 = 0; k0 < w; k0 += 32 * kHashChunk) {
      // every load of the chunk in flight before the first product; a
      // word past the row reads as 0 and adds nothing
      uint32_t x[kHashChunk];
#pragma unroll
      for (int u = 0; u < kHashChunk; ++u) {
        const int k = k0 + 32 * u + lane;
        x[u] = k < w ? static_cast<uint32_t>(__ldg(row + k)) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kHashChunk; ++u) {
        const int k = k0 + 32 * u + lane;
        key += x[u] * ((static_cast<uint32_t>(k + 1) * kGolden) | 1u);
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) key += __shfl_xor_sync(kFull, key, d);
    if (lane == 0)
      keys[j] = (static_cast<long long>(valid[j] ? 0 : 1) << 32) |
                static_cast<long long>(key);
  }
}

__global__ void __launch_bounds__(kKeepThreads)
mc_keep_kernel(const int* __restrict__ rows,
               const long long* __restrict__ skeys,
               const long long* __restrict__ order,
               unsigned char* __restrict__ keep, int n, int w) {
  const long long j =
      (static_cast<long long>(blockIdx.x) * kKeepThreads + threadIdx.x) /
      kCmpLanes;
  const int lane = threadIdx.x & 31, sub = lane % kCmpLanes;

  // keys first: a valid row keeps unless its key equals its predecessor's
  bool ok = false, same = false;
  if (j < n) {
    const long long key = skeys[j];
    ok = (key >> 32) == 0;
    same = j > 0 && skeys[j - 1] == key;
  }
  // equal keys: the group compares the two rows on consecutive words,
  // every load of a chunk in flight at once
  uint32_t diff = 0;
  if (ok && same) {
    const int* a = rows + order[j] * w;
    const int* b = rows + order[j - 1] * w;
    for (int c0 = 0; c0 < w; c0 += kCmpLanes * kCmpChunk) {
      int x[kCmpChunk], y[kCmpChunk];
#pragma unroll
      for (int u = 0; u < kCmpChunk; ++u) {
        const int c = c0 + kCmpLanes * u + sub;
        x[u] = c < w ? __ldg(a + c) : 0;
        y[u] = c < w ? __ldg(b + c) : 0;
      }
#pragma unroll
      for (int u = 0; u < kCmpChunk; ++u)
        diff |= static_cast<uint32_t>(x[u] ^ y[u]);
    }
  }
  // the group's verdict: any of its lanes saw a differing word
  const unsigned differ = __ballot_sync(kFull, diff != 0) >> (lane - sub);
  if (j < n && sub == 0)
    keep[j] = ok && (!same || (differ & ((1u << kCmpLanes) - 1))) ? 1 : 0;
}

unsigned hash_blocks(int n) {
  const long long need =
      (static_cast<long long>(n) + kHashThreads / 32 - 1) / (kHashThreads / 32);
  return static_cast<unsigned>(need < kHashBlocks ? need : kHashBlocks);
}

unsigned keep_blocks(int n) {
  return static_cast<unsigned>(
      (static_cast<long long>(n) * kCmpLanes + kKeepThreads - 1) /
      kKeepThreads);
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
    mc_hash_kernel<<<hash_blocks(n), kHashThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(rows, valid, keys,
                                                          n, w);
    return static_cast<int>(cudaGetLastError());
  });
}

// Launches the keep kernel likewise: skeys (n,) int64 the hash kernel's
// keys in stable ascending order, order (n,) int64 the row of each (the
// sort's indices), keep (n,) bool.
extern "C" int mc_keep_launch(const int* rows, const long long* skeys,
                              const long long* order, unsigned char* keep,
                              int n, int w, int device, void* stream) {
  return on_device(device, [&] {
    mc_keep_kernel<<<keep_blocks(n), kKeepThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(rows, skeys, order,
                                                          keep, n, w);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* mc_dedup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
