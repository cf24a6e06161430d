// K7's stable sort, by hand: an LSD radix sort of the dedup's sort keys.
//
// Part of manatee_tpu/state/mc_array.py::_build_dedup (:1320-1348): its
// two stable argsorts (:1339-1340), which XLA compiled.  The hash kernel
// (mc_dedup.cu) writes each row's sort key (!valid) << 32 | hash32, 33
// significant bits; this file sorts those keys
//
//   keys int64 (N,), each in [0, 2^33)
//   -> sorted keys int64 (N,), order int64 (N,)
//
// stably, so the output equals torch.sort(keys, stable=True) bit for
// bit: a stable sort has exactly one correct output.
//
// Three LSD passes of 11-bit digits: key bits 0-10, 11-21, then 22-32
// (the hash's top ten bits and the invalid bit).  A key travels as one
// 8-byte pair of words, its hash and (!valid) << 31 | index (N < 2^31);
// the int64 key and the order are written only by the last pass.
//
// A pass over a CTA's keys (up to kTile, in shared memory in their
// current order):
// 1. rank: the keys are cut into kWarps contiguous runs, one a warp,
//    taken 32 at a time (a round).  In a round twelve warp ballots, one
//    a bit of the digit and one for "no key", give each lane the lanes of
//    equal digit (__match_any_sync measured no faster on an H100); the
//    group's lowest lane adds the group's size to the warp's count of
//    that digit, and a lane's rank is the count before the round plus
//    the lanes of its group below it: the stable rank within the warp.
//    A scan over the warps (four 16-bit counts a 64-bit word) and over
//    the digits then gives each key its place in the CTA's keys sorted
//    stably by digit;
// 2. the keys are written there, into a second buffer of the CTA;
// 3. each digit's run of that buffer is copied, a thread a position, to
//    the run's place in the whole pass's output: consecutive threads
//    write consecutive places.  Writing each key straight to its place
//    (scattered stores, remote or to device memory) measured slower on
//    an H100 (PERF.md).
// A digit's place: all keys of smaller digits, then this digit's keys
// in the CTAs (or tiles) before.  A thread's digits and ranks are
// arrays indexed only by constants (loops fully unrolled): register
// arrays selected by a run-time index gave wrong bits from ptxas -O1 on
// in CUDA 12.8 (PERF.md).
//
// Two regimes:
// * mc_sort_cluster_kernel, N <= kCluster * kTile: one launch of one
//   thread-block cluster of kCluster CTAs (every path of the repo: chunk
//   1024 x 34 slots = 34,816 keys).  CTA c holds positions [c * share, (c + 1) * share)
//   of the current order.  After step 2 a CTA publishes its 16-bit digit
//   counts; after a cluster.sync() each CTA reads every CTA's counts
//   through distributed shared memory, all of a thread's loads in flight
//   at once, and step 3 writes into the shared memory of the CTAs that
//   hold the new positions; a second cluster.sync() ends the pass.
// * above that (a larger --chunk; the bulk timing's 2,228,224 keys):
//   reduce-then-scan in device memory, tiles of kTile keys.  The first
//   kernel counts each tile's first digits and adds the three digits'
//   histograms to global totals; per pass a scan turns the tiles'
//   counts into each tile's start for each digit (tile order within a
//   digit), and the scatter kernel runs steps 1-3 on its tile into
//   device memory.  The passes after the first count their tiles first.
//   Nine launches here, plus the wrapper's memset of the totals.
//
// Bound on an H100 SXM: bytes.  Each key is read once (8 bytes) and its
// key and order written once (16 bytes): 0.25 us at 34,816 keys, under
// the launch floor (~2 us), and 16 us at 2,228,224 keys.
//
// Plain C entry points, built by nvcc alone and loaded with ctypes
// (manatee_tpu_torch/kernels/mc_sort.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDigitBits = 11;
constexpr int kDigits = 1 << kDigitBits;       // 2,048 bins a pass
constexpr uint32_t kDigitMask = kDigits - 1;
constexpr int kPasses = 3;                     // 33 key bits
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 17;                     // keys a thread holds at most
constexpr int kTile = kThreads * kItems;       // 8,704 keys a CTA
// CTAs of the cluster: the portable maximum, the fastest of 1, 2, 4 and
// 8 at every size an H100 was timed at (chip_smoke.py phase m builds the
// others from copies of this file; PERF.md)
constexpr int kCluster = 8;
constexpr int kScanThreads = 1024;
constexpr int kScanDigits = 32;                // digits a scan block takes
constexpr uint32_t kEmpty = 1u << kDigitBits;  // the digit of no key
constexpr unsigned kFull = 0xffffffffu;

static_assert(kDigits == 4 * kThreads, "a thread scans four digits");
static_assert(kWarps <= 32, "one warp scans the warps' sums");
static_assert(kTile < 65536, "16-bit warp counts");
static_assert(kDigits % kScanDigits == 0 && kScanThreads == 32 * 32,
              "a scan block is 32 warps over 32 digits");

// Shared memory of one CTA's pass.
struct Smem {
  // a warp's count of each digit, then where its first key of the digit
  // goes in the CTA's keys sorted by digit
  __align__(16) uint16_t warp_count[kWarps][kDigits];
  __align__(16) uint16_t cta_count[kDigits];   // the CTA's keys a digit
  __align__(16) uint32_t shift[kDigits];       // a sorted position's shift
                                               // to its place in the pass
  uint32_t warp_sums[32];
  __align__(16) uint2 key[kTile];       // (hash, word), current order
  __align__(16) uint2 sorted[kTile];    // the same, sorted by this digit
};

__device__ __forceinline__ uint32_t digit_of(int pass, uint2 key) {
  return pass < 2 ? (key.x >> (kDigitBits * pass)) & kDigitMask
                  : (key.x >> 22) | ((key.y >> 31) << 10);
}

// This warp's run of a CTA's `count` keys: positions [begin, end).
struct Run {
  int begin, end;
};

__device__ __forceinline__ Run warp_run(int count) {
  const int per_warp = (count + kWarps - 1) / kWarps;
  const int begin = min(static_cast<int>(threadIdx.x >> 5) * per_warp, count);
  return {begin, min(begin + per_warp, count)};
}

// The lanes of the warp whose label (a digit, or kEmpty) equals this
// lane's: one ballot a bit.
__device__ __forceinline__ unsigned match_label(uint32_t label) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b <= kDigitBits; ++b) {
    const unsigned bit = (label >> b) & 1u;
    const unsigned vote = __ballot_sync(kFull, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

// Over the CTA, thread t holding the sum `mine` of values 4t .. 4t + 3
// of 2,048: the sum of the values before thread t's.  Every thread calls
// it; it ends with a __syncthreads.
__device__ __forceinline__ uint32_t scan_before(uint32_t mine,
                                                uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    const uint32_t x = lane < kWarps ? warp_sums[lane] : 0u;
    uint32_t xi = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, xi, o);
      if (lane >= o) xi += y;
    }
    if (lane < kWarps) warp_sums[lane] = xi - x;
  }
  __syncthreads();
  const uint32_t before = warp_sums[w] + incl - mine;
  __syncthreads();
  return before;
}

// Step 1: where each of this thread's keys goes in the CTA's keys sorted
// stably by digit (in rank[k]), each digit's count (s.cta_count) and the
// place of its first key there (s.shift).  d[k] is kEmpty where the
// thread holds no key k; `rounds` is the warp's.  Every thread of the
// CTA calls it; it ends with a __syncthreads.
__device__ __forceinline__ void rank_keys(const uint32_t (&d)[kItems],
                                          uint32_t (&rank)[kItems],
                                          Smem& s, int rounds) {
  const int lane = threadIdx.x & 31, t = threadIdx.x;
  uint16_t* counts = s.warp_count[t >> 5];
  uint4* row = reinterpret_cast<uint4*>(counts);
  for (int i = lane; i < kDigits * 2 / 16; i += 32)
    row[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (k < rounds) {                            // the same in every lane
      const unsigned peers = match_label(d[k]);
      const int leader = __ffs(peers) - 1;
      uint32_t start = 0;
      if (lane == leader && d[k] != kEmpty) {
        start = counts[d[k]];
        counts[d[k]] = static_cast<uint16_t>(start + __popc(peers));
      }
      start = __shfl_sync(kFull, start, leader);
      rank[k] = start + __popc(peers & below);
      __syncwarp();
    }
  }
  __syncthreads();
  // digits 4t .. 4t + 3 at once, a 16-bit count each in a 64-bit word:
  // no sum here reaches 2^16 (kTile), so the lanes never carry
  unsigned long long total = 0ull;
#pragma unroll
  for (int v = 0; v < kWarps; ++v)
    total += reinterpret_cast<const unsigned long long*>(s.warp_count[v])[t];
  reinterpret_cast<unsigned long long*>(s.cta_count)[t] = total;
  const uint32_t c0 = total & 0xffffu, c1 = (total >> 16) & 0xffffu,
                 c2 = (total >> 32) & 0xffffu;
  const uint32_t at = scan_before(
      c0 + c1 + c2 + static_cast<uint32_t>(total >> 48), s.warp_sums);
  reinterpret_cast<uint4*>(s.shift)[t] =
      make_uint4(at, at + c0, at + c0 + c1, at + c0 + c1 + c2);
  unsigned long long run =
      static_cast<unsigned long long>(at) |
      static_cast<unsigned long long>(at + c0) << 16 |
      static_cast<unsigned long long>(at + c0 + c1) << 32 |
      static_cast<unsigned long long>(at + c0 + c1 + c2) << 48;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    unsigned long long* c =
        reinterpret_cast<unsigned long long*>(s.warp_count[v]) + t;
    const unsigned long long mine = *c;
    *c = run;
    run += mine;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (k < rounds && d[k] != kEmpty) rank[k] += counts[d[k]];
}

// int64 key <-> (hash, (!valid) << 31 | index)
__device__ __forceinline__ uint2 pair_of(long long key, long long index) {
  return make_uint2(static_cast<uint32_t>(key),
                    (static_cast<uint32_t>(key >> 32) << 31) |
                        static_cast<uint32_t>(index));
}

__device__ __forceinline__ long long key_of(uint2 key) {
  return (static_cast<long long>(key.y >> 31) << 32) |
         static_cast<long long>(key.x);
}

// Steps 1 and 2 of a pass over the CTA's `count` keys in s.key: rank
// them and write them, sorted stably by digit, to s.sorted.
// Ends with s.shift[d] holding where the CTA's keys of digit d start in
// that order.  Every thread of the CTA calls it.
__device__ __forceinline__ void sort_by_digit(Smem& s, int pass, int count) {
  const int lane = threadIdx.x & 31;
  const Run run = warp_run(count);
  const int rounds = (run.end - run.begin + 31) / 32;
  uint32_t d[kItems], rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = run.begin + 32 * k + lane;
    d[k] = p < run.end ? digit_of(pass, s.key[p]) : kEmpty;
  }
  rank_keys(d, rank, s, rounds);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int p = run.begin + 32 * k + lane;
    if (p < run.end) s.sorted[rank[k]] = s.key[p];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
mc_sort_cluster_kernel(const long long* __restrict__ keys,
                       long long* __restrict__ skeys,
                       long long* __restrict__ order, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int cta = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int share = (n + kCluster - 1) / kCluster;
  const int first = min(cta * share, n);
  const int count = min(share, n - first);
  for (int i = t; i < count; i += kThreads)
    s.key[i] = pair_of(keys[first + i], first + i);
  __syncthreads();
  for (int pass = 0; pass < kPasses; ++pass) {
    sort_by_digit(s, pass, count);
    // every CTA's counts are out and its keys sorted by digit; no CTA
    // reads its s.key again this pass
    cluster.sync();
    // digits 4t .. 4t + 3 of every CTA, all the loads in flight at once
    unsigned long long c[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      c[r] = reinterpret_cast<const unsigned long long*>(
          cluster.map_shared_rank(&s.cta_count[0], r))[t];
    uint32_t t0 = 0u, t1 = 0u, t2 = 0u, t3 = 0u;   // all CTAs' keys
    uint32_t b0 = 0u, b1 = 0u, b2 = 0u, b3 = 0u;   // the CTAs' before this
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      t0 += c[r] & 0xffffu;
      t1 += (c[r] >> 16) & 0xffffu;
      t2 += (c[r] >> 32) & 0xffffu;
      t3 += static_cast<uint32_t>(c[r] >> 48);
      if (r + 1 == cta) {
        b0 = t0;
        b1 = t1;
        b2 = t2;
        b3 = t3;
      }
    }
    const uint32_t at = scan_before(t0 + t1 + t2 + t3, s.warp_sums);
    uint4* shift = reinterpret_cast<uint4*>(s.shift) + t;
    const uint4 local = *shift;
    *shift = make_uint4(at + b0 - local.x, at + t0 + b1 - local.y,
                        at + t0 + t1 + b2 - local.z,
                        at + t0 + t1 + t2 + b3 - local.w);
    __syncthreads();
    // step 3: each digit's run to its place, consecutive threads on
    // consecutive places
    for (int i = t; i < count; i += kThreads) {
      const uint2 key = s.sorted[i];
      const uint32_t pos = s.shift[digit_of(pass, key)] + i;
      if (pass == kPasses - 1) {
        skeys[pos] = key_of(key);
        order[pos] = key.y & 0x7fffffffu;
      } else {
        const int to = static_cast<int>(pos) / share;
        cluster.map_shared_rank(&s.key[0], to)[pos - to * share] = key;
      }
    }
    // the keys have landed, and no CTA reads this pass's counts any more
    cluster.sync();
  }
}

// Pass 0's counts and the histogram: block b counts its tile's first
// digits into counts[b][:] and adds the tile's three digit histograms
// to totals[3][2048] (zeroed by the caller).
__global__ void __launch_bounds__(kThreads)
mc_sort_count_first_kernel(const long long* __restrict__ keys,
                           uint32_t* __restrict__ counts,
                           uint32_t* __restrict__ totals, int n) {
  __shared__ uint32_t hist[kPasses][kDigits];
  for (int i = threadIdx.x; i < kPasses * kDigits; i += kThreads)
    (&hist[0][0])[i] = 0u;
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * kTile;
  const int count = static_cast<int>(min(static_cast<long long>(kTile),
                                         n - first));
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const uint2 key = pair_of(keys[first + i], 0);
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass)
      atomicAdd(&hist[pass][digit_of(pass, key)], 1u);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDigits; i += kThreads) {
    counts[static_cast<long long>(blockIdx.x) * kDigits + i] = hist[0][i];
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass)
      if (hist[pass][i]) atomicAdd(&totals[pass * kDigits + i], hist[pass][i]);
  }
}

// A later pass's counts: block b counts its tile's digits into counts[b][:].
template <int kPass>
__global__ void __launch_bounds__(kThreads)
mc_sort_count_kernel(const uint2* __restrict__ src,
                     uint32_t* __restrict__ counts, int n) {
  __shared__ uint32_t hist[kDigits];
  for (int i = threadIdx.x; i < kDigits; i += kThreads) hist[i] = 0u;
  __syncthreads();
  const long long first = static_cast<long long>(blockIdx.x) * kTile;
  const int count = static_cast<int>(min(static_cast<long long>(kTile),
                                         n - first));
  for (int i = threadIdx.x; i < count; i += kThreads)
    atomicAdd(&hist[digit_of(kPass, src[first + i])], 1u);
  __syncthreads();
  for (int i = threadIdx.x; i < kDigits; i += kThreads)
    counts[static_cast<long long>(blockIdx.x) * kDigits + i] = hist[i];
}

// counts[tiles][2048], in place -> where each tile's first key of each
// digit goes: all keys of smaller digits (`totals`, this pass's
// histogram), then this digit's keys in the tiles before.  Block j takes
// digits [32j, 32j + 32), a lane a digit; warp v sums, then writes, its
// segment of the tiles.
__global__ void __launch_bounds__(kScanThreads)
mc_sort_scan_kernel(uint32_t* __restrict__ counts,
                    const uint32_t* __restrict__ totals, int tiles) {
  __shared__ uint32_t part[32][33];
  __shared__ uint32_t below[32];
  const int lane = threadIdx.x & 31, v = threadIdx.x >> 5;
  const int d0 = blockIdx.x * kScanDigits;
  uint32_t sum = 0u;
  for (int d = threadIdx.x; d < d0; d += kScanThreads) sum += totals[d];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  if (lane == 0) below[v] = sum;
  const int seg = (tiles + 31) / 32;
  const int b0 = min(v * seg, tiles), b1 = min(b0 + seg, tiles);
  uint32_t mine = 0u;
  for (int b = b0; b < b1; ++b)
    mine += counts[static_cast<long long>(b) * kDigits + d0 + lane];
  part[v][lane] = mine;
  __syncthreads();
  if (v == 0) {
    uint32_t start = 0u;
    for (int i = 0; i < 32; ++i) start += below[i];
    const uint32_t t = totals[d0 + lane];
    uint32_t incl = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    start += incl - t;
    for (int i = 0; i < 32; ++i) {
      const uint32_t c = part[i][lane];
      part[i][lane] = start;
      start += c;
    }
  }
  __syncthreads();
  uint32_t at = part[v][lane];
  for (int b = b0; b < b1; ++b) {
    uint32_t* c = counts + static_cast<long long>(b) * kDigits + d0 + lane;
    const uint32_t x = *c;
    *c = at;
    at += x;
  }
}

// One pass over a tile: steps 1-3 into device memory, each digit's run
// to the tile's start of the digit (`starts`, the scan's).  Pass 0
// reads the int64 keys, pass 2 writes the sorted keys and the order.
template <int kPass>
__global__ void __launch_bounds__(kThreads, 1)
mc_sort_scatter_kernel(const long long* __restrict__ keys,
                       const uint2* __restrict__ src,
                       const uint32_t* __restrict__ starts,
                       uint2* __restrict__ dst,
                       long long* __restrict__ skeys,
                       long long* __restrict__ order, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int t = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kTile;
  const int count = static_cast<int>(
      min(static_cast<long long>(kTile), n - first));
  for (int i = t; i < count; i += kThreads)
    s.key[i] = kPass == 0 ? pair_of(keys[first + i], first + i)
                          : src[first + i];
  __syncthreads();
  sort_by_digit(s, kPass, count);
  uint4* shift = reinterpret_cast<uint4*>(s.shift) + t;
  const uint4 local = *shift;
  const uint4 start = reinterpret_cast<const uint4*>(
      starts + static_cast<long long>(blockIdx.x) * kDigits)[t];
  *shift = make_uint4(start.x - local.x, start.y - local.y,
                      start.z - local.z, start.w - local.w);
  __syncthreads();
  for (int i = t; i < count; i += kThreads) {
    const uint2 key = s.sorted[i];
    const uint32_t pos = s.shift[digit_of(kPass, key)] + i;
    if (kPass == kPasses - 1) {
      skeys[pos] = key_of(key);
      order[pos] = key.y & 0x7fffffffu;
    } else {
      dst[pos] = key;
    }
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

// Launches the cluster sort on `stream` of `device`: one cluster of
// kCluster CTAs (kCluster * kTile >= n >= 1) sorts keys (n,) int64 into
// skeys and order (n,) int64, contiguous device buffers.  Returns the
// cudaError_t of the launch; it does not synchronise.
extern "C" int mc_sort_cluster_launch(const long long* keys, long long* skeys,
                                      long long* order, int n, int device,
                                      void* stream) {
  if (n < 1 || kCluster * kTile < n)
    return static_cast<int>(cudaErrorInvalidValue);
  return on_device(device, [&] {
    constexpr int bytes = static_cast<int>(sizeof(Smem));
    cudaError_t err = cudaFuncSetAttribute(
        mc_sort_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(kCluster);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = bytes;
    config.stream = static_cast<cudaStream_t>(stream);
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, mc_sort_cluster_kernel, keys, skeys,
                             order, n);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  });
}

// One pass of the tiled sort: its counts (pass 0's with the histogram
// of all three digits), the scan, the scatter.
template <int kPass>
cudaError_t tiles_pass(const long long* keys, const uint2* src, uint2* dst,
                       long long* skeys, long long* order, uint32_t* counts,
                       uint32_t* totals, int n, unsigned tiles,
                       cudaStream_t st) {
  constexpr int bytes = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      mc_sort_scatter_kernel<kPass>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if constexpr (kPass == 0)
    mc_sort_count_first_kernel<<<tiles, kThreads, 0, st>>>(keys, counts,
                                                           totals, n);
  else
    mc_sort_count_kernel<kPass><<<tiles, kThreads, 0, st>>>(src, counts, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mc_sort_scan_kernel<<<kDigits / kScanDigits, kScanThreads, 0, st>>>(
      counts, totals + kPass * kDigits, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mc_sort_scatter_kernel<kPass><<<tiles, kThreads, bytes, st>>>(
      keys, src, counts, dst, skeys, order, n);
  return cudaGetLastError();
}

// Launches the tiled sort likewise for any n >= 1: scratch a and b, (n,)
// pairs of uint32 each (8-byte aligned), counts (tiles, 2048) uint32 and
// totals (3, 2048) uint32 set to 0, tiles = ceil(n / kTile).
extern "C" int mc_sort_tiles_launch(const long long* keys, long long* skeys,
                                    long long* order, int n, uint2* a,
                                    uint2* b, uint32_t* counts,
                                    uint32_t* totals, int device,
                                    void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = static_cast<unsigned>(
      (static_cast<long long>(n) + kTile - 1) / kTile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    cudaError_t err = tiles_pass<0>(keys, nullptr, a, nullptr, nullptr,
                                    counts, totals, n, tiles, st);
    if (err == cudaSuccess)
      err = tiles_pass<1>(nullptr, a, b, nullptr, nullptr, counts, totals,
                          n, tiles, st);
    if (err == cudaSuccess)
      err = tiles_pass<2>(nullptr, b, nullptr, skeys, order, counts, totals,
                          n, tiles, st);
    return static_cast<int>(err);
  });
}

extern "C" const char* mc_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
