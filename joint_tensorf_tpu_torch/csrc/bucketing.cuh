// Sort-free bucketing of samples for Hopper (sm_90a): the count, scan and
// fill kernels that K4 (binned_scatter.cu) and K5 (tile_scatter.cu) run in
// front of their accumulate kernels.
//
// A Key maps sample i to its bucket and a payload (K5: the destination
// block of rows and the row within it; K4: the TS x TS-cell plane tile and
// the cell within it):
//
//   struct Key {
//     __device__ int operator()(long long i, int& payload) const;
//         // bucket of sample i < N, or -1 to drop it
//     __device__ void zero(int bucket, bool multi_chunk) const;
//         // called by one whole fill block per bucket: zero the output
//         // that the bucket's accumulate blocks will add into atomically
//   };
//
// Passes, each one kernel on the caller's stream, none waiting on the host:
//   1. bucket_count: a shared-memory histogram per block of 2048 samples
//      (one atomic per run of equal buckets in a warp), added into
//      counts[b] (warp-aggregated global atomics, lanes of one bucket
//      grouped by __match_any_sync, when the buckets do not fit in shared
//      memory).
//   2. bucket_scan (one block): exclusive prefix sums of the counts
//      (offset, and cursor = offset) and of the chunks per bucket,
//      max(1, ceil(count / CH)): an empty bucket gets one chunk, so that a
//      block writes its zeros.  It also writes chunk_bucket, the bucket of
//      each of the accumulate grid's blocks (-1 past the last chunk); the
//      grid is sized by the bound ceil(N / CH) + n_buckets, so the host
//      never waits for a count.
//   3. bucket_fill: each sample claims a slot in its bucket, ranked by a
//      shared-memory atomic and placed by one global atomicAdd per bucket
//      and block on the cursor (warp-aggregated atomics on the cursor when
//      the buckets do not fit), and writes (position, payload) there.  The
//      same kernel calls Key::zero for every bucket.
// Positions are int32: the caller keeps N and the grid below 2^31.
#pragma once
#include <cuda_runtime.h>

namespace bucketing {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFillThreads = 256;
constexpr int kItems = 8;
constexpr int kFillTile = kFillThreads * kItems;  // samples a count/fill block
constexpr int kMaxSmemBins = 12288;               // 48 KB of int counters
constexpr int kScanThreads = 1024;

// The bucketing's int32 arrays, each allocated by the caller.
struct Layout {
  int2* perm;         // [N]: (sample position, payload)
  int* counts;        // [n_buckets]
  int* offset;        // [n_buckets + 1]: exclusive prefix of counts
  int* cursor;        // [n_buckets]: next free slot of each bucket
  int* chunk_start;   // [n_buckets + 1]: exclusive prefix of chunks
  int* chunk_bucket;  // [n_map]: bucket of each accumulate block, or -1
};

// Warp-aggregated claim on a global counter: the lanes of one bucket
// b >= 0 add their number to counter[b] with one atomic; returns this
// lane's slot (the counter's old value plus its rank among them).  Called
// by the whole warp.
__device__ __forceinline__ int claim(int* counter, int b) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, b);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (b >= 0 && lane == leader) base = atomicAdd(counter + b, __popc(peers));
  base = __shfl_sync(kFull, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// Consecutive lanes of equal b form a run (samples in march order fill a
// warp with one bucket): returns this lane's rank in its run and sets len
// to the run's length on its first lane, 0 on the others, so that one
// atomic per run replaces one per lane on the same counter.  Called by the
// whole warp.
__device__ __forceinline__ int run_rank(int b, int& len) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, b, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || b != prev);
  const unsigned upto = kFull >> (31 - lane);  // lanes 0..lane
  const int head = 31 - __clz(heads & upto);
  const unsigned later = heads & ~upto;
  len = head == lane ? (later ? __ffs(later) - 1 : 32) - lane : 0;
  return lane - head;
}

// Slot of this lane among its run's claims on counter[b] (b >= 0): one
// atomicAdd per run.  Called by the whole warp.
__device__ __forceinline__ int claim_run(int* counter, int b) {
  int len;
  const int r = run_rank(b, len);
  int base = 0;
  if (len && b >= 0) base = atomicAdd(counter + b, len);
  return __shfl_sync(kFull, base, (threadIdx.x & 31) - r) + r;
}

template <class Key>
__global__ void __launch_bounds__(kFillThreads)
bucket_count_kernel(const Key key, long long N, int n_buckets,
                    int* __restrict__ counts) {
  extern __shared__ int count_hist[];  // [n_buckets] when they fit
  const bool local = n_buckets <= kMaxSmemBins;  // block-uniform
  if (local) {
    for (int j = threadIdx.x; j < n_buckets; j += kFillThreads)
      count_hist[j] = 0;
    __syncthreads();
  }
  const long long tile0 = (long long)blockIdx.x * kFillTile + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = tile0 + k * kFillThreads;
    int payload;
    const int b = i < N ? key(i, payload) : -1;
    if (local)
      claim_run(count_hist, b);
    else
      claim(counts, b);
  }
  if (local) {
    __syncthreads();
    for (int j = threadIdx.x; j < n_buckets; j += kFillThreads)
      if (count_hist[j]) atomicAdd(counts + j, count_hist[j]);
  }
}

// Inclusive block scan of two ints over kScanThreads threads.
__device__ __forceinline__ void block_scan2(int& a, int& b, int* sa,
                                            int* sb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ta = __shfl_up_sync(kFull, a, off);
    const int tb = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      a += ta;
      b += tb;
    }
  }
  if (lane == 31) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    int xa = sa[lane], xb = sb[lane];  // kScanThreads / 32 == 32 warps
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ta = __shfl_up_sync(kFull, xa, off);
      const int tb = __shfl_up_sync(kFull, xb, off);
      if (lane >= off) {
        xa += ta;
        xb += tb;
      }
    }
    sa[lane] = xa - sa[lane];  // exclusive
    sb[lane] = xb - sb[lane];
  }
  __syncthreads();
  a += sa[warp];
  b += sb[warp];
}

__global__ void __launch_bounds__(kScanThreads)
bucket_scan_kernel(Layout L, int n_buckets, int CH, int n_map) {
  __shared__ int sa[32], sb[32];
  __shared__ int carry[2];
  if (threadIdx.x == 0) carry[0] = carry[1] = 0;
  __syncthreads();
  for (int base = 0; base < n_buckets; base += kScanThreads) {
    const int b = base + threadIdx.x;
    const int c = b < n_buckets ? L.counts[b] : 0;
    const int k = b < n_buckets ? (c > CH ? (c + CH - 1) / CH : 1) : 0;
    int ia = c, ib = k;
    block_scan2(ia, ib, sa, sb);
    const int off = carry[0] + ia - c, first = carry[1] + ib - k;
    if (b < n_buckets) {
      L.offset[b] = off;
      L.cursor[b] = off;
      L.chunk_start[b] = first;
      for (int j = 0; j < k; ++j) L.chunk_bucket[first + j] = b;
    }
    __syncthreads();  // everyone has read carry
    if (threadIdx.x == kScanThreads - 1) {
      carry[0] = off + c;
      carry[1] = first + k;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    L.offset[n_buckets] = carry[0];
    L.chunk_start[n_buckets] = carry[1];
  }
  for (int j = carry[1] + threadIdx.x; j < n_map; j += kScanThreads)
    L.chunk_bucket[j] = -1;
}

template <class Key>
__global__ void __launch_bounds__(kFillThreads)
bucket_fill_kernel(const Key key, long long N, int n_buckets, int CH,
                   Layout L) {
  extern __shared__ int fill_hist[];  // [n_buckets] when they fit
  const bool local = n_buckets <= kMaxSmemBins;  // block-uniform
  if (local) {
    for (int j = threadIdx.x; j < n_buckets; j += kFillThreads)
      fill_hist[j] = 0;
    __syncthreads();
  }
  const long long tile0 = (long long)blockIdx.x * kFillTile + threadIdx.x;
  int b[kItems], slot[kItems], payload[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = tile0 + k * kFillThreads;
    b[k] = i < N ? key(i, payload[k]) : -1;
    slot[k] = local ? claim_run(fill_hist, b[k]) : claim(L.cursor, b[k]);
  }
  if (local) {  // reserve each bucket's range of this block's samples
    __syncthreads();
    for (int j = threadIdx.x; j < n_buckets; j += kFillThreads) {
      const int c = fill_hist[j];
      if (c) fill_hist[j] = atomicAdd(L.cursor + j, c);
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (b[k] >= 0)
      L.perm[(local ? fill_hist[b[k]] : 0) + slot[k]] =
          make_int2((int)(tile0 + k * kFillThreads), payload[k]);

  for (int bb = blockIdx.x; bb < n_buckets; bb += gridDim.x)
    key.zero(bb, L.counts[bb] > CH);  // block-uniform
}

// Passes 1-3 on stream s.  N > 0.  The fill runs on at least
// min_fill_blocks blocks (a Key that zeroes something for every bucket
// asks for enough of them).
template <class Key>
cudaError_t bucket(const Key& key, long long N, int n_buckets, int CH,
                   int n_map, const Layout& L, cudaStream_t s,
                   unsigned min_fill_blocks = 1) {
  cudaError_t e = cudaMemsetAsync(L.counts, 0, sizeof(int) * n_buckets, s);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((N + kFillTile - 1) / kFillTile);
  const size_t hist =
      n_buckets <= kMaxSmemBins ? sizeof(int) * n_buckets : 0;
  bucket_count_kernel<Key><<<grid, kFillThreads, hist, s>>>(key, N, n_buckets,
                                                            L.counts);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bucket_scan_kernel<<<1, kScanThreads, 0, s>>>(L, n_buckets, CH, n_map);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  bucket_fill_kernel<Key>
      <<<grid > min_fill_blocks ? grid : min_fill_blocks, kFillThreads, hist,
         s>>>(key, N, n_buckets, CH, L);
  return cudaGetLastError();
}

}  // namespace bucketing
