// Row scatter-add with a block-local shared-memory accumulator for Hopper
// (sm_90a): K5 and the bucketing kernels in front of it.
//
//   out = zeros([n_rows, C]).at[idx].add(updates)
//
// K3's contract with another design.  Replaces the TPU kernel in
// joint_tensorf_tpu/ops/tile_scatter.py: _kernel (reached through
// scatter_add_rows_tiled), which double-buffers sorted chunks by DMA into
// VMEM, read-modify-writes rows of a 4096-row VMEM block and flushes the
// block once.  Its wrapper sorts the samples and permutes the update rows
// first; on this card that sort and permute cost more than the whole
// scatter (index_add_), so none of it is carried over.  A 4096 x 128
// block does not fit in shared memory either: the wrapper picks BR rows
// per block from C (BR x C x 4 B <= 96 KB).
//
// Bound on this card: bytes.  The indices and N x C x 4 B of updates are
// read once, n_rows x C x 4 B written once; the adds are far below the
// float32 peak.
//
// Design: the samples are bucketed by destination block (b = idx / BR)
// without moving any update row, in three small passes over the indices,
// then one block per chunk of at most CH samples of one bucket adds the
// gathered rows into a BR x C shared-memory tile.
//   1. tile_bucket_count: a shared-memory histogram per block of 2048
//      samples, added into counts[b] (warp-aggregated global atomics,
//      lanes of one bucket grouped by __match_any_sync, when the buckets do
//      not fit in shared memory).
//   2. tile_bucket_scan (one block): exclusive prefix sums of the counts
//      (offset, and cursor = offset) and of the chunks per bucket,
//      max(1, ceil(count / CH)): an empty bucket gets one chunk, so that a
//      block writes its zero rows.  It also writes chunk_bucket, the bucket
//      of each of the accumulate grid's blocks (-1 past the last chunk);
//      the grid is sized by the bound ceil(N / CH) + n_buckets, so the host
//      never waits for a count.
//   3. tile_bucket_fill: each sample claims a slot in its bucket, ranked by
//      a shared-memory atomic and placed by one global atomicAdd per bucket
//      and block on the cursor (warp-aggregated atomics on the cursor when
//      the buckets do not fit), and writes (position, row within the block)
//      there.  The same kernel zeroes the output rows of buckets that
//      several chunks share.
//   4. scatter_add_rows_tiled (K5 proper): zero the tile, and sort the
//      chunk's samples by row in shared memory (a counting sort with
//      integer shared atomics: histogram, scan, place).  Workers of C/4
//      lanes (16-byte loads when C % 4 == 0, else C lanes; a whole warp in
//      passes of 32 when that is more than 32) then each take a
//      contiguous slice of the sorted samples and gather the update rows
//      from their original places, kUnroll rows in flight, keeping a
//      running sum per row in registers.  A row's samples are contiguous,
//      so a run inside a slice is the whole row and is stored with a plain
//      shared store; only each slice's first and last runs, which a
//      neighbouring slice may share, take a shared atomicAdd.  A hot row
//      thus costs a few atomics, and no float atomic is made per sample:
//      a version that made one per sample and element ran 3x slower at
//      (524288, 90000, 64) on the H100.  The block flushes its rows with
//      plain coalesced stores when its bucket has one chunk, and with a
//      global atomicAdd per non-zero entry otherwise (those rows were
//      zeroed by pass 3).
// Samples outside [0, n_rows) are dropped.  Summation order varies from
// run to run.  The kernels allocate nothing: the caller passes the
// bucketing's arrays (see Layout) and the output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFillThreads = 256;
constexpr int kItems = 8;
constexpr int kFillTile = kFillThreads * kItems;  // samples a count/fill block
constexpr int kMaxSmemBins = 12288;               // 48 KB of int counters
constexpr int kScanThreads = 1024;
constexpr int kAccThreads = 256;
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kChunkMax = 2048;  // samples per accumulate block, at most
constexpr int kUnroll = 8;

// The bucketing's int32 arrays, each allocated by the caller.
struct Layout {
  int2* perm;         // [N]: (sample position, row within its block)
  int* counts;        // [n_buckets]
  int* offset;        // [n_buckets + 1]: exclusive prefix of counts
  int* cursor;        // [n_buckets]: next free slot of each bucket
  int* chunk_start;   // [n_buckets + 1]: exclusive prefix of chunks
  int* chunk_bucket;  // [n_map]: bucket of each accumulate block, or -1
};

// Bucket of sample i (-1 past N or for an index outside [0, n_rows)).
template <typename T>
__device__ __forceinline__ int bucket_of(const T* __restrict__ idx,
                                         long long i, long long N,
                                         long long n_rows, int BR,
                                         int& row) {
  row = 0;
  if (i >= N) return -1;
  const long long v = (long long)idx[i];
  if (v < 0 || v >= n_rows) return -1;
  const long long b = v / BR;
  row = (int)(v - b * BR);
  return (int)b;
}

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

template <typename T>
__global__ void __launch_bounds__(kFillThreads)
tile_bucket_count_kernel(const T* __restrict__ idx, long long N,
                         long long n_rows, int BR, int n_buckets,
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
    int row;
    const int b =
        bucket_of(idx, tile0 + k * kFillThreads, N, n_rows, BR, row);
    if (!local)
      claim(counts, b);
    else if (b >= 0)
      atomicAdd(count_hist + b, 1);
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
tile_bucket_scan_kernel(Layout L, int n_buckets, int CH, int n_map) {
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

template <typename T>
__global__ void __launch_bounds__(kFillThreads)
tile_bucket_fill_kernel(const T* __restrict__ idx, long long N,
                        long long n_rows, int BR, int n_buckets, int CH,
                        Layout L, float* __restrict__ out, int C) {
  extern __shared__ int fill_hist[];  // [n_buckets] when they fit
  const bool local = n_buckets <= kMaxSmemBins;  // block-uniform
  if (local) {
    for (int j = threadIdx.x; j < n_buckets; j += kFillThreads)
      fill_hist[j] = 0;
    __syncthreads();
  }
  const long long tile0 = (long long)blockIdx.x * kFillTile + threadIdx.x;
  int b[kItems], slot[kItems], row[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    b[k] = bucket_of(idx, tile0 + k * kFillThreads, N, n_rows, BR, row[k]);
    if (!local)
      slot[k] = claim(L.cursor, b[k]);
    else
      slot[k] = b[k] >= 0 ? atomicAdd(fill_hist + b[k], 1) : 0;
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
          make_int2((int)(tile0 + k * kFillThreads), row[k]);

  // rows of the buckets that several accumulate blocks share start at 0
  for (int bb = blockIdx.x; bb < n_buckets; bb += gridDim.x) {
    if (L.counts[bb] <= CH) continue;  // block-uniform
    const long long r0 = (long long)bb * BR;
    const long long n = (n_rows - r0 < BR ? n_rows - r0 : BR) * C;
    float* dst = out + r0 * C;
    for (long long e = threadIdx.x; e < n; e += kFillThreads) dst[e] = 0.f;
  }
}

// float / float4 helpers for the accumulate kernel
__device__ __forceinline__ float vzero(float) { return 0.f; }
__device__ __forceinline__ float4 vzero(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void vstore(float* p, float v) { *p = v; }
__device__ __forceinline__ void vstore(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void vatomic(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void vatomic(float* p, float4 v) {
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
}

// V = float4 (C % 4 == 0, 16-byte aligned updates) or float.
template <typename V>
__global__ void __launch_bounds__(kAccThreads)
scatter_add_rows_tiled_kernel(const float* __restrict__ upd, Layout L,
                              float* __restrict__ out, int C,
                              long long n_rows, int BR, int CH) {
  extern __shared__ float4 tile_raw[];
  constexpr int VEC = sizeof(V) / sizeof(float);
  float* acc = reinterpret_cast<float*>(tile_raw);   // [BR, C]
  int* spos = reinterpret_cast<int*>(acc + BR * C);  // [CH] sorted by row
  int* rstart = spos + CH;  // [BR + 1]: each row's range of spos
  const int bkt = L.chunk_bucket[blockIdx.x];
  if (bkt < 0) return;
  const int first = L.chunk_start[bkt];
  const int n_chunks = L.chunk_start[bkt + 1] - first;
  const int s0 = L.offset[bkt] + (blockIdx.x - first) * CH;
  const int ns = min(s0 + CH, L.offset[bkt + 1]) - s0;
  const long long r0 = (long long)bkt * BR;
  const int rows = (int)(n_rows - r0 < BR ? n_rows - r0 : BR);
  const int n_vec = rows * C / VEC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  V* acc_v = reinterpret_cast<V*>(acc);
  for (int e = tid; e < n_vec; e += kAccThreads) acc_v[e] = vzero(V());
  for (int r = tid; r <= BR; r += kAccThreads) rstart[r] = 0;
  __syncthreads();

  // counting sort of the chunk's samples by row (integer shared atomics)
  int pos[kChunkMax / kAccThreads], row[kChunkMax / kAccThreads],
      rank[kChunkMax / kAccThreads];
#pragma unroll
  for (int k = 0; k < kChunkMax / kAccThreads; ++k) {
    const int j = k * kAccThreads + tid;
    row[k] = -1;
    if (j < ns) {
      const int2 pr = L.perm[s0 + j];
      pos[k] = pr.x;
      row[k] = pr.y;
      rank[k] = atomicAdd(rstart + pr.y + 1, 1);
    }
  }
  __syncthreads();
  if (warp == 0) {  // scan rstart[1..BR]: row r is [rstart[r], rstart[r+1])
    int carry = 0;
    for (int base = 1; base <= BR; base += 32) {
      const int i = base + lane;
      int v = i <= BR ? rstart[i] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += t;
      }
      if (i <= BR) rstart[i] = carry + v;
      carry += __shfl_sync(kFull, v, 31);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kChunkMax / kAccThreads; ++k)
    if (row[k] >= 0) spos[rstart[row[k]] + rank[k]] = pos[k];
  __syncthreads();

  // Workers of E lanes (a whole warp, in passes of 32 vectors, when
  // E > 32) each sum a contiguous slice of the sorted samples run by run.
  // A run inside the slice holds every sample of its row: plain store.
  // The slice's first and last runs may share their row with the
  // neighbouring slices: shared atomicAdd.
  const int E = C / VEC;                 // vectors per row
  const int rpw = E >= 32 ? 1 : 32 / E;  // workers per warp
  const int slot = E >= 32 ? 0 : lane / E;
  const int per = (ns + kAccWarps * rpw - 1) / (kAccWarps * rpw);
  const int a = min(ns, (warp * rpw + slot) * per), b = min(ns, a + per);
  if (slot < rpw && a < b) {
    int lo = 0, hi = BR - 1;  // the row holding sorted sample a
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (rstart[mid] <= a)
        lo = mid;
      else
        hi = mid - 1;
    }
    for (int e = (E >= 32 ? lane : lane - slot * E); e < E; e += 32) {
      int r = lo, cur = -1;
      bool first_run = true;
      V run = vzero(V());
      for (int s = a; s < b; s += kUnroll) {
        V x[kUnroll];
        int rr[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = s + u;
          rr[u] = -1;
          x[u] = vzero(V());
          if (t < b) {
            while (t >= rstart[r + 1]) ++r;
            rr[u] = r;
            x[u] = __ldg(reinterpret_cast<const V*>(
                       upd + (long long)spos[t] * C) + e);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (rr[u] >= 0 && rr[u] == cur) {
            vadd(run, x[u]);
          } else if (rr[u] >= 0) {
            if (cur >= 0) {
              if (first_run)
                vatomic(acc + cur * C + e * VEC, run);
              else
                vstore(acc + cur * C + e * VEC, run);
              first_run = false;
            }
            cur = rr[u];
            run = x[u];
          }
        }
      }
      vatomic(acc + cur * C + e * VEC, run);
    }
  }
  __syncthreads();

  float* dst = out + r0 * C;
  if (n_chunks == 1) {
    V* dst_v = reinterpret_cast<V*>(dst);
    for (int e = tid; e < n_vec; e += kAccThreads) dst_v[e] = acc_v[e];
  } else {
    for (int e = tid; e < rows * C; e += kAccThreads) {
      const float v = acc[e];
      if (v != 0.f) atomicAdd(dst + e, v);
    }
  }
}

template <typename T>
cudaError_t launch_bucket(const T* idx, long long N, long long n_rows,
                          int BR, int CH, int n_buckets, int n_map,
                          const Layout& L, float* out, int C,
                          cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(L.counts, 0, sizeof(int) * n_buckets, s);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)((N + kFillTile - 1) / kFillTile);
  const size_t hist =
      n_buckets <= kMaxSmemBins ? sizeof(int) * n_buckets : 0;
  tile_bucket_count_kernel<T><<<grid, kFillThreads, hist, s>>>(
      idx, N, n_rows, BR, n_buckets, L.counts);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tile_bucket_scan_kernel<<<1, kScanThreads, 0, s>>>(L, n_buckets, CH,
                                                     n_map);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tile_bucket_fill_kernel<T><<<grid, kFillThreads, hist, s>>>(
      idx, N, n_rows, BR, n_buckets, CH, L, out, C);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_accumulate(const float* upd, const Layout& L, float* out,
                              int C, long long n_rows, int BR, int CH,
                              int n_map, cudaStream_t s) {
  if (CH > kChunkMax) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)BR * C + CH + BR + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scatter_add_rows_tiled_kernel<V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  scatter_add_rows_tiled_kernel<V><<<(unsigned)n_map, kAccThreads, smem, s>>>(
      upd, L, out, C, n_rows, BR, CH);
  return cudaGetLastError();
}

}  // namespace

// Passes 1-3: bucket N samples (idx of idx_bytes = 4 or 8 bytes each) into
// the Layout's arrays and zero the output rows of multi-chunk buckets.
// N > 0 and n_rows > 0.
extern "C" int tile_bucket(const void* idx, int idx_bytes, long long N,
                           long long n_rows, int BR, int CH, int n_buckets,
                           int n_map, void* perm, void* counts, void* offset,
                           void* cursor, void* chunk_start,
                           void* chunk_bucket, void* out, int C,
                           void* stream) {
  const Layout L{(int2*)perm, (int*)counts, (int*)offset, (int*)cursor,
                 (int*)chunk_start, (int*)chunk_bucket};
  const cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes == 8)
    return (int)launch_bucket((const long long*)idx, N, n_rows, BR, CH,
                              n_buckets, n_map, L, (float*)out, C, s);
  if (idx_bytes == 4)
    return (int)launch_bucket((const int*)idx, N, n_rows, BR, CH, n_buckets,
                              n_map, L, (float*)out, C, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 4 (K5): accumulate the bucketed samples into out [n_rows, C].
extern "C" int scatter_add_rows_tiled(const void* upd, const void* perm,
                                      const void* offset,
                                      const void* chunk_start,
                                      const void* chunk_bucket, void* out,
                                      int C, long long n_rows, int BR,
                                      int CH, int n_map, void* stream) {
  const Layout L{(int2*)perm, nullptr, (int*)offset, nullptr,
                 (int*)chunk_start, (int*)chunk_bucket};
  const cudaStream_t s = (cudaStream_t)stream;
  if (C % 4 == 0 && ((uintptr_t)upd & 15) == 0)
    return (int)launch_accumulate<float4>((const float*)upd, L, (float*)out,
                                          C, n_rows, BR, CH, n_map, s);
  return (int)launch_accumulate<float>((const float*)upd, L, (float*)out, C,
                                       n_rows, BR, CH, n_map, s);
}
