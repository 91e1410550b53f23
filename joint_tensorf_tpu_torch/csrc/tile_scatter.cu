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
// without moving any update row, in three small passes over the indices
// (count, scan, fill: bucketing.cuh, with RowKey below: payload the row
// within the block; the fill zeroes the output rows of buckets that
// several chunks share), then one block per chunk of at most CH samples of
// one bucket adds the gathered rows into a BR x C shared-memory tile.
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
//      zeroed by the fill).
// Samples outside [0, n_rows) are dropped.  Summation order varies from
// run to run.  The kernels allocate nothing: the caller passes the
// bucketing's arrays (see Layout) and the output.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bucketing.cuh"

namespace {

using bucketing::Layout;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAccThreads = 256;
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kChunkMax = 2048;  // samples per accumulate block, at most
constexpr int kUnroll = 8;

// The bucketing's key: sample i goes to block idx[i] / BR with its row
// within the block as payload; indices outside [0, n_rows) are dropped.
// Rows of blocks that several accumulate blocks share start at 0.
template <typename T>
struct RowKey {
  const T* idx;
  long long n_rows;
  int BR;
  float* out;
  int C;

  __device__ __forceinline__ int operator()(long long i, int& row) const {
    row = 0;
    const long long v = (long long)idx[i];
    if (v < 0 || v >= n_rows) return -1;
    const long long b = v / BR;
    row = (int)(v - b * BR);
    return (int)b;
  }

  __device__ __forceinline__ void zero(int bb, bool multi_chunk) const {
    if (!multi_chunk) return;
    const long long r0 = (long long)bb * BR;
    const long long n = (n_rows - r0 < BR ? n_rows - r0 : BR) * C;
    float* dst = out + r0 * C;
    for (long long e = threadIdx.x; e < n; e += bucketing::kFillThreads)
      dst[e] = 0.f;
  }
};

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
    return (int)bucketing::bucket(
        RowKey<long long>{(const long long*)idx, n_rows, BR, (float*)out, C},
        N, n_buckets, CH, n_map, L, s);
  if (idx_bytes == 4)
    return (int)bucketing::bucket(
        RowKey<int>{(const int*)idx, n_rows, BR, (float*)out, C}, N,
        n_buckets, CH, n_map, L, s);
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
