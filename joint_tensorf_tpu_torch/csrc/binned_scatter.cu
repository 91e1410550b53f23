// Tile-binned bilinear plane-gradient scatter for Hopper (sm_90a): K4 and
// the bucketing in front of it.
//
//   d_plane[H, W, R] = sum over samples n of g[n] * w_k(n) at the four
//                      corners k of cell (x0[n], y0[n])
//
// with w = ((1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx) for the corners
// (x0,y0), (x0+1,y0), (x0,y0+1), (x0+1,y0+1), x0 <= W-2 and y0 <= H-2.
//
// Replaces the TPU kernel in joint_tensorf_tpu/ops/binned_scatter.py:
// _scatter_kernel (launched by _plane_grad_scatter), the backward of
// sample_plane_binned.  That kernel pads each tile's samples to 256-row
// chunks and runs one [128, 256] one-hot MXU matmul per chunk into a VMEM
// tile, then overlap-adds the tiles outside the kernel; none of that is
// carried over.
//
// Bound on this card: bytes.  g (N x R x 4 B) and the per-sample cell and
// fractions are read once, d_plane (H x W x R x 4 B) is written once; the
// ~8 N R flops are far below the float32 peak.
//
// Design.  A plane tile is TS x TS cells; its accumulator is the
// (TS+1)^2 pixels its cells' corners touch, x R channels, in shared memory.
//   1-3. Bucketing (bucketing.cuh with TileKey below; no sort): count,
//      scan and fill put every sample in its tile's bucket as (position,
//      cell key), and an accumulate grid of ceil(N / CH) + n_tiles blocks
//      maps each block to one chunk of at most CH samples of one tile.  The
//      fill also zeroes the pixels that blocks will add into atomically:
//      the first row and column of every tile's accumulator (and the last
//      ones at the plane's far edges), where neighbouring tiles meet, and
//      every pixel of a tile split over several chunks.
//   4. binned_plane_scatter (K4 proper), one block per chunk: zero the
//      accumulator and sort the chunk's samples by cell key in shared
//      memory (a counting sort with integer shared atomics, one per run of
//      equal keys in a warp).  The key
//      orders the TS^2 cells by parity class, (y & 1, x & 1), first: two
//      cells of one class share no corner pixel.  The block walks the four
//      classes one after another, a barrier between them.  Inside a class,
//      workers of R/4 lanes (16-byte loads of g when R % 4 == 0, else R
//      lanes; a whole warp in passes of 32 when that is more) each take a
//      contiguous slice of the class's sorted samples and gather their g
//      rows and fractions, kUnroll samples in flight, keeping the four
//      corner sums of the current cell in registers.  A cell whose samples
//      all lie inside one slice owns its four pixels within the class, so
//      its sums are added with a plain read-add-write, once per cell; only
//      each slice's first and last cells, which a neighbouring slice may
//      share, take float shared atomics.  So a crowded cell (the clamped
//      samples on the plane's border) costs a few atomics, not four per
//      sample and channel as the first version did.
//      The flush writes the interior pixels of a one-chunk tile with plain
//      stores (no other block touches them) and adds the rest with one
//      global atomicAdd per non-zero entry (zeroed by the fill).
// On the H100 at 400^2 x 64 with 2.03M samples in march order the
// accumulate takes ~0.30 ms against the 0.172 ms byte bound, and the
// class passes' gathers are nearly all of it (scripts/
// chip_kernel_variants.py: 0.029 ms without them, 0.276 without the
// flush, 0.291 with plain writes for the slice edges' cells, whose shared
// float atomicAdd is a compare-and-swap loop on sm_90a).  Fewer warps an
// SM or longer slices cost more than deeper unrolls gain: kUnroll 2 0.314,
// kUnroll 8 at three blocks an SM 0.380, 32-sample minimum slices 0.351,
// one pass over the chunk with every cell added atomically 0.346, float2
// lanes (one worker a warp) 0.302, against 0.297 as built: 64 registers
// a thread, four blocks an SM, 20 bytes spilled.
// Samples whose cell lies outside the plane's are dropped.  Summation order
// varies from run to run.  The kernels allocate nothing: the caller passes
// the bucketing's arrays (bucketing::Layout) and the output.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bucketing.cuh"

namespace {

using bucketing::Layout;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTS = 10;              // tile side in cells
constexpr int kP1 = kTS + 1;         // accumulator side in pixels
constexpr int kCells = kTS * kTS;    // cell keys per tile
constexpr int kQ = kTS / 2;          // cells of one parity class per axis
constexpr int kClass = kQ * kQ;      // cells of one parity class
constexpr int kAccThreads = 256;
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kChunkMax = 2048;      // samples per accumulate block, at most
constexpr int kUnroll = 4;
static_assert(kTS % 2 == 0, "the parity classes need an even tile side");

// Cell (lx, ly) of a tile <-> its key: parity class first, so that each
// class is one contiguous range of kClass keys.
__host__ __device__ __forceinline__ int cell_key(int lx, int ly) {
  return (((ly & 1) << 1) | (lx & 1)) * kClass + (ly >> 1) * kQ + (lx >> 1);
}

// Index of the top-left corner pixel of the cell with key k.
__device__ __forceinline__ int corner_pixel(int k) {
  const int c = k / kClass, r = k - c * kClass;
  const int qy = r / kQ;
  return (2 * qy + (c >> 1)) * kP1 + 2 * (r - qy * kQ) + (c & 1);
}

// The bucketing's key: sample i goes to the tile of cell (x0, y0) with the
// cell's key as payload.  The fill zeroes what the accumulate adds into.
struct TileKey {
  const long long* x0;
  const long long* y0;
  int H, W, n_tx, n_ty;
  float* out;
  int R;

  __device__ __forceinline__ int operator()(long long i, int& key) const {
    key = 0;
    const long long x = x0[i], y = y0[i];
    if (x < 0 || y < 0 || x > (W > 1 ? W - 2 : 0) ||
        y > (H > 1 ? H - 2 : 0))
      return -1;
    const int tx = (int)x / kTS, ty = (int)y / kTS;
    key = cell_key((int)x - tx * kTS, (int)y - ty * kTS);
    return ty * n_tx + tx;
  }

  // The accumulator's first row and column (the last ones too for the
  // plane's last tiles), or all of it when several chunks share the tile.
  __device__ __forceinline__ void zero(int bb, bool multi_chunk) const {
    const int ty = bb / n_tx, tx = bb - ty * n_tx;
    const bool last_x = tx == n_tx - 1, last_y = ty == n_ty - 1;
    const int lane = threadIdx.x & 31;
    for (int p = threadIdx.x >> 5; p < kP1 * kP1;
         p += bucketing::kFillThreads / 32) {
      const int ly = p / kP1, lx = p - ly * kP1;
      if (!(multi_chunk || lx == 0 || ly == 0 || (lx == kTS && last_x) ||
            (ly == kTS && last_y)))
        continue;
      const int y = ty * kTS + ly, x = tx * kTS + lx;
      if (y >= H || x >= W) continue;
      float* dst = out + ((long long)y * W + x) * R;
      for (int c = lane; c < R; c += 32) dst[c] = 0.f;
    }
  }
};

// float / float4 helpers for the accumulate kernel
__device__ __forceinline__ float vzero(float) { return 0.f; }
__device__ __forceinline__ float4 vzero(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void vfma(float& a, float x, float w) {
  a = fmaf(x, w, a);
}
__device__ __forceinline__ void vfma(float4& a, float4 x, float w) {
  a.x = fmaf(x.x, w, a.x);
  a.y = fmaf(x.y, w, a.y);
  a.z = fmaf(x.z, w, a.z);
  a.w = fmaf(x.w, w, a.w);
}
__device__ __forceinline__ void vaccum(float* p, float v) { *p += v; }
__device__ __forceinline__ void vaccum(float* p, float4 v) {
  float4* q = reinterpret_cast<float4*>(p);
  float4 a = *q;
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
  *q = a;
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
__device__ __forceinline__ void vstore(float* p, float v) { *p = v; }
__device__ __forceinline__ void vstore(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void vatomic_nonzero(float* p, float v) {
  if (v != 0.f) atomicAdd(p, v);
}
__device__ __forceinline__ void vatomic_nonzero(float* p, float4 v) {
  vatomic_nonzero(p, v.x);
  vatomic_nonzero(p + 1, v.y);
  vatomic_nonzero(p + 2, v.z);
  vatomic_nonzero(p + 3, v.w);
}

// Add one cell's four corner sums (this lane's vector e) into the
// accumulator: atomically where a neighbouring slice may hold the cell.
template <typename V>
__device__ __forceinline__ void put_cell(float* acc, int R, int key, int e,
                                         const V (&s)[4], bool atomic) {
  constexpr int VEC = sizeof(V) / sizeof(float);
  float* p = acc + corner_pixel(key) * R + e * VEC;
  float* q[4] = {p, p + R, p + kP1 * R, p + (kP1 + 1) * R};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (atomic)
      vatomic(q[c], s[c]);
    else
      vaccum(q[c], s[c]);
  }
}

// V = float4 (R % 4 == 0, 16-byte aligned g) or float.  Four blocks an SM.
template <typename V>
__global__ void __launch_bounds__(kAccThreads, 4)
binned_plane_scatter_kernel(const float* __restrict__ g,
                            const float* __restrict__ fx,
                            const float* __restrict__ fy, Layout L,
                            float* __restrict__ out, int H, int W, int R,
                            int n_tx, int CH) {
  extern __shared__ float4 tile_raw[];
  constexpr int VEC = sizeof(V) / sizeof(float);
  float* acc = reinterpret_cast<float*>(tile_raw);  // [kP1 * kP1, R]
  int* spos = reinterpret_cast<int*>(acc + kP1 * kP1 * R);  // [CH] by key
  int* kstart = spos + CH;  // [kCells + 1]: each key's range of spos
  const int bkt = L.chunk_bucket[blockIdx.x];
  if (bkt < 0) return;
  const int first = L.chunk_start[bkt];
  const bool multi = L.chunk_start[bkt + 1] - first > 1;
  const int s0 = L.offset[bkt] + (blockIdx.x - first) * CH;
  const int ns = min(s0 + CH, L.offset[bkt + 1]) - s0;
  const int ty = bkt / n_tx;
  const int yb = ty * kTS, xb = (bkt - ty * n_tx) * kTS;
  const int n_vec = kP1 * kP1 * R / VEC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  V* acc_v = reinterpret_cast<V*>(acc);
  for (int e = tid; e < n_vec; e += kAccThreads) acc_v[e] = vzero(V());
  for (int k = tid; k <= kCells; k += kAccThreads) kstart[k] = 0;
  __syncthreads();

  // counting sort of the chunk's samples by cell key
  int pos[kChunkMax / kAccThreads], key[kChunkMax / kAccThreads],
      rank[kChunkMax / kAccThreads];
#pragma unroll
  for (int k = 0; k < kChunkMax / kAccThreads; ++k) {
    const int j = k * kAccThreads + tid;
    key[k] = -1;
    if (j < ns) {
      const int2 pk = L.perm[s0 + j];
      pos[k] = pk.x;
      key[k] = pk.y;
    }
    rank[k] = bucketing::claim_run(kstart + 1, key[k]);
  }
  __syncthreads();
  if (warp == 0) {  // scan kstart[1..kCells]: key k is [kstart[k], kstart[k+1])
    int carry = 0;
    for (int base = 1; base <= kCells; base += 32) {
      const int i = base + lane;
      int v = i <= kCells ? kstart[i] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += t;
      }
      if (i <= kCells) kstart[i] = carry + v;
      carry += __shfl_sync(kFull, v, 31);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kChunkMax / kAccThreads; ++k)
    if (key[k] >= 0) spos[kstart[key[k]] + rank[k]] = pos[k];
  __syncthreads();

  // Workers of E lanes (a whole warp, in passes of 32 vectors, when
  // E > 32), one parity class at a time.
  const int E = R / VEC;                 // vectors per pixel
  const int rpw = E >= 32 ? 1 : 32 / E;  // workers per warp
  const int slot = E >= 32 ? 0 : lane / E;
  const int n_workers = kAccWarps * rpw, worker = warp * rpw + slot;
  for (int cls = 0; cls < 4; ++cls) {
    const int k_lo = cls * kClass;
    const int ca = kstart[k_lo], n_c = kstart[k_lo + kClass] - ca;
    const int per = max((n_c + n_workers - 1) / n_workers, kUnroll);
    const int a = ca + min(n_c, worker * per);
    const int b = ca + min(n_c, worker * per + per);
    if (slot < rpw && a < b) {
      int lo = k_lo, hi = k_lo + kClass - 1;  // the key of sorted sample a
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (kstart[mid] <= a)
          lo = mid;
        else
          hi = mid - 1;
      }
      for (int e = (E >= 32 ? lane : lane - slot * E); e < E; e += 32) {
        int k = lo, cur = -1;
        bool first_cell = true;
        V sum[4] = {vzero(V()), vzero(V()), vzero(V()), vzero(V())};
        for (int s = a; s < b; s += kUnroll) {
          V x[kUnroll];
          float ax[kUnroll], ay[kUnroll];
          int kk[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int t = s + u;
            kk[u] = -1;
            x[u] = vzero(V());
            ax[u] = ay[u] = 0.f;
            if (t < b) {
              while (t >= kstart[k + 1]) ++k;
              kk[u] = k;
              const long long n = spos[t];
              x[u] = __ldg(reinterpret_cast<const V*>(g + n * R) + e);
              ax[u] = __ldg(fx + n);
              ay[u] = __ldg(fy + n);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (kk[u] < 0) continue;
            if (kk[u] != cur) {
              if (cur >= 0) put_cell(acc, R, cur, e, sum, first_cell);
              first_cell = cur < 0;
              cur = kk[u];
#pragma unroll
              for (int c = 0; c < 4; ++c) sum[c] = vzero(V());
            }
            vfma(sum[0], x[u], (1.f - ay[u]) * (1.f - ax[u]));
            vfma(sum[1], x[u], (1.f - ay[u]) * ax[u]);
            vfma(sum[2], x[u], ay[u] * (1.f - ax[u]));
            vfma(sum[3], x[u], ay[u] * ax[u]);
          }
        }
        put_cell(acc, R, cur, e, sum, true);
      }
    }
    __syncthreads();  // the next class may share this one's pixels
  }

  // flush: interior pixels of a one-chunk tile are this block's alone
  for (int e = tid; e < n_vec; e += kAccThreads) {
    const int f = e * VEC;
    const int p = f / R;
    const int ly = p / kP1, lx = p - ly * kP1;
    const int y = yb + ly, x = xb + lx;
    if (y >= H || x >= W) continue;
    float* dst = out + ((long long)y * W + x) * R + (f - p * R);
    if (!multi && lx != 0 && ly != 0 && lx != kTS && ly != kTS)
      vstore(dst, acc_v[e]);
    else
      vatomic_nonzero(dst, acc_v[e]);
  }
}

template <typename V>
cudaError_t launch_accumulate(const float* g, const float* fx,
                              const float* fy, const Layout& L, float* out,
                              int H, int W, int R, int n_tx, int CH,
                              int n_map, cudaStream_t s) {
  if (CH > kChunkMax) return cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)kP1 * kP1 * R + CH + kCells + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        binned_plane_scatter_kernel<V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  binned_plane_scatter_kernel<V><<<(unsigned)n_map, kAccThreads, smem, s>>>(
      g, fx, fy, L, out, H, W, R, n_tx, CH);
  return cudaGetLastError();
}

}  // namespace

// Passes 1-3: bucket N samples (cells x0, y0, int64) by tile of ts x ts
// cells into the Layout's arrays, and zero the pixels of out [H, W, R]
// that the accumulate adds into atomically.  N > 0; ts must be the
// kernels' tile side.
extern "C" int binned_bucket(const void* x0, const void* y0, long long N,
                             int H, int W, int ts, int n_tx,
                             int n_ty, int CH, int n_map, void* perm,
                             void* counts, void* offset, void* cursor,
                             void* chunk_start, void* chunk_bucket, void* out,
                             int R, void* stream) {
  if (ts != kTS) return (int)cudaErrorInvalidValue;
  const Layout L{(int2*)perm, (int*)counts, (int*)offset, (int*)cursor,
                 (int*)chunk_start, (int*)chunk_bucket};
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = n_tx * n_ty;
  // the fill zeroes 8 tiles' pixels a block at least
  return (int)bucketing::bucket(
      TileKey{(const long long*)x0, (const long long*)y0, H, W, n_tx, n_ty,
              (float*)out, R},
      N, n_tiles, CH, n_map, L, s, (unsigned)((n_tiles + 7) / 8));
}

// Pass 4 (K4): accumulate the bucketed samples into out [H, W, R].
extern "C" int binned_plane_scatter(const void* g, const void* fx,
                                    const void* fy, const void* perm,
                                    const void* offset,
                                    const void* chunk_start,
                                    const void* chunk_bucket, void* out,
                                    int H, int W, int R, int n_tx, int CH,
                                    int n_map, void* stream) {
  const Layout L{(int2*)perm, nullptr, (int*)offset, nullptr,
                 (int*)chunk_start, (int*)chunk_bucket};
  const cudaStream_t s = (cudaStream_t)stream;
  if (R % 4 == 0 && ((uintptr_t)g & 15) == 0)
    return (int)launch_accumulate<float4>(
        (const float*)g, (const float*)fx, (const float*)fy, L, (float*)out,
        H, W, R, n_tx, CH, n_map, s);
  return (int)launch_accumulate<float>((const float*)g, (const float*)fx,
                                       (const float*)fy, L, (float*)out, H, W,
                                       R, n_tx, CH, n_map, s);
}
