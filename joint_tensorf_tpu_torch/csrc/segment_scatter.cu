// Row scatter-add for Hopper (sm_90a): K3.
//
//   out = zeros([n_rows, C]).at[idx].add(updates)     idx: [N] int64, updates: [N, C] f32
//
// Replaces the TPU kernel in joint_tensorf_tpu/ops/segment_scatter.py:
// _kernel (reached through scatter_add_rows), the sorted segment sum that
// the plane backward of sample_planeline_prod needs
// (joint_tensorf_tpu/ops/sampling.py:_scatter_plane_rows).  The TPU kernel
// sorts and one-hot-matmuls, a measured dead end there (that file's STATUS
// note); nothing of it is carried over.
//
// Callers: the packed plane gradient (C = 4R: 64 / 192 / 256 channels into
// an H x W plane) and the dense grid's row gather (C = 8 into X*Y*Z rows,
// up to 64M of them).  Samples arrive in march order, so consecutive rows
// often share a destination.
//
// Bound on this card: bytes.  The indices and N x C x 4 B of updates are
// read once; the output (allocated by the caller, zeroed by a memset in
// the entry point) is written once.  At the 64M-voxel dense grid that
// memset is most of the bound: the kernel's own part is the updates and
// indices.  The dense grid's call is short (~0.01 ms at 448k x 8), so the
// host's work per call counts too: the memset is issued here, not as a
// separate torch fill from Python.
//
// Design: two routes, chosen by C in the entry point below; each merges
// runs of equal destinations in registers and issues one 16-byte vector
// atomic (atomicAdd on float4, global memory, sm_90) per run and float4
// (measured, scripts/chip_kernel_variants.py --k3: scalar atomics take
// 2.9x as long on the narrow route, one atomic per row 5.6x).
//   * Narrow rows (C % 4 == 0, C <= 16; the dense grid's 8): one thread
//     per row, reading its index once and its row as C/4 float4 loads, so
//     neighbouring lanes read neighbouring rows.  A warp takes 32
//     consecutive rows; a ballot of run heads and a segmented scan
//     (__shfl_up_sync, only as deep as the warp's longest run) leave each
//     run's sum on its last lane, which adds it.
//   * Wide rows (C = 64..256, and any C that is not a multiple of 4, with
//     scalar loads and atomics): groups of C/4 threads (one float4 of
//     channels each) walk 32 consecutive rows, kUnroll rows in flight,
//     several groups a block; the block stages its rows' indices in shared
//     memory once, and each thread keeps its run sum in registers.  The
//     updates are read with streaming loads (__ldcs, evict first), which
//     leaves L2 to the atomics' destination rows (4-16% faster at the
//     420x423 planes).
// Indices outside [0, n_rows) are dropped.  Summation order varies from
// run to run (atomics).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kNarrowMaxC = 16;     // narrow route up to this many channels
constexpr int kRowsPerGroup = 32;   // wide route: consecutive rows a group walks
constexpr int kUnroll = 8;          // wide route: rows in flight per thread
constexpr int kMaxGroups = 128;     // wide route: 32 KB of staged indices

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float vzero(float) { return 0.f; }
__device__ __forceinline__ float4 vzero(float4) { return zero4(); }
__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
// one global atomic per element, or one 16-byte vector atomic (sm_90)
__device__ __forceinline__ void vatomic(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void vatomic(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// Narrow route: NV = C / 4 float4s a row, one row a thread.
template <int NV>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_narrow_kernel(const long long* __restrict__ idx,
                               const float4* __restrict__ upd,
                               float* __restrict__ out, long long N,
                               long long n_rows) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long d = -1;  // destination, -1 when dropped or past N
  float4 v[NV];
  if (r < N) {
    d = __ldg(idx + r);
    if (d < 0 || d >= n_rows) d = -1;
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = __ldg(upd + r * NV + k);
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = zero4();
  }
  // runs of equal destinations among the warp's 32 rows: heads, and each
  // lane's head (the highest head at or below it)
  const long long prev = __shfl_up_sync(kFull, d, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != d);
  const int head = 31 - __clz(heads & (kFull >> (31 - lane)));
  const unsigned depth = __reduce_max_sync(kFull, (unsigned)(lane - head));
  // segmented inclusive scan: lane i ends with the sum of rows head..i
  for (unsigned off = 1; off <= depth; off <<= 1) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float4 t;
      t.x = __shfl_up_sync(kFull, v[k].x, off);
      t.y = __shfl_up_sync(kFull, v[k].y, off);
      t.z = __shfl_up_sync(kFull, v[k].z, off);
      t.w = __shfl_up_sync(kFull, v[k].w, off);
      if (lane - (int)off >= head) vadd(v[k], t);
    }
  }
  const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (tail && d >= 0) {
    float* dst = out + d * (4 * NV);
#pragma unroll
    for (int k = 0; k < NV; ++k) vatomic(dst + 4 * k, v[k]);
  }
}

// Wide route: V = float4 (C % 4 == 0, 16-byte aligned) or float.  The
// block's threads form G groups of TG threads; group g walks rows
// [g * kRowsPerGroup, (g + 1) * kRowsPerGroup) of the block's range, each
// thread over vectors e = lane-in-group, + TG, ... of the E = C / VEC.
template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_wide_kernel(const long long* __restrict__ idx,
                             const float* __restrict__ upd,
                             float* __restrict__ out, long long N, int C,
                             long long n_rows, int TG, int G) {
  extern __shared__ long long sidx[];  // [G * kRowsPerGroup]
  constexpr int VEC = sizeof(V) / sizeof(float);
  const long long r0 = (long long)blockIdx.x * G * kRowsPerGroup;
  const int nr = (int)(N - r0 < (long long)G * kRowsPerGroup
                           ? N - r0
                           : (long long)G * kRowsPerGroup);
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    const long long d = __ldg(idx + r0 + i);
    sidx[i] = (d >= 0 && d < n_rows) ? d : -1;
  }
  __syncthreads();
  const int g = threadIdx.x / TG;
  const int a = g * kRowsPerGroup;
  const int b = min(a + kRowsPerGroup, nr);
  const int E = C / VEC;
  const V* src = reinterpret_cast<const V*>(upd + r0 * C);
  for (int e = threadIdx.x - g * TG; e < E; e += TG) {
    long long cur = -1;  // destination of the open run, -1 when dropped
    V run = vzero(V());
    for (int s = a; s < b; s += kUnroll) {
      V x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = s + u < b ? __ldcs(src + (long long)(s + u) * E + e)
                       : vzero(V());
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s + u >= b) break;
        const long long d = sidx[s + u];
        if (d == cur) {
          vadd(run, x[u]);
        } else {
          if (cur >= 0) vatomic(out + cur * C + e * VEC, run);
          cur = d;
          run = x[u];
        }
      }
    }
    if (cur >= 0) vatomic(out + cur * C + e * VEC, run);
  }
}

template <int NV>
cudaError_t launch_narrow(const long long* idx, const float* upd, float* out,
                          long long N, long long n_rows, cudaStream_t s) {
  const long long blocks = (N + kThreads - 1) / kThreads;
  scatter_add_rows_narrow_kernel<NV><<<(unsigned)blocks, kThreads, 0, s>>>(
      idx, reinterpret_cast<const float4*>(upd), out, N, n_rows);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch_wide(const long long* idx, const float* upd, float* out,
                        long long N, int C, long long n_rows, cudaStream_t s) {
  const int E = C / (int)(sizeof(V) / sizeof(float));
  const int TG = E < kThreads ? E : kThreads;
  const int G = kThreads / TG < kMaxGroups ? kThreads / TG : kMaxGroups;
  const long long rows = (long long)G * kRowsPerGroup;
  const long long blocks = (N + rows - 1) / rows;
  scatter_add_rows_wide_kernel<V>
      <<<(unsigned)blocks, G * TG, rows * sizeof(long long), s>>>(
          idx, upd, out, N, C, n_rows, TG, G);
  return cudaGetLastError();
}

}  // namespace

// out [n_rows, C] is allocated by the caller and zeroed here (one memset
// on the stream, then the scatter); updates [N, C] and idx [N] contiguous
// on the stream's device.
extern "C" int scatter_add_rows(const void* idx, const void* upd, void* out,
                                long long N, int C, long long n_rows,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      cudaMemsetAsync(out, 0, (size_t)n_rows * C * sizeof(float), s);
  if (e != cudaSuccess || N == 0 || C == 0) return (int)e;
  const long long* ix = (const long long*)idx;
  const float* u = (const float*)upd;
  float* o = (float*)out;
  const bool vec = C % 4 == 0 && ((uintptr_t)upd & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  if (vec && C <= kNarrowMaxC) {
    switch (C / 4) {
      case 1: return (int)launch_narrow<1>(ix, u, o, N, n_rows, s);
      case 2: return (int)launch_narrow<2>(ix, u, o, N, n_rows, s);
      case 3: return (int)launch_narrow<3>(ix, u, o, N, n_rows, s);
      default: return (int)launch_narrow<4>(ix, u, o, N, n_rows, s);
    }
  }
  if (vec) return (int)launch_wide<float4>(ix, u, o, N, C, n_rows, s);
  return (int)launch_wide<float>(ix, u, o, N, C, n_rows, s);
}
