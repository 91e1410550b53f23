// What the plane x line factor samples K6 (density_sample.cu) and K7
// (app_sample.cu) share: an axis's factors and their dims, one axis's cell
// and corner rows at a slot, the 16-byte or scalar loads, stores and
// float32 reductions, the lane group's sum, and the card's resident-block
// count.  Cells are align-corners and clamped to the border, as
// ops/sampling.py's _pix and _floor_frac.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Axis {
  const float* plane;   // [H, W, R]
  const float* line;    // [D, R]
  float* d_plane;       // [H, W, R] or null
  float* d_line;        // [D, R] or null
  int H, W, D, R;
  int cu, cv, cw;       // coordinates read as u (-> W), v (-> H), w (-> D)
  int off;              // K7: the axis's first channel in the feature row
  int line_off;         // K6: offset of d_line in the block's shared copy
};

// One axis's cell: the clamped continuous index's floor (i0), its
// neighbour clamped to the border (i1), the fraction and the unclamped
// index (for the border masks of the coordinate gradients).
struct Cell {
  int i0, i1;
  float f, raw;
};

__device__ __forceinline__ Cell cell(float c, int size) {
  const float raw = (c + 1.f) * 0.5f * (float)(size - 1);
  const float x = fminf(fmaxf(raw, 0.f), (float)(size - 1));
  const float hi = size > 1 ? (float)(size - 2) : 0.f;
  const float x0 = fminf(fmaxf(floorf(x), 0.f), hi);
  Cell r;
  r.i0 = (int)x0;
  r.i1 = min(r.i0 + 1, size - 1);
  r.f = x - x0;
  r.raw = raw;
  return r;
}

__device__ __forceinline__ float pick(float a, float b, float c, int k) {
  return k == 0 ? a : (k == 1 ? b : c);
}

// d[k] += v with constant indices (a runtime index would put d in local
// memory)
__device__ __forceinline__ void add3(float (&d)[3], int k, float v) {
  d[0] += k == 0 ? v : 0.f;
  d[1] += k == 1 ? v : 0.f;
  d[2] += k == 2 ? v : 0.f;
}

template <int VW>
__device__ __forceinline__ void ld(const float* p, float (&r)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else {
    r[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void st(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int VW>
__device__ __forceinline__ void red(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// the sum over a group of G consecutive lanes, in every lane of it
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The rows of one axis at one slot.
struct Rows {
  const float *p00, *p01, *p10, *p11, *l0, *l1;
  long long o00, o01, o10, o11, q0, q1;   // their offsets, in floats
  Cell x, y, z;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Rows rows(const Axis& ax, float cx, float cy,
                                     float cz) {
  Rows r;
  r.x = cell(pick(cx, cy, cz, ax.cu), ax.W);
  r.y = cell(pick(cx, cy, cz, ax.cv), ax.H);
  r.z = cell(pick(cx, cy, cz, ax.cw), ax.D);
  const long long R = ax.R;
  r.o00 = ((long long)r.y.i0 * ax.W + r.x.i0) * R;
  r.o01 = ((long long)r.y.i0 * ax.W + r.x.i1) * R;
  r.o10 = ((long long)r.y.i1 * ax.W + r.x.i0) * R;
  r.o11 = ((long long)r.y.i1 * ax.W + r.x.i1) * R;
  r.q0 = (long long)r.z.i0 * R;
  r.q1 = (long long)r.z.i1 * R;
  r.p00 = ax.plane + r.o00;
  r.p01 = ax.plane + r.o01;
  r.p10 = ax.plane + r.o10;
  r.p11 = ax.plane + r.o11;
  r.l0 = ax.line + r.q0;
  r.l1 = ax.line + r.q1;
  r.w00 = (1.f - r.y.f) * (1.f - r.x.f);
  r.w01 = (1.f - r.y.f) * r.x.f;
  r.w10 = r.y.f * (1.f - r.x.f);
  r.w11 = r.y.f * r.x.f;
  return r;
}

// The border masks of ops/sampling.py's _prod_chunk_grads: d(index) /
// d(coordinate), or 0 where the unclamped index lies on or past a face.
__device__ __forceinline__ float border_scale(const Cell& c, int size) {
  return (c.raw > 0.f && c.raw < (float)(size - 1)) ? 0.5f * (float)(size - 1)
                                                     : 0.f;
}

// The card's SM count and, per kernel and shared-memory size, how many
// blocks fit on an SM, read once (the host's work per call is small).
int sm_count() {
  static int n[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (n[dev] == 0) cudaDeviceGetAttribute(&n[dev],
                                          cudaDevAttrMultiProcessorCount, dev);
  return n[dev] > 0 ? n[dev] : 132;
}

template <typename K>
int resident_blocks(K kernel, int threads, int smem, int* cache_smem,
                    int* cache_n) {
  if (*cache_smem != smem) {
    // opt in for every dynamic size: the default 48 KB covers the static
    // shared memory too, so a dynamic share just under 48 KB needs it as
    // well
    if (smem > 0)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    *cache_n = per_sm > 0 ? per_sm : 1;
    *cache_smem = smem;
  }
  return *cache_n * sm_count();
}

// Reads the axes' pointers and dims (7 ints an axis: H, W, D, R, cu, cv,
// cw) into ax (off and line_off 0); true where every width is a multiple
// of 4 and every factor pointer 16-byte aligned (the float4 route).
bool fill_axes(Axis (&ax)[3], const void* const* planes,
               const void* const* lines, const int* dims,
               void* const* d_planes, void* const* d_lines) {
  bool vec = true;
  for (int a = 0; a < 3; ++a) {
    Axis& A = ax[a];
    A.plane = (const float*)planes[a];
    A.line = (const float*)lines[a];
    A.d_plane = d_planes ? (float*)d_planes[a] : nullptr;
    A.d_line = d_lines ? (float*)d_lines[a] : nullptr;
    A.H = dims[7 * a];
    A.W = dims[7 * a + 1];
    A.D = dims[7 * a + 2];
    A.R = dims[7 * a + 3];
    A.cu = dims[7 * a + 4];
    A.cv = dims[7 * a + 5];
    A.cw = dims[7 * a + 6];
    A.off = 0;
    A.line_off = 0;
    vec = vec && A.R % 4 == 0 && (((uintptr_t)A.plane | (uintptr_t)A.line |
                                   (uintptr_t)A.d_plane |
                                   (uintptr_t)A.d_line) & 15) == 0;
  }
  return vec;
}

}  // namespace
