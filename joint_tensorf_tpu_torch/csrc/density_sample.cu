// Summed plane x line density sample for Hopper (sm_90a): forward and
// backward (K6).
//
//   feature[n] = live[n] ? sum_a sum_r P_a(u_a[n], v_a[n])[r] * L_a(w_a[n])[r]
//                        : 0
//
// over the three axes a of the VM field's density, P_a [H, W, R] a plane
// sampled bilinearly, L_a [D, R] a line sampled linearly (align-corners,
// clamped to the border, as ops/sampling.py's _pix and _floor_frac), each
// axis reading its own three of the coordinates x, y, z [N].  The plain
// version is ops/sampling.py's sample_planeline_prod summed over R and the
// axes, then masked by ``live``.
//
// Replaces no Pallas kernel.  The JAX package samples the density through
// the fused plane x line sample of joint_tensorf_tpu/ops/sampling.py, whose
// backward is the row scatter K3 replaced; on the compacted step most
// kept slots hold no live sample (the renderer zeroes their density after
// the sample), and that sample gathered, multiplied and scattered them all.
// This kernel exists so that the masked training step does work only for
// the live slots: the dead ones cost one predicate load.
//
// Bound on this card: bytes.  A live slot reads four plane rows and two
// line rows of R floats per axis (from L2: three 400^2 x 16 planes are
// 30.7 MB) and, backward, adds as many; the predicates, coordinates,
// feature and coordinate gradients are read or written once.  The
// arithmetic is a few flops per byte.
//
// Design.  A warp takes 32 consecutive slots: one coalesced load of their
// predicates and a __ballot_sync.  Dead lanes write their zeros and the
// live lanes' positions go to shared memory; then groups of kG = 4 lanes
// take the live slots eight at a time, the lanes of a group spread over
// the R channels in 16-byte loads (scalar loads where a width is not a
// multiple of 4), and a shuffle sums the group.  The renderer's
// compaction keeps each ray's live slots as a prefix, so a run of dead
// slots costs a warp one predicate load each 32 slots.
// Backward recomputes each live slot's rows and fractions and:
//   * adds the plane gradients into the unpacked [H, W, R] planes with
//     16-byte vector float32 reductions (atomicAdd on float4, sm_90): no
//     packed layout, no fold, no per-sample update rows in memory;
//   * adds the line gradients into a per-block shared-memory copy of the
//     three lines (shared atomics), flushed with one global reduction per
//     non-zero entry (float4 where aligned) when the block ends; a grid of
//     as many blocks as fit on the card at once walks all the slots, so
//     the flush is paid once per resident block.  Where the three lines do
//     not fit in kMaxLineSmem, the adds go to global memory directly;
//   * writes the coordinate gradients with the border masks of
//     ops/sampling.py's _prod_chunk_grads (0 at a dead slot), each
//     coordinate summed over the axes that read it.
// Only the gradients asked for are formed: a null output pointer skips its
// adds or stores (frozen factors: no factor adds; detached coordinates: no
// coordinate stores).  Summation order differs from the plain version (the
// group's shuffle; atomics in an order that varies from run to run).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kG = 4;                 // lanes per live slot
constexpr int kPass = 32 / kG;        // live slots a warp takes at once
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 256;
constexpr int kMaxLineSmem = 96 * 1024;   // bytes of shared line gradients

struct Axis {
  const float* plane;   // [H, W, R]
  const float* line;    // [D, R]
  float* d_plane;       // [H, W, R] or null
  float* d_line;        // [D, R] or null
  int H, W, D, R;
  int cu, cv, cw;       // coordinates read as u (-> W), v (-> H), w (-> D)
  int line_off;         // offset of d_line in the block's shared copy
};

struct Params {
  Axis ax[3];
  const float* c[3];            // x, y, z [N]
  const unsigned char* live;    // [N], or null: every slot live
  const float* g;               // [N] the feature's cotangent (backward)
  float* out;                   // [N] the feature (forward)
  float* dc[3];                 // [N] the coordinates' gradients, or null
  long long N;
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
__device__ __forceinline__ void red(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(v[0], v[1], v[2], v[3]));
  } else {
    atomicAdd(p, v[0]);
  }
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kG / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The rows of one axis at one slot.
struct Rows {
  const float *p00, *p01, *p10, *p11, *l0, *l1;
  long long o00, o01, o10, o11, q0, q1;   // their offsets, in floats
  Cell x, y, z;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Rows rows(const Axis& A, float cx, float cy,
                                     float cz) {
  Rows r;
  r.x = cell(pick(cx, cy, cz, A.cu), A.W);
  r.y = cell(pick(cx, cy, cz, A.cv), A.H);
  r.z = cell(pick(cx, cy, cz, A.cw), A.D);
  const long long R = A.R;
  r.o00 = ((long long)r.y.i0 * A.W + r.x.i0) * R;
  r.o01 = ((long long)r.y.i0 * A.W + r.x.i1) * R;
  r.o10 = ((long long)r.y.i1 * A.W + r.x.i0) * R;
  r.o11 = ((long long)r.y.i1 * A.W + r.x.i1) * R;
  r.q0 = (long long)r.z.i0 * R;
  r.q1 = (long long)r.z.i1 * R;
  r.p00 = A.plane + r.o00;
  r.p01 = A.plane + r.o01;
  r.p10 = A.plane + r.o10;
  r.p11 = A.plane + r.o11;
  r.l0 = A.line + r.q0;
  r.l1 = A.line + r.q1;
  r.w00 = (1.f - r.y.f) * (1.f - r.x.f);
  r.w01 = (1.f - r.y.f) * r.x.f;
  r.w10 = r.y.f * (1.f - r.x.f);
  r.w11 = r.y.f * r.x.f;
  return r;
}

// This lane's share (channels sub * VW, stepping kG * VW) of one axis's
// sum over R of p * l.
template <int VW>
__device__ __forceinline__ float axis_fwd(const Axis& A, float cx, float cy,
                                          float cz, int sub) {
  const Rows q = rows(A, cx, cy, cz);
  const float fz = q.z.f;
  float acc = 0.f;
  for (int r = sub * VW; r < A.R; r += kG * VW) {
    float f00[VW], f01[VW], f10[VW], f11[VW], l0[VW], l1[VW];
    ld<VW>(q.p00 + r, f00);
    ld<VW>(q.p01 + r, f01);
    ld<VW>(q.p10 + r, f10);
    ld<VW>(q.p11 + r, f11);
    ld<VW>(q.l0 + r, l0);
    ld<VW>(q.l1 + r, l1);
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const float p = f00[j] * q.w00 + f01[j] * q.w01 + f10[j] * q.w10 +
                      f11[j] * q.w11;
      const float l = l0[j] * (1.f - fz) + l1[j] * fz;
      acc += p * l;
    }
  }
  return acc;
}

// One axis's backward at one slot with cotangent g, this lane's channels:
// the factor adds, and the lane's parts of the coordinate gradients added
// into d[0..2] (x, y, z), already scaled and masked.
template <int VW, bool kSmemLine>
__device__ __forceinline__ void axis_bwd(const Axis& A, float cx, float cy,
                                         float cz, float g, int sub,
                                         float* s_line, float (&d)[3]) {
  const Rows q = rows(A, cx, cy, cz);
  const float fx = q.x.f, fy = q.y.f, fz = q.z.f;
  float du = 0.f, dv = 0.f, dw = 0.f;
  for (int r = sub * VW; r < A.R; r += kG * VW) {
    float f00[VW], f01[VW], f10[VW], f11[VW], l0[VW], l1[VW];
    ld<VW>(q.p00 + r, f00);
    ld<VW>(q.p01 + r, f01);
    ld<VW>(q.p10 + r, f10);
    ld<VW>(q.p11 + r, f11);
    ld<VW>(q.l0 + r, l0);
    ld<VW>(q.l1 + r, l1);
    float g00[VW], g01[VW], g10[VW], g11[VW], gl0[VW], gl1[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const float p = f00[j] * q.w00 + f01[j] * q.w01 + f10[j] * q.w10 +
                      f11[j] * q.w11;
      const float l = l0[j] * (1.f - fz) + l1[j] * fz;
      const float gl = g * l, gp = g * p;
      g00[j] = gl * q.w00;
      g01[j] = gl * q.w01;
      g10[j] = gl * q.w10;
      g11[j] = gl * q.w11;
      gl0[j] = gp * (1.f - fz);
      gl1[j] = gp * fz;
      du += gl * ((f01[j] - f00[j]) * (1.f - fy) + (f11[j] - f10[j]) * fy);
      dv += gl * ((f10[j] - f00[j]) * (1.f - fx) + (f11[j] - f01[j]) * fx);
      dw += gp * (l1[j] - l0[j]);
    }
    if (A.d_plane != nullptr) {
      red<VW>(A.d_plane + q.o00 + r, g00);
      red<VW>(A.d_plane + q.o01 + r, g01);
      red<VW>(A.d_plane + q.o10 + r, g10);
      red<VW>(A.d_plane + q.o11 + r, g11);
    }
    if (A.d_line != nullptr) {
      if constexpr (kSmemLine) {
        float* s = s_line + A.line_off;
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          atomicAdd(s + q.q0 + r + j, gl0[j]);
          atomicAdd(s + q.q1 + r + j, gl1[j]);
        }
      } else {
        red<VW>(A.d_line + q.q0 + r, gl0);
        red<VW>(A.d_line + q.q1 + r, gl1);
      }
    }
  }
  // the border masks of _prod_chunk_grads: no gradient where the
  // unclamped index lies on or past a face
  const float sx = (q.x.raw > 0.f && q.x.raw < (float)(A.W - 1))
                       ? 0.5f * (float)(A.W - 1) : 0.f;
  const float sy = (q.y.raw > 0.f && q.y.raw < (float)(A.H - 1))
                       ? 0.5f * (float)(A.H - 1) : 0.f;
  const float sz = (q.z.raw > 0.f && q.z.raw < (float)(A.D - 1))
                       ? 0.5f * (float)(A.D - 1) : 0.f;
  add3(d, A.cu, du * sx);
  add3(d, A.cv, dv * sy);
  add3(d, A.cw, dw * sz);
}

// The live slots of the warp's tile t of 32: their lanes, in order, to
// s_lane, and the mask of live lanes.
__device__ __forceinline__ unsigned tile_live(const Params& P, long long t,
                                              int lane, int* s_lane) {
  const long long i = (t << 5) + lane;
  const bool in = i < P.N;
  const bool live = in && (P.live == nullptr || P.live[i] != 0);
  const unsigned mask = __ballot_sync(kFull, live);
  if (live) s_lane[__popc(mask & ((1u << lane) - 1u))] = lane;
  __syncwarp();
  return mask;
}

template <int VW>
__global__ void __launch_bounds__(kFwdThreads)
density_fwd_kernel(const Params P) {
  __shared__ int s_lane[kFwdThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kG, sub = lane % kG;
  const long long tiles = (P.N + 31) >> 5;
  const long long step = (long long)gridDim.x * (kFwdThreads / 32);
  for (long long t = (long long)blockIdx.x * (kFwdThreads / 32) + warp;
       t < tiles; t += step) {
    const unsigned mask = tile_live(P, t, lane, s_lane[warp]);
    const long long i = (t << 5) + lane;
    if (i < P.N && !((mask >> lane) & 1u)) P.out[i] = 0.f;
    const int n_live = __popc(mask);
    for (int k0 = 0; k0 < n_live; k0 += kPass) {
      const int k = k0 + grp;
      float acc = 0.f;
      long long s = -1;
      if (k < n_live) {
        s = (t << 5) + s_lane[warp][k];
        const float cx = P.c[0][s], cy = P.c[1][s], cz = P.c[2][s];
#pragma unroll
        for (int a = 0; a < 3; ++a) acc += axis_fwd<VW>(P.ax[a], cx, cy, cz,
                                                        sub);
      }
      acc = group_sum(acc);
      if (sub == 0 && s >= 0) P.out[s] = acc;
    }
    __syncwarp();   // s_lane is rewritten by the next tile
  }
}

template <int VW, bool kSmemLine>
__global__ void __launch_bounds__(kBwdThreads, 2)
density_bwd_kernel(const Params P, int line_floats) {
  extern __shared__ float s_line[];   // kSmemLine: the lines' gradients
  __shared__ int s_lane[kBwdThreads / 32][32];
  if constexpr (kSmemLine) {
    for (int e = threadIdx.x; e < line_floats; e += kBwdThreads)
      s_line[e] = 0.f;
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kG, sub = lane % kG;
  const long long tiles = (P.N + 31) >> 5;
  const long long step = (long long)gridDim.x * (kBwdThreads / 32);
  for (long long t = (long long)blockIdx.x * (kBwdThreads / 32) + warp;
       t < tiles; t += step) {
    const unsigned mask = tile_live(P, t, lane, s_lane[warp]);
    const long long i = (t << 5) + lane;
    if (i < P.N && !((mask >> lane) & 1u)) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (P.dc[c] != nullptr) P.dc[c][i] = 0.f;
    }
    const int n_live = __popc(mask);
    for (int k0 = 0; k0 < n_live; k0 += kPass) {
      const int k = k0 + grp;
      float d[3] = {0.f, 0.f, 0.f};
      long long s = -1;
      if (k < n_live) {
        s = (t << 5) + s_lane[warp][k];
        const float cx = P.c[0][s], cy = P.c[1][s], cz = P.c[2][s];
        const float g = P.g[s];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          axis_bwd<VW, kSmemLine>(P.ax[a], cx, cy, cz, g, sub, s_line, d);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = group_sum(d[c]);
      if (sub == 0 && s >= 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (P.dc[c] != nullptr) P.dc[c][s] = d[c];
      }
    }
    __syncwarp();
  }
  if constexpr (kSmemLine) {
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const Axis& A = P.ax[a];
      if (A.d_line == nullptr) continue;
      const float* s = s_line + A.line_off;
      const int n = A.D * A.R / VW;
      for (int e = threadIdx.x; e < n; e += kBwdThreads) {
        float v[VW];
#pragma unroll
        for (int j = 0; j < VW; ++j) v[j] = s[e * VW + j];
        bool any = false;
#pragma unroll
        for (int j = 0; j < VW; ++j) any |= v[j] != 0.f;
        if (any) red<VW>(A.d_line + e * VW, v);
      }
    }
  }
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
    if (smem > 48 * 1024)
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
// cw) into P; true where every width is a multiple of 4 and every factor
// pointer 16-byte aligned (the float4 route).
bool fill_axes(Params& P, const void* const* planes, const void* const* lines,
               const int* dims, void* const* d_planes, void* const* d_lines) {
  bool vec = true;
  for (int a = 0; a < 3; ++a) {
    Axis& A = P.ax[a];
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
    A.line_off = 0;
    vec = vec && A.R % 4 == 0 && (((uintptr_t)A.plane | (uintptr_t)A.line |
                                   (uintptr_t)A.d_plane |
                                   (uintptr_t)A.d_line) & 15) == 0;
  }
  return vec;
}

}  // namespace

// feature [N] = the summed sample, 0 at the dead slots.  planes / lines:
// three device pointers each (host arrays); dims: 21 ints (see fill_axes);
// coords: the device pointers of x, y, z [N]; live: [N] bytes or null.
// Every buffer float32 and contiguous on the stream's device.
extern "C" int density_sample_fwd(const void* const* planes,
                                  const void* const* lines, const int* dims,
                                  const void* const* coords, const void* live,
                                  void* out, long long N, void* stream) {
  if (N == 0) return 0;
  Params P = {};
  const bool vec = fill_axes(P, planes, lines, dims, nullptr, nullptr);
  for (int c = 0; c < 3; ++c) P.c[c] = (const float*)coords[c];
  P.live = (const unsigned char*)live;
  P.out = (float*)out;
  P.N = N;
  const long long tiles = (N + 31) / 32;
  const long long need = (tiles + kFwdThreads / 32 - 1) / (kFwdThreads / 32);
  const long long cap = 16LL * sm_count();
  const unsigned grid = (unsigned)(need < cap ? need : cap);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    density_fwd_kernel<4><<<grid, kFwdThreads, 0, s>>>(P);
  else
    density_fwd_kernel<1><<<grid, kFwdThreads, 0, s>>>(P);
  return (int)cudaGetLastError();
}

// The gradients of sum_n g[n] feature[n]: d_planes / d_lines three device
// pointers each, a null entry (or a null array) where that gradient is
// not asked for, zeroed here (a memset each on the stream) and then added
// into; d_coords three device pointers of [N] or null, written at every
// slot.  The rest as density_sample_fwd.
extern "C" int density_sample_bwd(const void* const* planes,
                                  const void* const* lines, const int* dims,
                                  const void* const* coords, const void* live,
                                  const void* g, void* const* d_planes,
                                  void* const* d_lines, void* const* d_coords,
                                  long long N, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  Params P = {};
  const bool vec = fill_axes(P, planes, lines, dims, d_planes, d_lines);
  int line_floats = 0;
  for (int a = 0; a < 3; ++a) {
    Axis& A = P.ax[a];
    if (A.d_plane) {
      const cudaError_t e = cudaMemsetAsync(
          A.d_plane, 0, (size_t)A.H * A.W * A.R * sizeof(float), s);
      if (e != cudaSuccess) return (int)e;
    }
    if (A.d_line) {
      const cudaError_t e = cudaMemsetAsync(
          A.d_line, 0, (size_t)A.D * A.R * sizeof(float), s);
      if (e != cudaSuccess) return (int)e;
      A.line_off = line_floats;
      line_floats += A.D * A.R;
    }
  }
  if (N == 0) return 0;
  for (int c = 0; c < 3; ++c) {
    P.c[c] = (const float*)coords[c];
    P.dc[c] = d_coords ? (float*)d_coords[c] : nullptr;
  }
  P.live = (const unsigned char*)live;
  P.g = (const float*)g;
  P.N = N;
  const bool smem_line =
      line_floats > 0 && (long long)line_floats * 4 <= kMaxLineSmem;
  const int smem = smem_line ? line_floats * 4 : 0;
  const long long tiles = (N + 31) / 32;
  const long long need = (tiles + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
  long long cap;
  // one cache per kernel: the shared size it was last sized for
  static int c_smem[4] = {-1, -1, -1, -1}, c_n[4] = {0, 0, 0, 0};
  if (vec && smem_line)
    cap = resident_blocks(density_bwd_kernel<4, true>, kBwdThreads, smem,
                          &c_smem[0], &c_n[0]);
  else if (vec)
    cap = resident_blocks(density_bwd_kernel<4, false>, kBwdThreads, smem,
                          &c_smem[1], &c_n[1]);
  else if (smem_line)
    cap = resident_blocks(density_bwd_kernel<1, true>, kBwdThreads, smem,
                          &c_smem[2], &c_n[2]);
  else
    cap = resident_blocks(density_bwd_kernel<1, false>, kBwdThreads, smem,
                          &c_smem[3], &c_n[3]);
  const unsigned grid = (unsigned)(need < cap ? need : cap);
  if (vec && smem_line)
    density_bwd_kernel<4, true><<<grid, kBwdThreads, smem, s>>>(P,
                                                                line_floats);
  else if (vec)
    density_bwd_kernel<4, false><<<grid, kBwdThreads, 0, s>>>(P, 0);
  else if (smem_line)
    density_bwd_kernel<1, true><<<grid, kBwdThreads, smem, s>>>(P,
                                                                line_floats);
  else
    density_bwd_kernel<1, false><<<grid, kBwdThreads, 0, s>>>(P, 0);
  return (int)cudaGetLastError();
}
