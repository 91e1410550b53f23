// Concatenated plane x line appearance sample for Hopper (sm_90a): forward
// and backward (K7).
//
//   feature[n, o_a + r] = P_a(u_a[n], v_a[n])[r] * L_a(w_a[n])[r],  r < R_a
//
// over the three axes a of the VM field's appearance, o_a = R_0 + ... +
// R_{a-1}: P_a [H, W, R_a] a plane sampled bilinearly, L_a [D, R_a] a line
// sampled linearly (align-corners, clamped to the border, as
// ops/sampling.py's _pix and _floor_frac), each axis reading its own three
// of the coordinates x, y, z [N].  The plain version is ops/sampling.py's
// three sample_planeline_prod calls, concatenated.
//
// Replaces no Pallas kernel.  The JAX package samples the appearance
// through the fused plane x line sample of joint_tensorf_tpu/ops/sampling.py
// once an axis, whose forward gathers corner-packed plane rows and whose
// backward is the row scatter K3 replaced.  On the card that path packed
// each plane anew (four concatenations), gathered 4R-wide rows, multiplied
// in strided passes, concatenated the three features, and scattered [N,
// 4R] and [N, 2R] update rows through K3 in chunks, folding them back
// afterwards.  This kernel reads the unpacked factors and writes the
// feature row once.
//
// Bound on this card: bytes.  A slot writes (forward) or reads (backward)
// its feature row of R_0 + R_1 + R_2 floats and reads its three
// coordinates; the backward writes the coordinates' gradients.  The factor
// rows (four plane and two line rows of R_a an axis) come mostly from L2,
// since a ray's samples march through neighbouring cells; six times the
// feature row's bytes a slot, they set the kernel's pace, some 3x the byte
// bound forward and 7x backward at bat_llff.final's shape (PERF.md section
// 6).  The arithmetic is a few flops per byte.
//
// Design.  A group of lanes takes one slot: kFwdG = 8 in the forward, kG =
// 4 in the backward, so that a backward warp takes kSlots = 8 consecutive
// slots at once.  The slot's feature row is cut into chunks of VW channels
// (16-byte chunks where every R_a is a multiple of 4, else single floats),
// numbered across the three axes, and lane sub of a group of G takes the
// chunks whose number is sub modulo G: so the lanes share the row evenly
// whatever the ranks (15 chunks at R_a 20: 2 a lane but one, forward; 4, 4,
// 4, 3 backward), and a forward warp writes 4 neighbouring rows in adjacent
// 16-byte pieces.  The forward's 8 lanes a slot keep more of its loads in
// flight (at 4 lanes it took 1.3x as long at bat_llff.final's shape); the
// backward's 4 sum 8 slots' runs below.  No shared memory.  Backward
// recomputes each slot's cells and rows and:
//   * sums, before adding, the gradients of a run of the warp's slots that
//     share an axis's plane cell (or line cell) in the run's first slot: a
//     segmented sum over the 8 groups by shuffles, taken only where the
//     warp holds such a run.  A ray's consecutive samples share cells: on
//     NDC rays x and y barely move, so all 8 slots add into the same rows
//     of the xy plane and of the x and y lines, which would otherwise
//     serialise 8 atomics on one address;
//   * adds the plane gradients into the unpacked [H, W, R] planes with
//     16-byte vector float32 reductions (atomicAdd on float4, sm_90): no
//     packed layout, no fold, no update rows in memory;
//   * adds the line gradients into the [D, R] lines with the same
//     reductions: the run sums above already merge a warp's adds into one
//     line row, and a per-block shared copy of the lines gained nothing
//     at either cell's shape (PERF.md section 6, K7);
//   * writes the coordinate gradients with the border masks of
//     ops/sampling.py's _prod_chunk_grads, each coordinate summed over the
//     axes that read it (a shuffle sums the group's lanes).
// Only the gradients asked for are formed: a null output pointer skips its
// adds or stores (frozen factors: no factor adds; detached coordinates: no
// coordinate stores).  The forward is the plain version's arithmetic slot
// by slot (fused multiply-adds aside); the backward's sums run in another
// order (the group's shuffle; atomics in an order that varies from run to
// run).
#include "factor_sample.cuh"

namespace {

constexpr int kFwdG = 8;               // lanes per slot, forward
constexpr int kG = 4;                  // lanes per slot, backward
constexpr int kSlots = 32 / kG;        // slots a backward warp takes at once
constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 256;

struct Params {
  Axis ax[3];
  const float* c[3];    // x, y, z [N]
  const float* g;       // [N, C] the feature's cotangent (backward)
  float* out;           // [N, C] the feature (forward)
  float* dc[3];         // [N] the coordinates' gradients, or null
  long long N;
  int C;                // R_0 + R_1 + R_2
};

// The first of axis A's channels that lane sub of a group of G takes: its
// chunks are those numbered sub modulo G across the row.
template <int VW, int G>
__device__ __forceinline__ int first_channel(const Axis& A, int sub) {
  return ((sub - (A.off / VW) % G + G) % G) * VW;
}

// This lane's chunks of one axis's products at one slot, into its
// feature row.
template <int VW>
__device__ __forceinline__ void axis_fwd(const Axis& A, float cx, float cy,
                                         float cz, int sub, float* row) {
  const Rows q = rows(A, cx, cy, cz);
  const float fz = q.z.f;
  for (int r = first_channel<VW, kFwdG>(A, sub); r < A.R; r += kFwdG * VW) {
    float f00[VW], f01[VW], f10[VW], f11[VW], l0[VW], l1[VW], o[VW];
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
      o[j] = p * l;
    }
    st<VW>(row + A.off + r, o);
  }
}

// The runs of the warp's kSlots slots (one a group of kG lanes) whose
// ``key`` is equal to the previous slot's: for this lane's group, the last
// group of its run (end), whether it starts the run (lead), and whether any
// run holds more than one slot (agg; the same in every lane).
struct Run {
  int end;
  bool lead, agg;
};

__device__ __forceinline__ Run runs(int key, int grp, int sub) {
  const int prev = __shfl_up_sync(kFull, key, kG);
  const bool start = grp == 0 || prev != key;
  const unsigned b = __ballot_sync(kFull, start && sub == 0);
  const unsigned after = grp + 1 < kSlots ? b >> ((grp + 1) * kG) : 0u;
  Run r;
  r.end = after ? grp + (__ffs(after) - 1) / kG : kSlots - 1;
  r.lead = start;
  r.agg = __popc(b) < kSlots;
  return r;
}

// v summed over this lane's group and the later groups of its run, the
// lanes of one sub across the groups (a segmented suffix sum: each step
// adds the partial sum d groups on where that group lies in the run).
// Every lane of the warp calls it.
template <int VW>
__device__ __forceinline__ void run_sum(float (&v)[VW], int grp, int end) {
#pragma unroll
  for (int d = 1; d < kSlots; d <<= 1) {
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const float u = __shfl_down_sync(kFull, v[j], d * kG);
      if (grp + d <= end) v[j] += u;
    }
  }
}

// One axis's backward at one slot (``valid``: a slot of the N) with
// cotangent row grow, this lane's chunks: the factor adds, and the lane's
// parts of the coordinate gradients added into d[0..2] (x, y, z), already
// scaled and masked.  Every lane of the warp calls it: the chunk loop runs
// as often in every lane (a lane past its chunks adds zeros), so that the
// run sums can shuffle.
template <int VW>
__device__ __forceinline__ void axis_bwd(const Axis& A, float cx, float cy,
                                         float cz, const float* grow,
                                         bool valid, int grp, int sub,
                                         float (&d)[3]) {
  const Rows q = rows(A, cx, cy, cz);
  const float fx = q.x.f, fy = q.y.f, fz = q.z.f;
  // an invalid slot is a run of its own
  const Run rp = runs(valid ? q.y.i0 * A.W + q.x.i0 : -1 - grp, grp, sub);
  const Run rl = runs(valid ? q.z.i0 : -1 - grp, grp, sub);
  float du = 0.f, dv = 0.f, dw = 0.f;
  const int first = first_channel<VW, kG>(A, sub);
  const int n_iter = (A.R / VW + kG - 1) / kG;
  for (int it = 0; it < n_iter; ++it) {
    const int r = first + it * kG * VW;
    const bool has = valid && r < A.R;
    float f00[VW] = {}, f01[VW] = {}, f10[VW] = {}, f11[VW] = {},
          l0[VW] = {}, l1[VW] = {}, gg[VW] = {};
    if (has) {
      ld<VW>(q.p00 + r, f00);
      ld<VW>(q.p01 + r, f01);
      ld<VW>(q.p10 + r, f10);
      ld<VW>(q.p11 + r, f11);
      ld<VW>(q.l0 + r, l0);
      ld<VW>(q.l1 + r, l1);
      ld<VW>(grow + A.off + r, gg);
    }
    float g00[VW], g01[VW], g10[VW], g11[VW], gl0[VW], gl1[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      const float p = f00[j] * q.w00 + f01[j] * q.w01 + f10[j] * q.w10 +
                      f11[j] * q.w11;
      const float l = l0[j] * (1.f - fz) + l1[j] * fz;
      const float gl = gg[j] * l, gp = gg[j] * p;
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
      if (rp.agg) {
        run_sum<VW>(g00, grp, rp.end);
        run_sum<VW>(g01, grp, rp.end);
        run_sum<VW>(g10, grp, rp.end);
        run_sum<VW>(g11, grp, rp.end);
      }
      if (has && rp.lead) {
        red<VW>(A.d_plane + q.o00 + r, g00);
        red<VW>(A.d_plane + q.o01 + r, g01);
        red<VW>(A.d_plane + q.o10 + r, g10);
        red<VW>(A.d_plane + q.o11 + r, g11);
      }
    }
    if (A.d_line != nullptr) {
      if (rl.agg) {
        run_sum<VW>(gl0, grp, rl.end);
        run_sum<VW>(gl1, grp, rl.end);
      }
      if (has && rl.lead) {
        red<VW>(A.d_line + q.q0 + r, gl0);
        red<VW>(A.d_line + q.q1 + r, gl1);
      }
    }
  }
  add3(d, A.cu, du * border_scale(q.x, A.W));
  add3(d, A.cv, dv * border_scale(q.y, A.H));
  add3(d, A.cw, dw * border_scale(q.z, A.D));
}

template <int VW>
__global__ void __launch_bounds__(kFwdThreads)
app_fwd_kernel(const Params P) {
  const int sub = threadIdx.x % kFwdG;
  const long long step = (long long)gridDim.x * (kFwdThreads / kFwdG);
  for (long long s = (long long)blockIdx.x * (kFwdThreads / kFwdG) +
                     threadIdx.x / kFwdG;
       s < P.N; s += step) {
    const float cx = P.c[0][s], cy = P.c[1][s], cz = P.c[2][s];
    float* row = P.out + s * P.C;
#pragma unroll
    for (int a = 0; a < 3; ++a) axis_fwd<VW>(P.ax[a], cx, cy, cz, sub, row);
  }
}

template <int VW>
__global__ void __launch_bounds__(kBwdThreads, 2)
app_bwd_kernel(const Params P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kG, sub = lane % kG;
  const long long tiles = (P.N + kSlots - 1) / kSlots;
  const long long step = (long long)gridDim.x * (kBwdThreads / 32);
  // warp-uniform: every lane reaches the shuffles
  for (long long t = (long long)blockIdx.x * (kBwdThreads / 32) + warp;
       t < tiles; t += step) {
    const long long s = t * kSlots + grp;
    const bool valid = s < P.N;
    float cx = 0.f, cy = 0.f, cz = 0.f;
    if (valid) {
      cx = P.c[0][s];
      cy = P.c[1][s];
      cz = P.c[2][s];
    }
    const float* grow = P.g + (valid ? s : 0) * P.C;
    float d[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      axis_bwd<VW>(P.ax[a], cx, cy, cz, grow, valid, grp, sub, d);
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = group_sum<kG>(d[c]);
    if (sub == 0 && valid) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (P.dc[c] != nullptr) P.dc[c][s] = d[c];
    }
  }
}

// Reads the axes (see fill_axes) and their channel offsets into P; true
// for the float4 route: every R_a a multiple of 4 and every pointer,
// feature and cotangent rows included, 16-byte aligned.
bool fill(Params& P, const void* const* planes, const void* const* lines,
          const int* dims, void* const* d_planes, void* const* d_lines,
          const void* rows_ptr) {
  bool vec = fill_axes(P.ax, planes, lines, dims, d_planes, d_lines);
  P.C = 0;
  for (int a = 0; a < 3; ++a) {
    P.ax[a].off = P.C;
    P.C += P.ax[a].R;
  }
  return vec && ((uintptr_t)rows_ptr & 15) == 0;
}

}  // namespace

// feature [N, R_0 + R_1 + R_2] = the three axes' products, concatenated.
// planes / lines: three device pointers each (host arrays); dims: 21 ints
// (H, W, D, R, cu, cv, cw an axis); coords: the device pointers of x, y, z
// [N].  Every buffer float32 and contiguous on the stream's device.
extern "C" int app_sample_fwd(const void* const* planes,
                              const void* const* lines, const int* dims,
                              const void* const* coords, void* out,
                              long long N, void* stream) {
  if (N == 0) return 0;
  Params P = {};
  const bool vec = fill(P, planes, lines, dims, nullptr, nullptr, out);
  for (int c = 0; c < 3; ++c) P.c[c] = (const float*)coords[c];
  P.out = (float*)out;
  P.N = N;
  const long long per_block = kFwdThreads / kFwdG;
  const long long need = (N + per_block - 1) / per_block;
  const long long cap = 16LL * sm_count();
  const unsigned grid = (unsigned)(need < cap ? need : cap);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    app_fwd_kernel<4><<<grid, kFwdThreads, 0, s>>>(P);
  else
    app_fwd_kernel<1><<<grid, kFwdThreads, 0, s>>>(P);
  return (int)cudaGetLastError();
}

// The gradients of sum g * feature, g [N, R_0 + R_1 + R_2]: d_planes /
// d_lines three device pointers each, a null entry (or a null array) where
// that gradient is not asked for, zeroed here (a memset each on the
// stream) and then added into; d_coords three device pointers of [N] or
// null, written at every slot.  The rest as app_sample_fwd.
extern "C" int app_sample_bwd(const void* const* planes,
                              const void* const* lines, const int* dims,
                              const void* const* coords, const void* g,
                              void* const* d_planes, void* const* d_lines,
                              void* const* d_coords, long long N,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  Params P = {};
  const bool vec = fill(P, planes, lines, dims, d_planes, d_lines, g);
  for (int a = 0; a < 3; ++a) {
    const Axis& A = P.ax[a];
    if (A.d_plane) {
      const cudaError_t e = cudaMemsetAsync(
          A.d_plane, 0, (size_t)A.H * A.W * A.R * sizeof(float), s);
      if (e != cudaSuccess) return (int)e;
    }
    if (A.d_line) {
      const cudaError_t e = cudaMemsetAsync(
          A.d_line, 0, (size_t)A.D * A.R * sizeof(float), s);
      if (e != cudaSuccess) return (int)e;
    }
  }
  if (N == 0) return 0;
  for (int c = 0; c < 3; ++c) {
    P.c[c] = (const float*)coords[c];
    P.dc[c] = d_coords ? (float*)d_coords[c] : nullptr;
  }
  P.g = (const float*)g;
  P.N = N;
  const long long tiles = (N + kSlots - 1) / kSlots;
  const long long need = (tiles + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
  const long long cap = 16LL * sm_count();
  const unsigned grid = (unsigned)(need < cap ? need : cap);
  if (vec)
    app_bwd_kernel<4><<<grid, kBwdThreads, 0, s>>>(P);
  else
    app_bwd_kernel<1><<<grid, kBwdThreads, 0, s>>>(P);
  return (int)cudaGetLastError();
}
