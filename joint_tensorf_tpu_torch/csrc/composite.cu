// Volume compositor for Hopper (sm_90a): forward (K1) and backward (K2).
//
// Replaces the TPU kernels in joint_tensorf_tpu/ops/pallas_kernels.py:
//   K1 <- _fwd_kernel (reached through composite_pallas / _composite_fwd_impl)
//   K2 <- _bwd_kernel (reached through _composite_bwd)
//
// Per ray (alpha, z [N,S]; rgb [N,S,3], all float32, contiguous):
//   u_i = 1 - alpha_i + 1e-10,  T_i = prod_{j<i} u_j (exclusive),  w_i = alpha_i T_i
//   gate_i = w_i > thres  (the renderer's appearance gate; thres = -inf: none)
//   rgb_map = sum_i gate_i w_i rgb_i,  depth = sum_i w_i z_i,  acc = sum_i w_i
// T is a running product of u, like the reference's cumprod
// (joint_tensorf_tpu/ops/composite.py).  The TPU kernel's exp(cumsum(log u))
// stood in for a scan Mosaic lacks, and differs in the last bits.
//
// Backward, in the division-free form of ops/composite.py (the TPU kernel
// divides by u, which gave NaN gradients on saturated rays):
//   g_w_i   = gate_i <g_rgb, rgb_i> + g_depth z_i + g_acc + g_weights_i
//   B_{S-1} = 0,  B_i = g_w_{i+1} alpha_{i+1} + u_{i+1} B_{i+1}
//   d_alpha_i = T_i (g_w_i - B_i),  d_rgb_i = g_rgb w_i gate_i,  d_z_i = g_depth w_i
//
// K1 (forward): one group of NT = 64 threads per ray, two rays to a block
// of 128 threads, each thread holding K contiguous samples of a tile of
// NT x K samples (K = 4 or 8 from S; a ray longer than one tile is
// walked front to back, one tile at a time, T carried from one to the
// next in a register).  Each thread loads its samples of alpha and z
// straight into registers (16 bytes a load where the row is aligned) and
// the tile's rgb is staged through shared memory by coalesced loads, as in
// K2.  T is the carried product times the product of earlier warps' u
// times a warp-shuffle exclusive scan of the threads' products: one
// exchange of the warps' totals per tile, two barriers (rgb staged and
// totals in; everything read before the next tile).  Each thread then
// walks its samples, writes its weights in one 16-byte store where
// aligned, and sums acc, depth and the gated rgb in registers; the ray's
// five sums are reduced once, at the end.  Every input is read once and
// every output written once.  A ray is two warps (two rays a block) with
// K = 4 up to S = 768 and K = 8 beyond: of 32 / 64 / 128 threads a ray
// and K = 2 / 4 / 8 that ran fastest on the H100 at N = 2028, back to back
// (scripts/chip_kernel_variants.py; S = 221: 0.0044 ms against 0.0050 for
// one warp of K = 4 and 0.0057 for 128 x 2; S = 1000: 0.0178 against
// 0.0180 for 128 x 8 and 0.0208 for 32 x 8).  A warp per ray leaves too
// few threads to cover the loads' latency, a block per ray too few rays
// resident.  64 registers, no spills.
//
// K2 (backward): one block of NT = 128 threads per ray, each thread
// holding K = 1, 2, 4 or 8 contiguous samples (K from S) of a tile of
// NT x K samples (a ray longer than 1024 is walked tile by tile, last
// tile first).  Each thread loads its
// samples of alpha, z, weights and g_weights straight into registers, 16
// bytes a load where the row is aligned, so a warp's load reads one
// contiguous stretch; the tile's rgb (3 values a sample) is staged through
// shared memory by coalesced loads and d_rgb leaves the same way.  T is the
// thread's product of u times an exclusive product over earlier threads;
// B is a first-order linear recurrence, i.e. a composition of affine maps
// x -> Q + P x, and each thread needs the composition of the later
// threads' maps.  Both block scans run together: warp shuffles, then one
// shared-memory exchange of the warps' totals, so a tile costs three
// barriers (rgb staged, totals in, totals read).  The thread then walks
// its samples backwards.  The gate is read from the forward's saved
// weights (w > thres), as B2 takes weights_ref, so it equals the forward's
// bit for bit whatever order T is formed in here; d_rgb and d_z use those
// weights too.  Every element is read once and written once, with no
// second pass over device memory.
//
// Bound on this card: bytes.  At the last phase's shape (N = 2028 rays,
// S = 1000) the forward moves ~49 MB and the backward ~97 MB (0.015 and
// 0.029 ms at 3.35 TB/s).  The first K1 ran one warp per ray over
// 32-sample chunks: at N = 2028 that left ~15 warps resident per SM, each
// ray a chain of S / 32 dependent shuffle scans with scalar loads and
// 12-byte-strided rgb loads, at 39% of the bound's rate.  Both kernels
// now have all of a ray's loads in flight at once and scans of log depth
// over threads, not samples.  Registers, not shared memory, bound how
// many rays an SM holds: 64 a thread, eight blocks an SM.  On the H100
// that ran faster at S = 221 and S = 1000 than capping them at 32 to fit
// 2048 threads (which spills), and 128 threads of K = 8 ran faster at
// S = 1000 than 256 of K = 4 (K2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 128;    // K1: two rays a block,
constexpr int kFwdRayThreads = 64;  // 64 threads a ray
constexpr int kBwdThreads = 128;    // K2: one block of 128 threads per ray
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1e-10f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// ------------------------------------------------------- shared helpers
// Shared-memory index of value i: one pad word per 32, so that a thread's
// 3K contiguous rgb values are read with few bank conflicts.
__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// src[0, n) -> dst[pad(i)] by the NT threads tid = 0..NT-1, coalesced, 16
// bytes a thread where aligned.
template <int NT>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src, int n,
                                      int tid) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = n & ~3;
    for (int i = 4 * tid; i < done; i += 4 * NT) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(src + i));
      float* d = dst + pad(i);  // i..i+3 share one 32-word row
      d[0] = x.x;
      d[1] = x.y;
      d[2] = x.z;
      d[3] = x.w;
    }
  }
  for (int i = done + tid; i < n; i += NT) dst[pad(i)] = __ldg(src + i);
}

// src[pad(i)] -> dst[0, n), the reverse of stage.
template <int NT>
__device__ __forceinline__ void unstage(float* __restrict__ dst,
                                        const float* src, int n, int tid) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    done = n & ~3;
    for (int i = 4 * tid; i < done; i += 4 * NT) {
      const float* s = src + pad(i);
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(s[0], s[1], s[2], s[3]);
    }
  }
  for (int i = done + tid; i < n; i += NT) dst[i] = src[pad(i)];
}

// v[0, K) <- p[0, valid), zero past valid: 16-byte loads where p is
// aligned and all K values are there (a warp then reads one contiguous
// stretch per load), else scalar loads.
template <int K>
__device__ __forceinline__ void load_k(float (&v)[K],
                                       const float* __restrict__ p,
                                       int valid) {
  if (K % 4 == 0 && valid >= K &&
      (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p + k));
      v[k] = x.x;
      v[k + 1] = x.y;
      v[k + 2] = x.z;
      v[k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = k < valid ? __ldg(p + k) : 0.f;
  }
}

// p[0, valid) <- v, the reverse of load_k.
template <int K>
__device__ __forceinline__ void store_k(float* __restrict__ p,
                                        const float (&v)[K], int valid) {
  if (K % 4 == 0 && valid >= K &&
      (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < valid) p[k] = v[k];
  }
}

// ---------------------------------------------------------------- K1
// K1's arguments: alpha, z [N, S], rgb [N, S, 3] in; rgb_map [N, 3],
// depth, acc [N], weights [N, S] out; all float32.
struct FwdArgs {
  const float *alpha, *rgb, *z;
  float thres;
  float *rgb_map, *depth, *acc, *weights;
  int N, S;
};

// K samples a thread.  Eight blocks an SM: 64 registers a thread.
template <int K>
__global__ void __launch_bounds__(kFwdThreads, 8)
composite_fwd_kernel(const FwdArgs A) {
  constexpr int NT = kFwdRayThreads, RAYS = kFwdThreads / NT, NW = NT / 32,
                TS = NT * K;
  extern __shared__ float s_c[];  // RAYS x [pad(3 TS)]: each ray's rgb
  __shared__ float s_p[kFwdThreads / 32];       // warps' products of u
  __shared__ float s_sum[5][kFwdThreads / 32];  // warps' sums

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = threadIdx.x / NT, tid = threadIdx.x - grp * NT;
  const int w0 = grp * NW;  // the ray's first warp in the block
  const int S = A.S;
  const long long ray = (long long)blockIdx.x * RAYS + grp;
  const bool live = ray < A.N;  // the block's last rays may not exist
  const long long o = ray * S;
  const float thres = A.thres;
  float* c = s_c + grp * pad(3 * TS);
  float carry = 1.f;  // T at the tile's start
  float s_acc = 0.f, s_depth = 0.f, s_r = 0.f, s_g = 0.f, s_b = 0.f;

  for (int s0 = 0; s0 < S; s0 += TS) {
    // this thread's samples: i0 + k for k < valid
    const int n = min(TS, S - s0);
    const int valid = live ? min(K, n - tid * K) : 0;
    const long long i0 = o + s0 + tid * K;
    if (live) stage<NT>(c, A.rgb + 3 * (o + s0), 3 * n, tid);
    float a[K], zz[K], u[K];
    load_k<K>(a, A.alpha + i0, valid);
    load_k<K>(zz, A.z + i0, valid);
    float p = 1.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      u[k] = k < valid ? (1.f - a[k]) + kEps : 1.f;
      p *= u[k];
    }
    // inclusive product over the warp's threads, then the warps' totals
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float q = __shfl_up_sync(kFull, p, off);
      if (lane >= off) p *= q;
    }
    if (lane == 31) s_p[warp] = p;
    float T = __shfl_up_sync(kFull, p, 1);
    if (lane == 0) T = 1.f;
    __syncthreads();  // rgb staged, the warps' totals in
    float pre = carry;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w0 + w < warp) pre *= s_p[w0 + w];
      carry *= s_p[w0 + w];
    }
    T *= pre;
    float wt[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      wt[k] = a[k] * T;
      T *= u[k];
      if (k < valid) {
        s_acc += wt[k];
        s_depth += wt[k] * zz[k];
        if (wt[k] > thres) {
          const int j = 3 * (tid * K + k);
          s_r += wt[k] * c[pad(j)];
          s_g += wt[k] * c[pad(j + 1)];
          s_b += wt[k] * c[pad(j + 2)];
        }
      }
    }
    store_k<K>(A.weights + i0, wt, valid);
    __syncthreads();  // rgb and the totals read before the next tile
  }

  s_acc = warp_sum(s_acc);
  s_depth = warp_sum(s_depth);
  s_r = warp_sum(s_r);
  s_g = warp_sum(s_g);
  s_b = warp_sum(s_b);
  if (NW > 1) {
    if (lane == 0) {
      s_sum[0][warp] = s_acc;
      s_sum[1][warp] = s_depth;
      s_sum[2][warp] = s_r;
      s_sum[3][warp] = s_g;
      s_sum[4][warp] = s_b;
    }
    __syncthreads();
    if (tid == 0) {
      s_acc = s_depth = s_r = s_g = s_b = 0.f;
#pragma unroll
      for (int w = w0; w < w0 + NW; ++w) {
        s_acc += s_sum[0][w];
        s_depth += s_sum[1][w];
        s_r += s_sum[2][w];
        s_g += s_sum[3][w];
        s_b += s_sum[4][w];
      }
    }
  }
  if (tid == 0 && live) {
    A.acc[ray] = s_acc;
    A.depth[ray] = s_depth;
    A.rgb_map[3 * ray] = s_r;
    A.rgb_map[3 * ray + 1] = s_g;
    A.rgb_map[3 * ray + 2] = s_b;
  }
}

template <int K>
cudaError_t launch_fwd(const FwdArgs& A, cudaStream_t stream) {
  constexpr int RAYS = kFwdThreads / kFwdRayThreads;
  const size_t smem =
      (size_t)RAYS * pad(3 * kFwdRayThreads * K) * sizeof(float);
  composite_fwd_kernel<K>
      <<<(unsigned)((A.N + RAYS - 1) / RAYS), kFwdThreads, smem, stream>>>(A);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K2
// Product of p over the block.
__device__ __forceinline__ float block_product(float p, float* s_w) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) p *= __shfl_xor_sync(kFull, p, off);
  if ((threadIdx.x & 31) == 0) s_w[threadIdx.x >> 5] = p;
  __syncthreads();
  float total = 1.f;
#pragma unroll
  for (int w = 0; w < kBwdThreads / 32; ++w) total *= s_w[w];
  __syncthreads();
  return total;
}

// K2's arguments: inputs [N, S] / [N, S, 3] / [N, 3] / [N], all float32;
// g_weights may be null (no gradient reaches the weights).
struct BwdArgs {
  const float *alpha, *rgb, *z, *weights;
  float thres;
  const float *g_rgb, *g_depth, *g_acc, *g_weights;
  float *d_alpha, *d_rgb, *d_z;
  int S;
};

// Eight blocks an SM: 64 registers a thread, no spills.
template <int K>
__global__ void __launch_bounds__(kBwdThreads, 8)
composite_bwd_kernel(const BwdArgs A) {
  constexpr int NT = kBwdThreads, TS = NT * K, NW = NT / 32;
  extern __shared__ float s_c[];  // rgb, then d_rgb: [pad(3 TS)]
  float* s_T0 = s_c + pad(3 * TS);  // [n_tiles]: T at each tile's start
  __shared__ float s_p[NW], s_q[NW], s_r[NW];  // per-warp totals
  __shared__ float s_x;  // X at the start of the tile after this one

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = A.S;
  const long long ray = blockIdx.x;
  const long long o = ray * S;
  const int n_tiles = (S + TS - 1) / TS;
  const float thres = A.thres;
  const float gr = A.g_rgb[3 * ray], gg = A.g_rgb[3 * ray + 1],
              gb = A.g_rgb[3 * ray + 2];
  const float gd = A.g_depth[ray], ga = A.g_acc[ray];

  // rays longer than one tile: T at each tile's start, front to back
  if (tid == 0) {
    s_T0[0] = 1.f;
    s_x = 0.f;  // B_{S-1} = 0
  }
  for (int t = 0; t + 1 < n_tiles; ++t) {
    float p = 1.f;
    for (int i = t * TS + tid; i < (t + 1) * TS; i += kBwdThreads)
      p *= (1.f - __ldg(A.alpha + o + i)) + kEps;
    p = block_product(p, s_p);
    if (tid == 0) s_T0[t + 1] = s_T0[t] * p;
  }
  __syncthreads();

  for (int t = n_tiles - 1; t >= 0; --t) {
    // this thread's samples: i0 + k for k < valid; past them the identity
    const int s0 = t * TS;
    const int n = min(TS, S - s0);
    const long long i0 = o + s0 + tid * K;
    const int valid = min(K, n - tid * K);
    stage<NT>(s_c, A.rgb + 3 * (o + s0), 3 * n, tid);
    float u[K], q[K], gw[K];
    {
      float a[K], zz[K], w[K], dz[K];
      load_k<K>(a, A.alpha + i0, valid);
      load_k<K>(zz, A.z + i0, valid);
      load_k<K>(w, A.weights + i0, valid);
      if (A.g_weights) {  // null: no gradient reaches the weights
        load_k<K>(gw, A.g_weights + i0, valid);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) gw[k] = 0.f;
      }
      __syncthreads();  // rgb staged
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool gate = w[k] > thres;
        const bool in = k < valid;
        if (in) {  // d_rgb into this thread's own rgb slots
          float* c = s_c + pad(3 * (tid * K + k));
          float* c1 = s_c + pad(3 * (tid * K + k) + 1);
          float* c2 = s_c + pad(3 * (tid * K + k) + 2);
          const float dot = gr * *c + gg * *c1 + gb * *c2;
          gw[k] += (gate ? dot : 0.f);
          *c = gate ? gr * w[k] : 0.f;
          *c1 = gate ? gg * w[k] : 0.f;
          *c2 = gate ? gb * w[k] : 0.f;
        }
        gw[k] += gd * zz[k] + ga;
        dz[k] = gd * w[k];
        u[k] = in ? (1.f - a[k]) + kEps : 1.f;
        q[k] = in ? gw[k] * a[k] : 0.f;
      }
      store_k<K>(A.d_z + i0, dz, valid);  // d_z needs no scan
    }

    // this thread's product of u, and its composed map F = f_first o ..
    // o f_last with f_i(x) = q_i + u_i x
    float p = 1.f, Q = 0.f, P = 1.f;
#pragma unroll
    for (int k = 0; k < K; ++k) p *= u[k];
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      Q = q[k] + u[k] * Q;
      P = u[k] * P;
    }
    // both block scans at once: warp shuffles, then one exchange of the
    // warps' totals; T needs the product of earlier threads, B the
    // composition of later threads' maps
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float p2 = __shfl_up_sync(kFull, p, off);
      const float Q2 = __shfl_down_sync(kFull, Q, off);
      const float P2 = __shfl_down_sync(kFull, P, off);
      if (lane >= off) p *= p2;
      if (lane + off < 32) {
        Q = Q + P * Q2;
        P = P * P2;
      }
    }
    if (lane == 31) s_p[warp] = p;
    if (lane == 0) {
      s_q[warp] = Q;
      s_r[warp] = P;
    }
    __syncthreads();  // the totals and every thread's d_rgb are in
    unstage<NT>(A.d_rgb + 3 * (o + s0), s_c, 3 * n, tid);
    float pre = s_T0[t];
    for (int w = 0; w < warp; ++w) pre *= s_p[w];
    float x = s_x;
    for (int w = NW - 1; w > warp; --w) x = s_q[w] + s_r[w] * x;
    float pe = __shfl_up_sync(kFull, p, 1);
    float Qe = __shfl_down_sync(kFull, Q, 1);
    float Pe = __shfl_down_sync(kFull, P, 1);
    if (lane == 0) pe = 1.f;
    if (lane == 31) {
      Qe = 0.f;
      Pe = 1.f;
    }
    __syncthreads();  // every thread has read s_x, the totals and d_rgb

    float T[K], da[K];
    T[0] = pre * pe;
#pragma unroll
    for (int k = 1; k < K; ++k) T[k] = T[k - 1] * u[k - 1];
    float X = Qe + Pe * x;  // B at this thread's last sample
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      da[k] = T[k] * (gw[k] - X);
      X = q[k] + u[k] * X;
    }
    store_k<K>(A.d_alpha + i0, da, valid);
    if (tid == 0) s_x = X;  // read after the next tile's first barrier
  }
}

template <int K>
cudaError_t launch_bwd(const BwdArgs& A, int N, cudaStream_t stream) {
  constexpr int TS = kBwdThreads * K;
  const int n_tiles = (A.S + TS - 1) / TS;
  const size_t smem = (size_t)(pad(3 * TS) + n_tiles) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        composite_bwd_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  composite_bwd_kernel<K><<<(unsigned)N, kBwdThreads, smem, stream>>>(A);
  return cudaGetLastError();
}

}  // namespace

extern "C" int composite_fwd(const void* alpha, const void* rgb,
                             const void* z, float thres, void* rgb_map,
                             void* depth, void* acc, void* weights, int N,
                             int S, void* stream) {
  if (N == 0 || S == 0) return 0;
  const FwdArgs A{(const float*)alpha, (const float*)rgb, (const float*)z,
                  thres,               (float*)rgb_map,   (float*)depth,
                  (float*)acc,         (float*)weights,   N,
                  S};
  const cudaStream_t s = (cudaStream_t)stream;
  // two warps a ray; 4 samples a thread up to S = 768 (tiles of 256),
  // then 8 (tiles of 512)
  if (S <= 768) return (int)launch_fwd<4>(A, s);
  return (int)launch_fwd<8>(A, s);
}

extern "C" int composite_bwd(const void* alpha, const void* rgb,
                             const void* z, const void* weights, float thres,
                             const void* g_rgb, const void* g_depth,
                             const void* g_acc, const void* g_weights,
                             void* d_alpha, void* d_rgb, void* d_z, int N,
                             int S, void* stream) {
  if (N == 0 || S == 0) return 0;
  const BwdArgs A{(const float*)alpha,   (const float*)rgb,
                  (const float*)z,       (const float*)weights,
                  thres,                 (const float*)g_rgb,
                  (const float*)g_depth, (const float*)g_acc,
                  (const float*)g_weights, (float*)d_alpha,
                  (float*)d_rgb,         (float*)d_z,
                  S};
  const cudaStream_t s = (cudaStream_t)stream;
  // samples per thread from S; rays longer than 1024 walk 1024-sample tiles
  if (S <= 128) return (int)launch_bwd<1>(A, N, s);
  if (S <= 256) return (int)launch_bwd<2>(A, N, s);
  if (S <= 512) return (int)launch_bwd<4>(A, N, s);
  return (int)launch_bwd<8>(A, N, s);
}
