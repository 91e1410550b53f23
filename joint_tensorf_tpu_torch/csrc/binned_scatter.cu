// Tile-binned bilinear plane-gradient scatter for Hopper (sm_90a): K4.
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
// Design (first version, simple and right): the wrapper sorts the samples
// by TS x TS-cell tile and cuts each tile's range of the sorted order into
// chunks of at most CHUNK samples, so that a tile crowded with samples (a
// small plane, or the clamped samples piling onto the plane's border) is
// spread over many blocks.  One block per chunk keeps a (TS+1)^2 x R
// float32 accumulator in shared memory; blockDim.x threads span the
// channels (so each sample's row of g is one coalesced read) and
// blockDim.y groups take samples in turn, adding the four weighted rows
// with shared-memory atomics.  The block then adds its accumulator into
// d_plane with one global atomic per non-zero entry: a tile's cells are
// shared with its neighbours' edges and with the tile's other chunks.  The
// caller zeroes d_plane.  Summation order varies from run to run.
#include <cuda_runtime.h>

namespace {

__global__ void binned_plane_scatter_kernel(
    const float* __restrict__ g, const int* __restrict__ order,
    const int* __restrict__ chunk_tile, const int* __restrict__ chunk_lo,
    const int* __restrict__ chunk_hi, const int* __restrict__ cell,
    const float* __restrict__ fx, const float* __restrict__ fy, int H, int W,
    int R, int n_tx, int ts, float* __restrict__ out) {
  extern __shared__ float acc[];  // [(ts+1)^2, R]
  const int t = chunk_tile[blockIdx.x];
  const int s0 = chunk_lo[blockIdx.x], s1 = chunk_hi[blockIdx.x];
  const int P1 = ts + 1;
  const int y_base = (t / n_tx) * ts, x_base = (t % n_tx) * ts;
  const int n_acc = P1 * P1 * R;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < n_acc; e += nthreads) acc[e] = 0.f;
  __syncthreads();

  for (int s = s0 + threadIdx.y; s < s1; s += blockDim.y) {
    const int n = order[s];
    const int c0 = cell[n];
    const int y0 = c0 / W;
    const int x0 = c0 - y0 * W;
    const float ax = fx[n], ay = fy[n];
    const float w00 = (1.f - ay) * (1.f - ax), w01 = (1.f - ay) * ax;
    const float w10 = ay * (1.f - ax), w11 = ay * ax;
    float* a = acc + ((y0 - y_base) * P1 + (x0 - x_base)) * R;
    const float* gr = g + (long long)n * R;
    for (int c = threadIdx.x; c < R; c += blockDim.x) {
      const float v = gr[c];
      atomicAdd(a + c, v * w00);
      atomicAdd(a + R + c, v * w01);
      atomicAdd(a + P1 * R + c, v * w10);
      atomicAdd(a + (P1 + 1) * R + c, v * w11);
    }
  }
  __syncthreads();

  for (int e = tid; e < n_acc; e += nthreads) {
    const int p = e / R;
    const int c = e - p * R;
    const int y = y_base + p / P1, x = x_base + p % P1;
    const float v = acc[e];
    if (y < H && x < W && v != 0.f)
      atomicAdd(out + ((long long)y * W + x) * R + c, v);
  }
}

}  // namespace

extern "C" int binned_plane_scatter(const void* g, const void* order,
                                    const void* chunk_tile,
                                    const void* chunk_lo,
                                    const void* chunk_hi, const void* cell,
                                    const void* fx, const void* fy,
                                    int n_chunks, int H, int W, int R,
                                    int n_tx, int ts, void* out,
                                    void* stream) {
  if (n_chunks == 0 || R == 0) return 0;
  const size_t smem = (size_t)(ts + 1) * (ts + 1) * R * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        binned_plane_scatter_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int cw = ((R + 31) / 32) * 32;
  if (cw > 256) cw = 256;
  const dim3 block(cw, 256 / cw > 0 ? 256 / cw : 1);
  binned_plane_scatter_kernel<<<n_chunks, block, smem,
                                (cudaStream_t)stream>>>(
      (const float*)g, (const int*)order, (const int*)chunk_tile,
      (const int*)chunk_lo, (const int*)chunk_hi, (const int*)cell,
      (const float*)fx, (const float*)fy, H, W, R, n_tx, ts, (float*)out);
  return (int)cudaGetLastError();
}
