// Row scatter-add with a block-local shared-memory accumulator for Hopper
// (sm_90a): K5.
//
//   out = zeros([n_rows, C]).at[idx].add(updates)
//
// K3's contract with another design.  Replaces the TPU kernel in
// joint_tensorf_tpu/ops/tile_scatter.py: _kernel (reached through
// scatter_add_rows_tiled), which double-buffers sorted chunks by DMA into
// VMEM, read-modify-writes rows of a 4096-row VMEM block and flushes the
// block once.  A 4096 x 128 block does not fit in shared memory; the
// wrapper picks BR rows per block from C instead (BR x C x 4 B <= 96 KB).
//
// Bound on this card: bytes.  N x 8 B of indices and N x C x 4 B of
// updates are read once, n_rows x C x 4 B written once.
//
// Design (first version, simple and right): the wrapper sorts idx,
// permutes the updates and finds each destination block's range of the
// sorted samples with searchsorted, as the JAX wrapper does outside its
// kernel.  One block per BR destination rows zeroes its rows in shared
// memory; blockDim.y groups each walk a contiguous part of the block's
// sample range with blockDim.x threads over channels (one coalesced read
// per sample row), sum each run of equal indices in a register and add it
// to the shared row with one shared-memory atomic per run.  The block then
// writes its rows once, with coalesced stores and no global atomics, so
// the output needs no zeroing.  Samples outside [0, n_rows) are dropped.
#include <cuda_runtime.h>

namespace {

__global__ void scatter_add_rows_tiled_kernel(
    const long long* __restrict__ idx, const float* __restrict__ upd,
    const long long* __restrict__ starts, float* __restrict__ out, int C,
    long long n_rows, int BR) {
  extern __shared__ float acc[];  // [BR, C]
  const long long base = (long long)blockIdx.x * BR;
  const int rows = (int)(n_rows - base < BR ? n_rows - base : BR);
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < rows * C; e += nthreads) acc[e] = 0.f;
  __syncthreads();

  const long long s0 = starts[blockIdx.x], s1 = starts[blockIdx.x + 1];
  const long long per = (s1 - s0 + blockDim.y - 1) / blockDim.y;
  const long long a0 = s0 + threadIdx.y * per;
  const long long a1 = a0 + per < s1 ? a0 + per : s1;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    long long cur = -1;  // destination row of the open run, -1 when none
    float sum = 0.f;
    for (long long s = a0; s < a1; ++s) {
      const long long r = idx[s] - base;
      const float v = upd[s * C + c];
      if (r != cur) {
        if (cur >= 0 && cur < rows) atomicAdd(acc + cur * C + c, sum);
        cur = r;
        sum = 0.f;
      }
      sum += v;
    }
    if (cur >= 0 && cur < rows) atomicAdd(acc + cur * C + c, sum);
  }
  __syncthreads();

  float* dst = out + base * C;
  for (int e = tid; e < rows * C; e += nthreads) dst[e] = acc[e];
}

}  // namespace

extern "C" int scatter_add_rows_tiled(const void* idx, const void* upd,
                                      const void* starts, void* out, int C,
                                      long long n_rows, int BR,
                                      void* stream) {
  if (n_rows == 0 || C == 0) return 0;
  const long long blocks = (n_rows + BR - 1) / BR;
  const size_t smem = (size_t)BR * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        scatter_add_rows_tiled_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int cw = ((C + 31) / 32) * 32;
  if (cw > 256) cw = 256;
  const dim3 block(cw, 256 / cw > 0 ? 256 / cw : 1);
  scatter_add_rows_tiled_kernel<<<(unsigned)blocks, block, smem,
                                  (cudaStream_t)stream>>>(
      (const long long*)idx, (const float*)upd, (const long long*)starts,
      (float*)out, C, n_rows, BR);
  return (int)cudaGetLastError();
}
