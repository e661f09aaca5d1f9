// Deterministic row scatter-add: the backward of a row gather.
//
// Replaces the TPU kernel _rows_scatter_kernel
// (bodyfitting_tpu/ops/pallas_kernels.py:1738, called through
// rows_scatter_add).
//
// Contract: for idx [BV, P] int32 and g [BV, P, C] with C = 2 (the
// x/y cotangent of the matched contour points, its only caller),
//   out[bv, c, m] = sum over p with idx[bv, p] == m of g[bv, p, c]
// into out [BV, C, M]; entries with idx >= M or idx < 0 are dropped.
// The sum runs over p in ascending order, in f32, so it is bit-for-bit
// repeatable (no float atomics: the f32 fits are chaotic, and a
// run-to-run change in summation order would change converged fits).
//
// Bound on the H100: memory (a few MB move; the compares are cheap).
// Design: one thread per output (bv, m); the block stages tiles of
// (idx, g) in shared memory and every thread walks them in order.  The
// TPU form (a one-hot contracted on the MXU) rounds g to bf16 on the chip;
// this kernel sums exact f32 values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileP = 512;
constexpr int kThreads = 256;
constexpr int C = 2;

__global__ void rows_scatter_add_kernel(const int* __restrict__ idx,
                                        const float* __restrict__ g,
                                        float* __restrict__ out, int P,
                                        int M) {
  __shared__ int s_idx[kTileP];
  __shared__ float s_g[kTileP * C];
  const int bv = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  const int* ix = idx + (int64_t)bv * P;
  const float* gg = g + (int64_t)bv * P * C;
  for (int base = 0; base < P; base += kTileP) {
    const int cnt = min(kTileP, P - base);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) s_idx[i] = ix[base + i];
    for (int i = threadIdx.x; i < cnt * C; i += blockDim.x)
      s_g[i] = gg[(int64_t)base * C + i];
    __syncthreads();
    if (m < M) {
      for (int j = 0; j < cnt; ++j) {
        if (s_idx[j] == m) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], s_g[j * C + c]);
        }
      }
    }
  }
  if (m < M) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[((int64_t)bv * C + c) * M + m] = acc[c];
  }
}

}  // namespace

extern "C" int rows_scatter_add_f32(const int* idx, const float* g, float* out,
                                    int BV, int P, int M, void* stream) {
  if (BV == 0 || M == 0) return 0;
  dim3 grid((M + kThreads - 1) / kThreads, BV);
  rows_scatter_add_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      idx, g, out, P, M);
  return (int)cudaGetLastError();
}
