// Zero-padded bilinear sample + coverage + position derivatives.
//
// Replaces the TPU kernel _bilinear_cov_kernel
// (bodyfitting_tpu/ops/pallas_kernels.py:1242, called through
// bilinear_cov_grads) and its row-windowed / row-banded variants, which
// compute the same function.
//
// Contract (pixel-grid units, torch-1.2 grid_sample align_corners=True
// taps): for img [BV, H, W] and xy [BV, N, 2], out [BV, 6, N] holds
//   0 sample s, 1 coverage c (the same sample of an all-ones image),
//   2 ds/dx, 3 ds/dy, 4 dc/dx, 5 dc/dy.
// Rows 1,4,5 are zero without with_cov; rows 2-5 without with_grads.
// Derivatives follow the TPU kernel's rule d hinge / dy = sign(i - y) on
// the open support: a coordinate that is an exact integer has derivative 0.
//
// Bound on the H100: memory.  Each point does ~40 flops on 4 taps, so the
// kernel is a gather; the crop (a few hundred KB per view) stays in L2.
// Design: one thread per point reads its 4 taps directly.  The TPU form
// (hinge matrices contracted on the MXU) existed only because Mosaic has
// no per-point gather.  Far-out or non-finite points are tested before
// any float->int cast (an out-of-range cast is undefined) and write zeros,
// which is what the hinge form gives there.  All arithmetic is f32 without
// the TPU kernel's bf16 rounding of the hinge weights.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float tap(const float* img, int H, int W,
                                     int r, int c) {
  return (r >= 0 && r < H && c >= 0 && c < W) ? img[(int64_t)r * W + c]
                                              : 0.0f;
}

__global__ void bilinear_cov_grads_kernel(const float* __restrict__ img,
                                          const float* __restrict__ xy,
                                          float* __restrict__ out,
                                          int H, int W, int N,
                                          int with_grads, int with_cov) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int bv = blockIdx.y;
  if (n >= N) return;
  const float* im = img + (int64_t)bv * H * W;
  const float x = xy[((int64_t)bv * N + n) * 2 + 0];
  const float y = xy[((int64_t)bv * N + n) * 2 + 1];
  float* o = out + (int64_t)bv * 6 * N + n;

  float s = 0.f, c = 0.f, sx = 0.f, sy = 0.f, cx = 0.f, cy = 0.f;
  // outside (-1, W) x (-1, H) every hinge weight is zero; NaN fails too
  if (x > -1.0f && x < (float)W && y > -1.0f && y < (float)H) {
    const float fx = floorf(x), fy = floorf(y);
    const int x0 = (int)fx, y0 = (int)fy;
    const float wx = x - fx, wy = y - fy;
    const float ux = 1.0f - wx, uy = 1.0f - wy;
    const float v00 = tap(im, H, W, y0, x0);
    const float v01 = tap(im, H, W, y0, x0 + 1);
    const float v10 = tap(im, H, W, y0 + 1, x0);
    const float v11 = tap(im, H, W, y0 + 1, x0 + 1);
    s = uy * (ux * v00 + wx * v01) + wy * (ux * v10 + wx * v11);
    const float gx = wx > 0.0f ? 1.0f : 0.0f;
    const float gy = wy > 0.0f ? 1.0f : 0.0f;
    if (with_grads) {
      sx = gx * (uy * (v01 - v00) + wy * (v11 - v10));
      sy = gy * (ux * (v10 - v00) + wx * (v11 - v01));
    }
    if (with_cov) {
      const float r0 = (y0 >= 0 && y0 < H) ? 1.0f : 0.0f;
      const float r1 = (y0 + 1 >= 0 && y0 + 1 < H) ? 1.0f : 0.0f;
      const float c0 = (x0 >= 0 && x0 < W) ? 1.0f : 0.0f;
      const float c1 = (x0 + 1 >= 0 && x0 + 1 < W) ? 1.0f : 0.0f;
      const float rsum = uy * r0 + wy * r1;
      const float csum = ux * c0 + wx * c1;
      c = rsum * csum;
      if (with_grads) {
        cx = rsum * (gx * (c1 - c0));
        cy = (gy * (r1 - r0)) * csum;
      }
    }
  }
  o[0] = s;
  o[(int64_t)N] = c;
  o[(int64_t)2 * N] = sx;
  o[(int64_t)3 * N] = sy;
  o[(int64_t)4 * N] = cx;
  o[(int64_t)5 * N] = cy;
}

}  // namespace

extern "C" int bilinear_cov_grads_f32(const float* img, const float* xy,
                                      float* out, int BV, int H, int W, int N,
                                      int with_grads, int with_cov,
                                      void* stream) {
  if (BV == 0 || N == 0) return 0;
  const int threads = 256;
  dim3 grid((N + threads - 1) / threads, BV);
  bilinear_cov_grads_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      img, xy, out, H, W, N, with_grads, with_cov);
  return (int)cudaGetLastError();
}
