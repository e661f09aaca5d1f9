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
// The image is f32 or a bit mask (bilinear_cov_grads_f32 / _b1; a mask
// holds pixel c of a row as bit c % 32 of 32-bit word c / 32): a mask bit
// converts to float exactly, so a 0/1 mask gives the f32 image's bits.
//
// Bound on the H100: memory, and at the fits' shapes (BV 64 x N 2,619 and
// 512 points, 368 x 384 crops) the launch, two dependent memory round
// trips (xy, then the taps) and the 4 MB of output rows.  Each point does
// ~40 flops on 4 taps: the kernel is a gather.  Design:
//   * one flat grid over BV x N, so no view leaves a partial block; a
//     point's view is a multiply and a shift (Divisor), not a division;
//   * a point a thread, 256 threads a block: a warp loads 32 consecutive
//     xy and stores 32 consecutive floats of each row.  At these sizes
//     every thread fits on the card at once (655 blocks of 256), so more
//     points a thread only lengthen each warp's instruction stream: 2, 4
//     and 8 points a thread measured slower (PERF.md, PR 7);
//   * a thread issues its 4 tap loads together, through the read-only
//     path, before any arithmetic reads one;
//   * the main path samples its 0/1 crops as a bit mask: a 32-byte sector
//     holds 256 pixels of a row, so a warp's taps on a band of rows touch
//     a few sectors, where f32 pixels touch about one a point.
// The TPU form (hinge matrices contracted on the MXU) existed only because
// Mosaic has no per-point gather.  Far-out or non-finite points are tested
// before any float->int cast (an out-of-range cast is undefined) and write
// zeros, which is what the hinge form gives there.  All arithmetic is f32
// without the TPU kernel's bf16 rounding of the hinge weights.

#include "silhouette.cuh"

namespace {

constexpr int kThreads = 256;

// p / N for 0 <= p < 2^31 by a multiply and a shift, exact for every such
// p: with 2^l >= N, m = ceil(2^(31 + l) / N) < 2^32 and s = 31 + l, the
// error of p m / 2^s against p / N is below 1 / N.
struct Divisor {
  uint32_t m;
  int s;
};

Divisor divisor(int N) {
  int l = 0;
  while ((int64_t{1} << l) < N) ++l;
  const uint64_t two_s = uint64_t{1} << (31 + l);
  return Divisor{(uint32_t)((two_s + N - 1) / N), 31 + l};
}

__device__ __forceinline__ int view_of(int p, Divisor d) {
  return (int)(((uint64_t)(uint32_t)p * d.m) >> d.s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bilinear_cov_grads_kernel(const T* __restrict__ img,
                          const float* __restrict__ xy,
                          float* __restrict__ out, int H, int W, int N,
                          Divisor by_n, int total, int with_grads,
                          int with_cov) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= total) return;
  const float2 pxy = __ldg(reinterpret_cast<const float2*>(xy) + p);
  const int bv = view_of(p, by_n), n = p - bv * N;
  const T* im = img + (int64_t)bv * H * sil::Image<T>::row_elems(W);
  const sil::Sample r = sil::bilinear_sample<T>(im, H, W, pxy.x, pxy.y,
                                                with_grads, with_cov);
  float* o = out + (int64_t)bv * 6 * N + n;
  o[0] = r.s;
  o[(int64_t)N] = r.c;
  o[(int64_t)2 * N] = r.sx;
  o[(int64_t)3 * N] = r.sy;
  o[(int64_t)4 * N] = r.cx;
  o[(int64_t)5 * N] = r.cy;
}

// The launch geometry of BV x N points: out = {blocks, threads}.
void geometry(int BV, int N, int* out) {
  const int64_t total = (int64_t)BV * N;
  out[0] = (int)((total + kThreads - 1) / kThreads);
  out[1] = kThreads;
}

template <typename T>
int launch(const void* img, const float* xy, float* out, int BV, int H,
           int W, int N, int with_grads, int with_cov, void* stream) {
  if (BV == 0 || N == 0) return 0;
  int geo[2];
  geometry(BV, N, geo);
  bilinear_cov_grads_kernel<T><<<geo[0], kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(img), xy, out, H, W, N, divisor(N), BV * N,
      with_grads, with_cov);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" void bilinear_cov_grads_geometry(int BV, int N, int* out) {
  geometry(BV, N, out);
}

extern "C" int bilinear_cov_grads_f32(const void* img, const float* xy,
                                      float* out, int BV, int H, int W, int N,
                                      int with_grads, int with_cov,
                                      void* stream) {
  return launch<float>(img, xy, out, BV, H, W, N, with_grads, with_cov,
                       stream);
}

// A bit mask [BV, H, (W + 31) / 32] of 32-bit words; W in pixels.
extern "C" int bilinear_cov_grads_b1(const void* img, const float* xy,
                                     float* out, int BV, int H, int W, int N,
                                     int with_grads, int with_cov,
                                     void* stream) {
  return launch<uint32_t>(img, xy, out, BV, H, W, N, with_grads, with_cov,
                          stream);
}
