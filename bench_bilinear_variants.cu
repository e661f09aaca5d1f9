// The variant source of bench_bilinear_kernel.py --variants: the kernel
// of bodyfitting_torch/ops/csrc/bilinear.cu with each design choice open
// as a -D macro, and a u8 image type beside f32 and the bit mask.  The
// program builds csrc/bilinear.cu, which hard-codes the choices this
// file's defaults name; only the bench builds this file, once a variant.
//
// Choices (defaults in brackets): BILINEAR_VEC consecutive points a group,
// one xy vector [1]; BILINEAR_GROUPS groups a thread [1];
// BILINEAR_THREADS threads a block [256]; BILINEAR_TAPS the tap loads, 0
// plain, 1 the read-only path, 2 read-only with an L2 evict_last hint, 3
// none (a timing probe: every tap reads 0, so its results are wrong) [1];
// BILINEAR_U8CVT a u8 pixel or a mask bit to float, 0 by conversion, 1 by
// a float subtraction [0]; BILINEAR_DIV a point's view, 0 by division, 1
// by a multiply and a shift [1].  Contract, symbols and arithmetic are
// csrc/bilinear.cu's, plus bilinear_cov_grads_u8; the geometry export
// adds points, vector, tap_load, u8_cvt and view_div after blocks and
// threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef BILINEAR_VEC
#define BILINEAR_VEC 1          // consecutive points a group: one xy vector
#endif
#ifndef BILINEAR_GROUPS
#define BILINEAR_GROUPS 1       // groups a thread
#endif
#ifndef BILINEAR_THREADS
#define BILINEAR_THREADS 256    // threads a block
#endif
#ifndef BILINEAR_TAPS
#define BILINEAR_TAPS 1         // tap loads: 0 plain, 1 read-only path,
#endif                          // 2 read-only + L2 evict_last, 3 none
                                // (a timing probe: every tap reads 0)
#ifndef BILINEAR_U8CVT
#define BILINEAR_U8CVT 0        // u8 to float: 0 by conversion, 1 by a
#endif                          // float subtraction
#ifndef BILINEAR_DIV
#define BILINEAR_DIV 1          // a point's view: 0 by division, 1 by a
#endif                          // multiply and a shift

namespace {

constexpr int kVec = BILINEAR_VEC;
constexpr int kGroups = BILINEAR_GROUPS;
constexpr int kThreads = BILINEAR_THREADS;
constexpr int kPoints = kVec * kGroups;            // points a thread
constexpr int kWarpPoints = 32 * kPoints;
constexpr int kBlockPoints = kThreads * kPoints;
static_assert(kVec == 1 || kVec == 2, "a group is one or two points");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

__device__ __forceinline__ uint64_t tap_policy() {
#if BILINEAR_TAPS == 2
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
#else
  return 0;
#endif
}

// One raw element of an image (a pixel, or 32 pixels of a bit mask) by
// the chosen tap load.
template <typename T>
__device__ __forceinline__ T load_raw(const T* a, uint64_t pol) {
#if BILINEAR_TAPS == 0
  return *a;
#elif BILINEAR_TAPS == 1
  return __ldg(a);
#elif BILINEAR_TAPS == 2
  if constexpr (sizeof(T) == 4) {
    unsigned v;
    asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
        : "=r"(v) : "l"(a), "l"(pol));
    if constexpr (std::is_same_v<T, float>) return __uint_as_float(v);
    else return v;
  } else {
    unsigned v;
    asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;"
        : "=r"(v) : "l"(a), "l"(pol));
    return (T)v;
  }
#else
  return T(0);
#endif
}

// A u8 pixel (or a mask bit) as float, exactly.
__device__ __forceinline__ float u8_to_float(unsigned v) {
#if BILINEAR_U8CVT == 1
  // 2^23 + v, less 2^23: two full-rate integer and float operations
  return __uint_as_float(0x4b000000u | v) - 8388608.0f;
#else
  return (float)v;
#endif
}

// An image kind: how far apart its rows are, and the two taps at columns
// c and c + 1 of a row (0 outside [0, W)), loaded before either is used.
// f32 and u8 hold a pixel an element; a bit mask (uint32_t) holds pixel c
// of a row as bit c % 32 of word c / 32, rows (W + 31) / 32 words apart.
template <typename T>
struct Image {
  static __device__ __forceinline__ int row_elems(int W) { return W; }
  static __device__ __forceinline__ void taps(const T* row, int c, int W,
                                              bool in, uint64_t pol,
                                              float& a, float& b) {
    const T ra = (in && c >= 0) ? load_raw(row + c, pol) : T(0);
    const T rb = (in && c + 1 < W) ? load_raw(row + c + 1, pol) : T(0);
    if constexpr (sizeof(T) == 1) {
      a = u8_to_float(ra);
      b = u8_to_float(rb);
    } else {
      a = ra;
      b = rb;
    }
  }
};

template <>
struct Image<uint32_t> {
  static __device__ __forceinline__ int row_elems(int W) {
    return (W + 31) >> 5;
  }
  static __device__ __forceinline__ void taps(const uint32_t* row, int c,
                                              int W, bool in, uint64_t pol,
                                              float& a, float& b) {
    const bool ina = in && c >= 0, inb = in && c + 1 < W;
    // c + 1 opens a word when c % 32 is 31 (or c is -1)
    const bool split = ((c + 1) & 31) == 0;
    const uint32_t wa = ina ? load_raw(row + (c >> 5), pol) : 0u;
    const uint32_t wb =
        !split ? wa : inb ? load_raw(row + ((c + 1) >> 5), pol) : 0u;
    a = u8_to_float((wa >> (c & 31)) & 1u);
    b = u8_to_float(inb ? (wb >> ((c + 1) & 31)) & 1u : 0u);
  }
};

// p / N for 0 <= p < 2^31 by a multiply and a shift, exact for every such
// p: with 2^l >= N, m = ceil(2^(31 + l) / N) < 2^32 and s = 31 + l, the
// error of p m / 2^s against p / N is below 1 / N (BILINEAR_DIV 0: the
// compiler's division sequence).
struct Divisor {
  int N;
  uint32_t m;
  int s;
};

Divisor divisor(int N) {
  int l = 0;
  while ((int64_t{1} << l) < N) ++l;
  const uint64_t two_s = uint64_t{1} << (31 + l);
  return Divisor{N, (uint32_t)((two_s + N - 1) / N), 31 + l};
}

__device__ __forceinline__ int view_of(int p, Divisor d) {
#if BILINEAR_DIV == 1
  return (int)(((uint64_t)(uint32_t)p * d.m) >> d.s);
#else
  return p / d.N;
#endif
}

// The first point of group g of this lane.
__device__ __forceinline__ int group_point(int warp0, int lane, int g) {
  return warp0 + (lane + 32 * g) * kVec;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bilinear_cov_grads_kernel(const T* __restrict__ img,
                          const float* __restrict__ xy,
                          float* __restrict__ out, int H, int W, int N,
                          Divisor by_n, int total, int with_grads,
                          int with_cov) {
  const int lane = threadIdx.x & 31;
  const int warp0 =
      blockIdx.x * kBlockPoints + (threadIdx.x >> 5) * kWarpPoints;
  if (warp0 >= total) return;
  const uint64_t pol = tap_policy();

  // 1. every point's xy; a point past the end reads NaN, which is far
  float px[kPoints], py[kPoints];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int p = group_point(warp0, lane, g);
    if (p + kVec <= total) {
      if constexpr (kVec == 2) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xy) + p / 2);
        px[2 * g] = v.x;
        py[2 * g] = v.y;
        px[2 * g + 1] = v.z;
        py[2 * g + 1] = v.w;
      } else {
        const float2 v = __ldg(reinterpret_cast<const float2*>(xy) + p);
        px[g] = v.x;
        py[g] = v.y;
      }
    } else {
      const float nan = __int_as_float(0x7fc00000);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool in = p + j < total;
        px[kVec * g + j] = in ? __ldg(xy + 2 * (int64_t)(p + j)) : nan;
        py[kVec * g + j] = in ? __ldg(xy + 2 * (int64_t)(p + j) + 1) : nan;
      }
    }
  }

  // 2. weights and tap addresses, then all 4 kPoints tap loads at once
  const int row = Image<T>::row_elems(W);
  bool near[kPoints];
  float fx[kPoints], fy[kPoints];
  int x0[kPoints], y0[kPoints];
  float v[kPoints][4];
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    const int p = group_point(warp0, lane, i / kVec) + i % kVec;
    // outside (-1, W) x (-1, H) every hinge weight is zero; NaN fails too
    near[i] = px[i] > -1.0f && px[i] < (float)W && py[i] > -1.0f &&
              py[i] < (float)H;
    fx[i] = floorf(near[i] ? px[i] : 0.0f);
    fy[i] = floorf(near[i] ? py[i] : 0.0f);
    x0[i] = (int)fx[i];
    y0[i] = (int)fy[i];
    const T* im = img + (int64_t)(near[i] ? view_of(p, by_n) : 0) * H * row;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int r = y0[i] + k;
      Image<T>::taps(im + r * row, x0[i], W, near[i] && r >= 0 && r < H,
                     pol, v[i][2 * k], v[i][2 * k + 1]);
    }
  }

  // 3. the six rows of every point
  float o[kPoints][6];
#pragma unroll
  for (int i = 0; i < kPoints; ++i) {
    float s = 0.f, c = 0.f, sx = 0.f, sy = 0.f, cx = 0.f, cy = 0.f;
    if (near[i]) {
      const float wx = px[i] - fx[i], wy = py[i] - fy[i];
      const float ux = 1.0f - wx, uy = 1.0f - wy;
      const float v00 = v[i][0], v01 = v[i][1], v10 = v[i][2], v11 = v[i][3];
      s = uy * (ux * v00 + wx * v01) + wy * (ux * v10 + wx * v11);
      const float gx = wx > 0.0f ? 1.0f : 0.0f;
      const float gy = wy > 0.0f ? 1.0f : 0.0f;
      if (with_grads) {
        sx = gx * (uy * (v01 - v00) + wy * (v11 - v10));
        sy = gy * (ux * (v10 - v00) + wx * (v11 - v01));
      }
      if (with_cov) {
        const int ya = y0[i], xa = x0[i];
        const float r0 = (ya >= 0 && ya < H) ? 1.0f : 0.0f;
        const float r1 = (ya + 1 >= 0 && ya + 1 < H) ? 1.0f : 0.0f;
        const float c0 = (xa >= 0 && xa < W) ? 1.0f : 0.0f;
        const float c1 = (xa + 1 >= 0 && xa + 1 < W) ? 1.0f : 0.0f;
        const float rsum = uy * r0 + wy * r1;
        const float csum = ux * c0 + wx * c1;
        c = rsum * csum;
        if (with_grads) {
          cx = rsum * (gx * (c1 - c0));
          cy = (gy * (r1 - r0)) * csum;
        }
      }
    }
    o[i][0] = s;
    o[i][1] = c;
    o[i][2] = sx;
    o[i][3] = sy;
    o[i][4] = cx;
    o[i][5] = cy;
  }

  // 4. stores: a two-point group's row as one float2 where it can
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int p = group_point(warp0, lane, g);
    const int bv = view_of(p, by_n), n = p - bv * N;
    float* q = out + (int64_t)bv * 6 * N + n;
    if constexpr (kVec == 2) {
      if (p + 1 < total) {
        // the second point: the next n of this view, or n 0 of the next
        const bool same = n + 1 < N;
        float* q1 = same ? q + 1 : q + (int64_t)6 * N - n;
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          float* a = q + (int64_t)r * N;
          if (same && ((uintptr_t)a & 7) == 0) {
            *reinterpret_cast<float2*>(a) =
                make_float2(o[2 * g][r], o[2 * g + 1][r]);
          } else {
            *a = o[2 * g][r];
            q1[(int64_t)r * N] = o[2 * g + 1][r];
          }
        }
        continue;
      }
    }
    if (p < total) {
#pragma unroll
      for (int r = 0; r < 6; ++r) q[(int64_t)r * N] = o[kVec * g][r];
    }
  }
}

// The launch geometry of BV x N points: out = {blocks, threads, points a
// thread, points a vector, tap load kind, u8 conversion kind, view index
// kind}.
void geometry(int BV, int N, int* out) {
  const int64_t total = (int64_t)BV * N;
  out[0] = (int)((total + kBlockPoints - 1) / kBlockPoints);
  out[1] = kThreads;
  out[2] = kPoints;
  out[3] = kVec;
  out[4] = BILINEAR_TAPS;
  out[5] = BILINEAR_U8CVT;
  out[6] = BILINEAR_DIV;
}

template <typename T>
int launch(const void* img, const float* xy, float* out, int BV, int H,
           int W, int N, int with_grads, int with_cov, void* stream) {
  if (BV == 0 || N == 0) return 0;
  int geo[7];
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

extern "C" int bilinear_cov_grads_u8(const void* img, const float* xy,
                                     float* out, int BV, int H, int W, int N,
                                     int with_grads, int with_cov,
                                     void* stream) {
  return launch<uint8_t>(img, xy, out, BV, H, W, N, with_grads, with_cov,
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
