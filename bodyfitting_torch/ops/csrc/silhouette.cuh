// Device code shared by the silhouette kernels: the sampler
// (bilinear.cu), the contour match (contour_match.cu), the row scatter
// (rows_scatter.cu) and the fused per-view mask term (mask_terms.cu).
// Each kernel file states its contract and design; this header holds the
// per-point and per-row pieces they have in common, so the fused term
// computes each quantity with the very instructions the separate kernels
// use.  Every source is built with -fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sil {

// ---------------------------------------------------------------------------
// The sampler: zero-padded bilinear sample, coverage, x/y derivatives
// ---------------------------------------------------------------------------

// An image kind: how far apart its rows are, and the two taps at columns
// c and c + 1 of a row (0 outside [0, W)), loaded before either is used.
// f32 holds a pixel an element; a bit mask (uint32_t) holds pixel c of a
// row as bit c % 32 of word c / 32, rows (W + 31) / 32 words apart.
template <typename T>
struct Image;

template <>
struct Image<float> {
  static __device__ __forceinline__ int row_elems(int W) { return W; }
  static __device__ __forceinline__ void taps(const float* row, int c, int W,
                                              bool in, float& a, float& b) {
    a = (in && c >= 0) ? __ldg(row + c) : 0.0f;
    b = (in && c + 1 < W) ? __ldg(row + c + 1) : 0.0f;
  }
};

template <>
struct Image<uint32_t> {
  static __device__ __forceinline__ int row_elems(int W) {
    return (W + 31) >> 5;
  }
  static __device__ __forceinline__ void taps(const uint32_t* row, int c,
                                              int W, bool in, float& a,
                                              float& b) {
    const bool ina = in && c >= 0, inb = in && c + 1 < W;
    // c + 1 opens a word when c % 32 is 31 (or c is -1)
    const bool split = ((c + 1) & 31) == 0;
    const uint32_t wa = ina ? __ldg(row + (c >> 5)) : 0u;
    const uint32_t wb = !split ? wa : inb ? __ldg(row + ((c + 1) >> 5)) : 0u;
    a = (float)((wa >> (c & 31)) & 1u);
    b = (float)(inb ? (wb >> ((c + 1) & 31)) & 1u : 0u);
  }
};

// sample s, coverage c, ds/dx, ds/dy, dc/dx, dc/dy
struct Sample {
  float s, c, sx, sy, cx, cy;
};

// The sample of one view's image ``im [H, row_elems(W)]`` at (x, y) in
// pixel-grid units (torch-1.2 grid_sample taps, align_corners=True, zero
// padding).  Far-out or non-finite points are tested before any
// float->int cast (an out-of-range cast is undefined) and give zeros.
template <typename T>
__device__ __forceinline__ Sample bilinear_sample(const T* im, int H, int W,
                                                  float x, float y,
                                                  int with_grads,
                                                  int with_cov) {
  // outside (-1, W) x (-1, H) every hinge weight is zero; NaN fails too
  const bool near = x > -1.0f && x < (float)W && y > -1.0f && y < (float)H;
  const float fx = floorf(near ? x : 0.0f), fy = floorf(near ? y : 0.0f);
  const int x0 = (int)fx, y0 = (int)fy;
  // the 4 taps, loaded together
  const int row = Image<T>::row_elems(W);
  float v00, v01, v10, v11;
  Image<T>::taps(im + y0 * row, x0, W, near && y0 >= 0 && y0 < H, v00, v01);
  Image<T>::taps(im + (y0 + 1) * row, x0, W, near && y0 + 1 < H, v10, v11);

  Sample r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (near) {
    const float wx = x - fx, wy = y - fy;
    const float ux = 1.0f - wx, uy = 1.0f - wy;
    r.s = uy * (ux * v00 + wx * v01) + wy * (ux * v10 + wx * v11);
    const float gx = wx > 0.0f ? 1.0f : 0.0f;
    const float gy = wy > 0.0f ? 1.0f : 0.0f;
    if (with_grads) {
      r.sx = gx * (uy * (v01 - v00) + wy * (v11 - v10));
      r.sy = gy * (ux * (v10 - v00) + wx * (v11 - v01));
    }
    if (with_cov) {
      const float r0 = (y0 >= 0 && y0 < H) ? 1.0f : 0.0f;
      const float r1 = (y0 + 1 >= 0 && y0 + 1 < H) ? 1.0f : 0.0f;
      const float c0 = (x0 >= 0 && x0 < W) ? 1.0f : 0.0f;
      const float c1 = (x0 + 1 >= 0 && x0 + 1 < W) ? 1.0f : 0.0f;
      const float rsum = uy * r0 + wy * r1;
      const float csum = ux * c0 + wx * c1;
      r.c = rsum * csum;
      if (with_grads) {
        r.cx = rsum * (gx * (c1 - c0));
        r.cy = (gy * (r1 - r0)) * csum;
      }
    }
  }
  return r;
}

// ---------------------------------------------------------------------------
// The contour match: each contour pixel's nearest valid candidate
// ---------------------------------------------------------------------------

namespace match {

constexpr float kFar = 1e30f;
constexpr int kWarps = 16;                      // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kG = 8;                           // pixels a warp
constexpr int kLogG = 3;
constexpr int kK = 4;                           // candidates a lane a chunk
constexpr int kPixPerBlock = kWarps * kG;       // 128
constexpr int kChunk = 32 * kK;                 // candidates a warp a chunk
constexpr int kStage = 3072;                    // candidates a tile
constexpr int kNone = 0x7fffffff;               // no winner (yet)
static_assert(1 << kLogG == kG && kG <= 32, "kG is a power of two");
static_assert(kStage % kChunk == 0 && kStage % kThreads == 0,
              "a tile is whole chunks and whole block strides");

__device__ __forceinline__ float pair_d2(float cx, float cy, float2 q) {
  const float dx = __fsub_rn(cx, q.x);
  const float dy = __fsub_rn(cy, q.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// (d, i) <- the lexicographic minimum of (d, i) and (od, oi)
__device__ __forceinline__ void lexmin(float& d, int& i, float od, int oi) {
  if (od < d || (od == d && oi < i)) {
    d = od;
    i = oi;
  }
}

// The shared bytes a block needs for M candidates: one tile, rounded up
// to whole chunks.
inline int stage_bytes(int M) {
  const int n = M < kStage ? M : kStage;
  return (n + kChunk - 1) / kChunk * kChunk * (int)sizeof(float2);
}

// The match of a block of kThreads threads: the 128 contour pixels from
// ``pix0_block`` of one row ``ct [P, 2]`` against the row's candidates
// ``pr [M, 2]``, candidate m taking part when ``valid(m, q)`` holds for
// its point q.  Returns, on every lane, its pixel ``p`` and that pixel's
// best (d2, index) (index kNone when no candidate is valid); ``owner`` is
// set on one lane a pixel, for p < P.  ``s_pt`` is the block's dynamic
// shared memory (stage_bytes(M)).
template <class Valid>
__device__ __forceinline__ void nearest(const float* __restrict__ ct,
                                        const float* __restrict__ pr,
                                        Valid valid, int P, int M,
                                        int pix0_block, float2* s_pt, int& p,
                                        float& d_out, int& i_out,
                                        bool& owner) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pix0 = pix0_block + warp * kG;
  const float2 nan2 = make_float2(NAN, NAN);

  float cx[kG], cy[kG], best[kG];
  int bidx[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int q = pix0 + g;
    cx[g] = q < P ? ct[(int64_t)q * 2] : NAN;   // NaN pixels never match
    cy[g] = q < P ? ct[(int64_t)q * 2 + 1] : NAN;
    best[g] = kFar;
    bidx[g] = kNone;
  }

  for (int base = 0; base < M; base += kStage) {
    // --- stage the tile, invalid candidates as NaN, padded to chunks;
    // every load of a thread is issued before its first store
    const int cnt = min(kStage, M - base);
    const int npad = (cnt + kChunk - 1) / kChunk * kChunk;
#pragma unroll
    for (int s = 0; s < kStage / kThreads; ++s) {
      const int i = threadIdx.x + s * kThreads;
      if (i < npad) {
        const int m = base + min(i, cnt - 1);   // the pad reads a real one
        const float2 q = make_float2(pr[(int64_t)m * 2], pr[(int64_t)m * 2 + 1]);
        const bool v = valid(m, q);
        s_pt[i] = i < cnt && v ? q : nan2;
      }
    }
    __syncthreads();

    // --- sweep: each lane its candidates, 4 at a time, for 8 pixels
    int bc[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) bc[g] = -1;
    for (int ch = 0; ch < npad / kChunk; ++ch) {
      const float2* sp = s_pt + ch * kChunk + lane;
      float2 q[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k) q[k] = sp[32 * k];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float cm = pair_d2(cx[g], cy[g], q[0]);
#pragma unroll
        for (int k = 1; k < kK; ++k)
          cm = fminf(cm, pair_d2(cx[g], cy[g], q[k]));
        const bool better = cm < best[g];
        best[g] = better ? cm : best[g];
        bc[g] = better ? ch : bc[g];
      }
    }
    // the first candidate of the winning chunk that equals the minimum
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (bc[g] >= 0) {
        const int j0 = bc[g] * kChunk + lane;
        int hit = j0;
#pragma unroll
        for (int k = kK - 1; k >= 0; --k)
          if (pair_d2(cx[g], cy[g], s_pt[j0 + 32 * k]) == best[g])
            hit = j0 + 32 * k;
        bidx[g] = base + hit;
      }
    }
    __syncthreads();                  // the next tile overwrites the stage
  }

  // --- the lexicographic minimum of (d2, m) over the warp's lanes.  Each
  // round of the butterfly (lanes 16, 8, 4 apart) a lane keeps half of its
  // pixels, takes its partner's values for them and sends its own for the
  // other half; then one pixel a lane is left, reduced 2 and 1 apart.
  int g_of_lane = 0;
#pragma unroll
  for (int r = 0; r < kLogG; ++r) {
    const int h = kG >> (r + 1);
    const bool up = lane & (16 >> r);
    g_of_lane += up ? h : 0;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      float d = up ? best[k + h] : best[k];
      int i = up ? bidx[k + h] : bidx[k];
      const float od = __shfl_xor_sync(0xffffffffu, up ? best[k] : best[k + h],
                                       16 >> r);
      const int oi = __shfl_xor_sync(0xffffffffu, up ? bidx[k] : bidx[k + h],
                                     16 >> r);
      lexmin(d, i, od, oi);
      best[k] = d;
      bidx[k] = i;
    }
  }
  float d = best[0];
  int i = bidx[0];
#pragma unroll
  for (int o = 16 >> kLogG; o > 0; o >>= 1)
    lexmin(d, i, __shfl_xor_sync(0xffffffffu, d, o),
           __shfl_xor_sync(0xffffffffu, i, o));
  p = pix0 + g_of_lane;
  owner = (lane & ((32 >> kLogG) - 1)) == 0 && p < P;
  d_out = d;
  i_out = i;
}

}  // namespace match

// ---------------------------------------------------------------------------
// The row scatter: out[m] += g[p] over idx[p] == m, ascending p
// ---------------------------------------------------------------------------

namespace scatter {

constexpr int kPBits = 10;                 // a chunk's entry in the key
constexpr int kMaxThreads = 1 << kPBits;
constexpr unsigned kNoKey = 0xffffffffu;   // dropped entries sort last

// The launch geometry of one row of P entries: {threads, dynamic shared
// bytes}; a thread an entry of a chunk, the chunk the power of two >= P,
// at most 1,024 entries.
inline void row_geometry(int P, int* threads, int* smem) {
  int n = 32;
  while (n < P && n < kMaxThreads) n <<= 1;
  *threads = n;
  *smem = n * (int)(2 * sizeof(unsigned) + 2 * sizeof(float2));
}

// One block adds a row's entries onto its output: the x/y sums of entry
// p (``g(p)``, a float2) with ``idx[p] == m`` land on ``row[m * stride]``
// and ``row[off1 + m * stride]`` (the [2, M] layout: stride 1, off1 M;
// the [M, 2] layout: stride 2, off1 1); idx outside [0, M) is dropped.
// The row (2 M floats from ``row``) is zeroed first; each sum starts at 0
// and adds its entries in ascending p.  ``s_key`` is the block's dynamic
// shared memory (row_geometry).  The writes of run heads are visible to
// the block after its next __syncthreads().
//
// Design: the block walks the row in chunks of blockDim entries: it
// stages the chunk's g in shared memory, sorts the in-range entries by
// the 32-bit key (idx << 10 | p in the chunk; callers keep M below
// 2^22 - 1, so no key reaches the sentinel of dropped entries) with a
// bitonic network (shuffles for strides below 32, double-buffered shared
// memory above), and the first thread of each run of one idx adds the
// run's g in ascending p onto its output: g is gathered into sorted order
// and the run's end read from the warps' ballots of run starts, so the
// serial sum waits on no load.  Chunks run in ascending p, each head
// reading back what the chunks before left, so the chunked sum is the
// sequential one.
template <class G>
__device__ __forceinline__ void add_row(const int* __restrict__ ix, G g,
                                        float* row, int off1, int stride,
                                        int P, int M, unsigned* s_key) {
  const int n = blockDim.x;
  const int t = threadIdx.x;
  float2* s_g = reinterpret_cast<float2*>(s_key + 2 * n);  // [n] by p
  float2* s_gs = s_g + n;                                 // [n] sorted
  __shared__ unsigned s_start[kMaxThreads / 32 + 1];

  for (int base = 0; base < P; base += n) {
    const int cnt = min(n, P - base);
    unsigned key = kNoKey;
    if (t < cnt) {
      const int m = ix[base + t];
      if (m >= 0 && m < M) key = ((unsigned)m << kPBits) | (unsigned)t;
      s_g[t] = g(base + t);
    }
    if (base == 0) {                // zero the row while the loads fly
      for (int i = t; i < 2 * M; i += n) row[i] = 0.0f;
      __syncthreads();
    }
    // bitonic sort of the block's keys, one a thread, ascending
    int sb = 0;
    for (int k = 2; k <= n; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        unsigned other;
        if (j >= 32) {
          s_key[sb * n + t] = key;
          __syncthreads();
          other = s_key[sb * n + (t ^ j)];
          sb ^= 1;
        } else {
          other = __shfl_xor_sync(0xffffffffu, key, j);
        }
        const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
        key = keep_min == (other < key) ? other : key;
      }
    }
    // the sorted keys, and each entry's g at its sorted position
    const unsigned* ks = s_key + sb * n;
    s_key[sb * n + t] = key;
    __syncthreads();
    const unsigned m = key >> kPBits;
    const bool head = key != kNoKey && (t == 0 || (ks[t - 1] >> kPBits) != m);
    if (key != kNoKey) s_gs[t] = s_g[key & (kMaxThreads - 1)];
    // bit l of a warp's word: sorted position 32 w + l starts a run (or
    // the dropped entries); the word past the last warp ends every run
    const unsigned starts = __ballot_sync(
        0xffffffffu, t == 0 || (ks[t - 1] >> kPBits) != m);
    if ((t & 31) == 0) s_start[t >> 5] = starts;
    if (t == 0) s_start[n >> 5] = 1u;
    __syncthreads();
    // the head of each run adds the run, in ascending p, onto its output
    // (onto 0 in the first chunk, which the row was just zeroed to)
    if (head) {
      int w = t >> 5;
      unsigned later = s_start[w] & ~(0xffffffffu >> (31 - (t & 31)));
      while (later == 0u) later = s_start[++w];
      const int end = 32 * w + __ffs(later) - 1;
      float* o0 = row + (int64_t)m * stride;
      float* o1 = o0 + off1;
      float a0 = 0.0f, a1 = 0.0f;
      if (base > 0) {
        a0 = *o0;
        a1 = *o1;
      }
#pragma unroll 4
      for (int u = t; u < end; ++u) {
        const float2 v = s_gs[u];
        a0 = __fadd_rn(a0, v.x);
        a1 = __fadd_rn(a1, v.y);
      }
      *o0 = a0;
      *o1 = a1;
    }
    __syncthreads();                // the next chunk reuses the stage
  }
  if (P == 0)
    for (int i = t; i < 2 * M; i += n) row[i] = 0.0f;
}

}  // namespace scatter

}  // namespace sil
