// Contour -> projected-vertex nearest match with payloads (silhouette ICP).
//
// Replaces the TPU kernel _contour_match_full_kernel
// (bodyfitting_tpu/ops/pallas_kernels.py:1620, called through
// contour_match_full); contour_min_idx (:1157, _contour_match_kernel :1125)
// is the same match without payloads and is served by this kernel too.
//
// Contract, bit for bit with the TPU kernel: for each contour pixel p of
// batch row bv, over candidates m in ascending order,
//   d2 = (cx - px)^2 + (cy - py)^2 + (valid[m] > 0 ? 0 : 1e30)
// and the running best, started at (d2 = 1e30, idx = 0, matched = (0, 0),
// inside = 0), is replaced only when d2 < best (strict).  That scan is the
// lexicographic minimum of (d2, m) over the candidates with d2 < 1e30 (NaN
// never wins), or the start value when there is none.  Each multiply and
// add is rounded on its own (__fmul_rn / __fadd_rn, and the file is built
// with -fmad=false), so the result equals the plain PyTorch version's
// bitwise.
//
// Bound on the H100: operations.  BV * P * M pairs (86 M at the production
// shape, BV 64, P 512, M 2,619) against a few MB of inputs.  A pair needs
// 5 floating-point instructions that cannot be fused (2 subtractions,
// 2 products, 1 addition) plus its share of the running minimum, so the
// kernel is held by instruction issue.  Design:
//   * A block takes 128 contour pixels of one row and stages the row's
//     candidates in shared memory as float2, in tiles of 3,072 when the
//     row is longer.  An invalid candidate is staged as a NaN point: its
//     d2 + 1e30 can never fall below 1e30 and a NaN never wins, and for
//     the valid ones the + 0 is exact, so the match does not change.
//   * A warp owns 8 pixels.  Each lane strides the staged candidates
//     (j = lane, lane + 32, ...), so shared loads are conflict-free and
//     each load serves all 8 pixels.  A lane takes its candidates 4 at a
//     time: the chunk's minimum is a tree of fminf (NaN drops out), and
//     only the chunk number is carried with the running minimum, not the
//     index.  At the end of a tile the lane finds the first candidate of
//     its winning chunk that equals its minimum.  A lane's candidates
//     ascend in m, so a strict < across chunks and the first equal one
//     inside a chunk give the lane's lexicographic minimum of (d2, m).
//   * The lanes' (d2, m) are reduced on the lexicographic order by a
//     shuffle butterfly that halves the pixels a lane carries each round,
//     and the payload (matched, inside) is read once, by the winning
//     index.
// 256 blocks of 512 threads at the production shape (2 resident an SM).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__global__ void __launch_bounds__(kThreads, 2) contour_match_full_kernel(
    const float* __restrict__ contour, const float* __restrict__ proj,
    const float* __restrict__ valid, const float* __restrict__ inside,
    float* __restrict__ d2_out, int* __restrict__ idx_out,
    float* __restrict__ matched_out, float* __restrict__ in_out,
    int P, int M) {
  extern __shared__ float2 s_pt[];              // a tile of candidates
  const int bv = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* pr = proj + (int64_t)bv * M * 2;
  const float* va = valid + (int64_t)bv * M;
  const float* ct = contour + (int64_t)bv * P * 2;
  const int pix0 = blockIdx.x * kPixPerBlock + warp * kG;
  const float2 nan2 = make_float2(NAN, NAN);

  float cx[kG], cy[kG], best[kG];
  int bidx[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int p = pix0 + g;
    cx[g] = p < P ? ct[(int64_t)p * 2] : NAN;   // NaN pixels never match
    cy[g] = p < P ? ct[(int64_t)p * 2 + 1] : NAN;
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
        const bool v = va[m] > 0.0f;
        const float2 q = make_float2(pr[(int64_t)m * 2], pr[(int64_t)m * 2 + 1]);
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
  const int p = pix0 + g_of_lane;
  if ((lane & ((32 >> kLogG) - 1)) == 0 && p < P) {
    const int64_t o = (int64_t)bv * P + p;
    const bool hit = i != kNone;
    d2_out[o] = hit ? d : kFar;
    idx_out[o] = hit ? i : 0;
    matched_out[o * 2 + 0] = hit ? pr[(int64_t)i * 2] : 0.0f;
    matched_out[o * 2 + 1] = hit ? pr[(int64_t)i * 2 + 1] : 0.0f;
    in_out[o] = hit ? inside[(int64_t)bv * M + i] : 0.0f;
  }
}

// The launch geometry for a [BV, P] x [BV, M] match: out = {blocks,
// threads, dynamic shared bytes}.  The shared memory holds one tile of
// candidates, rounded up to whole chunks.
void geometry(int BV, int P, int M, int* out) {
  const int n = M < kStage ? M : kStage;
  out[0] = (P + kPixPerBlock - 1) / kPixPerBlock * BV;
  out[1] = kThreads;
  out[2] = (n + kChunk - 1) / kChunk * kChunk * (int)sizeof(float2);
}

}  // namespace

extern "C" void contour_match_full_geometry(int BV, int P, int M, int* out) {
  geometry(BV, P, M, out);
}

extern "C" int contour_match_full_f32(const float* contour, const float* proj,
                                      const float* valid, const float* inside,
                                      float* d2, int* idx, float* matched,
                                      float* in_match, int BV, int P, int M,
                                      void* stream) {
  if (BV == 0 || P == 0) return 0;
  int geo[3];
  geometry(BV, P, M, geo);
  dim3 grid(geo[0] / BV, BV);
  contour_match_full_kernel<<<grid, geo[1], geo[2], (cudaStream_t)stream>>>(
      contour, proj, valid, inside, d2, idx, matched, in_match, P, M);
  return (int)cudaGetLastError();
}
