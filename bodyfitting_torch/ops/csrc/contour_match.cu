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

#include "silhouette.cuh"

namespace {

using namespace sil::match;

// a candidate takes part when its valid flag is positive
struct FlagValid {
  const float* va;
  __device__ __forceinline__ bool operator()(int m, float2) const {
    return va[m] > 0.0f;
  }
};

__global__ void __launch_bounds__(kThreads, 2) contour_match_full_kernel(
    const float* __restrict__ contour, const float* __restrict__ proj,
    const float* __restrict__ valid, const float* __restrict__ inside,
    float* __restrict__ d2_out, int* __restrict__ idx_out,
    float* __restrict__ matched_out, float* __restrict__ in_out,
    int P, int M) {
  extern __shared__ float2 s_pt[];              // a tile of candidates
  const int bv = blockIdx.y;
  const float* pr = proj + (int64_t)bv * M * 2;
  int p, i;
  float d;
  bool owner;
  nearest(contour + (int64_t)bv * P * 2, pr, FlagValid{valid + (int64_t)bv * M},
          P, M, blockIdx.x * kPixPerBlock, s_pt, p, d, i, owner);
  if (owner) {
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
  out[0] = (P + kPixPerBlock - 1) / kPixPerBlock * BV;
  out[1] = kThreads;
  out[2] = stage_bytes(M);
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
