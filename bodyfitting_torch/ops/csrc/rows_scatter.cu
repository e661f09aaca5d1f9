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
// The sum starts at 0 and runs over p in ascending order, in f32, so it
// is bit-for-bit repeatable and equal to the plain version (no float
// atomics: the f32 fits are chaotic, and a run-to-run change in
// summation order would change converged fits).
//
// Bound on the H100: memory, and at the fits' shapes the launch (a few MB
// move at most; the function needs O(P) additions).  Design: one block a
// batch row, one thread an entry of a chunk of blockDim entries (the
// power of two >= P, at most 1,024): a bitonic sort of (idx, p) keys and
// one serial sum a run of one idx, in ascending p, as
// sil::scatter::add_row (silhouette.cuh) sets out.  The wrapper keeps M
// below 2^22 - 1, which the sort key needs.
// The TPU form (a one-hot contracted on the MXU) rounds g to bf16 on the
// chip; this kernel sums exact f32 values.

#include "silhouette.cuh"

namespace {

// entry p's cotangent row of g [P, 2]
struct Rows {
  const float* g;
  __device__ __forceinline__ float2 operator()(int p) const {
    return make_float2(g[(int64_t)p * 2], g[(int64_t)p * 2 + 1]);
  }
};

__global__ void rows_scatter_add_kernel(const int* __restrict__ idx,
                                        const float* __restrict__ g,
                                        float* __restrict__ out, int P,
                                        int M) {
  extern __shared__ unsigned s_key[];
  const int bv = blockIdx.x;
  sil::scatter::add_row(idx + (int64_t)bv * P, Rows{g + (int64_t)bv * P * 2},
                        out + (int64_t)bv * 2 * M, M, 1, P, M, s_key);
}

// The launch geometry for a [BV, P] -> [BV, 2, M] scatter: out = {blocks,
// threads, dynamic shared bytes}; a thread an entry of a chunk, the
// chunk the power of two >= P, at most 1,024 entries.
void geometry(int BV, int P, int* out) {
  out[0] = BV;
  sil::scatter::row_geometry(P, &out[1], &out[2]);
}

}  // namespace

extern "C" void rows_scatter_add_geometry(int BV, int P, int M, int* out) {
  geometry(BV, P, out);
}

extern "C" int rows_scatter_add_f32(const int* idx, const float* g, float* out,
                                    int BV, int P, int M, void* stream) {
  if (BV == 0 || M == 0) return 0;
  int geo[3];
  geometry(BV, P, geo);
  rows_scatter_add_kernel<<<geo[0], geo[1], geo[2], (cudaStream_t)stream>>>(
      idx, g, out, P, M);
  return (int)cudaGetLastError();
}
