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
// inside = 0), is replaced only when d2 < best (strict): ties keep the
// lowest index and a row with no valid candidate returns the start value.
// Each multiply and add is rounded on its own (__fmul_rn / __fadd_rn, and
// the file is built with -fmad=false) so the argmin equals the plain
// PyTorch version's exactly.
//
// Bound on the H100: operations.  BV * P * M distance evaluations (86 M at
// the production shape) against a few MB of inputs.  Design: one thread per
// contour pixel; candidates are staged through shared memory in tiles that
// every thread of the block then scans sequentially.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFar = 1e30f;
constexpr int kTile = 1024;
constexpr int kThreads = 128;

__global__ void contour_match_full_kernel(
    const float* __restrict__ contour, const float* __restrict__ proj,
    const float* __restrict__ valid, const float* __restrict__ inside,
    float* __restrict__ d2_out, int* __restrict__ idx_out,
    float* __restrict__ matched_out, float* __restrict__ in_out,
    int P, int M) {
  __shared__ float s_px[kTile];
  __shared__ float s_py[kTile];
  __shared__ float s_big[kTile];
  __shared__ float s_in[kTile];

  const int bv = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < P;
  float cx = 0.f, cy = 0.f;
  if (live) {
    cx = contour[((int64_t)bv * P + p) * 2 + 0];
    cy = contour[((int64_t)bv * P + p) * 2 + 1];
  }
  float best = kFar, bpx = 0.f, bpy = 0.f, bin = 0.f;
  int bidx = 0;

  const float* pr = proj + (int64_t)bv * M * 2;
  const float* va = valid + (int64_t)bv * M;
  const float* ins = inside + (int64_t)bv * M;
  for (int base = 0; base < M; base += kTile) {
    const int cnt = min(kTile, M - base);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      s_px[i] = pr[(int64_t)(base + i) * 2 + 0];
      s_py[i] = pr[(int64_t)(base + i) * 2 + 1];
      s_big[i] = va[base + i] > 0.0f ? 0.0f : kFar;
      s_in[i] = ins[base + i];
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        const float dx = __fsub_rn(cx, s_px[j]);
        const float dy = __fsub_rn(cy, s_py[j]);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), s_big[j]);
        if (d2 < best) {
          best = d2;
          bidx = base + j;
          bpx = s_px[j];
          bpy = s_py[j];
          bin = s_in[j];
        }
      }
    }
  }
  if (live) {
    const int64_t o = (int64_t)bv * P + p;
    d2_out[o] = best;
    idx_out[o] = bidx;
    matched_out[o * 2 + 0] = bpx;
    matched_out[o * 2 + 1] = bpy;
    in_out[o] = bin;
  }
}

}  // namespace

extern "C" int contour_match_full_f32(const float* contour, const float* proj,
                                      const float* valid, const float* inside,
                                      float* d2, int* idx, float* matched,
                                      float* in_match, int BV, int P, int M,
                                      void* stream) {
  if (BV == 0 || P == 0) return 0;
  dim3 grid((P + kThreads - 1) / kThreads, BV);
  contour_match_full_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      contour, proj, valid, inside, d2, idx, matched, in_match, P, M);
  return (int)cudaGetLastError();
}
