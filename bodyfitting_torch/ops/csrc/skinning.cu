// Fused linear blend skinning, forward and backward, batched over frames.
//
// Replaces the TPU kernels _skin_fwd_kernel and _skin_bwd_kernel
// (bodyfitting_tpu/ops/pallas_kernels.py:982 and :996, built by
// make_fused_skinning :1026 and vmapped over frames there).
//
// Contract, for W [V, J] (a constant: no gradient), A [B, J, 12],
// vp [B, V, 3], all f32 and contiguous, with T = W[v] @ A[b] ([12], the
// row-major 3x4 blended transform):
//   forward   out[b, v, r] = T[4r+3] + T[4r+0] vp[0] + T[4r+1] vp[1]
//                                    + T[4r+2] vp[2]
//   backward  dvp[b, v, k] = T[k] g[0] + T[4+k] g[1] + T[8+k] g[2]
//             dA[b, j, 4r+k] = sum_v W[v, j] g[v, r] vp[v, k]  (k < 3)
//             dA[b, j, 4r+3] = sum_v W[v, j] g[v, r]
// Every sum runs in the stated order and every product and sum is
// rounded on its own (-fmad=false), as the plain PyTorch version in
// ops/kernels/skinning.py does, so the two agree bit for bit:
//   T: j ascending from 0; the 3x4 apply as written above, left to right;
//   dA: per tile of kTile = 128 vertices, v ascending from 0, then the
//   tiles' partial sums in ascending tile order.  kTile is part of the
//   contract (the summation order), not of the launch: dA does not
//   depend on how many blocks run, and no float atomics are used, so
//   launches repeat bit for bit.
//
// Bound on the H100: launch-sized.  At B = 8, V = 10475, J = 55 the
// forward moves ~4.3 MB and does ~113 MFLOP of f32 FMA-free work, about
// 1.7 us either way.  Design: one block per (tile of 128 vertices,
// frame), one thread per vertex.  The block stages its W tile (contiguous
// rows, coalesced) and A[b] in shared memory; T stays in registers, so
// the [B, V, 12] blended transform never reaches device memory.  The
// backward writes per-tile dA partials [B, tiles, J, 12] (each thread of
// the tile block owns some (j, c) entries and walks the tile's vertices
// in order) and a second kernel sums them over tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;     // vertices per tile (the dA summation unit)
constexpr int kMaxJ = 64;      // joints a model may have (SMPL-X: 55)

// Stage the W tile [n, J] and A[b] [J, 12] in shared memory.
__device__ void stage(const float* __restrict__ W, const float* __restrict__ A,
                      float* sW, float* sA, int v0, int n, int J, int b) {
  const float* wt = W + (int64_t)v0 * J;
  for (int i = threadIdx.x; i < n * J; i += blockDim.x) sW[i] = wt[i];
  const float* ab = A + (int64_t)b * J * 12;
  for (int i = threadIdx.x; i < J * 12; i += blockDim.x) sA[i] = ab[i];
}

// T = W[v] @ A[b], j ascending from 0, each product and sum rounded.
__device__ void blend(const float* w, const float* sA, int J, float* T) {
#pragma unroll
  for (int c = 0; c < 12; ++c) T[c] = 0.0f;
  for (int j = 0; j < J; ++j) {
    const float wj = w[j];
#pragma unroll
    for (int c = 0; c < 12; ++c)
      T[c] = __fadd_rn(T[c], __fmul_rn(wj, sA[j * 12 + c]));
  }
}

__global__ void skin_fwd_kernel(const float* __restrict__ W,
                                const float* __restrict__ A,
                                const float* __restrict__ vp,
                                float* __restrict__ out, int V, int J) {
  __shared__ float sW[kTile * kMaxJ];
  __shared__ float sA[kMaxJ * 12];
  const int b = blockIdx.y;
  const int v0 = blockIdx.x * kTile;
  const int n = min(kTile, V - v0);
  stage(W, A, sW, sA, v0, n, J, b);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= n) return;
  float T[12];
  blend(sW + t * J, sA, J, T);
  const int64_t o = ((int64_t)b * V + v0 + t) * 3;
  const float p0 = vp[o], p1 = vp[o + 1], p2 = vp[o + 2];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float acc = T[4 * r + 3];
    acc = __fadd_rn(acc, __fmul_rn(T[4 * r + 0], p0));
    acc = __fadd_rn(acc, __fmul_rn(T[4 * r + 1], p1));
    acc = __fadd_rn(acc, __fmul_rn(T[4 * r + 2], p2));
    out[o + r] = acc;
  }
}

__global__ void skin_bwd_tile_kernel(const float* __restrict__ W,
                                     const float* __restrict__ A,
                                     const float* __restrict__ vp,
                                     const float* __restrict__ g,
                                     float* __restrict__ dvp,
                                     float* __restrict__ part, int V, int J,
                                     int tiles) {
  __shared__ float sW[kTile * kMaxJ];
  __shared__ float sA[kMaxJ * 12];
  __shared__ float sM[kTile * 12];
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int v0 = tile * kTile;
  const int n = min(kTile, V - v0);
  stage(W, A, sW, sA, v0, n, J, b);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < n) {
    float T[12];
    blend(sW + t * J, sA, J, T);
    const int64_t o = ((int64_t)b * V + v0 + t) * 3;
    const float gr[3] = {g[o], g[o + 1], g[o + 2]};
    const float pk[3] = {vp[o], vp[o + 1], vp[o + 2]};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = __fmul_rn(T[k], gr[0]);
      acc = __fadd_rn(acc, __fmul_rn(T[4 + k], gr[1]));
      acc = __fadd_rn(acc, __fmul_rn(T[8 + k], gr[2]));
      dvp[o + k] = acc;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int k = 0; k < 3; ++k) sM[t * 12 + 4 * r + k] = __fmul_rn(gr[r], pk[k]);
      sM[t * 12 + 4 * r + 3] = gr[r];
    }
  }
  __syncthreads();
  float* pb = part + ((int64_t)b * tiles + tile) * J * 12;
  for (int e = t; e < J * 12; e += blockDim.x) {
    const int j = e / 12, c = e - 12 * (e / 12);
    float acc = 0.0f;
    for (int i = 0; i < n; ++i)
      acc = __fadd_rn(acc, __fmul_rn(sW[i * J + j], sM[i * 12 + c]));
    pb[e] = acc;
  }
}

// dA[b, e] = sum over tiles, ascending, of part[b, tile, e].
__global__ void skin_bwd_sum_kernel(const float* __restrict__ part,
                                    float* __restrict__ dA, int B, int E,
                                    int tiles) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)B * E) return;
  const int b = (int)(i / E), e = (int)(i - (int64_t)b * E);
  const float* p = part + (int64_t)b * tiles * E + e;
  float acc = 0.0f;
  for (int s = 0; s < tiles; ++s) acc = __fadd_rn(acc, p[(int64_t)s * E]);
  dA[i] = acc;
}

}  // namespace

extern "C" int skin_fwd_f32(const float* W, const float* A, const float* vp,
                            float* out, int B, int V, int J, void* stream) {
  if (J > kMaxJ || J <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0) return 0;
  dim3 grid((V + kTile - 1) / kTile, B);
  skin_fwd_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(W, A, vp, out, V, J);
  return (int)cudaGetLastError();
}

// part: scratch of B * tiles * J * 12 floats, tiles = ceil(V / 128).
extern "C" int skin_bwd_f32(const float* W, const float* A, const float* vp,
                            const float* g, float* dvp, float* dA, float* part,
                            int B, int V, int J, void* stream) {
  if (J > kMaxJ || J <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int tiles = (V + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiles > 0) {
    dim3 grid(tiles, B);
    skin_bwd_tile_kernel<<<grid, kTile, 0, s>>>(W, A, vp, g, dvp, part, V, J,
                                                tiles);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int E = J * 12;
  const int64_t n = (int64_t)B * E;
  skin_bwd_sum_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(part, dA, B, E,
                                                             tiles);
  return (int)cudaGetLastError();
}
