// Z-buffer rasterization of projected triangles: per pixel the nearest
// perspective-correct depth and the winning face, and (second entry point)
// the winner's per-corner attributes interpolated perspective-correctly.
//
// Replaces the TPU kernels rasterize_zbuf (bodyfitting_tpu/ops/
// pallas_kernels.py:508, body _raster_kernel :445 / _raster_block :468)
// and rasterize_attrs_prepacked (:779, body _raster_attr_kernel :641).
//
// Contract (ops/kernels/raster.py states it in full): pixel centres at
// +0.5, rows are y.  A face covers a pixel centre p when p lies in its
// closed bounding box, inside the triangle by the edge functions e0, e1,
// e2 (either winding), |area| > 1e-9 and all three z > 1e-9.  With
// iz_k = 1 / max(z_k, 1e-9): wiz_k = (e_k / area) iz_k, inv_z = (wiz0 +
// wiz1) + wiz2, depth = 1 / (inv_z > 1e-9 ? inv_z : 1e-9).  The winner is
// the covering face of least depth, ties to the least caller face index,
// and a depth of 1e9 (FAR) never wins; background is depth FAR, index -1,
// attributes 0.  Attributes are ((wiz0 a0 + wiz1 a1) + wiz2 a2) depth.
// Every operation is rounded on its own (__f*_rn, and the file is built
// with -fmad=false) in the order of the plain PyTorch version, so depth and
// attributes equal it bit for bit and the face index exactly.
//
// Design.  Face-parallel, in two kernels.  The wrapper gives each face
// that can win the pixel box its bounding box may cover (a superset,
// clamped to the image) and a prefix sum of its 8x8-pixel sub-boxes.  The
// sweep kernel takes one sub-box a thread (grid-stride; the face by binary
// search in the prefix sum, so a large face spreads over many threads),
// tests each pixel centre of it against the face (box, edges, area) and
// merges the hit into the pixel's 64-bit key, depth bits above the caller
// index, with atomicMin.  A positive float's bits order as the float, so
// the least key is the least depth and, among equal depths, the least
// index: the contract's tie rule, whatever the order of the atomics.  The
// resolve kernel unpacks each pixel's key and, for attributes, evaluates
// the winner again with the same __device__ function, so its weights and
// depth are the sweep's.  The work is the pixel-face pairs of the face
// boxes (a few a covered pixel).  The Pallas kernels' y-sorted face
// blocks, scalar-prefetched tile ranges and one-hot winner selection
// (Mosaic has no gather) have no counterpart.
//
// Bound on the H100: bytes (face data in, depth/index/attributes out: ~10
// MB for a 512^2 view of a 219,008-face scan, ~3 us at 3.35 TB/s); the
// box pairs' operations (~1.5 M pairs x 25) take well under that.  The
// wrapper's box and prefix-sum pass and the 64-bit key buffer (8 bytes a
// pixel, written, read and re-written) add traffic the bound leaves out.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kSub = 8;               // sub-box side, pixels
constexpr int kThreads = 256;
constexpr float kEps = 1e-9f;
constexpr float kFar = 1e9f;
constexpr unsigned long long kEmpty = ~0ull;

struct Face {
  float ax, ay, bx, by, cx, cy;
  float iz0, iz1, iz2;
  float x0, x1, y0, y1;               // box; empty when the face is not front
};

// Face j (caller order).
__device__ __forceinline__ Face load_face(const float* __restrict__ px,
                                          const float* __restrict__ z,
                                          int j) {
  const float* p = px + (int64_t)j * 6;
  const float* q = z + (int64_t)j * 3;
  Face f;
  f.ax = __ldg(p + 0); f.ay = __ldg(p + 1);
  f.bx = __ldg(p + 2); f.by = __ldg(p + 3);
  f.cx = __ldg(p + 4); f.cy = __ldg(p + 5);
  const float z0 = __ldg(q + 0), z1 = __ldg(q + 1), z2 = __ldg(q + 2);
  f.iz0 = __fdiv_rn(1.0f, fmaxf(z0, kEps));
  f.iz1 = __fdiv_rn(1.0f, fmaxf(z1, kEps));
  f.iz2 = __fdiv_rn(1.0f, fmaxf(z2, kEps));
  if (z0 > kEps && z1 > kEps && z2 > kEps) {
    f.x0 = fminf(fminf(f.ax, f.bx), f.cx);
    f.x1 = fmaxf(fmaxf(f.ax, f.bx), f.cx);
    f.y0 = fminf(fminf(f.ay, f.by), f.cy);
    f.y1 = fmaxf(fmaxf(f.ay, f.by), f.cy);
  } else {                            // never wins: an empty box skips it
    f.x0 = f.y0 = CUDART_INF_F;
    f.x1 = f.y1 = -CUDART_INF_F;
  }
  return f;
}

__device__ __forceinline__ bool in_box(const Face& f, float px, float py) {
  return px >= f.x0 && px <= f.x1 && py >= f.y0 && py <= f.y1;
}

// Edge tests, depth and weights of pixel centre (px, py) against face f,
// inside its box.  False when f does not cover the pixel.
__device__ __forceinline__ bool shade(const Face& f, float px, float py,
                                      float& depth, float& wiz0, float& wiz1,
                                      float& wiz2) {
  const float e0 = __fsub_rn(__fmul_rn(__fsub_rn(f.cx, f.bx),
                                       __fsub_rn(py, f.by)),
                             __fmul_rn(__fsub_rn(f.cy, f.by),
                                       __fsub_rn(px, f.bx)));
  const float e1 = __fsub_rn(__fmul_rn(__fsub_rn(f.ax, f.cx),
                                       __fsub_rn(py, f.cy)),
                             __fmul_rn(__fsub_rn(f.ay, f.cy),
                                       __fsub_rn(px, f.cx)));
  const float e2 = __fsub_rn(__fmul_rn(__fsub_rn(f.bx, f.ax),
                                       __fsub_rn(py, f.ay)),
                             __fmul_rn(__fsub_rn(f.by, f.ay),
                                       __fsub_rn(px, f.ax)));
  const float area = __fsub_rn(__fmul_rn(__fsub_rn(f.bx, f.ax),
                                         __fsub_rn(f.cy, f.ay)),
                               __fmul_rn(__fsub_rn(f.by, f.ay),
                                         __fsub_rn(f.cx, f.ax)));
  const bool inside = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) ||
                      (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
  if (!inside || !(fabsf(area) > kEps)) return false;
  wiz0 = __fmul_rn(__fdiv_rn(e0, area), f.iz0);
  wiz1 = __fmul_rn(__fdiv_rn(e1, area), f.iz1);
  wiz2 = __fmul_rn(__fdiv_rn(e2, area), f.iz2);
  const float inv_z = __fadd_rn(__fadd_rn(wiz0, wiz1), wiz2);
  depth = __fdiv_rn(1.0f, inv_z > kEps ? inv_z : kEps);   // NaN -> FAR
  return true;
}

// One 8x8 sub-box of one face a thread: each pixel centre of it that the
// face covers merges (depth bits, face index) into keys with atomicMin.
// box[j] = (first column, first row, columns, rows) of face j's pixel box;
// offsets[j] the inclusive prefix sum of the sub-box counts.
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ px, const float* __restrict__ z,
             const int4* __restrict__ box,
             const long long* __restrict__ offsets,
             unsigned long long* __restrict__ keys, int W, int F) {
  const long long total = __ldg(offsets + F - 1);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
       item < total; item += stride) {
    int lo = 0, hi = F - 1;           // the first face whose sum exceeds item
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(offsets + mid) > item) hi = mid; else lo = mid + 1;
    }
    const int j = lo;
    const long long start = j ? __ldg(offsets + j - 1) : 0;
    const int4 b = __ldg(box + j);
    const int cols = (b.z + kSub - 1) / kSub;
    const int sub = (int)(item - start);
    const int x0 = b.x + (sub % cols) * kSub;
    const int y0 = b.y + (sub / cols) * kSub;
    const int x1 = min(x0 + kSub, b.x + b.z);
    const int y1 = min(y0 + kSub, b.y + b.w);
    const Face f = load_face(px, z, j);
    for (int y = y0; y < y1; ++y) {
      const float pyc = (float)y + 0.5f;
      for (int x = x0; x < x1; ++x) {
        const float pxc = (float)x + 0.5f;
        float d, w0, w1, w2;
        if (!in_box(f, pxc, pyc) || !shade(f, pxc, pyc, d, w0, w1, w2) ||
            !(d < kFar))
          continue;
        const unsigned long long key =
            ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)j;
        unsigned long long* k = keys + (int64_t)y * W + x;
        if (key < *k) atomicMin(k, key);
      }
    }
  }
}

// One pixel a thread: unpack its key; with A > 0, the winner's attributes
// (attrs [F, 3, A], caller order) into out_attr [H, W, A].
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const unsigned long long* __restrict__ keys,
               const float* __restrict__ px, const float* __restrict__ z,
               const float* __restrict__ attrs, float* __restrict__ out_depth,
               int* __restrict__ out_idx, float* __restrict__ out_attr,
               int H, int W, int A) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (int64_t)H * W) return;
  const unsigned long long key = keys[p];
  const bool won = key != kEmpty;
  const int j = won ? (int)(key & 0xffffffffull) : -1;
  out_depth[p] = won ? __uint_as_float((unsigned)(key >> 32)) : kFar;
  out_idx[p] = j;
  if (A == 0) return;
  float* out = out_attr + p * A;
  if (!won) {
    for (int c = 0; c < A; ++c) out[c] = 0.0f;
    return;
  }
  const Face f = load_face(px, z, j);
  const float pxc = (float)(p % W) + 0.5f, pyc = (float)(p / W) + 0.5f;
  float d, w0, w1, w2;
  shade(f, pxc, pyc, d, w0, w1, w2);             // the sweep's values
  const float* a = attrs + (int64_t)j * 3 * A;
  for (int c = 0; c < A; ++c) {
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(w0, __ldg(a + c)),
                                        __fmul_rn(w1, __ldg(a + A + c))),
                              __fmul_rn(w2, __ldg(a + 2 * A + c)));
    out[c] = __fmul_rn(v, d);
  }
}

int launch(const float* px, const float* z, const int* box,
           const long long* offsets, const float* attrs,
           unsigned long long* keys, float* depth, int* idx, float* out_attr,
           int H, int W, int F, int A, int sweep_blocks, void* stream) {
  if (H <= 0 || W <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (F > 0) {
    sweep_kernel<<<sweep_blocks, kThreads, 0, s>>>(
        px, z, reinterpret_cast<const int4*>(box), offsets, keys, W, F);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int64_t P = (int64_t)H * W;
  resolve_kernel<<<(unsigned)((P + kThreads - 1) / kThreads), kThreads, 0,
                   s>>>(keys, px, z, attrs, depth, idx, out_attr, H, W, A);
  return (int)cudaGetLastError();
}

}  // namespace

// Inputs from the wrapper (ops/kernels/raster.py): px [F, 3, 2] and z
// [F, 3] in caller order; box [F, 4] int32 each face's pixel box (first
// column, first row, columns, rows; 0 columns for a face that cannot win);
// offsets [F] int64 the inclusive prefix sum of its 8x8 sub-boxes; keys
// [H, W] uint64 all ones (scratch).  Outputs depth [H, W] f32 and idx
// [H, W] int32.  sweep_blocks: the sweep's grid (grid-stride).
extern "C" int rasterize_zbuf_f32(const float* px, const float* z,
                                  const int* box, const long long* offsets,
                                  unsigned long long* keys, float* depth,
                                  int* idx, int H, int W, int F,
                                  int sweep_blocks, void* stream) {
  return launch(px, z, box, offsets, nullptr, keys, depth, idx, nullptr, H, W,
                F, 0, sweep_blocks, stream);
}

// As above, with attrs [F, 3, A] in caller order, and out_attr [H, W, A]
// f32 out.
extern "C" int rasterize_attrs_f32(const float* px, const float* z,
                                   const int* box, const long long* offsets,
                                   const float* attrs,
                                   unsigned long long* keys, float* depth,
                                   int* idx, float* out_attr, int H, int W,
                                   int F, int A, int sweep_blocks,
                                   void* stream) {
  return launch(px, z, box, offsets, attrs, keys, depth, idx, out_attr, H, W,
                F, A, sweep_blocks, stream);
}
