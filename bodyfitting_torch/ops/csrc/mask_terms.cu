// The fused per-view mask term: both silhouette terms of every view in a
// forward of two launches and a backward of one.
//
// Replaces the route of the TPU package's custom VJP
// _mask_view_terms_fused (bodyfitting_tpu/losses/silhouette.py:589; its
// forward :606 reaches the TPU kernels _bilinear_cov_kernel
// (pallas_kernels.py:1242) and _contour_match_full_kernel (:1620), its
// backward :615 reaches _rows_scatter_kernel (:1738)).
//
// Contract, per view bv of BV (f32; the crop f32 or a bit mask):
//   xyhat = proj * (sx, sy); per projected vertex m, the stay-inside
//   sample s and its derivatives on the crop at xyhat - origin (the
//   sampler of bilinear.cu, without coverage) and the closed-form coverage
//   c of the full H x W image with its derivatives (NaN propagates, as
//   torch.minimum and torch.clamp do):
//     vert[bv] = (c - s, dc/dx - ds/dx, dc/dy - ds/dy)       [3, M]
//   per contour pixel p, the nearest projected vertex inside [0, imsize)^2
//   (the match of contour_match.cu: lowest index on ties, NaN never wins),
//   hit when there is one; matched = proj[idx] (0 without a hit),
//     dist = sqrt((mx - cx)^2 + (my - cy)^2 + 1e-12),
//     coeff = epsilon where the crop's pixel at the clamped integer matched
//       pixel, minus origin, is below 0.1 (outside the crop reads 0), else 1,
//     pix[bv] = (hit ? dist : 0) * coeff * cvalid,
//               hit ? coeff * cvalid / dist : 0, mx - cx, my - cy  [4, P]
//   and the view's sums
//     icp = tree(pix[bv][0]),  binary = vvalid * tree(vert[bv][0]),
//   where tree(x) pads x with zeros to the next power of two and adds its
//   halves, x[:h] + x[h:], until one value is left (a fixed order, so a
//   rerun gives the same bits and the plain version writes it out).
// Backward, for the cotangents g_icp, g_binary [BV]:
//   dproj[bv, m] = sum over p with idx[p] == m, ascending p, from 0, of
//                  (g_icp wf_p) (dx_p, dy_p)
//                  + ((g_binary vvalid) (ex_m, ey_m)) * (sx, sy).
// Each multiply and add is rounded on its own (-fmad=false, and __f*_rn
// where the order matters), so the plain PyTorch version
// (ops/kernels/mask_terms.py) equals the kernels bitwise.
//
// Design.  The work is the three separate kernels' work; what changes is
// the launches around them: the separate route runs the inside test, the
// distance chain, the lookup's coordinates, the coefficient, three
// reductions, the coverage and its gradients and the cotangent assembly
// as dozens of small PyTorch ops in the forward and again in autograd's
// backward.  Here
//   * launch 1 (mask_terms_points_kernel) is one flat grid of 512-thread
//     blocks: first the contour match's blocks of 128 pixels of every
//     view (the match of contour_match.cu, its candidates' validity the
//     inside test, then each pixel's whole chain), so the heavy blocks
//     are placed first, then blocks of 512 vertices (a vertex a thread:
//     the sampler of bilinear.cu and the coverage);
//   * launch 2 (mask_terms_sums_kernel) is a block of 1,024 threads a
//     view: the two tree sums in shared memory (half the padded lengths
//     of both, within 48 KB: M up to 16,384 at P 512);
//   * the backward (mask_terms_backward_kernel) is a block a view: the
//     scatter of rows_scatter.cu with the cotangent made as it is loaded,
//     into the [M, 2] layout, then the stay-inside term added per vertex.
// Bound on the H100: operations, by the match (BV P M pairs); the rest
// moves a few MB.

#include "silhouette.cuh"

namespace {

using sil::match::kNone;
using sil::match::kPixPerBlock;
constexpr int kThreads = sil::match::kThreads;   // 512
constexpr int kVertsPerBlock = kThreads;         // a vertex a thread
constexpr int kSumThreads = 1024;

// the separate route's inside test: a candidate in [0, imsize)^2
struct InImage {
  float imsize;
  __device__ __forceinline__ bool operator()(int, float2 q) const {
    return q.x >= 0.0f && q.x < imsize && q.y >= 0.0f && q.y < imsize;
  }
};

// clamp(min(v + 1, n - v), 0, 1) and its slope on the open ramp, with
// torch.minimum's and torch.clamp's NaN propagation
__device__ __forceinline__ void axis_cov(float v, float n, float& c,
                                         float& d) {
  const float lo = __fadd_rn(v, 1.0f), hi = __fsub_rn(n, v);
  const float m = (isnan(lo) || lo < hi) ? lo : hi;
  c = isnan(m) ? m : fminf(fmaxf(m, 0.0f), 1.0f);
  const bool ramp = c > 0.0f && c < 1.0f;
  d = ramp ? (lo < hi ? 1.0f : -1.0f) : 0.0f;
}

// half the padded length of a tree sum over n values (0 for n <= 1)
int half_of(int n) {
  if (n <= 1) return 0;
  int h = 1;
  while (2 * h < n) h <<= 1;
  return h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) mask_terms_points_kernel(
    const float* __restrict__ proj, const float* __restrict__ contour,
    const float* __restrict__ cvalid, const T* __restrict__ crop,
    const float* __restrict__ origin, float* __restrict__ pix,
    int* __restrict__ idx, float* __restrict__ vert, int BV, int P, int M,
    int Hc, int Wc, int H, int W, int pix_blocks, int vert_blocks,
    float imsize, float epsilon, float sx, float sy) {
  extern __shared__ float2 s_pt[];              // the match's tile
  // the pixel blocks of every view first, then the vertex blocks
  const int b = blockIdx.x;
  const bool pixels = b < BV * pix_blocks;
  const int r = pixels ? b : b - BV * pix_blocks;
  const int per_view = pixels ? pix_blocks : vert_blocks;
  const int bv = r / per_view, x = r - bv * per_view;
  const float* pr = proj + (int64_t)bv * M * 2;
  const T* im = crop + (int64_t)bv * Hc * sil::Image<T>::row_elems(Wc);
  const float ox = origin[bv * 2], oy = origin[bv * 2 + 1];

  if (pixels) {
    // --- contour pixels: the match, then each pixel's chain
    const float* ct = contour + (int64_t)bv * P * 2;
    int p, i;
    float d;
    bool owner;
    sil::match::nearest(ct, pr, InImage{imsize}, P, M, x * kPixPerBlock,
                        s_pt, p, d, i, owner);
    if (!owner) return;
    const bool hit = i != kNone;
    const float mx = hit ? pr[(int64_t)i * 2] : 0.0f;
    const float my = hit ? pr[(int64_t)i * 2 + 1] : 0.0f;
    const float dx = __fsub_rn(mx, ct[(int64_t)p * 2]);
    const float dy = __fsub_rn(my, ct[(int64_t)p * 2 + 1]);
    const float dist = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), 1e-12f));
    // the crop's pixel at the matched pixel: a bilinear sample at integer
    // coordinates is the pixel's value exactly
    const int px = min(max((int)mx, 0), W - 1);
    const int py = min(max((int)my, 0), H - 1);
    const sil::Sample at = sil::bilinear_sample<T>(
        im, Hc, Wc, __fsub_rn((float)px, ox), __fsub_rn((float)py, oy), 0, 0);
    const float coeff = at.s < 0.1f ? epsilon : 1.0f;
    const float cv = cvalid[(int64_t)bv * P + p];
    float* o = pix + (int64_t)bv * 4 * P + p;
    o[0] = __fmul_rn(__fmul_rn(hit ? dist : 0.0f, coeff), cv);
    o[P] = hit ? __fdiv_rn(__fmul_rn(coeff, cv), dist) : 0.0f;
    o[2 * P] = dx;
    o[3 * P] = dy;
    idx[(int64_t)bv * P + p] = hit ? i : 0;
    return;
  }

  // --- projected vertices: the stay-inside sample and the coverage
  const int m = x * kVertsPerBlock + threadIdx.x;
  if (m >= M) return;
  const float xh = __fmul_rn(pr[(int64_t)m * 2], sx);
  const float yh = __fmul_rn(pr[(int64_t)m * 2 + 1], sy);
  const sil::Sample s = sil::bilinear_sample<T>(
      im, Hc, Wc, __fsub_rn(xh, ox), __fsub_rn(yh, oy), 1, 0);
  float rs, drs, cs, dcs;
  axis_cov(yh, (float)H, rs, drs);
  axis_cov(xh, (float)W, cs, dcs);
  float* o = vert + (int64_t)bv * 3 * M + m;
  o[0] = __fsub_rn(__fmul_rn(rs, cs), s.s);
  o[M] = __fsub_rn(__fmul_rn(dcs, rs), s.sx);
  o[2 * M] = __fsub_rn(__fmul_rn(drs, cs), s.sy);
}

// The tree sum of x [n] by one block, through the row s [h] (h = half_of(n)).
__device__ float tree_sum(const float* x, int n, float* s, int h) {
  if (n <= 1) return n == 1 ? x[0] : 0.0f;
  for (int i = threadIdx.x; i < h; i += blockDim.x)
    s[i] = __fadd_rn(x[i], i + h < n ? x[i + h] : 0.0f);
  __syncthreads();
  for (int k = h >> 1; k > 0; k >>= 1) {
    for (int i = threadIdx.x; i < k; i += blockDim.x)
      s[i] = __fadd_rn(s[i], s[i + k]);
    __syncthreads();
  }
  return s[0];
}

// A block a view: the two trees, in two rows of shared memory.
__global__ void __launch_bounds__(kSumThreads) mask_terms_sums_kernel(
    const float* __restrict__ pix, const float* __restrict__ vert,
    const float* __restrict__ vvalid, float* __restrict__ sums, int BV,
    int P, int M, int hP, int hM) {
  extern __shared__ float s_sum[];                // [hP + hM]
  const int bv = blockIdx.x;
  const float icp = tree_sum(pix + (int64_t)bv * 4 * P, P, s_sum, hP);
  const float bin = tree_sum(vert + (int64_t)bv * 3 * M, M, s_sum + hP, hM);
  if (threadIdx.x == 0) {
    sums[bv] = icp;
    sums[BV + bv] = __fmul_rn(vvalid[bv], bin);
  }
}

// entry p's cotangent, (g_icp wf_p) (dx_p, dy_p), made as it is loaded
struct Cotangent {
  const float* wf;               // pix rows 1-3 of one view
  int P;
  float gi;
  __device__ __forceinline__ float2 operator()(int p) const {
    const float w = __fmul_rn(gi, wf[p]);
    return make_float2(__fmul_rn(w, wf[P + p]), __fmul_rn(w, wf[2 * P + p]));
  }
};

__global__ void mask_terms_backward_kernel(
    const int* __restrict__ idx, const float* __restrict__ pix,
    const float* __restrict__ vert, const float* __restrict__ g_icp,
    const float* __restrict__ g_binary, const float* __restrict__ vvalid,
    float* __restrict__ dproj, int P, int M, float sx, float sy) {
  extern __shared__ unsigned s_key[];
  const int bv = blockIdx.x;
  float* row = dproj + (int64_t)bv * M * 2;
  sil::scatter::add_row(idx + (int64_t)bv * P,
                        Cotangent{pix + (int64_t)bv * 4 * P + P, P, g_icp[bv]},
                        row, 1, 2, P, M, s_key);
  __syncthreads();
  const float gb = __fmul_rn(g_binary[bv], vvalid[bv]);
  const float* e = vert + (int64_t)bv * 3 * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    row[2 * m] = __fadd_rn(row[2 * m], __fmul_rn(__fmul_rn(gb, e[M + m]), sx));
    row[2 * m + 1] =
        __fadd_rn(row[2 * m + 1], __fmul_rn(__fmul_rn(gb, e[2 * M + m]), sy));
  }
}

// The dynamic shared bytes of launch 2: both trees' rows (the wrapper
// keeps them within the 48 KB a block has without opting in).
int sums_smem(int P, int M) {
  return (half_of(P) + half_of(M)) * (int)sizeof(float);
}

// The forward's launch geometry: out = {blocks of launch 1 (the pixel
// blocks of every view, then the vertex blocks), threads, dynamic shared
// bytes, blocks of launch 2, its threads}.
void forward_geometry(int BV, int P, int M, int* out) {
  const int pix_blocks = (P + kPixPerBlock - 1) / kPixPerBlock;
  const int vert_blocks = (M + kVertsPerBlock - 1) / kVertsPerBlock;
  out[0] = (pix_blocks + vert_blocks) * BV;
  out[1] = kThreads;
  out[2] = sil::match::stage_bytes(M);
  out[3] = BV;
  out[4] = kSumThreads;
}

template <typename T>
int forward(const float* proj, const float* contour, const float* cvalid,
            const void* crop, const float* origin, const float* vvalid,
            float* sums, float* pix, float* vert, int* idx,
            int BV, int P, int M, int Hc, int Wc, int H, int W, float imsize,
            float epsilon, float sx, float sy, void* stream) {
  if (BV == 0) return 0;
  const int pix_blocks = (P + kPixPerBlock - 1) / kPixPerBlock;
  const int vert_blocks = (M + kVertsPerBlock - 1) / kVertsPerBlock;
  const cudaStream_t st = (cudaStream_t)stream;
  if (pix_blocks + vert_blocks > 0) {
    mask_terms_points_kernel<T>
        <<<(pix_blocks + vert_blocks) * BV, kThreads,
           sil::match::stage_bytes(M), st>>>(
            proj, contour, cvalid, static_cast<const T*>(crop), origin, pix,
            idx, vert, BV, P, M, Hc, Wc, H, W, pix_blocks, vert_blocks,
            imsize, epsilon, sx, sy);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  mask_terms_sums_kernel<<<BV, kSumThreads, sums_smem(P, M), st>>>(
      pix, vert, vvalid, sums, BV, P, M, half_of(P), half_of(M));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" void mask_terms_forward_geometry(int BV, int P, int M, int* out) {
  forward_geometry(BV, P, M, out);
}

extern "C" void mask_terms_backward_geometry(int BV, int P, int M, int* out) {
  out[0] = BV;
  sil::scatter::row_geometry(P, &out[1], &out[2]);
}

// sums [2, BV] (icp, binary), pix [BV, 4, P], vert [BV, 3, M], idx
// [BV, P]; the crop [BV, Hc, Wc] f32 (_f32)
// or a bit mask [BV, Hc, (Wc + 31) / 32] of 32-bit words (_b1), Wc in
// pixels; (H, W) the full image.
extern "C" int mask_terms_forward_f32(
    const float* proj, const float* contour, const float* cvalid,
    const void* crop, const float* origin, const float* vvalid, float* sums,
    float* pix, float* vert, int* idx, int BV, int P, int M,
    int Hc, int Wc, int H, int W, float imsize, float epsilon, float sx,
    float sy, void* stream) {
  return forward<float>(proj, contour, cvalid, crop, origin, vvalid, sums,
                        pix, vert, idx, BV, P, M, Hc, Wc, H, W,
                        imsize, epsilon, sx, sy, stream);
}

extern "C" int mask_terms_forward_b1(
    const float* proj, const float* contour, const float* cvalid,
    const void* crop, const float* origin, const float* vvalid, float* sums,
    float* pix, float* vert, int* idx, int BV, int P, int M,
    int Hc, int Wc, int H, int W, float imsize, float epsilon, float sx,
    float sy, void* stream) {
  return forward<uint32_t>(proj, contour, cvalid, crop, origin, vvalid, sums,
                           pix, vert, idx, BV, P, M, Hc, Wc, H, W,
                           imsize, epsilon, sx, sy, stream);
}

// dproj [BV, M, 2] from the forward's idx, pix and vert.
extern "C" int mask_terms_backward_f32(const int* idx, const float* pix,
                                       const float* vert, const float* g_icp,
                                       const float* g_binary,
                                       const float* vvalid, float* dproj,
                                       int BV, int P, int M, float sx,
                                       float sy, void* stream) {
  if (BV == 0 || M == 0) return 0;
  int threads, smem;
  sil::scatter::row_geometry(P, &threads, &smem);
  mask_terms_backward_kernel<<<BV, threads, smem, (cudaStream_t)stream>>>(
      idx, pix, vert, g_icp, g_binary, vvalid, dproj, P, M, sx, sy);
  return (int)cudaGetLastError();
}
