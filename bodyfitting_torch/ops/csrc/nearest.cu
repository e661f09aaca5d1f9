// Nearest point-on-mesh query: minimum point-triangle squared distance and
// the winning face, under the implementation-independent tie rule.
//
// Replaces the TPU kernel nearest_d2_idx (bodyfitting_tpu/ops/
// pallas_kernels.py:231): its min pass _nearest_kernel (:49, through
// _nearest_block :79 and _block_dist2 :92) and its tie pass
// _nearest_tie_kernel (:161).
//
// Contract, for points [Q, 3] and triangles [F, 3, 3] (f32, contiguous):
//   d2[q]  = min over faces f of dist2(q, f), an exact minimum: NaN
//            distances never win, +inf when no face gives a number;
//   idx[q] = the lowest face index f with dist2(q, f) <= thr[q], where
//            thr = d2 + (32 eps) (d2 + diag2), eps = 2^-23 and diag2 the
//            squared diagonal of the caller's vertex bounding box
//            (ops.nearest.tie_threshold); 0 when no face qualifies.
// dist2 is _block_dist2's arithmetic in its order: the six dots, va/vb/vc,
// the clamped safe_div with its 1e-30 floor, the Voronoi regions with the
// highest priority first.  Only the winning region's candidate point is
// computed; it is the same sequence of operations that the plain version
// computes for every region and then selects, so the values are bitwise
// equal.  Every multiply, add and divide is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, and the file is built
// with -fmad=false), so d2 equals the plain PyTorch version's bit for bit
// and idx exactly.
//
// Culling.  The wrapper (ops/kernels/nearest.py) sorts the queries and the
// faces by the Morton code of their position (queries) and centroid
// (faces), and gives each block of kBlockFaces consecutive sorted faces
// its bounding box.  One warp takes kWarpQueries consecutive sorted
// queries, kLanesPerQuery lanes each (a lane evaluates every
// kLanesPerQuery-th face of a block; the lanes of a query meet through
// shuffles), and sweeps the face blocks, starting at the block where its
// first query's code falls in the face order (the nearby surface, so the
// running minimum is small early) and wrapping around.  A face block is
// evaluated only if its box can hold a face within a query's limit: first
// the box against the warp's query box (32 blocks at a time, one per
// lane), then each query's point against the box.  Pass 1 (the minimum)
// limits by the running minimum, pass 2 (the tie band) by the band's
// threshold, and pass 2 takes the lowest ORIGINAL face index in the band,
// so the sort and the lanes' split change no result, only the work.
// Eight queries a warp keep the warp's box tight and put four times as
// many warps on the card as one query a lane would: at a few thousand
// queries the sweep is latency-bound.
//
// The cull is conservative under rounding.  Every candidate point the
// distance takes is a convex combination of the triangle's corners up to a
// few roundings (the interior weights are non-negative and sum to at most
// 1, the edge parameters are clamped to [0, 1]), so it lies in the face's
// box up to ~10 eps of the largest coordinate magnitude.  A box is skipped
// only when its squared distance, less kCull of itself, exceeds the limit
// plus kCull (limit + scale2), scale2 = 3 max|coordinate|^2; that slack is
// several times the rounding of both distances.  NaN anywhere (a
// coordinate, a box, scale2) makes a comparison false, and nothing is
// skipped.  Non-finite boxes take fmaxf's NaN-dropping form, which only
// lowers their distance.
//
// Bound on the H100: bytes (a few MB in and out) once the cull leaves tens
// of pairs a query; the box sweep itself is F / kBlockFaces box tests per
// warp and pass.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;          // two warps, each its own queries
constexpr int kLanesPerQuery = 4;
constexpr int kWarpQueries = 32 / kLanesPerQuery;
constexpr int kBlockFaces = 32;       // faces per bounding box
constexpr int kBigIdx = 1 << 30;      // "no face yet" (the TPU kernel's)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1.1920928955078125e-07f;
constexpr float kTieEps32 = 32.0f * kEps;  // the tie band, 32 eps
constexpr float kCull = 64.0f * kEps;      // the cull's rounding slack

struct Face {
  float ax, ay, az, bx, by, bz, cx, cy, cz;
  float abx, aby, abz, acx, acy, acz, cbx, cby, cbz;
};

__device__ __forceinline__ float dot3(float x0, float y0, float z0, float x1,
                                      float y1, float z1) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, x1), __fmul_rn(y0, y1)),
                   __fmul_rn(z0, z1));
}

__device__ __forceinline__ float safe_div(float num, float den) {
  return __fdiv_rn(num, fabsf(den) > 1e-30f ? den : 1e-30f);
}

// jnp.clip(x, 0, 1): NaN stays NaN, as in torch.clamp
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// Squared distance from p to the closest point of one triangle; the one
// function both passes call, so they read bit-identical distances.
__device__ __forceinline__ float tri_dist2(float px, float py, float pz,
                                           const Face& f) {
  const float apx = __fsub_rn(px, f.ax), apy = __fsub_rn(py, f.ay),
              apz = __fsub_rn(pz, f.az);
  const float d1 = dot3(f.abx, f.aby, f.abz, apx, apy, apz);
  const float d2 = dot3(f.acx, f.acy, f.acz, apx, apy, apz);
  const float bpx = __fsub_rn(px, f.bx), bpy = __fsub_rn(py, f.by),
              bpz = __fsub_rn(pz, f.bz);
  const float d3 = dot3(f.abx, f.aby, f.abz, bpx, bpy, bpz);
  const float d4 = dot3(f.acx, f.acy, f.acz, bpx, bpy, bpz);
  const float cpx = __fsub_rn(px, f.cx), cpy = __fsub_rn(py, f.cy),
              cpz = __fsub_rn(pz, f.cz);
  const float d5 = dot3(f.abx, f.aby, f.abz, cpx, cpy, cpz);
  const float d6 = dot3(f.acx, f.acy, f.acz, cpx, cpy, cpz);

  const float va = __fsub_rn(__fmul_rn(d3, d6), __fmul_rn(d5, d4));
  const float vb = __fsub_rn(__fmul_rn(d5, d2), __fmul_rn(d1, d6));
  const float vc = __fsub_rn(__fmul_rn(d1, d4), __fmul_rn(d3, d2));
  const float d43 = __fsub_rn(d4, d3);
  const float d56 = __fsub_rn(d5, d6);

  float ox, oy, oz;
  if (d1 <= 0.0f && d2 <= 0.0f) {                      // vertex a
    ox = f.ax; oy = f.ay; oz = f.az;
  } else if (d3 >= 0.0f && d4 <= d3) {                 // vertex b
    ox = f.bx; oy = f.by; oz = f.bz;
  } else if (d6 >= 0.0f && d5 <= d6) {                 // vertex c
    ox = f.cx; oy = f.cy; oz = f.cz;
  } else if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {  // edge ab
    const float t = clip01(safe_div(d1, __fsub_rn(d1, d3)));
    ox = __fadd_rn(f.ax, __fmul_rn(t, f.abx));
    oy = __fadd_rn(f.ay, __fmul_rn(t, f.aby));
    oz = __fadd_rn(f.az, __fmul_rn(t, f.abz));
  } else if (vb <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {  // edge ac
    const float t = clip01(safe_div(d2, __fsub_rn(d2, d6)));
    ox = __fadd_rn(f.ax, __fmul_rn(t, f.acx));
    oy = __fadd_rn(f.ay, __fmul_rn(t, f.acy));
    oz = __fadd_rn(f.az, __fmul_rn(t, f.acz));
  } else if (va <= 0.0f && d43 >= 0.0f && d56 >= 0.0f) {  // edge bc
    const float t = clip01(safe_div(d43, __fadd_rn(d43, d56)));
    ox = __fadd_rn(f.bx, __fmul_rn(t, f.cbx));
    oy = __fadd_rn(f.by, __fmul_rn(t, f.cby));
    oz = __fadd_rn(f.bz, __fmul_rn(t, f.cbz));
  } else {                                             // interior
    const float denom = safe_div(1.0f, __fadd_rn(__fadd_rn(va, vb), vc));
    const float v = __fmul_rn(vb, denom);
    const float w = __fmul_rn(vc, denom);
    ox = __fadd_rn(__fadd_rn(f.ax, __fmul_rn(f.abx, v)), __fmul_rn(f.acx, w));
    oy = __fadd_rn(__fadd_rn(f.ay, __fmul_rn(f.aby, v)), __fmul_rn(f.acy, w));
    oz = __fadd_rn(__fadd_rn(f.az, __fmul_rn(f.abz, v)), __fmul_rn(f.acz, w));
  }
  const float dx = __fsub_rn(px, ox), dy = __fsub_rn(py, oy),
              dz = __fsub_rn(pz, oz);
  return dot3(dx, dy, dz, dx, dy, dz);
}

// Face j of the sorted triangles; every lane reads the same address.
__device__ __forceinline__ Face load_face(const float* __restrict__ tri,
                                          int j) {
  const float* t = tri + (int64_t)j * 9;
  Face f;
  f.ax = __ldg(t + 0); f.ay = __ldg(t + 1); f.az = __ldg(t + 2);
  f.bx = __ldg(t + 3); f.by = __ldg(t + 4); f.bz = __ldg(t + 5);
  f.cx = __ldg(t + 6); f.cy = __ldg(t + 7); f.cz = __ldg(t + 8);
  f.abx = __fsub_rn(f.bx, f.ax); f.aby = __fsub_rn(f.by, f.ay);
  f.abz = __fsub_rn(f.bz, f.az);
  f.acx = __fsub_rn(f.cx, f.ax); f.acy = __fsub_rn(f.cy, f.ay);
  f.acz = __fsub_rn(f.cz, f.az);
  f.cbx = __fsub_rn(f.cx, f.bx); f.cby = __fsub_rn(f.cy, f.by);
  f.cbz = __fsub_rn(f.cz, f.bz);
  return f;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// min over the kLanesPerQuery lanes of one query (NaN never wins)
__device__ __forceinline__ float query_min(float v) {
  for (int o = kLanesPerQuery / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int query_min(int v) {
  for (int o = kLanesPerQuery / 2; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Squared distance between the box [lo, hi] and the box b = (lo xyz, hi
// xyz); a point is a box with lo == hi.
__device__ __forceinline__ float box_d2(float lx, float ly, float lz, float hx,
                                        float hy, float hz,
                                        const float* __restrict__ b) {
  const float ex = fmaxf(fmaxf(__ldg(b + 0) - hx, lx - __ldg(b + 3)), 0.0f);
  const float ey = fmaxf(fmaxf(__ldg(b + 1) - hy, ly - __ldg(b + 4)), 0.0f);
  const float ez = fmaxf(fmaxf(__ldg(b + 2) - hz, lz - __ldg(b + 5)), 0.0f);
  return ex * ex + ey * ey + ez * ez;
}

// The squared distance beyond which no face counts for a lane whose
// limit is x (its running minimum, or its tie threshold).
__device__ __forceinline__ float cull_limit(float x, float scale2) {
  return x + kCull * (x + scale2);
}

__device__ __forceinline__ bool beyond(float box2, float limit) {
  return box2 - kCull * box2 > limit;   // false for NaN: never skip
}

struct Warp {
  float px, py, pz;                    // this lane's query
  bool live;
  int sub;                             // the lane's share of each block
  float lx, ly, lz, hx, hy, hz;        // the warp's query box
  int s0;                              // first face block of the sweep
};

// One sweep over the face blocks.  kTie false: lower `best` to the
// query's minimum (the lane's share, then the query's lanes together).
// kTie true: lower `low` to the least original index of a face of the
// lane's share with d2 <= thr.
template <bool kTie>
__device__ __forceinline__ void sweep(const Warp& w,
                                      const float* __restrict__ tri,
                                      const int* __restrict__ fperm,
                                      const float* __restrict__ box,
                                      float scale2, int F, int NB,
                                      float& best, float thr, int& low) {
  const int lane = threadIdx.x & 31;
  float lane_limit = cull_limit(kTie ? thr : best, scale2);
  float warp_limit = warp_max(w.live ? lane_limit : -CUDART_INF_F);
  for (int base = 0; base < NB; base += 32) {
    const int k = base + lane;
    int b = w.s0 + k;
    if (b >= NB) b -= NB;
    const bool cand =
        k < NB && !beyond(box_d2(w.lx, w.ly, w.lz, w.hx, w.hy, w.hz,
                                 box + (int64_t)b * 6),
                          warp_limit);
    unsigned m = __ballot_sync(kFull, cand);
    while (m) {
      const int t = __ffs(m) - 1;
      m &= m - 1;
      int bb = w.s0 + base + t;
      if (bb >= NB) bb -= NB;
      const bool need =
          w.live && !beyond(box_d2(w.px, w.py, w.pz, w.px, w.py, w.pz,
                                   box + (int64_t)bb * 6),
                            lane_limit);
      if (!__any_sync(kFull, need)) continue;
      const int f1 = min(F, (bb + 1) * kBlockFaces);
      for (int j = bb * kBlockFaces + w.sub; j < f1; j += kLanesPerQuery) {
        const float d = tri_dist2(w.px, w.py, w.pz, load_face(tri, j));
        if (kTie) {
          if (d <= thr) low = min(low, __ldg(fperm + j));
        } else if (d < best) {
          best = d;
        }
      }
      if (!kTie) {
        best = query_min(best);
        lane_limit = cull_limit(best, scale2);
        warp_limit = warp_max(w.live ? lane_limit : -CUDART_INF_F);
      }
    }
  }
}

// One warp per kWarpQueries consecutive sorted queries: pass 1 (the
// minimum), then pass 2 (the tie band), both over the culled face blocks.
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const float* __restrict__ pts, const int* __restrict__ qperm,
               const float* __restrict__ tri, const int* __restrict__ fperm,
               const float* __restrict__ box, const int* __restrict__ seed,
               const float* __restrict__ consts, float* __restrict__ d2_out,
               int* __restrict__ idx_out, int Q, int F, int NB) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (warp * kWarpQueries >= Q) return;                // warp-uniform
  const int i = warp * kWarpQueries + lane / kLanesPerQuery;
  Warp w;
  w.live = i < Q;
  w.sub = lane % kLanesPerQuery;
  const int q = w.live ? __ldg(qperm + i) : 0;
  w.px = w.live ? __ldg(pts + (int64_t)q * 3 + 0) : 0.0f;
  w.py = w.live ? __ldg(pts + (int64_t)q * 3 + 1) : 0.0f;
  w.pz = w.live ? __ldg(pts + (int64_t)q * 3 + 2) : 0.0f;
  // the warp's query box; NaN coordinates drop out of fminf / fmaxf, and
  // such a lane's own box test never skips
  const float inf = CUDART_INF_F;
  w.lx = warp_min(w.live ? w.px : inf);
  w.ly = warp_min(w.live ? w.py : inf);
  w.lz = warp_min(w.live ? w.pz : inf);
  w.hx = warp_max(w.live ? w.px : -inf);
  w.hy = warp_max(w.live ? w.py : -inf);
  w.hz = warp_max(w.live ? w.pz : -inf);
  w.s0 = __ldg(seed + warp);
  const float diag2 = __ldg(consts + 0), scale2 = __ldg(consts + 1);

  float best = inf;
  int low = kBigIdx;
  sweep<false>(w, tri, fperm, box, scale2, F, NB, best, 0.0f, low);
  const float thr = __fadd_rn(best, __fmul_rn(kTieEps32,
                                              __fadd_rn(best, diag2)));
  sweep<true>(w, tri, fperm, box, scale2, F, NB, best, thr, low);
  low = query_min(low);
  if (w.live && w.sub == 0) {
    d2_out[q] = best;
    idx_out[q] = low == kBigIdx ? 0 : low;
  }
}

__global__ void empty_mesh_kernel(float* __restrict__ d2,
                                  int* __restrict__ idx, int Q) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < Q) {
    d2[q] = CUDART_INF_F;
    idx[q] = 0;
  }
}

}  // namespace

// Inputs from the wrapper: pts [Q, 3] in the caller's order; qperm [Q] the
// queries' Morton order; tri [F, 3, 3] the faces in Morton order and
// fperm [F] their original indices; box [NB, 6] each block of kBlockFaces
// sorted faces' lo xyz, hi xyz (NB = ceil(F / kBlockFaces)); seed
// [ceil(Q / kWarpQueries)] each warp's first face block; consts = (diag2,
// scale2).
// d2 [Q] f32 and idx [Q] int32 out, in the caller's order.  One launch.
extern "C" int nearest_d2_idx_f32(const float* pts, const int* qperm,
                                  const float* tri, const int* fperm,
                                  const float* box, const int* seed,
                                  const float* consts, float* d2, int* idx,
                                  int Q, int F, int NB, void* stream) {
  if (Q == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (F == 0) {
    empty_mesh_kernel<<<(Q + 127) / 128, 128, 0, s>>>(d2, idx, Q);
    return (int)cudaGetLastError();
  }
  const int warps = (Q + kWarpQueries - 1) / kWarpQueries;
  const int blocks = (warps * 32 + kThreads - 1) / kThreads;
  nearest_kernel<<<blocks, kThreads, 0, s>>>(pts, qperm, tri, fperm, box,
                                             seed, consts, d2, idx, Q, F, NB);
  return (int)cudaGetLastError();
}
