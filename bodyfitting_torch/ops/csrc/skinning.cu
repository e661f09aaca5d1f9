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
//   contract (the summation order): dA does not depend on the launch,
//   and no float atomics are used, so launches repeat bit for bit.
//
// Bound on the H100: instruction issue.  A (vertex, frame) costs 24 J + 18
// multiplies and adds in the forward and 42 J + 24 in the backward (T's 9
// rotation columns, dvp, M and its share of dA); with -fmad=false none
// fuse, so at B 128, V 10,475, J 55 the pair needs 1.79 G and 3.13 G
// instructions (53.6 and 93.5 us at 132 SMs x 128 lanes x 1.98 GHz)
// against ~15 MB of inputs.  At the fits' batch of 8 frames the work is a
// few microseconds of one wave, and a block's latency decides.  Design
// (the launch geometry is chosen here, by `geometry`, and reported by
// skin_geometry):
//   * A block takes TV vertices x FB frames.  One thread stages the W tile
//     [TV, J] (contiguous rows) and A[b0 : b0 + FB] with two bulk copies
//     on one mbarrier, so every staging load is in flight at once and each
//     W tile serves FB frames.  The W tile's last n J mod 4 floats (a bulk
//     copy moves whole 16-byte units) are copied by plain loads.
//   * A thread owns VR vertices of one frame, with their 12 (forward) or
//     9 (backward: only T's rotation part reaches dvp) accumulators in
//     registers, and reads A[b, j, :] as three 16-byte shared loads that
//     every lane of the warp shares.  The forward takes 64 vertices x 4
//     frames a block, 2 vertices a thread, at every size.
//   * The backward's block is one 128-vertex tile (the contract's) x FB
//     frames.  Its vertex threads write M = g (x) [vp, 1] [FB, 128, 12] to
//     shared memory and compute dvp; FB 12 / CW more warps each sum CW
//     columns of one frame's dA partial over the tile's vertices in order,
//     a lane owning joints lane and lane + 32: independent chains, no
//     atomics.  Small launches take the latency geometry, a frame a
//     block, a vertex a thread and 4 columns a warp (short chains over
//     many warps); from kWideFrames frames and kWidePairs (vertex, frame)
//     pairs on, the throughput geometry, 4 frames a block, 4 vertices a
//     thread and 12 columns a warp (fewer shared loads an instruction).
//     The tile's partials go to
//     `part`; the last block of a frame group to finish (elected by
//     __threadfence and an atomicAdd on the group's counter, which it
//     resets to 0) sums the group's partials in ascending tile order, read
//     through L2 with __ldcg.  The atomic elects who sums, never the order,
//     so dA is bitwise the same in every launch, in one launch a call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;     // vertices per tile (the dA summation unit)
constexpr int kMaxJ = 64;      // joints a model may have (SMPL-X: 55)
constexpr int kSumBatch = 16;  // tile partials a thread has in flight

// The forward's geometry: vertices a block, vertices a thread, frames a
// block (fewer when the launch has fewer).
constexpr int kFwdTV = 64, kFwdVR = 2, kFwdFB = 4;

// The backward's two geometries: frames a block, vertices a thread, dA
// columns a warp.  The throughput one is taken from kWideFrames frames
// and kWidePairs (vertex, frame) pairs on: on an H100 SXM,
// bench_skin_kernels.py --geometries found it the faster one there, and
// the latency one below, at all but two of its 32 shapes (4 to 512 frames
// of 564, 3,035 and 10,475 vertices, 55 joints), where the other lost by
// 1 and 6 %.  Neither B V nor B alone separates them.
struct BwdGeometry { int FB, VR, CW; };
constexpr BwdGeometry kBwdLatency = {1, 1, 4};
constexpr BwdGeometry kBwdThroughput = {4, 4, 12};
constexpr int kWideFrames = 32;
constexpr int64_t kWidePairs = 50000;

static_assert(4 * (kTile * kMaxJ + kBwdThroughput.FB * kMaxJ * 12 +
                   kBwdThroughput.FB * kTile * 12) <= 232448 - 16,
              "the backward's dynamic shared memory fits 227 KB");
// A thread owning VR vertices keeps VR x 12 accumulators: a block of at
// most 1024 / VR threads leaves it 64 VR registers (__launch_bounds__).

bool wide_geometry(int B, int V, int wide) {
  if (wide >= 0) return wide != 0;
  return B >= kWideFrames && (int64_t)B * V >= kWidePairs;
}

// The launch geometry of B frames of V vertices and J joints, out = {TV,
// FB, VR, CW, threads, blocks, dynamic shared bytes}: the forward's, or
// the backward's (wide -1: by size; 0 / 1: the latency / throughput one).
void geometry(int B, int V, int J, int backward, int wide, int* out) {
  int TV = kFwdTV, FB = kFwdFB, VR = kFwdVR, CW = 0;
  if (backward) {
    const BwdGeometry g =
        wide_geometry(B, V, wide) ? kBwdThroughput : kBwdLatency;
    TV = kTile; FB = g.FB; VR = g.VR; CW = g.CW;
  }
  FB = FB < B ? FB : (B > 0 ? B : 1);
  const int tiles = (V + TV - 1) / TV;
  out[0] = TV;
  out[1] = FB;
  out[2] = VR;
  out[3] = CW;
  out[4] = TV / VR * FB + (backward ? 32 * FB * 12 / CW : 0);
  out[5] = (backward && tiles == 0 ? 1 : tiles) * ((B + FB - 1) / FB);
  out[6] = 4 * (TV * J + FB * J * 12 + (backward ? FB * TV * 12 : 0));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 starts the copies of nw floats of W (from w, 16-byte aligned)
// into sW and na floats of A (a multiple of 4) into sA, both completing
// on `bar`; threads 1-3 copy the W tail that is not a whole 16 bytes.
__device__ void stage_begin(const float* __restrict__ w, int nw,
                            const float* __restrict__ a, int na, float* sW,
                            float* sA, uint64_t* bar) {
  const int nw4 = nw & ~3;
  if (threadIdx.x == 0) {
    const uint32_t b = smem_u32(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(b), "r"((nw4 + na) * 4) : "memory");
    if (nw4 > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_u32(sW)), "l"(w), "r"(nw4 * 4), "r"(b) : "memory");
    if (na > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(smem_u32(sA)), "l"(a), "r"(na * 4), "r"(b) : "memory");
  } else if (threadIdx.x <= nw - nw4) {
    sW[nw4 + threadIdx.x - 1] = w[nw4 + threadIdx.x - 1];
  }
}

// Every thread: after a __syncthreads (the barrier's init and the plain
// shared stores are then visible), wait for the bulk copies to land.
__device__ void stage_end(uint64_t* bar) {
  __syncthreads();
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(b), "r"(0) : "memory");
}

__device__ __forceinline__ void load12(const float* s, float* a) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const float4 x = s4[0], y = s4[1], z = s4[2];
  a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
  a[4] = y.x; a[5] = y.y; a[6] = y.z; a[7] = y.w;
  a[8] = z.x; a[9] = z.y; a[10] = z.z; a[11] = z.w;
}

// T[r][c] = sum over j ascending of w[r * stride + j] * sa[j * 12 + col],
// col = c (NC 12) or T's rotation column 4 (c / 3) + c % 3 (NC 9), each
// product and sum rounded.  With one vertex a thread (VR 1: the small
// launches, one block an SM, nothing else to hide the latency) the next
// j's shared loads are issued before this j's arithmetic; with more, the
// vertices' independent sums hide it, and the registers a prefetch takes
// would cost blocks an SM.
template <int VR, int NC>
__device__ __forceinline__ void blend(const float* sa, const float* w,
                                      int stride, int J, float (&T)[VR][NC]) {
#pragma unroll
  for (int r = 0; r < VR; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) T[r][c] = 0.0f;
  float a[12], wv[VR];
  if (VR == 1) {
    load12(sa, a);
    wv[0] = w[0];
  }
#pragma unroll 2
  for (int j = 0; j < J; ++j) {
    float ac[12], wc[VR];
    if (VR == 1) {
#pragma unroll
      for (int c = 0; c < 12; ++c) ac[c] = a[c];
      wc[0] = wv[0];
      const int jn = min(j + 1, J - 1);
      load12(sa + jn * 12, a);
      wv[0] = w[jn];
    } else {
      load12(sa + j * 12, ac);
#pragma unroll
      for (int r = 0; r < VR; ++r) wc[r] = w[r * stride + j];
    }
#pragma unroll
    for (int r = 0; r < VR; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        T[r][c] = __fadd_rn(
            T[r][c], __fmul_rn(wc[r], ac[NC == 12 ? c : 4 * (c / 3) + c % 3]));
  }
}

// Grid (ceil(V / kFwdTV), ceil(B / FB)); (kFwdTV / kFwdVR) FB threads;
// dynamic shared (kFwdTV J + FB J 12) floats: sW [kFwdTV, J], then sA
// [FB, J, 12].
__global__ void __launch_bounds__(1024 / kFwdVR)
skin_fwd_kernel(const float* __restrict__ W, const float* __restrict__ A,
                const float* __restrict__ vp, float* __restrict__ out,
                int B, int V, int J, int FB) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  float* sW = smem;
  float* sA = smem + kFwdTV * J;
  const int v0 = blockIdx.x * kFwdTV, b0 = blockIdx.y * FB;
  const int n = min(kFwdTV, V - v0), nf = min(FB, B - b0);
  stage_begin(W + (int64_t)v0 * J, n * J, A + (int64_t)b0 * J * 12,
              nf * J * 12, sW, sA, &bar);
  constexpr int tpf = kFwdTV / kFwdVR;         // threads a frame
  const int fr = threadIdx.x / tpf, tl = threadIdx.x - fr * tpf;
  const bool live = fr < nf;
  const int64_t o = ((int64_t)(b0 + fr) * V + v0) * 3;
  float p[kFwdVR][3];
#pragma unroll
  for (int r = 0; r < kFwdVR; ++r) {
    const int v = tl + r * tpf;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p[r][k] = (live && v < n) ? vp[o + v * 3 + k] : 0.0f;
  }
  stage_end(&bar);
  if (!live) return;
  float T[kFwdVR][12];
  blend(sA + fr * J * 12, sW + tl * J, tpf * J, J, T);
#pragma unroll
  for (int r = 0; r < kFwdVR; ++r) {
    const int v = tl + r * tpf;
    if (v >= n) continue;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float acc = T[r][4 * q + 3];
      acc = __fadd_rn(acc, __fmul_rn(T[r][4 * q + 0], p[r][0]));
      acc = __fadd_rn(acc, __fmul_rn(T[r][4 * q + 1], p[r][1]));
      acc = __fadd_rn(acc, __fmul_rn(T[r][4 * q + 2], p[r][2]));
      out[o + v * 3 + q] = acc;
    }
  }
}

// Grid (tiles, ceil(B / FB)); (kTile / VR) FB + 32 FB 12 / CW threads;
// dynamic shared (kTile J + FB J 12 + FB kTile 12) floats: sW, sA, then
// sM [FB, kTile, 12].  part [B, tiles, J, 12] holds the tile partials;
// cnt[blockIdx.y] counts the group's finished tiles and is 0 before and
// after a launch.  A dA task is (frame, CW columns): its warp's lane
// owns joints lane and lane + 32; the tasks go to the block's warps from
// the last one down, so warps with no vertices of their own start on
// them at once.
template <int VR, int CW>
__global__ void __launch_bounds__(1024 / VR)
skin_bwd_kernel(const float* __restrict__ W, const float* __restrict__ A,
                const float* __restrict__ vp, const float* __restrict__ g,
                float* __restrict__ dvp, float* __restrict__ dA,
                float* __restrict__ part, int* __restrict__ cnt, int B,
                int V, int J, int FB, int tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ int last;
  float* sW = smem;
  float* sA = sW + kTile * J;
  float* sM = sA + FB * J * 12;
  const int tile = blockIdx.x, v0 = tile * kTile, b0 = blockIdx.y * FB;
  const int n = max(0, min(kTile, V - v0)), nf = min(FB, B - b0);
  stage_begin(W + (int64_t)v0 * J, n * J, A + (int64_t)b0 * J * 12,
              nf * J * 12, sW, sA, &bar);
  // Roles by a warp number rotated by half the warps in odd tiles, so that
  // the vertex warps and the dA warps of an SM's blocks share its four
  // schedulers evenly.
  const int nw = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int warp = ((threadIdx.x >> 5) + (blockIdx.x & 1) * (nw >> 1)) % nw;
  constexpr int tpf = kTile / VR;
  const int fr = (warp * 32 + lane) / tpf;
  const int tl = warp * 32 + lane - fr * tpf;
  const bool live = fr < nf;
  const int64_t o = ((int64_t)(b0 + fr) * V + v0) * 3;
  float gr[VR][3];
#pragma unroll
  for (int r = 0; r < VR; ++r) {
    const int v = tl + r * tpf;
    const bool ok = live && v < n;
    float pk[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pk[k] = ok ? vp[o + v * 3 + k] : 0.0f;
      gr[r][k] = ok ? g[o + v * 3 + k] : 0.0f;
    }
    if (ok) {
      float4* m = reinterpret_cast<float4*>(sM + (fr * kTile + v) * 12);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        m[q] = make_float4(__fmul_rn(gr[r][q], pk[0]),
                           __fmul_rn(gr[r][q], pk[1]),
                           __fmul_rn(gr[r][q], pk[2]), gr[r][q]);
    }
  }
  stage_end(&bar);
  if (live) {
    float T[VR][9];
    blend(sA + fr * J * 12, sW + tl * J, tpf * J, J, T);
#pragma unroll
    for (int r = 0; r < VR; ++r) {
      const int v = tl + r * tpf;
      if (v >= n) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float acc = __fmul_rn(T[r][k], gr[r][0]);
        acc = __fadd_rn(acc, __fmul_rn(T[r][3 + k], gr[r][1]));
        acc = __fadd_rn(acc, __fmul_rn(T[r][6 + k], gr[r][2]));
        dvp[o + v * 3 + k] = acc;
      }
    }
  }
  // The tile's dA partials, each a chain over the tile's vertices in order.
  constexpr int groups = 12 / CW;
  const int E = J * 12, ntask = nf * groups;
  for (int k = nw - 1 - warp; k < ntask; k += nw) {
    const int f = k / groups, c0 = (k - f * groups) * CW;
    float acc[2][CW];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[q][c] = 0.0f;
    const float* m = sM + f * kTile * 12 + c0;
    const float* wr = sW + lane;
#pragma unroll 4
    for (int i = 0; i < n; ++i, wr += J, m += 12) {
      const float wi[2] = {wr[0], wr[32]};      // past J: read, unused
      float mv[CW];
#pragma unroll
      for (int q = 0; q < CW / 4; ++q) {
        const float4 x = reinterpret_cast<const float4*>(m)[q];
        mv[4 * q] = x.x; mv[4 * q + 1] = x.y;
        mv[4 * q + 2] = x.z; mv[4 * q + 3] = x.w;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int c = 0; c < CW; ++c)
          acc[q][c] = __fadd_rn(acc[q][c], __fmul_rn(wi[q], mv[c]));
    }
    float* pb = part + ((int64_t)(b0 + f) * tiles + tile) * E + c0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = lane + 32 * q;
      if (j >= J) continue;
      float4* pp = reinterpret_cast<float4*>(pb + j * 12);
#pragma unroll
      for (int c = 0; c < CW / 4; ++c)
        pp[c] = make_float4(acc[q][4 * c], acc[q][4 * c + 1],
                            acc[q][4 * c + 2], acc[q][4 * c + 3]);
    }
  }
  // The last block of the group to finish sums its partials over tiles.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(cnt + blockIdx.y, 1) == tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int E4 = E / 4;
  for (int e = threadIdx.x; e < nf * E4; e += blockDim.x) {
    const int f = e / E4, q = e - f * E4;
    const float4* pp =
        reinterpret_cast<const float4*>(part + (int64_t)(b0 + f) * tiles * E) + q;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int s = 0;
    for (; s + kSumBatch <= tiles; s += kSumBatch) {
      float4 x[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u)
        x[u] = __ldcg(pp + (int64_t)(s + u) * E4);
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        acc.x = __fadd_rn(acc.x, x[u].x);
        acc.y = __fadd_rn(acc.y, x[u].y);
        acc.z = __fadd_rn(acc.z, x[u].z);
        acc.w = __fadd_rn(acc.w, x[u].w);
      }
    }
    for (; s < tiles; ++s) {
      const float4 x = __ldcg(pp + (int64_t)s * E4);
      acc.x = __fadd_rn(acc.x, x.x);
      acc.y = __fadd_rn(acc.y, x.y);
      acc.z = __fadd_rn(acc.z, x.z);
      acc.w = __fadd_rn(acc.w, x.w);
    }
    reinterpret_cast<float4*>(dA + (int64_t)(b0 + f) * E)[q] = acc;
  }
  if (threadIdx.x == 0) cnt[blockIdx.y] = 0;
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <typename K>
int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int VR, int CW>
int launch_bwd(const float* W, const float* A, const float* vp,
               const float* g, float* dvp, float* dA, float* part, int* cnt,
               int B, int V, int J, const int* geo, cudaStream_t s) {
  const int tiles = V > 0 ? (V + kTile - 1) / kTile : 1, FB = geo[1];
  const int err = allow_smem(skin_bwd_kernel<VR, CW>, geo[6]);
  if (err) return err;
  skin_bwd_kernel<VR, CW><<<dim3(tiles, (B + FB - 1) / FB), geo[4], geo[6],
                            s>>>(W, A, vp, g, dvp, dA, part, cnt, B, V, J, FB,
                                 tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// out = {TV, FB, VR, CW, threads, blocks, dynamic shared bytes} of the
// forward (backward 0) or the backward (1; wide as skin_bwd_f32 takes it).
extern "C" void skin_geometry(int B, int V, int J, int backward, int wide,
                              int* out) {
  geometry(B, V, J, backward, wide, out);
}

extern "C" int skin_fwd_f32(const float* W, const float* A, const float* vp,
                            float* out, int B, int V, int J, void* stream) {
  if (J > kMaxJ || J <= 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0) return 0;
  int geo[7];
  geometry(B, V, J, 0, -1, geo);
  const int err = allow_smem(skin_fwd_kernel, geo[6]);
  if (err) return err;
  const int FB = geo[1];
  skin_fwd_kernel<<<dim3((V + kFwdTV - 1) / kFwdTV, (B + FB - 1) / FB),
                    geo[4], geo[6], (cudaStream_t)stream>>>(W, A, vp, out, B,
                                                            V, J, FB);
  return (int)cudaGetLastError();
}

// wide: -1 the geometry by size (what the wrapper asks for), 0 / 1 the
// latency / throughput one.  part: scratch of B * max(1, ceil(V / 128))
// * J * 12 floats; cnt: B ints (ceil(B / FB) are used), all 0 (the launch
// leaves them 0).
extern "C" int skin_bwd_f32(const float* W, const float* A, const float* vp,
                            const float* g, float* dvp, float* dA, float* part,
                            int* cnt, int B, int V, int J, int wide,
                            void* stream) {
  if (J > kMaxJ || J <= 0 || wide < -1 || wide > 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int geo[7];
  geometry(B, V, J, 1, wide, geo);
  cudaStream_t s = (cudaStream_t)stream;
  if (wide_geometry(B, V, wide))
    return launch_bwd<kBwdThroughput.VR, kBwdThroughput.CW>(
        W, A, vp, g, dvp, dA, part, cnt, B, V, J, geo, s);
  return launch_bwd<kBwdLatency.VR, kBwdLatency.CW>(
      W, A, vp, g, dvp, dA, part, cnt, B, V, J, geo, s);
}
