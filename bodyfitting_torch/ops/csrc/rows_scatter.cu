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
// batch row, one thread an entry.  The block zeroes the row's [2, M]
// output, then walks the row in chunks of blockDim entries (blockDim the
// power of two >= P, at most 1,024): it stages the chunk's g in shared
// memory, sorts the in-range entries by the 32-bit key (idx << 10 | p in
// the chunk; the wrapper keeps M below 2^22 - 1, so no key reaches the
// sentinel of dropped entries) with a bitonic network (shuffles for
// strides below 32, double-buffered shared memory above), and the first
// thread of each run of one idx adds the run's g in ascending p onto
// out[m]: g is gathered into sorted order and the run's end read from
// the warps' ballots of run starts, so the serial sum waits on no load.
// Chunks run in ascending p, each head reading back what the chunks
// before left, so the chunked sum is the sequential one.
// The TPU form (a one-hot contracted on the MXU) rounds g to bf16 on the
// chip; this kernel sums exact f32 values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 2;
constexpr int kPBits = 10;                 // a chunk's entry in the key
constexpr int kMaxThreads = 1 << kPBits;
constexpr unsigned kNoKey = 0xffffffffu;   // dropped entries sort last

__global__ void rows_scatter_add_kernel(const int* __restrict__ idx,
                                        const float* __restrict__ g,
                                        float* __restrict__ out, int P,
                                        int M) {
  extern __shared__ unsigned s_key[];                    // [2][n]
  const int n = blockDim.x;
  const int t = threadIdx.x;
  float2* s_g = reinterpret_cast<float2*>(s_key + 2 * n);  // [n] by p
  float2* s_gs = s_g + n;                                 // [n] sorted
  __shared__ unsigned s_start[kMaxThreads / 32 + 1];
  const int bv = blockIdx.x;
  const int* ix = idx + (int64_t)bv * P;
  const float* gg = g + (int64_t)bv * P * C;
  float* o0 = out + (int64_t)bv * C * M;
  float* o1 = o0 + M;

  for (int base = 0; base < P; base += n) {
    const int cnt = min(n, P - base);
    unsigned key = kNoKey;
    if (t < cnt) {
      const int m = ix[base + t];
      if (m >= 0 && m < M) key = ((unsigned)m << kPBits) | (unsigned)t;
      s_g[t] = make_float2(gg[(int64_t)(base + t) * C],
                           gg[(int64_t)(base + t) * C + 1]);
    }
    if (base == 0) {                // zero the row while the loads fly
      for (int i = t; i < C * M; i += n) o0[i] = 0.0f;
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
    // the head of each run adds the run, in ascending p, onto out[m]
    // (onto 0 in the first chunk, which the row was just zeroed to)
    if (head) {
      int w = t >> 5;
      unsigned later = s_start[w] & ~(0xffffffffu >> (31 - (t & 31)));
      while (later == 0u) later = s_start[++w];
      const int end = 32 * w + __ffs(later) - 1;
      float a0 = 0.0f, a1 = 0.0f;
      if (base > 0) {
        a0 = o0[m];
        a1 = o1[m];
      }
#pragma unroll 4
      for (int u = t; u < end; ++u) {
        const float2 v = s_gs[u];
        a0 = __fadd_rn(a0, v.x);
        a1 = __fadd_rn(a1, v.y);
      }
      o0[m] = a0;
      o1[m] = a1;
    }
    __syncthreads();                // the next chunk reuses the stage
  }
  if (P == 0)
    for (int i = t; i < C * M; i += n) o0[i] = 0.0f;
}

// The launch geometry for a [BV, P] -> [BV, 2, M] scatter: out = {blocks,
// threads, dynamic shared bytes}; a thread an entry of a chunk, the
// chunk the power of two >= P, at most 1,024 entries.
void geometry(int BV, int P, int* out) {
  int n = 32;
  while (n < P && n < kMaxThreads) n <<= 1;
  out[0] = BV;
  out[1] = n;
  out[2] = n * (int)(2 * sizeof(unsigned) + 2 * sizeof(float2));
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
