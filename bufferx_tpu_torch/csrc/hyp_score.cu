// K6: every rigid hypothesis scored against every correspondence of its
// pair, for RANSAC and the cross-scale consensus.
//
// Replaces no Pallas kernel: the JAX package scores in jnp
// (bufferx_tpu/solver/ransac.py, solver/consensus.py), which XLA fuses on
// the TPU. PyTorch ran it as an eager chunk loop (kernels/hyp_score.py:
// hyp_score_plain): per chunk of hypotheses a [B, chunk, C, 3] tensor of
// warped points through a GEMM, then the add, subtract, norm, compare, mask
// and sum, each a full pass over it. This kernel keeps the warped points in
// registers and writes only the counts:
//   counts[b, h] = #{c : mask[b, c] and ||R[b,h] s[b,c] + t[b,h] - g[b,c]||
//                  < thr}       where gate[b, h], else -1
// with thr a scalar (RANSAC) or one a correspondence (the consensus).
//
// Bits: the counts equal the eager chain's. Each step rounds where the eager
// chain rounds, with explicit intrinsics so that nothing is contracted:
//   w_i = fma(R_i2, s_z, fma(R_i1, s_y, R_i0 * s_x))   (cuBLAS's K = 3 dot)
//   d_i = (w_i + t_i) - g_i
//   q   = (d_x * d_x + d_y * d_y) + d_z * d_z           (the norm's sum)
//   d   = sqrt_rn(q) < thr
// The compare skips the square root exactly: sqrt_rn is monotone, so for
// every q, sqrt_rn(q) < thr holds iff q < L(thr), L the least float whose
// root reaches thr (below_limit). dist, when given (a probe, not the
// serving path), receives sqrt_rn(q) for every scored (h, c), so that the
// order above can be held to the eager chain's distances on the card.
//
// What bounds it: f32 operations. A scored (hypothesis, correspondence)
// costs 22 issued instructions (9 for the rotation, 6 for the translation
// and the difference, 5 for the squared norm, a compare and an add) and no
// bytes: the inputs are read once. Design:
// * a block takes 256 hypotheses of one pair; the gated-in ones are
//   compacted in shared memory (RANSAC's edge and distance checks reject
//   most minimal sets) and each thread keeps two of them, R and t, in
//   registers with their counts;
// * the pair's masked correspondences stream through shared memory in
//   tiles of 256, compacted as they are staged and packed as two float4
//   (s, L) and (g, c); every thread reads the same entry, a broadcast;
// * the grid is pairs x hypothesis tiles x splits of C; the caller picks the
//   split from the shapes so that small calls still fill the card. Partial
//   counts are integers: with more than one split they meet by atomic adds
//   into counts zeroed beforehand, exact in any order.

#include "common.cuh"

#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 2;
constexpr int kHypTile = kThreads * kPerThread;
constexpr int kCorrTile = 256;

// The least float L with sqrt_rn(L) >= thr: for every float q (q >= 0 or
// NaN, as a sum of squares is), sqrt_rn(q) < thr iff q < L. NaN stays NaN
// (nothing compares below it) and thr <= 0 gives 0 (no root is below it).
__device__ float below_limit(float thr) {
  if (!(thr > 0.f)) return thr != thr ? thr : 0.f;
  float q = __fmul_rn(thr, thr);
  while (q > 0.f && __fsqrt_rn(nextafterf(q, 0.f)) >= thr)
    q = nextafterf(q, 0.f);
  while (__fsqrt_rn(q) < thr) q = nextafterf(q, CUDART_INF_F);
  return q;
}

struct Hyp {
  float r[9];
  float t[3];
};

__device__ __forceinline__ float sqdist(const Hyp& h, const float4& s,
                                        const float4& g) {
  const float wx = __fmaf_rn(h.r[2], s.z,
                             __fmaf_rn(h.r[1], s.y, __fmul_rn(h.r[0], s.x)));
  const float wy = __fmaf_rn(h.r[5], s.z,
                             __fmaf_rn(h.r[4], s.y, __fmul_rn(h.r[3], s.x)));
  const float wz = __fmaf_rn(h.r[8], s.z,
                             __fmaf_rn(h.r[7], s.y, __fmul_rn(h.r[6], s.x)));
  return bx_sqdist(__fsub_rn(__fadd_rn(wx, h.t[0]), g.x),
                   __fsub_rn(__fadd_rn(wy, h.t[1]), g.y),
                   __fsub_rn(__fadd_rn(wz, h.t[2]), g.z));
}

__device__ __forceinline__ void load_hyp(Hyp& h, const float* R,
                                         const float* t, int64_t i) {
#pragma unroll
  for (int k = 0; k < 9; ++k) h.r[k] = R[i * 9 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) h.t[k] = t[i * 3 + k];
}

template <bool kDist>
__global__ void __launch_bounds__(kThreads)
hyp_score_kernel(const float* __restrict__ R, const float* __restrict__ t,
                 const float* __restrict__ src, const float* __restrict__ tgt,
                 const float* __restrict__ thr, float thr_all,
                 const uint8_t* __restrict__ mask,
                 const uint8_t* __restrict__ gate, long long* counts,
                 float* dist, int n_hyp, int n_corr, int per_split,
                 int splits) {
  __shared__ float4 s_pt[kCorrTile];    // (s, L)
  __shared__ float4 s_gc[kCorrTile];    // (g, c)
  __shared__ int s_hyp[kHypTile];
  __shared__ int s_nh;
  __shared__ int s_nc[2];

  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int64_t row = static_cast<int64_t>(b) * n_hyp;
  const int64_t crow = static_cast<int64_t>(b) * n_corr;
  const int h_begin = blockIdx.x * kHypTile;
  const int c_begin = split * per_split;
  const int c_end = min(n_corr, c_begin + per_split);

  if (threadIdx.x == 0) {
    s_nh = 0;
    s_nc[0] = s_nc[1] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kHypTile; i += kThreads) {
    const int h = h_begin + i;
    if (h >= n_hyp) break;
    if (gate[row + h])
      s_hyp[atomicAdd(&s_nh, 1)] = h;
    else if (split == 0)
      counts[row + h] = -1;
  }
  __syncthreads();
  const int nh = s_nh;
  if (nh == 0) return;

  const int j = kPerThread * threadIdx.x;
  const bool has0 = j < nh, has1 = j + 1 < nh;
  const int h0 = has0 ? s_hyp[j] : 0;
  const int h1 = has1 ? s_hyp[j + 1] : h0;
  Hyp a, c;
  load_hyp(a, R, t, row + h0);
  load_hyp(c, R, t, row + h1);
  const float lim_all = thr == nullptr ? below_limit(thr_all) : 0.f;
  int n0 = 0, n1 = 0;

  for (int tile = 0, c0 = c_begin; c0 < c_end; ++tile, c0 += kCorrTile) {
    int* nc_here = &s_nc[tile & 1];
    for (int i = threadIdx.x; i < kCorrTile; i += kThreads) {
      const int cc = c0 + i;
      if (cc >= c_end || !mask[crow + cc]) continue;
      const float lim = thr == nullptr ? lim_all : below_limit(thr[crow + cc]);
      if (!kDist && !(lim > 0.f)) continue;      // no root is below it
      const float* s = src + (crow + cc) * 3;
      const float* g = tgt + (crow + cc) * 3;
      const int p = atomicAdd(nc_here, 1);
      s_pt[p] = make_float4(s[0], s[1], s[2], lim);
      s_gc[p] = make_float4(g[0], g[1], g[2], __int_as_float(cc));
    }
    __syncthreads();
    const int nc = *nc_here;
    // the other counter was last read for the tile before this one, which
    // every thread has finished: zero it for the next tile
    if (threadIdx.x == 0) s_nc[(tile + 1) & 1] = 0;
    if (has0) {
#pragma unroll 2
      for (int e = 0; e < nc; ++e) {
        const float4 s = s_pt[e];
        const float4 g = s_gc[e];
        const float qa = sqdist(a, s, g);
        const float qc = sqdist(c, s, g);
        n0 += qa < s.w;
        n1 += qc < s.w;
        if (kDist) {
          const int64_t cc = __float_as_int(g.w);
          dist[(row + h0) * n_corr + cc] = __fsqrt_rn(qa);
          if (has1) dist[(row + h1) * n_corr + cc] = __fsqrt_rn(qc);
        }
      }
    }
    __syncthreads();
  }

  if (splits == 1) {
    if (has0) counts[row + h0] = n0;
    if (has1) counts[row + h1] = n1;
  } else {
    auto* out = reinterpret_cast<unsigned long long*>(counts);
    if (has0 && n0) atomicAdd(out + row + h0, static_cast<unsigned long long>(n0));
    if (has1 && n1) atomicAdd(out + row + h1, static_cast<unsigned long long>(n1));
  }
}

}  // namespace

// R [B, H, 3, 3], t [B, H, 3], src and tgt [B, C, 3] f32; thr [B, C] f32 or
// null (then thr_all for every correspondence); mask [B, C] and gate [B, H]
// bool; counts [B, H] int64; dist [B, H, C] f32 or null. splits: how many
// parts C is cut into (1 to C); with more than one, counts is zeroed on the
// stream first.
extern "C" int bx_hyp_score(const float* R, const float* t, const float* src,
                            const float* tgt, const float* thr,
                            const uint8_t* mask, const uint8_t* gate,
                            long long* counts, float* dist, float thr_all,
                            int n_batch, int n_hyp, int n_corr, int splits,
                            cudaStream_t stream) {
  if (n_batch < 0 || n_batch > 65535 || n_hyp < 0 || n_corr < 0 ||
      splits < 1 || splits > 65535 || (n_corr > 0 && splits > n_corr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_batch == 0 || n_hyp == 0) return static_cast<int>(cudaSuccess);
  const int per_split = n_corr == 0 ? 0 : (n_corr + splits - 1) / splits;
  if (splits > 1) {
    const cudaError_t err = cudaMemsetAsync(
        counts, 0, sizeof(long long) * n_batch * n_hyp, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_hyp + kHypTile - 1) / kHypTile, n_batch, splits);
  if (dist != nullptr)
    hyp_score_kernel<true><<<grid, kThreads, 0, stream>>>(
        R, t, src, tgt, thr, thr_all, mask, gate, counts, dist, n_hyp, n_corr,
        per_split, splits);
  else
    hyp_score_kernel<false><<<grid, kThreads, 0, stream>>>(
        R, t, src, tgt, thr, thr_all, mask, gate, counts, dist, n_hyp, n_corr,
        per_split, splits);
  return static_cast<int>(cudaGetLastError());
}
