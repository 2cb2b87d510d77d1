// K2: fused multi-radius stratified ball query.
//
// Replaces the Pallas kernel bufferx_tpu/kernels/strat_pallas.py:_kernel
// (:104, called through ball_query_stratified_multi :137). The cloud's N
// points are L = N/S strips of S slots (point li*S + s is strip li, slot s).
// For every centre k, slot s and radius r it keeps
//     min over li of ((in_r(d2[k, li*S+s]) ? rank : L) << 24) + q[c, li, s]
// for each coordinate c, where rank = (li - off[k, s]) mod L: the first
// in-radius point in cyclic order from a random offset wins, and its
// 24-bit quantized coordinate rides in the low bits of the packed int32.
//
// What bounds it: reading d2 once, [1500, 30208] f32 = 181 MB per call on
// the main path (54 us at 3.35 TB/s); the ~30 integer ops per d2 element
// stay under that. Design: one thread per (k, s) with neighbouring threads
// on neighbouring s, so every d2 and q load is coalesced; the 3 x R running
// minima live in registers and are written once as [R, 3, K, S]. The
// result is integer, so it is bit-exact against the plain version.

#include "common.cuh"

#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kQBits = 24;

template <int R>
__global__ void __launch_bounds__(kThreads)
    strat_kernel(const float* __restrict__ d2,      // [K, L*S]
                 const int32_t* __restrict__ off,   // [K, S]
                 const int32_t* __restrict__ q,     // [3, L, S]
                 const float* __restrict__ radii2,  // [R]
                 int kq, int l, int s_n, int32_t* __restrict__ out) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (s >= s_n) return;
  float r2[R];
  int32_t acc[R][3];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    r2[r] = radii2[r];
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[r][c] = INT_MAX;
  }
  const int o = off[static_cast<size_t>(k) * s_n + s];
  const float* row = d2 + static_cast<size_t>(k) * l * s_n + s;
  const size_t plane = static_cast<size_t>(l) * s_n;
  for (int li = 0; li < l; ++li) {
    const float d = __ldg(row + static_cast<size_t>(li) * s_n);
    int rank = li - o;
    if (rank < 0) rank += l;
    const size_t qi = static_cast<size_t>(li) * s_n + s;
    const int32_t qc[3] = {__ldg(q + qi), __ldg(q + plane + qi),
                           __ldg(q + 2 * plane + qi)};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t base = (d <= r2[r] ? rank : l) << kQBits;
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[r][c] = min(acc[r][c], base + qc[c]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[(static_cast<size_t>(r * 3 + c) * kq + k) * s_n + s] = acc[r][c];
    }
  }
}

template <int R>
cudaError_t launch(const float* d2, const int32_t* off, const int32_t* q,
                   const float* radii2, int kq, int l, int s_n, int32_t* out,
                   cudaStream_t stream) {
  dim3 grid((s_n + kThreads - 1) / kThreads, kq);
  strat_kernel<R><<<grid, kThreads, 0, stream>>>(d2, off, q, radii2, kq, l,
                                                  s_n, out);
  return cudaGetLastError();
}

}  // namespace

// d2 [K, L*S] f32, off [K, S] i32, q [3, L, S] i32, radii2 [R] f32
// -> out [R, 3, K, S] i32. 1 <= R <= 4, K <= 65535, L < 128.
extern "C" int bx_strat(const float* d2, const int32_t* off, const int32_t* q,
                        const float* radii2, int num_r, int kq, int l, int s_n,
                        int32_t* out, cudaStream_t stream) {
  cudaError_t err;
  switch (num_r) {
    case 1: err = launch<1>(d2, off, q, radii2, kq, l, s_n, out, stream); break;
    case 2: err = launch<2>(d2, off, q, radii2, kq, l, s_n, out, stream); break;
    case 3: err = launch<3>(d2, off, q, radii2, kq, l, s_n, out, stream); break;
    case 4: err = launch<4>(d2, off, q, radii2, kq, l, s_n, out, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
