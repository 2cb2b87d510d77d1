// K1: masked farthest point sampling, one thread block per cloud.
//
// Replaces the Pallas kernel bufferx_tpu/kernels/fps.py:_fps_kernel (:87,
// called through farthest_point_sampling_pallas :179). Semantics: the
// running min-distance field starts at +inf on valid points and -1 on padded
// ones; every round picks the argmax (lowest index on ties), records it and
// lowers the field by the squared distance to the pick.
//
// What bounds it: 2 x 2000 dependent rounds per pair, each a block-wide
// argmax, so latency, not bytes (the clouds are 0.8 MB) or arithmetic
// (~1.1 GFLOP per pair). Design: 1024 threads, each owning PT points
// (point p = tid + j*1024, so every sweep is coalesced) with its slice of
// the min-distance field in registers; the field (30208 x 4 B per cloud)
// never leaves the SM, and the coordinates (362 KB per cloud, more than a
// block's shared memory) are re-read through L1/L2 each round. One pass per
// round fuses the field update with the thread-local argmax; the block
// argmax is warp shuffles, then one warp over the 32 partial winners.
// Two clouds use 2 of 132 SMs: spreading one cloud over a cluster is the
// next step.

#include "common.cuh"

#include <cfloat>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void take_better(float& bv, int& bi, float ov,
                                            int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_down_sync(0xffffffffu, bv, off);
    int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take_better(bv, bi, ov, oi);
  }
}

template <int PT>
__global__ void __launch_bounds__(kThreads, 1)
    fps_kernel(const float* __restrict__ xyz_soa,    // [B, 3, N]
               const uint8_t* __restrict__ mask,     // [B, N]
               int n, int k, int32_t* __restrict__ out) {  // [B, K]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* xs = xyz_soa + static_cast<size_t>(b) * 3 * n;
  const float* ys = xs + n;
  const float* zs = ys + n;
  const uint8_t* m = mask + static_cast<size_t>(b) * n;
  int32_t* o = out + static_cast<size_t>(b) * k;

  __shared__ float s_val[32];
  __shared__ int s_idx[32];
  __shared__ int s_sel;

  float mind[PT];
  float bv = -INFINITY;
  int bi = INT_MAX;
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int p = tid + j * kThreads;
    // slots past n can never win; padded points sit at -1
    mind[j] = p < n ? (m[p] ? INFINITY : -1.0f) : -INFINITY;
    if (p < n && mind[j] > bv) {
      bv = mind[j];
      bi = p;
    }
  }

  for (int i = 0; i < k; ++i) {
    warp_argmax(bv, bi);
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = s_val[lane];
      bi = s_idx[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_sel = bi;
        o[i] = bi;
      }
    }
    __syncthreads();
    const int sel = s_sel;
    const float sx = __ldg(xs + sel);
    const float sy = __ldg(ys + sel);
    const float sz = __ldg(zs + sel);
    bv = -INFINITY;
    bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int p = tid + j * kThreads;
      if (p < n) {
        const float d = bx_sqdist(__ldg(xs + p) - sx, __ldg(ys + p) - sy,
                                  __ldg(zs + p) - sz);
        mind[j] = fminf(mind[j], d);
        if (mind[j] > bv) {   // p rises with j: strict > keeps the lowest
          bv = mind[j];
          bi = p;
        }
      }
    }
  }
}

template <int PT>
cudaError_t launch(const float* xyz, const uint8_t* mask, int b, int n, int k,
                   int32_t* out, cudaStream_t stream) {
  fps_kernel<PT><<<b, kThreads, 0, stream>>>(xyz, mask, n, k, out);
  return cudaGetLastError();
}

}  // namespace

// xyz_soa [B, 3, N] f32, mask [B, N] u8 -> out [B, K] int32. N <= 32768.
extern "C" int bx_fps(const float* xyz_soa, const uint8_t* mask, int b, int n,
                      int k, int32_t* out, cudaStream_t stream) {
  const int per_thread = (n + kThreads - 1) / kThreads;
  cudaError_t err;
  if (per_thread <= 1) err = launch<1>(xyz_soa, mask, b, n, k, out, stream);
  else if (per_thread <= 2) err = launch<2>(xyz_soa, mask, b, n, k, out, stream);
  else if (per_thread <= 4) err = launch<4>(xyz_soa, mask, b, n, k, out, stream);
  else if (per_thread <= 8) err = launch<8>(xyz_soa, mask, b, n, k, out, stream);
  else if (per_thread <= 16) err = launch<16>(xyz_soa, mask, b, n, k, out, stream);
  else if (per_thread <= 32) err = launch<32>(xyz_soa, mask, b, n, k, out, stream);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
