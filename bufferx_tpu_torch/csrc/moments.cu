// K3: dense SPT moment pooling ("moments" descriptor mode).
//
// Replaces the Pallas kernel bufferx_tpu/geometry/spt_pallas.py:
// _moments_kernel (:204, called through spt_moments_pallas :274). For every
// patch k and cylinder cell g it sums, over the valid patch points p with
// |c_g - p|^2 <= r^2, the ten moments
//     [x, y, z, xx, yy, zz, xy, yz, zx, 1]
// and writes them moments-major, out[k, m, g].
//
// What bounds it: arithmetic. The main path makes 3000 x 420 x 512 = 645 M
// point-cell tests per call (9 flops each) plus 16 flops per in-radius hit,
// against 70 MB of input and output. Design: one block per patch; the 512
// points and their mask are staged once in shared memory (8 KB) as
// structure-of-arrays; one thread per cell (420 -> 448 threads) walks the
// points in order, so every shared-memory read is a broadcast, and keeps its
// ten f32 sums in registers. The in-radius test is the plain f32
// (dx*dx + dy*dy) + dz*dz <= r^2 without FMA contraction (the TPU kernel's
// bf16 hi/lo matmul is not copied), so counts match the plain version
// exactly; sums differ from it only by f32 summation order.

#include "common.cuh"

namespace {

__global__ void moments_kernel(const float* __restrict__ patches,  // [K, P, 3]
                               const uint8_t* __restrict__ mask,   // [K, P]
                               const float* __restrict__ cells,    // [G, 3]
                               int p_n, int g_n, float r2,
                               float* __restrict__ out) {          // [K, 10, G]
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + p_n;
  float* sz = sy + p_n;
  uint8_t* sv = reinterpret_cast<uint8_t*>(sz + p_n);
  const int k = blockIdx.x;
  const float* pk = patches + static_cast<size_t>(k) * p_n * 3;
  const uint8_t* mk = mask + static_cast<size_t>(k) * p_n;
  for (int p = threadIdx.x; p < p_n; p += blockDim.x) {
    sx[p] = pk[3 * p];
    sy[p] = pk[3 * p + 1];
    sz[p] = pk[3 * p + 2];
    sv[p] = mk[p];
  }
  __syncthreads();

  for (int g = threadIdx.x; g < g_n; g += blockDim.x) {
    const float cx = cells[3 * g];
    const float cy = cells[3 * g + 1];
    const float cz = cells[3 * g + 2];
    float a[10];
#pragma unroll
    for (int m = 0; m < 10; ++m) a[m] = 0.0f;
    for (int p = 0; p < p_n; ++p) {
      const float x = sx[p];
      const float y = sy[p];
      const float z = sz[p];
      if (sv[p] && bx_sqdist(cx - x, cy - y, cz - z) <= r2) {
        a[0] += x;
        a[1] += y;
        a[2] += z;
        a[3] += x * x;
        a[4] += y * y;
        a[5] += z * z;
        a[6] += x * y;
        a[7] += y * z;
        a[8] += z * x;
        a[9] += 1.0f;
      }
    }
    float* ok = out + static_cast<size_t>(k) * 10 * g_n + g;
#pragma unroll
    for (int m = 0; m < 10; ++m) ok[static_cast<size_t>(m) * g_n] = a[m];
  }
}

}  // namespace

// patches [K, P, 3] f32, mask [K, P] u8, cells [G, 3] f32, r2
// -> out [K, 10, G] f32. P <= 3072 (13 B per point of shared memory).
extern "C" int bx_moments(const float* patches, const uint8_t* mask,
                          const float* cells, int kq, int p_n, int g_n,
                          float r2, float* out, cudaStream_t stream) {
  const int threads = g_n >= 1024 ? 1024 : (g_n + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(p_n) * (3 * sizeof(float) + 1);
  moments_kernel<<<kq, threads, smem, stream>>>(patches, mask, cells, p_n,
                                                g_n, r2, out);
  return static_cast<int>(cudaGetLastError());
}
