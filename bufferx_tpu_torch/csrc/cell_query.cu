// K4: SPT cell query ("sampled" descriptor mode).
//
// Replaces the Pallas kernel bufferx_tpu/geometry/spt_pallas.py: _kernel
// (:120, called through spt_cell_query_pallas :158). For every patch k and
// cylinder cell g it writes the first nsample valid patch points p (in row
// order) with |c_g - p|^2 <= r^2, zero-filling the slots past the last hit:
//     out[k, g, s, :] = xyz of the s-th hit, or 0.
//
// What bounds it: bytes, nearly. The main path makes 3000 x 420 x 512 =
// 645 M point-cell tests per call (9 flops each, 0.09 ms at the f32 rate)
// and writes a 151 MB output (0.05 ms at 3.35 TB/s). The TPU kernel ranks
// hits with bf16 prefix-sum matmuls on the MXU; here the rank is a warp
// vote. Design: one block per patch with its points and mask staged in
// shared memory as structure-of-arrays (13 B per point); one warp per cell
// at a time walks the points 32 at a time, __ballot_sync marks the hits and
// __popc of the lower lanes gives each hit its rank; hits of rank <
// nsample land in a per-warp slot buffer in shared memory (zeroed first),
// the walk stops once nsample hits are found, and the warp writes the
// cell's 3 * nsample floats to global memory in one coalesced pass. The
// in-radius test is bx_sqdist without FMA contraction, the plain version's
// arithmetic, so the two agree to the bit.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxSample = 32;

__global__ void cell_query_kernel(const float* __restrict__ patches,  // [K, P, 3]
                                  const uint8_t* __restrict__ mask,   // [K, P]
                                  const float* __restrict__ cells,    // [G, 3]
                                  int p_n, int g_n, int ns, float r2,
                                  float* __restrict__ out) {  // [K, G, ns, 3]
  extern __shared__ float smem[];
  float* slots = smem;                                  // [kWarps, 3 * 32]
  float* sx = slots + kWarps * 3 * kMaxSample;
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

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  float* mine = slots + warp * 3 * kMaxSample;
  const int width = 3 * ns;
  for (int g = warp; g < g_n; g += kWarps) {
    const float cx = cells[3 * g];
    const float cy = cells[3 * g + 1];
    const float cz = cells[3 * g + 2];
    for (int i = lane; i < width; i += 32) mine[i] = 0.0f;
    __syncwarp();
    int count = 0;  // hits so far; the same in every lane
    for (int base = 0; base < p_n && count < ns; base += 32) {
      const int p = base + lane;
      bool hit = false;
      float x = 0.0f, y = 0.0f, z = 0.0f;
      if (p < p_n) {
        x = sx[p];
        y = sy[p];
        z = sz[p];
        hit = sv[p] && bx_sqdist(cx - x, cy - y, cz - z) <= r2;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      const int rank = count + __popc(ballot & below);
      if (hit && rank < ns) {
        mine[3 * rank] = x;
        mine[3 * rank + 1] = y;
        mine[3 * rank + 2] = z;
      }
      count += __popc(ballot);
    }
    __syncwarp();
    float* o = out + (static_cast<size_t>(k) * g_n + g) * width;
    for (int i = lane; i < width; i += 32) o[i] = mine[i];
    __syncwarp();
  }
}

}  // namespace

// patches [K, P, 3] f32, mask [K, P] u8, cells [G, 3] f32, r2, 1 <= ns <= 32
// -> out [K, G, ns, 3] f32. P <= 3072 (13 B per point of shared memory).
extern "C" int bx_cell_query(const float* patches, const uint8_t* mask,
                             const float* cells, int kq, int p_n, int g_n,
                             int ns, float r2, float* out,
                             cudaStream_t stream) {
  if (ns < 1 || ns > kMaxSample) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kWarps) * 3 * kMaxSample * sizeof(float) +
                      static_cast<size_t>(p_n) * (3 * sizeof(float) + 1);
  cell_query_kernel<<<kq, kWarps * 32, smem, stream>>>(patches, mask, cells,
                                                       p_n, g_n, ns, r2, out);
  return static_cast<int>(cudaGetLastError());
}
