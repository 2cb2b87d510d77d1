// K3: dense SPT moment pooling ("moments" descriptor mode).
//
// Replaces the Pallas kernel bufferx_tpu/geometry/spt_pallas.py:
// _moments_kernel (:204, called through spt_moments_pallas :274). For every
// patch k and cylinder cell g it sums, over the valid patch points p with
// |c_g - p|^2 <= r^2, the ten moments
//     [x, y, z, xx, yy, zz, xy, yz, zx, 1]
// and writes them moments-major, out[k, m, g].
//
// What bounds it: issued instructions. The main path makes 3000 x 420 x 512 =
// 645 M point-cell pairs per call, of which 1-4% hit, against 70 MB of input
// and output. The test is the plain f32 (dx*dx + dy*dy) + dz*dz <= r^2
// without FMA contraction (the TPU kernel's bf16 hi/lo matmul is not
// copied), so counts match the plain version exactly: 9 issued instructions
// a test, ~0.2 ms for every pair on an H100, ten times what moving the
// bytes takes. Design (the shared parts are in ring_cull.cuh):
//
// * The ring cull: per patch, each ring of ring_len cells gets the list of
//   its candidate points in row order, 2-10% of the points, and only those
//   meet the exact test. What is left is a few ten thousand warp
//   instructions a patch for lists, tests and sums, and that is what bounds
//   the kernel now.
// * The exact tests run with lanes as candidates, 32 list entries against
//   the cells of their ring (no lane idles where ring_len is not 32), and
//   leave a hit mask per (chunk, cell). Then lanes are cells: each lane
//   walks the set bits of its cell's masks chunk by chunk, which are the
//   hits in row order, and keeps the cell's ten sums in registers. One owner
//   per cell and a fixed order: no atomics, the plain version's summation
//   order, the same bits on every run.
// * A persistent block per resident slot (two an SM at the main path's
//   shapes) loops over patches; the input comes by cp.async.bulk behind the
//   previous patch's work. A patch's [10, G] output is contiguous: it is
//   assembled in a shared-memory tile and leaves with one cp.async.bulk
//   shared -> global, which the next patch's staging, lists and tests
//   overlap (a run that is not a 16-byte multiple leaves by plain coalesced
//   stores). Rings whose lists and masks do not fit at once (large P or G)
//   go in batches; the tile always holds all cells.

#include "ring_cull.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMoments = 10;
// two blocks an SM when a batch fits in this, else one block with all of it
constexpr size_t kSmemSeveralPerSm = 112 * 1024;

__device__ __forceinline__ void add_moments(float (&a)[kMoments],
                                            const float4& p) {
  a[0] += p.x;
  a[1] += p.y;
  a[2] += p.z;
  a[3] += p.x * p.x;
  a[4] += p.y * p.y;
  a[5] += p.z * p.z;
  a[6] += p.x * p.y;
  a[7] += p.y * p.z;
  a[8] += p.z * p.x;
  a[9] += 1.0f;
}

__global__ void __launch_bounds__(kThreads)
    moments_kernel(const float* __restrict__ patches,  // [K, P, 3]
                   const uint8_t* __restrict__ mask,   // [K, P] bool
                   const float* __restrict__ cells,    // [G, 3]
                   int kq, float r, float r2, BxCellLayout lay,
                   float* __restrict__ out,            // [K, 10, G]
                   int* __restrict__ ring_counts) {    // [K, n_rings] or null
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long s_bar;
  const BxCellSmem sm(smem, lay);
  const uint32_t bar = bx_smem_u32(&s_bar);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* tile = reinterpret_cast<float*>(sm.tile);  // [10, G]
  const int n_floats = kMoments * lay.g_n;

  if (tid == 0) bx_mbar_init(bar, 1);
  bx_ring_params(cells, lay, r, sm);
  __syncthreads();
  if (lay.bulk_in && tid == 0 && blockIdx.x < kq)
    bx_patch_fetch(patches, mask, blockIdx.x, lay, sm, bar);

  int it = 0;
  for (int k = blockIdx.x; k < kq; k += gridDim.x, ++it) {
    bx_patch_stage(patches, mask, k, k + gridDim.x, kq, it, lay, sm, bar);
    for (int b = 0; b < lay.n_batches; ++b) {
      const int q0 = b * lay.rings_per_batch;
      const int q1 = min(q0 + lay.rings_per_batch, lay.n_rings);
      const int g0 = q0 * lay.ring_len;
      const int n_cells = (q1 - q0) * lay.ring_len;

      bx_batch_lists(lay, sm, q0, q1, k, ring_counts);
      __syncthreads();
      bx_batch_hits(lay, sm, q0, r2);
      if (tid == 0) bx_bulk_wait_read();  // the last patch's tile has left
      __syncthreads();
      if (tid == 0) *sm.n_units = 0;

      // lanes are cells: the set bits of the cell's masks, chunk by chunk,
      // are its hits in row order, and the sums take them in that order
      for (int c0 = warp * 32; c0 < n_cells; c0 += kThreads) {
        const bool active = c0 + lane < n_cells;
        const int c = active ? c0 + lane : n_cells - 1;
        const BxCellHits hits(lay, sm, c, active);
        const int most = __reduce_max_sync(kBxFullWarp, hits.n_chunks);
        float a[kMoments];
#pragma unroll
        for (int m = 0; m < kMoments; ++m) a[m] = 0.0f;
        for (int chunk = 0; chunk < most; ++chunk) {
          unsigned m =
              chunk < hits.n_chunks ? hits.masks[chunk * lay.ring_len] : 0u;
          // two hits a step: the second's loads overlap the first's sums
          while (m != 0) {
            const int j0 = __ffs(m) - 1;
            m &= m - 1;
            const bool two = m != 0;
            const int j1 = two ? __ffs(m) - 1 : j0;
            m &= m - 1;
            const float4 p = sm.pt[hits.list[chunk * 32 + j0]];
            const float4 q = sm.pt[hits.list[chunk * 32 + j1]];
            add_moments(a, p);
            if (two) add_moments(a, q);
          }
        }
        if (active) {
#pragma unroll
          for (int m = 0; m < kMoments; ++m) tile[m * lay.g_n + g0 + c] = a[m];
        }
      }
      // before the next batch's lists and masks replace this one's
      if (b + 1 < lay.n_batches) __syncthreads();
    }

    bx_fence_proxy_async();
    __syncthreads();
    float* dst = out + static_cast<size_t>(k) * n_floats;
    const size_t bytes = sizeof(float) * n_floats;
    if (bx_aligned16(dst, bytes)) {
      if (tid == 0)
        bx_bulk_store(dst, bx_smem_u32(tile), static_cast<uint32_t>(bytes));
    } else {
      for (int i = tid; i < n_floats; i += kThreads) dst[i] = tile[i];
    }
  }
  if (tid == 0) bx_bulk_wait();
}

}  // namespace

// patches [K, P, 3] f32, mask [K, P] bool (one byte each), cells [G, 3] f32
// with G a multiple of ring_len, r and r2 = r^2 as the caller rounds them
// -> out [K, 10, G] f32. ring_counts, if not null, receives the length of
// every ring's candidate list, [K, G / ring_len] int32. P < 65536 (16-bit
// list entries); P, G and ring_len small enough that the points, the cells,
// the [10, G] tile and one ring's list and masks fit in shared memory.
extern "C" int bx_moments(const float* patches, const uint8_t* mask,
                          const float* cells, int kq, int p_n, int g_n,
                          int ring_len, float r, float r2, float* out,
                          int* ring_counts, cudaStream_t stream) {
  if (p_n < 1 || p_n > 65535 || ring_len < 1 || g_n < 1 ||
      g_n % ring_len != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kq < 1) return static_cast<int>(cudaSuccess);
  const bool bulk_in = p_n % 16 == 0 && bx_aligned16(patches, 0) &&
                       bx_aligned16(mask, 0);
  const size_t whole_tile = sizeof(float) * kMoments * g_n;
  BxCellLayout lay;
  if (!bx_cell_layout(p_n, g_n, ring_len, bulk_in, whole_tile, 0, 0,
                      kSmemSeveralPerSm, &lay) &&
      !bx_cell_layout(p_n, g_n, ring_len, bulk_in, whole_tile, 0, 0, kBxSmemMax,
                      &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  cudaError_t err =
      bx_persistent_grid(moments_kernel, kThreads, lay.total, kq, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_kernel<<<grid, kThreads, lay.total, stream>>>(
      patches, mask, cells, kq, r, r2, lay, out, ring_counts);
  return static_cast<int>(cudaGetLastError());
}
