// K4: SPT cell query ("sampled" descriptor mode).
//
// Replaces the Pallas kernel bufferx_tpu/geometry/spt_pallas.py: _kernel
// (:120, called through spt_cell_query_pallas :158). For every patch k and
// cylinder cell g it writes the first nsample valid patch points p (in row
// order) with |c_g - p|^2 <= r^2, zero-filling the slots past the last hit:
//     out[k, g, s, :] = xyz of the s-th hit, or 0.
//
// What bounds it: issued instructions, then the store of the output. The
// sampled path makes 3000 x 420 x 512 = 645 M point-cell pairs per call, of
// which 1-4% hit. The test is bx_sqdist without FMA contraction (the plain
// version's arithmetic, so the two agree to the bit): 9 issued instructions
// a test, which alone is ~0.2 ms for every pair on an H100, four times what
// moving the 171 MB of input and output takes. The TPU kernel ranks hits with
// bf16 prefix-sum matmuls on the MXU; nothing of that carries over. Design
// (the shared parts are in ring_cull.cuh):
//
// * The ring cull: per patch, each ring of ring_len cells gets the list of
//   its candidate points in row order (a 2-D test per point and ring,
//   compacted by warp ballot), 2-10% of the points, and only those meet the
//   exact test. What is left is a few ten thousand warp instructions a patch
//   for lists, tests and bookkeeping, and that is what bounds the kernel now.
// * The exact tests run with lanes as candidates, 32 list entries against
//   the cells of their ring, and leave a hit mask per (chunk, cell). Then
//   lanes are cells: a lane walks the set bits of its cell's masks chunk by
//   chunk, which are the hits in row order, copies the first nsample points
//   into the cell's slots and stops; a warp stops when all its lanes have.
// * A persistent block per resident slot (three an SM at the sampled path's
//   shapes) loops over patches. The input comes by cp.async.bulk behind the
//   previous patch's work. The output of a batch of rings is one contiguous
//   run of global memory: it is built in a shared-memory tile, zero-filled
//   once, and leaves with one cp.async.bulk shared -> global, from two tiles
//   in turn so that a tile's store overlaps the next batch's tests. At the
//   sampled path's shapes a batch is a shell of 7 rings (16.8 KB tiles);
//   larger P, G or nsample get more batches. Runs that are not 16-byte
//   multiples are stored by plain coalesced writes.

#include "ring_cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSample = 32;
// three blocks an SM when a batch fits in this, else one block with all of it
constexpr size_t kSmemSeveralPerSm = 74 * 1024;

__global__ void __launch_bounds__(kThreads)
    cell_query_kernel(const float* __restrict__ patches,  // [K, P, 3]
                      const uint8_t* __restrict__ mask,   // [K, P] bool
                      const float* __restrict__ cells,    // [G, 3]
                      int kq, int ns, float r, float r2, BxCellLayout lay,
                      float* __restrict__ out) {          // [K, G, ns, 3]
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) unsigned long long s_bar;
  const BxCellSmem sm(smem, lay);
  const uint32_t bar = bx_smem_u32(&s_bar);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int width = 3 * ns;

  if (tid == 0) bx_mbar_init(bar, 1);
  bx_ring_params(cells, lay, r, sm);
  __syncthreads();
  if (lay.bulk_in && tid == 0 && blockIdx.x < kq)
    bx_patch_fetch(patches, mask, blockIdx.x, lay, sm, bar);

  int tile_i = 0;
  int it = 0;
  for (int k = blockIdx.x; k < kq; k += gridDim.x, ++it) {
    bx_patch_stage(patches, mask, k, k + gridDim.x, kq, it, lay, sm, bar);
    for (int b = 0; b < lay.n_batches; ++b) {
      const int q0 = b * lay.rings_per_batch;
      const int q1 = min(q0 + lay.rings_per_batch, lay.n_rings);
      const int g0 = q0 * lay.ring_len;
      const int n_cells = (q1 - q0) * lay.ring_len;
      const int n_floats = n_cells * width;
      float* tile = reinterpret_cast<float*>(sm.tile + tile_i * lay.tile_bytes);

      // The tile's previous store was waited for before the block's last
      // barrier, and the last readers of the lists and masks passed it too.
      float4* tile4 = reinterpret_cast<float4*>(tile);
      for (int i = tid; i < (n_floats + 3) / 4; i += kThreads)
        tile4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      bx_batch_lists(lay, sm, q0, q1, k, nullptr);
      __syncthreads();
      bx_batch_hits(lay, sm, q0, r2);
      __syncthreads();
      if (tid == 0) *sm.n_units = 0;

      // lanes are cells: the first ns set bits of the cell's masks, chunk by
      // chunk, are its first ns hits in row order
      for (int c0 = warp * 32; c0 < n_cells; c0 += kThreads) {
        const bool active = c0 + lane < n_cells;
        const int c = active ? c0 + lane : n_cells - 1;
        const BxCellHits hits(lay, sm, c, active);
        float* slot = tile + static_cast<size_t>(c) * width;
        const int most = __reduce_max_sync(kBxFullWarp, hits.n_chunks);
        int count = 0;
        for (int chunk = 0; chunk < most; ++chunk) {
          const bool more = chunk < hits.n_chunks && count < ns;
          if (!__any_sync(kBxFullWarp, more)) break;
          unsigned m = more ? hits.masks[chunk * lay.ring_len] : 0u;
          while (m != 0 && count < ns) {
            const int j = __ffs(m) - 1;
            m &= m - 1;
            const float4 p = sm.pt[hits.list[chunk * 32 + j]];
            slot[0] = p.x;
            slot[1] = p.y;
            slot[2] = p.z;
            slot += 3;
            ++count;
          }
        }
      }

      bx_fence_proxy_async();
      if (tid == 0) bx_bulk_wait_read();  // the other tile has left
      __syncthreads();
      float* dst = out + (static_cast<size_t>(k) * lay.g_n + g0) * width;
      const size_t bytes = static_cast<size_t>(n_floats) * sizeof(float);
      if (bx_aligned16(dst, bytes)) {
        if (tid == 0)
          bx_bulk_store(dst, bx_smem_u32(tile), static_cast<uint32_t>(bytes));
      } else {
        for (int i = tid; i < n_floats; i += kThreads) dst[i] = tile[i];
      }
      tile_i ^= 1;
    }
  }
  if (tid == 0) bx_bulk_wait();
}

}  // namespace

// patches [K, P, 3] f32, mask [K, P] bool (one byte each), cells [G, 3] f32
// with G a multiple of ring_len, r and r2 = r^2 as the caller rounds them,
// 1 <= ns <= 32 -> out [K, G, ns, 3] f32. P < 65536 (16-bit list entries);
// P, G and ring_len small enough that the points, the cells and one ring's
// list, masks and tiles fit in shared memory.
extern "C" int bx_cell_query(const float* patches, const uint8_t* mask,
                             const float* cells, int kq, int p_n, int g_n,
                             int ring_len, int ns, float r, float r2,
                             float* out, cudaStream_t stream) {
  if (ns < 1 || ns > kMaxSample || p_n < 1 || p_n > 65535 || ring_len < 1 ||
      g_n < 1 || g_n % ring_len != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kq < 1) return static_cast<int>(cudaSuccess);
  const bool bulk_in = p_n % 16 == 0 && bx_aligned16(patches, 0) &&
                       bx_aligned16(mask, 0);
  const size_t tile_per_ring =
      static_cast<size_t>(ring_len) * 3 * ns * sizeof(float);
  BxCellLayout lay;
  if (!bx_cell_layout(p_n, g_n, ring_len, bulk_in, 0, tile_per_ring, 2,
                      kSmemSeveralPerSm, &lay) &&
      !bx_cell_layout(p_n, g_n, ring_len, bulk_in, 0, tile_per_ring, 2,
                      kBxSmemMax, &lay))
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  cudaError_t err =
      bx_persistent_grid(cell_query_kernel, kThreads, lay.total, kq, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  cell_query_kernel<<<grid, kThreads, lay.total, stream>>>(
      patches, mask, cells, kq, ns, r, r2, lay, out);
  return static_cast<int>(cudaGetLastError());
}
