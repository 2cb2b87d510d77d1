// The ring cull and the patch pipeline shared by the two SPT cell kernels
// (K4 cell_query.cu, K3 moments.cu).
//
// Both kernels decide, per patch and cylinder cell, which valid patch points
// lie within r of the cell centre. Only a few percent of the point-cell pairs
// do, so the brute-force walk of every pair is bound by the instructions
// issued on tests that fail. The cells [q * ring_len, (q + 1) * ring_len) of a grid
// share one shell and one elevation: they lie on a circle about the z axis
// ("ring" q). With rho = sqrt(x^2 + y^2),
//     |p - c|^2 >= (rho_p - rho_c)^2 + (z_p - z_c)^2
// for every azimuth of c, so a point within r of any cell of the ring
// satisfies a 2-D test against the ring. Per patch, each ring gets the list
// of its candidate points, in row order, in shared memory; the kernels then
// run the exact test (bx_sqdist, unchanged) on the candidates alone. The
// cull may keep too much and never drops a point the exact test accepts:
//
// * the ring's (rho, z) come from the cells the kernel is given (midrange
//   of the ring's cells), and the spread of the cells about them,
//   (rho_max - rho_min) + (z_max - z_min), widens the radius;
// * the radius is widened once more by 2^-18 of the magnitudes involved
//   (64 f32 roundings where the computation of both sides makes about ten)
//   plus 1e-18 for underflow;
// * every operation is an explicitly rounded f32 one (no FMA contraction,
//   correctly rounded square roots), the same sequence as the plain PyTorch
//   twin ring_candidates_plain in geometry/spt_pallas.py, so the two keep
//   the same candidates to the bit.
//
// The patch pipeline: a persistent block loops over patches. A patch's
// points and mask are one contiguous run each; thread 0 fetches them with
// cp.async.bulk onto an mbarrier into a landing buffer, the block repacks
// them (float4 x, y, z, rho, with rho = NaN for masked points, so that they
// enter no list and the later loops read no mask) and the next patch's
// fetch starts at once, behind this patch's work. Runs whose address or
// size is not a multiple of 16 bytes are read with plain loads instead.
//
// The exact tests run with lanes as candidates (bx_batch_hits): 32 list
// entries at a time against the cells of their ring, the ballot of each
// test being a 32-bit hit mask per (chunk, cell) in shared memory. Every
// lane does a real test whatever the list lengths, and the chunks of a long
// list (on surface patches the rings near the equator hold ten times the
// candidates of the others) spread over the block's warps. The kernels then
// turn to lanes as cells and walk the set bits of their cell's masks, which
// are its hits in row order.
#pragma once

#include <mutex>
#include <vector>

#include "common.cuh"

constexpr float kBxCullRel = 3.814697265625e-06f;  // 2^-18
constexpr float kBxCullAbs = 1e-18f;
constexpr unsigned kBxFullWarp = 0xffffffffu;
constexpr int kBxListChunks = 4;   // chunks of 32 points a list-building step
constexpr int kBxCellGroup = 4;    // cells a step of the exact tests
// A block's shared memory: the card's opt-in limit of 227 KB holds the
// kernels' static part (their mbarrier, rounded up) and the dynamic layout.
constexpr size_t kBxSmemStatic = 16;
constexpr size_t kBxSmemMax = 227 * 1024 - kBxSmemStatic;

__device__ __forceinline__ void bx_mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arms the mbarrier for `bytes` and starts the 1-D bulk copy global -> shared.
__device__ __forceinline__ void bx_bulk_load(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bx_mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// 1-D bulk copy shared -> global as one bulk group of the calling thread.
__device__ __forceinline__ void bx_bulk_store(void* dst, uint32_t src,
                                              uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The calling thread's bulk stores have all been read out of shared memory.
__device__ __forceinline__ void bx_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The calling thread's bulk stores are complete.
__device__ __forceinline__ void bx_bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before a later bulk copy's reads.
__device__ __forceinline__ void bx_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__host__ __device__ __forceinline__ bool bx_aligned16(const void* p,
                                                      size_t bytes) {
  return ((reinterpret_cast<uintptr_t>(p) | bytes) & 15u) == 0;
}

// Where a block's arrays lie in its dynamic shared memory (byte offsets, each
// a multiple of 16), and how the rings are split into batches whose lists,
// hit masks and output tiles fit. Filled by bx_cell_layout on the host.
struct BxCellLayout {
  int p_n, g_n, ring_len, n_rings;
  int n_chunks;      // ceil(p_n / 32): the most 32-candidate chunks of a list
  int rings_per_batch, n_batches;
  int bulk_in;       // the patches' runs qualify for cp.async.bulk
  int off_raw;       // landing buffer: 3 * p_n floats, then p_n mask bytes
  int off_pt;        // float4 [p_n rounded up to a list-building step]:
                     // x, y, z, rho (NaN where masked and in the padding)
  int off_cells;     // float4 [g_n]: the cell centres
  int off_ring;      // float [3, n_rings]: rho, z, squared cull radius
  int off_len;       // int [rings_per_batch], then the batch's unit count
  int off_units;     // uint32 [rings_per_batch, n_chunks]: (ring << 16) | chunk
  int off_list;      // uint16 [rings_per_batch, p_n]
  int off_hits;      // uint32 [rings_per_batch, n_chunks, ring_len]
  int off_tile;      // the output tiles
  int tile_bytes;    // of one per-batch tile
  int total;
};

// Points are staged with padding up to a whole list-building step, so that
// the step needs no bounds check.
__host__ __device__ inline int bx_padded_points(int p_n) {
  const int step = 32 * kBxListChunks;
  return (p_n + step - 1) / step * step;
}

// Splits n_rings into the fewest equal batches such that everything fits in
// `budget` bytes: `whole_tile` bytes of output tile for all cells, and per
// batch `n_tiles` tiles of `tile_per_ring` bytes a ring. Returns false if
// not even one ring per batch fits.
inline bool bx_cell_layout(int p_n, int g_n, int ring_len, bool bulk_in,
                           size_t whole_tile, size_t tile_per_ring,
                           int n_tiles, size_t budget, BxCellLayout* lay) {
  auto up16 = [](size_t v) { return (v + 15) / 16 * 16; };
  const int n_rings = g_n / ring_len;
  const int n_chunks = (p_n + 31) / 32;
  size_t off = 0;
  lay->p_n = p_n;
  lay->g_n = g_n;
  lay->ring_len = ring_len;
  lay->n_rings = n_rings;
  lay->n_chunks = n_chunks;
  lay->bulk_in = bulk_in ? 1 : 0;
  lay->off_raw = static_cast<int>(off);
  off += bulk_in ? up16(static_cast<size_t>(p_n) * 13) : 0;
  lay->off_pt = static_cast<int>(off);
  off += static_cast<size_t>(bx_padded_points(p_n)) * 16;
  lay->off_cells = static_cast<int>(off);
  off += static_cast<size_t>(g_n) * 16;
  lay->off_ring = static_cast<int>(off);
  off += up16(static_cast<size_t>(n_rings) * 12);
  lay->off_tile = static_cast<int>(off);
  off += up16(whole_tile);
  const size_t hits_per_ring = static_cast<size_t>(n_chunks) * ring_len * 4;
  const size_t per_ring = 4 + static_cast<size_t>(p_n) * 2 + hits_per_ring +
                          static_cast<size_t>(n_chunks) * 4 +
                          n_tiles * tile_per_ring;
  const size_t slack = 16 * (5 + n_tiles);   // rounding of the arrays below
  if (off + slack + per_ring > budget) return false;
  size_t fit = (budget - off - slack) / per_ring;
  if (fit > static_cast<size_t>(n_rings)) fit = n_rings;
  const int most = static_cast<int>(fit);
  const int fewest = (n_rings + most - 1) / most;
  const int rpb = (n_rings + fewest - 1) / fewest;
  lay->rings_per_batch = rpb;
  lay->n_batches = (n_rings + rpb - 1) / rpb;
  lay->off_len = static_cast<int>(off);
  off += up16(static_cast<size_t>(rpb + 1) * 4);
  lay->off_units = static_cast<int>(off);
  off += up16(static_cast<size_t>(rpb) * n_chunks * 4);
  lay->off_list = static_cast<int>(off);
  off += up16(static_cast<size_t>(rpb) * p_n * 2);
  lay->off_hits = static_cast<int>(off);
  off += up16(rpb * hits_per_ring);
  lay->tile_bytes = static_cast<int>(up16(rpb * tile_per_ring));
  if (n_tiles > 0) lay->off_tile = static_cast<int>(off);
  off += static_cast<size_t>(n_tiles) * lay->tile_bytes;
  lay->total = static_cast<int>(off);
  return off <= budget;
}

// Views of a block's shared memory under a layout.
struct BxCellSmem {
  const float* raw;
  const uint8_t* raw_mask;
  float4* pt;
  float4* cells;
  float* ring;
  int* len;
  int* n_units;
  uint32_t* units;
  uint16_t* list;
  uint32_t* hits;
  unsigned char* tile;

  __device__ BxCellSmem(unsigned char* base, const BxCellLayout& lay)
      : raw(reinterpret_cast<const float*>(base + lay.off_raw)),
        raw_mask(base + lay.off_raw + static_cast<size_t>(lay.p_n) * 12),
        pt(reinterpret_cast<float4*>(base + lay.off_pt)),
        cells(reinterpret_cast<float4*>(base + lay.off_cells)),
        ring(reinterpret_cast<float*>(base + lay.off_ring)),
        len(reinterpret_cast<int*>(base + lay.off_len)),
        n_units(reinterpret_cast<int*>(base + lay.off_len) +
                lay.rings_per_batch),
        units(reinterpret_cast<uint32_t*>(base + lay.off_units)),
        list(reinterpret_cast<uint16_t*>(base + lay.off_list)),
        hits(reinterpret_cast<uint32_t*>(base + lay.off_hits)),
        tile(base + lay.off_tile) {}
};

// Once per block: the cell centres into shared memory, the padding of the
// staged points (rho = NaN: candidates of no ring), and per ring q
// ring[q] = rho, ring[n + q] = z, ring[2n + q] = squared cull radius (one
// warp per ring). The block synchronizes after the call.
__device__ __forceinline__ void bx_ring_params(const float* __restrict__ cells,
                                               const BxCellLayout& lay, float r,
                                               const BxCellSmem& sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  const float nan = __int_as_float(0x7fc00000);
  float* ring = sm.ring;
  if (threadIdx.x == 0) *sm.n_units = 0;
  for (int p = lay.p_n + threadIdx.x; p < bx_padded_points(lay.p_n);
       p += blockDim.x)
    sm.pt[p] = make_float4(0.0f, 0.0f, 0.0f, nan);
  for (int g = threadIdx.x; g < lay.g_n; g += blockDim.x)
    sm.cells[g] =
        make_float4(cells[3 * g], cells[3 * g + 1], cells[3 * g + 2], 0.0f);
  for (int q = warp; q < lay.n_rings; q += n_warps) {
    float rmin = inf, rmax = -inf, zmin = inf, zmax = -inf;
    for (int j = lane; j < lay.ring_len; j += 32) {
      const float* c = cells + 3 * (static_cast<size_t>(q) * lay.ring_len + j);
      const float cx = c[0], cy = c[1], cz = c[2];
      const float rho =
          __fsqrt_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)));
      rmin = fminf(rmin, rho);
      rmax = fmaxf(rmax, rho);
      zmin = fminf(zmin, cz);
      zmax = fmaxf(zmax, cz);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      rmin = fminf(rmin, __shfl_xor_sync(kBxFullWarp, rmin, s));
      rmax = fmaxf(rmax, __shfl_xor_sync(kBxFullWarp, rmax, s));
      zmin = fminf(zmin, __shfl_xor_sync(kBxFullWarp, zmin, s));
      zmax = fmaxf(zmax, __shfl_xor_sync(kBxFullWarp, zmax, s));
    }
    if (lane == 0) {
      const float rho_r = __fmul_rn(0.5f, __fadd_rn(rmin, rmax));
      const float z_r = __fmul_rn(0.5f, __fadd_rn(zmin, zmax));
      const float spread =
          __fadd_rn(__fsub_rn(rmax, rmin), __fsub_rn(zmax, zmin));
      const float rc = __fadd_rn(r, spread);
      const float mag = __fadd_rn(__fadd_rn(rho_r, fabsf(z_r)), rc);
      const float wide =
          __fadd_rn(__fadd_rn(rc, __fmul_rn(kBxCullRel, mag)), kBxCullAbs);
      ring[q] = rho_r;
      ring[lay.n_rings + q] = z_r;
      ring[2 * lay.n_rings + q] = __fmul_rn(wide, wide);
    }
  }
}

// Thread 0 of the block: start the fetch of patch k into the landing buffer.
__device__ __forceinline__ void bx_patch_fetch(const float* patches,
                                               const uint8_t* mask, int k,
                                               const BxCellLayout& lay,
                                               const BxCellSmem& sm,
                                               uint32_t bar) {
  const uint32_t pts_bytes = static_cast<uint32_t>(lay.p_n) * 12u;
  const uint32_t mask_bytes = static_cast<uint32_t>(lay.p_n);
  bx_mbar_expect_tx(bar, pts_bytes + mask_bytes);
  bx_bulk_load(bx_smem_u32(sm.raw),
               patches + static_cast<size_t>(k) * lay.p_n * 3, pts_bytes, bar);
  bx_bulk_load(bx_smem_u32(sm.raw_mask),
               mask + static_cast<size_t>(k) * lay.p_n, mask_bytes, bar);
}

// The whole block: wait for patch k (the block's `it`-th), repack it into
// pt, synchronize, and start the fetch of the block's next patch. On return
// every thread may read pt.
__device__ __forceinline__ void bx_patch_stage(const float* __restrict__ patches,
                                               const uint8_t* __restrict__ mask,
                                               int k, int k_next, int kq, int it,
                                               const BxCellLayout& lay,
                                               const BxCellSmem& sm,
                                               uint32_t bar) {
  const float* src;
  const uint8_t* msrc;
  if (lay.bulk_in) {
    bx_mbar_wait(bar, static_cast<uint32_t>(it & 1));
    src = sm.raw;
    msrc = sm.raw_mask;
  } else {
    src = patches + static_cast<size_t>(k) * lay.p_n * 3;
    msrc = mask + static_cast<size_t>(k) * lay.p_n;
  }
  const float nan = __int_as_float(0x7fc00000);
  for (int p = threadIdx.x; p < lay.p_n; p += blockDim.x) {
    const float x = src[3 * p], y = src[3 * p + 1], z = src[3 * p + 2];
    const float rho =
        msrc[p] ? __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y))) : nan;
    sm.pt[p] = make_float4(x, y, z, rho);
  }
  __syncthreads();
  if (lay.bulk_in && threadIdx.x == 0 && k_next < kq)
    bx_patch_fetch(patches, mask, k_next, lay, sm, bar);
}

// One warp: the candidates of ring q among the staged patch's points, in
// row order, into list[0 .. count); returns the count (the same in every
// lane).
__device__ __forceinline__ int bx_ring_list(const BxCellLayout& lay,
                                            const BxCellSmem& sm, int q,
                                            uint16_t* list) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float rho_r = sm.ring[q];
  const float z_r = sm.ring[lay.n_rings + q];
  const float wide2 = sm.ring[2 * lay.n_rings + q];
  int count = 0;
  // kBxListChunks x 32 points a step: their loads and tests are independent,
  // only the ballots' counts chain
  for (int base = 0; base < lay.p_n; base += 32 * kBxListChunks) {
    bool cand[kBxListChunks];
#pragma unroll
    for (int j = 0; j < kBxListChunks; ++j) {
      // no bounds check: rows past the patch are padding with rho = NaN
      const float4 q4 = sm.pt[base + 32 * j + lane];
      const float t = __fsub_rn(q4.w, rho_r);
      const float w = __fsub_rn(q4.z, z_r);
      cand[j] = __fadd_rn(__fmul_rn(t, t), __fmul_rn(w, w)) <= wide2;
    }
#pragma unroll
    for (int j = 0; j < kBxListChunks; ++j) {
      const unsigned ballot = __ballot_sync(kBxFullWarp, cand[j]);
      if (cand[j])
        list[count + __popc(ballot & below)] =
            static_cast<uint16_t>(base + 32 * j + lane);
      count += __popc(ballot);
    }
  }
  return count;
}

// The whole block: the lists of the rings [q0, q1) of one batch, one warp
// per ring in turn. Each warp also enters its ring's chunks of 32 list
// entries into the batch's table of units for bx_batch_hits (in the order
// the warps finish, which changes no result). `counts`, if not null,
// receives each ring's count for patch k ([K, n_rings] int32, for checks of
// the cull). The caller synchronizes the block before the lists are read.
__device__ __forceinline__ void bx_batch_lists(const BxCellLayout& lay,
                                               const BxCellSmem& sm, int q0,
                                               int q1, int k, int* counts) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int q = q0 + warp; q < q1; q += n_warps) {
    const int count = bx_ring_list(
        lay, sm, q, sm.list + static_cast<size_t>(q - q0) * lay.p_n);
    const int n_chunks = (count + 31) >> 5;
    int first = 0;
    if (lane == 0) {
      sm.len[q - q0] = count;
      if (counts) counts[static_cast<size_t>(k) * lay.n_rings + q] = count;
      first = atomicAdd(sm.n_units, n_chunks);
    }
    first = __shfl_sync(kBxFullWarp, first, 0);
    for (int c = lane; c < n_chunks; c += 32)
      sm.units[first + c] = (static_cast<uint32_t>(q - q0) << 16) | c;
  }
}

// The whole block: the exact test of every candidate of the rings [q0, q1)
// against every cell of its ring. A unit of work is one chunk of 32
// consecutive list entries of one ring, dealt to the warps in turn, so a
// long list spreads over the block. Lanes are candidates (each holds its
// point in registers), the ring's cells pass by in a loop, and the ballot of
// the test is the chunk's hit mask for that cell:
//     hits[(ring, chunk, cell of the ring)] bit j = list entry 32 chunk + j
//     lies within r of the cell.
// Bit order is list order is row order. The caller synchronizes the block
// before (the lists and the unit table) and after (the masks); thread 0
// then empties the unit table for the next batch.
__device__ __forceinline__ void bx_batch_hits(const BxCellLayout& lay,
                                              const BxCellSmem& sm, int q0,
                                              float r2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int n_units = *sm.n_units;
  for (int u = warp; u < n_units; u += n_warps) {
    const uint32_t unit = sm.units[u];
    const int ql = unit >> 16, chunk = unit & 0xffffu;
    const int len = sm.len[ql];
    // a lane past the list's end tests a NaN: no hit, whatever r2 is
    const int i = chunk * 32 + lane;
    float4 p = sm.pt[sm.list[static_cast<size_t>(ql) * lay.p_n +
                             min(i, len - 1)]];
    if (i >= len) p.x = __int_as_float(0x7fc00000);
    const float4* ring_cells =
        sm.cells + static_cast<size_t>(q0 + ql) * lay.ring_len;
    uint32_t* out =
        sm.hits + (static_cast<size_t>(ql) * lay.n_chunks + chunk) * lay.ring_len;
    // kBxCellGroup cells a step, without a branch, so that their loads and
    // distance chains overlap; lane 0 stores each test's ballot
    int c = 0;
    for (; c + kBxCellGroup <= lay.ring_len; c += kBxCellGroup) {
      float d2[kBxCellGroup];
#pragma unroll
      for (int j = 0; j < kBxCellGroup; ++j) {
        const float4 g = ring_cells[c + j];
        d2[j] = bx_sqdist(g.x - p.x, g.y - p.y, g.z - p.z);
      }
#pragma unroll
      for (int j = 0; j < kBxCellGroup; ++j) {
        const unsigned ballot = __ballot_sync(kBxFullWarp, d2[j] <= r2);
        if (lane == 0) out[c + j] = ballot;
      }
    }
    for (; c < lay.ring_len; ++c) {
      const float4 g = ring_cells[c];
      const unsigned ballot = __ballot_sync(
          kBxFullWarp, bx_sqdist(g.x - p.x, g.y - p.y, g.z - p.z) <= r2);
      if (lane == 0) out[c] = ballot;
    }
  }
}

// A lane's view of its cell's hits in a batch: cell c of the batch (clamped
// for lanes past the last cell, which get no chunks).
struct BxCellHits {
  const uint32_t* masks;  // masks[chunk * ring_len]: the chunk's hit mask
  const uint16_t* list;   // the ring's list
  int n_chunks;           // chunks that hold candidates

  __device__ BxCellHits(const BxCellLayout& lay, const BxCellSmem& sm, int c,
                        bool active) {
    const int ql = c / lay.ring_len;
    masks = sm.hits + static_cast<size_t>(ql) * lay.n_chunks * lay.ring_len +
            (c - ql * lay.ring_len);
    list = sm.list + static_cast<size_t>(ql) * lay.p_n;
    n_chunks = active ? (sm.len[ql] + 31) >> 5 : 0;
  }
};

// Host side: blocks for a persistent launch of `kernel`, as many as are
// resident at once with `smem` bytes of dynamic shared memory each (at most
// `work`). The opt-in for large dynamic shared memory is made once per
// device, up to the device's limit, and the occupancy of each (device, smem)
// is asked once and kept: a later launch pays for neither.
template <typename Kernel>
inline cudaError_t bx_persistent_grid(Kernel kernel, int threads, int smem,
                                      int work, int* grid) {
  struct Seen {
    int dev, smem, resident;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  int resident = 0;
  bool opted_in = false;
  for (const Seen& s : seen) {
    opted_in = opted_in || s.dev == dev;
    if (s.dev == dev && s.smem == smem) resident = s.resident;
  }
  if (resident == 0) {
    int sms = 0, optin = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (!opted_in) {
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - static_cast<int>(kBxSmemStatic));
      if (err != cudaSuccess) return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
    seen.push_back({dev, smem, resident});
  }
  *grid = work < resident ? work : resident;
  return cudaSuccess;
}
