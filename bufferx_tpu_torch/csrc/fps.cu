// K1: masked farthest point sampling, one thread-block cluster per cloud.
//
// Replaces the Pallas kernel bufferx_tpu/kernels/fps.py:_fps_kernel (:87,
// called through farthest_point_sampling_pallas :179). Semantics: the
// running min-distance field starts at +inf on valid points and -1 on padded
// ones; every round picks the argmax (lowest index on ties), records it and
// lowers the field by the squared distance to the pick.
//
// What bounds it: latency. A pair is 2000 dependent rounds, each a
// cloud-wide argmax; the bytes (0.8 MB per pair) and the arithmetic
// (~1.1 GFLOP) are nothing beside that, so the floor is rounds times one
// exchange between the SMs that share a cloud. Design: a cluster of kCluster
// blocks of kThreads threads owns one cloud. A thread keeps its points'
// coordinates and its slice of the min-distance field in registers (point
// p = (j * kCluster + rank) * kThreads + tid, so the prologue's reads are
// coalesced and p rises with j); the block keeps a copy of its coordinates in
// shared memory, so the round loop reads no global memory at all. Per
// round:
//   1. the thread-local update and argmax;
//   2. two warp reductions (max of an order-preserving 32-bit image of the
//      float, then min of the index among the lanes that hold it);
//   3. one __syncthreads, then the same two reductions over the warps'
//      winners in warp 0;
//   4. lanes 0..kCluster-1 of warp 0 send the block's winner {key, ~index,
//      x, y, z} into this block's slot in EVERY block of the cluster (itself
//      included) with st.async through distributed shared memory; each store
//      completes its bytes on the receiver's mbarrier;
//   5. every thread waits on its own block's mbarrier for the kCluster
//      messages of the round: the one cross-SM signal on the round's path,
//      one way, with no barrier that all threads of the cluster must join
//      (barrier.cluster in this place cost about twice as much per
//      exchange-only round on an H100, whatever the cluster size);
//   6. every thread reduces the kCluster slots itself and has the pick's
//      coordinates without a load from global memory; rank 0 writes out[i].
// Slots and mbarriers are double-buffered by round parity. A block can be
// one round ahead of a peer, never two: it sends round i+2 only after it has
// the peer's message of round i+1, which the peer sends after the
// __syncthreads that all its warps pass once they are done with round i.
// Value descending, index ascending holds across blocks because slots are
// compared as (key, ~index) and the larger wins. A last cluster barrier
// keeps every block resident until no peer can write into its shared memory.
//
// The entry's `exchange_only` mode runs the rounds with the __syncthreads of
// step 3 and steps 4 to 6 alone (no field, no reductions): its time is the
// latency floor of this design, which the smoke run measures beside the
// kernel.

#include "common.cuh"

#include <cooperative_groups.h>

#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

// 8 blocks is the largest cluster every launch may ask for. 256 threads was
// the fastest of 128..1024 within 3%: more threads make the block-level pass
// and the wake-up dearer, fewer leave each thread more points.
constexpr int kCluster = 8;                   // blocks per cloud
constexpr int kThreads = 256;                 // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPoints = 32768;
constexpr int kMaxPerThread = kMaxPoints / (kCluster * kThreads);
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0x7fffffffu;
static_assert(kCluster <= 8 && kThreads % 32 == 0 && kWarps <= 32, "shape");
static_assert(kMaxPerThread >= 1, "too many threads for 32768 points");

// Order-preserving image of a float: a > b  <=>  key(a) > key(b), for every
// value the field holds (-inf, -1, +0 and up, +inf).
__device__ __forceinline__ unsigned ordered_key(float v) {
  const unsigned u = __float_as_uint(v);
  return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) | 0x80000000u);
}

// Winner of (key descending, index ascending) over the warp, in every lane.
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& idx) {
  const unsigned top = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == top ? idx : kNoIndex);
  key = top;
}

// The address of this block's shared `addr` in block `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Asynchronous stores into a peer's shared memory that complete their bytes
// on the peer's mbarrier.
__device__ __forceinline__ void st_async_v4(uint32_t dst, uint32_t a,
                                            uint32_t b, uint32_t c, uint32_t d,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async_b32(uint32_t dst, uint32_t a,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];\n" ::"r"(dst),
      "r"(a), "r"(bar)
      : "memory");
}

template <int PT, bool kExchangeOnly>
__global__ void __launch_bounds__(kThreads, 1)
    fps_kernel(const float* __restrict__ xyz,      // [B, N, 3]
               const uint8_t* __restrict__ mask,   // [B, N], 0 or 1
               int n, int k, int32_t* __restrict__ out) {  // [B, K]
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kOwn = PT * kThreads;             // points of this block

  extern __shared__ float s_coord[];              // [3][kOwn]
  __shared__ unsigned s_wkey[32];
  __shared__ unsigned s_widx[32];
  // a block's message: {key, ~index, x, y} and z, 20 bytes
  constexpr uint32_t kRoundBytes = kCluster * 20;
  __shared__ __align__(16) uint4 s_msg[2][kCluster];
  __shared__ float s_msgz[2][kCluster];
  __shared__ __align__(8) unsigned long long s_bar[2];
  if (tid == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       bx_smem_u32(&s_bar[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  const uint8_t* m = mask + static_cast<size_t>(b) * n;
  int32_t* o = out + static_cast<size_t>(b) * k;

  float px[PT], py[PT], pz[PT], mind[PT];
  float bv = -INFINITY;
  unsigned bi = kNoIndex;
#pragma unroll
  for (int j = 0; j < PT; ++j) {
    const int p = (j * kCluster + static_cast<int>(rank)) * kThreads + tid;
    px[j] = py[j] = pz[j] = 0.0f;
    mind[j] = -INFINITY;              // slots past n can never win
    if (p < n) {
      px[j] = cloud[3 * p];
      py[j] = cloud[3 * p + 1];
      pz[j] = cloud[3 * p + 2];
      mind[j] = m[p] ? INFINITY : -1.0f;   // padded points sit at -1
    }
    s_coord[j * kThreads + tid] = px[j];
    s_coord[kOwn + j * kThreads + tid] = py[j];
    s_coord[2 * kOwn + j * kThreads + tid] = pz[j];
    if (mind[j] > bv) {               // p rises with j: strict > keeps the lowest
      bv = mind[j];
      bi = static_cast<unsigned>(p);
    }
  }
  // the peers' shared memory and mbarriers must be ready before the first
  // remote store
  cluster.sync();

  for (int i = 0; i < k; ++i) {
    const int par = i & 1;
    unsigned key = kExchangeOnly ? 0u : ordered_key(bv);
    unsigned idx = kExchangeOnly ? rank : bi;
    if (!kExchangeOnly) {
      warp_argmax(key, idx);
      if (lane == 0) {
        s_wkey[warp] = key;
        s_widx[warp] = idx;
      }
    }
    __syncthreads();
    const uint32_t bar = bx_smem_u32(&s_bar[par]);
    if (warp == 0) {
      if (!kExchangeOnly) {
        key = lane < kWarps ? s_wkey[lane] : 0u;
        idx = lane < kWarps ? s_widx[lane] : kNoIndex;
        warp_argmax(key, idx);
      }
      if (lane == 0) {
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
            "r"(kRoundBytes)
            : "memory");
      }
      if (lane < kCluster) {
        // the block's winner lives in this block: fetch its coordinates
        // from the shared copy (a block that owns no point in range sends
        // the key of -inf with no index, which loses to every real point)
        int slot = 0;
        if (idx < static_cast<unsigned>(n)) {
          const int p = static_cast<int>(idx);
          slot = (p / (kCluster * kThreads)) * kThreads + p % kThreads;
        }
        const uint32_t rbar = peer_addr(bar, lane);
        st_async_v4(peer_addr(bx_smem_u32(&s_msg[par][rank]), lane), key, ~idx,
                    __float_as_uint(s_coord[slot]),
                    __float_as_uint(s_coord[kOwn + slot]), rbar);
        st_async_b32(peer_addr(bx_smem_u32(&s_msgz[par][rank]), lane),
                     __float_as_uint(s_coord[2 * kOwn + slot]), rbar);
      }
    }
    bx_mbar_wait(bar, (i >> 1) & 1);       // this buffer's (i / 2)-th use

    uint4 win = s_msg[par][0];
    int from = 0;
#pragma unroll
    for (int r = 1; r < kCluster; ++r) {
      const uint4 v = s_msg[par][r];
      if (v.x > win.x || (v.x == win.x && v.y > win.y)) {
        win = v;
        from = r;
      }
    }
    const float4 sel = make_float4(__uint_as_float(win.z),
                                   __uint_as_float(win.w),
                                   s_msgz[par][from], 0.0f);
    if (rank == 0 && tid == 0)
      o[i] = static_cast<int32_t>(~win.y);
    if (kExchangeOnly) continue;

    bv = -INFINITY;
    bi = kNoIndex;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const float d = bx_sqdist(px[j] - sel.x, py[j] - sel.y, pz[j] - sel.z);
      mind[j] = fminf(mind[j], d);
      if (mind[j] > bv) {
        bv = mind[j];
        bi = static_cast<unsigned>(
            (j * kCluster + static_cast<int>(rank)) * kThreads + tid);
      }
    }
  }
  // no block may leave while a peer can still write into its slots
  cluster.sync();
}

template <int PT, bool kExchangeOnly>
cudaError_t launch(const float* xyz, const uint8_t* mask, int b, int n, int k,
                   int32_t* out, cudaStream_t stream) {
  auto kernel = fps_kernel<PT, kExchangeOnly>;
  const size_t smem = sizeof(float) * 3 * PT * kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xyz, mask, n, k, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The smallest power of two PT >= the points a thread must own.
template <int PT, bool kExchangeOnly>
cudaError_t dispatch(const float* xyz, const uint8_t* mask, int b, int n,
                     int k, int32_t* out, cudaStream_t stream) {
  if constexpr (PT > kMaxPerThread) {
    return cudaErrorInvalidValue;
  } else {
    if (n <= PT * kCluster * kThreads)
      return launch<PT, kExchangeOnly>(xyz, mask, b, n, k, out, stream);
    return dispatch<2 * PT, kExchangeOnly>(xyz, mask, b, n, k, out, stream);
  }
}

}  // namespace

// xyz [B, N, 3] f32, mask [B, N] bool (one byte, 0 or 1) -> out [B, K] int32.
// 1 <= N <= 32768. With exchange_only != 0 the rounds run the slot exchange
// and its waits alone (out is then meaningless): the design's latency floor.
extern "C" int bx_fps(const float* xyz, const uint8_t* mask, int b, int n,
                      int k, int32_t* out, int exchange_only,
                      cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      exchange_only ? dispatch<1, true>(xyz, mask, b, n, k, out, stream)
                    : dispatch<1, false>(xyz, mask, b, n, k, out, stream);
  return static_cast<int>(err);
}
