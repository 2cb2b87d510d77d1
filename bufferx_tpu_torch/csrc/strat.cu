// K2: fused multi-radius stratified ball query, one launch for a batch of
// clouds.
//
// Replaces the Pallas kernel bufferx_tpu/kernels/strat_pallas.py:_kernel
// (:104, called through ball_query_stratified_multi :137). A cloud's N points
// are L = N/S strips of S slots (point li*S + s is strip li, slot s). For
// every cloud c, centre k, slot s and radius r it gives, per coordinate x,
//     min over li of ((d2[c, k, li*S+s] <= r2[c, r] ? rank : L) << 24)
//                    + q[c, x, li, s],        rank = (li - off[c, k, s]) mod L:
// the first in-radius point in cyclic order from a random offset wins, and
// its 24-bit quantized coordinate rides in the low bits of the packed int32.
// The result is integer: bit-exact against the plain version.
//
// What bounds it: bytes. d2 is read once, [1500, 30208] f32 = 181 MB a cloud
// on the main path (54 us at 3.35 TB/s), against 27.6 MB of output and 3 MB
// of offsets; q is 362 KB a cloud.
//
// Design.
// * One winner, then one look-up. The ranks of a slot's strips are distinct,
//   so the three coordinates' minima are taken at the same strip. The loop
//   over li keeps, per radius, one signed key that orders the strips by rank,
//       key = int(0x80000000 + 2 (li - off))   (wrapping: negative from li = off
//       on, positive and even before it)
//   which costs one add per element and a compare, a select and a min per
//   radius; INT_MAX, odd and so no strip's key, stands for "no hit". q is
//   touched after the loop, 3 R times per (centre, slot): the winner's
//   coordinates, or for a slot without a hit the minimum of q over its
//   strips, kept per (cloud, slot) in shared memory. The first version of this
//   kernel added q inside the loop: 3 loads, 9 adds and 9 minima an element,
//   and every block re-read its 90 KB of q through L2 for every centre.
// * A cloud dimension and an even deal. The work is C x ceil(S / 64) x K units
//   of (cloud, tile of 64 slots, centre), dealt in equal runs over as many
//   blocks as are resident, so one cloud fills the card as sixteen do. A block
//   brings its [3, L, 64] tile of q into shared memory once per (cloud, tile)
//   of its run (45 KB at L = 59) and looks the winners up there.
// * d2 by the consumers' own loads. A warp takes a unit; a lane owns two
//   neighbouring slots and loads 8 bytes a strip (256 contiguous bytes a
//   warp), eight strips' loads in flight before the first is used, with 24
//   warps an SM. The keys stay in registers; stores are 8-byte, 256 bytes a
//   warp and row of [C, R, 3, K, S].
// * Ragged edges: a last tile narrower than 64 loads and stores only its
//   width; S not a multiple of 4 (or unaligned tensors) takes the same code
//   on 4-byte loads and stores; L up to 127 is only a longer loop.
//
// Tried and dropped (tools/bench_strat.py, an NVIDIA H100 80GB HBM3 at a
// 700 W limit, PERF.md section 6): d2 by cp.async.bulk into a ring of
// shared-memory stages, one copy per strip of a tile, completing mbarriers,
// with a producer warp. At 256- and 512-byte runs the copies come at a fixed
// rate of about 3.5 a nanosecond over the card, whatever their size: 1.69 ms
// (tiles of 128 slots) and 3.09 ms (64) at C = 16 against 1.22 ms for plain
// loads. Tiles of 128 slots (16 bytes a lane) hold more registers, so fewer
// warps are resident: 1.58 ms. The winners' q read through L2 instead of from
// a tile in shared memory: 1.32 ms, and no faster for one cloud.
//
// Measured (tools/bench_strat.py and chip_smoke.py, same card; launches back
// to back, so that the wrapper's host time does not count): one cloud, R = 3,
// 0.093-0.104 ms against a bound of 0.063 ms, where the first version of this
// kernel takes 0.112 ms in the same run; one pair (C = 2) 0.164-0.177 ms
// against 0.127; a batch of 8 pairs (C = 16) 1.18-1.20 ms against 1.014 for
// all three radii and 1.10-1.11 ms against 0.926 for phase 1's one. PERF.md
// section 6 has every shape, also timed as a single launch.

#include "common.cuh"

#include <climits>
#include <mutex>

namespace {

constexpr int kQBits = 24;
constexpr int kNoHit = INT_MAX;
constexpr int kMaxDevices = 64;
constexpr int kSlots = 2;            // slots a lane
constexpr int kTile = 32 * kSlots;   // slots a tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLoadsInFlight = 8;    // strips a lane loads before it uses them

struct StratParams {
  const float* d2;        // [C] x [K, L*S], clouds d2_cloud_stride apart
  const int32_t* off;     // [C, K, S]
  const int32_t* q;       // [C, 3, L, S]
  const float* radii2;    // [C, R]
  int32_t* out;           // [C, R, 3, K, S]
  long long d2_cloud_stride;
  long long units;        // C * n_tiles * K
  int c_n, kq, l, s_n;
  int n_tiles;            // ceil(S / kTile)
};

// One strip's distances of a lane: the keys of in-radius slots enter the
// running minima.
template <int R>
__device__ __forceinline__ void strat_step(int (&best)[R][kSlots],
                                           const unsigned (&kj)[kSlots],
                                           const float (&r2)[R],
                                           const float (&d)[kSlots], int li) {
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int key = static_cast<int>(kj[j] + 2u * static_cast<unsigned>(li));
#pragma unroll
    for (int r = 0; r < R; ++r)
      best[r][j] = min(best[r][j], d[j] <= r2[r] ? key : kNoHit);
  }
}

// VECTOR: 8-byte loads and stores (S % 4 == 0, aligned tensors); else 4-byte.
template <int R, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
    strat_kernel(const StratParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* qmin = reinterpret_cast<int32_t*>(smem);   // [3][kTile]
  int32_t* qtile = qmin + 3 * kTile;                   // [3][L][kTile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const long long u0 = p.units * blockIdx.x / gridDim.x;
  const long long u1 = p.units * (blockIdx.x + 1) / gridDim.x;
  for (long long u = u0; u < u1;) {
    // a segment: consecutive centres of one (cloud, slot tile)
    const int combo = static_cast<int>(u / p.kq);
    const int k0 = static_cast<int>(u - static_cast<long long>(combo) * p.kq);
    const long long left = u1 - u;
    const int n_seg = left < p.kq - k0 ? static_cast<int>(left) : p.kq - k0;
    const int c = combo / p.n_tiles;
    const int s0 = (combo - c * p.n_tiles) * kTile;
    const int width = min(kTile, p.s_n - s0);

    __syncthreads();   // every warp is done with the last segment's q
    const int32_t* qg = p.q + static_cast<size_t>(c) * 3 * p.l * p.s_n + s0;
    for (int i = threadIdx.x; i < 3 * p.l * kTile; i += kThreads) {
      const int row = i / kTile, col = i % kTile;   // row = coordinate * L + li
      qtile[i] =
          col < width ? __ldg(qg + static_cast<size_t>(row) * p.s_n + col) : 0;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {
      const int32_t* qc = qtile + (i / kTile) * p.l * kTile + i % kTile;
      int m = INT_MAX;
#pragma unroll 8
      for (int li = 0; li < p.l; ++li) m = min(m, qc[li * kTile]);
      qmin[i] = m;
    }
    __syncthreads();

    const int slot = kSlots * lane;
    // with vector loads the width is even: a lane's slots are both inside the
    // tile or both outside
    bool live[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) live[j] = slot + j < width;
    float r2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) r2[r] = p.radii2[c * R + r];
    const float* d2c = p.d2 + static_cast<size_t>(c) * p.d2_cloud_stride + s0;

    for (int i = warp; live[0] && i < n_seg; i += kWarps) {
      const int k = k0 + i;
      const size_t row = static_cast<size_t>(c) * p.kq + k;
      int o[kSlots];
      if (VECTOR) {
        const int2 ov =
            *reinterpret_cast<const int2*>(p.off + row * p.s_n + s0 + slot);
        o[0] = ov.x;
        o[1] = ov.y;
      } else {
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
          o[j] = live[j] ? __ldg(p.off + row * p.s_n + s0 + slot + j) : 0;
      }
      unsigned kj[kSlots];
      int best[R][kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        kj[j] = 0x80000000u - 2u * static_cast<unsigned>(o[j]);
#pragma unroll
        for (int r = 0; r < R; ++r) best[r][j] = kNoHit;
      }

      const float* g = d2c + static_cast<size_t>(k) * p.l * p.s_n + slot;
      if (VECTOR) {
        // kLoadsInFlight strips' loads leave before the first is used
        int li = 0;
        for (; li + kLoadsInFlight <= p.l; li += kLoadsInFlight) {
          float2 dv[kLoadsInFlight];
#pragma unroll
          for (int t = 0; t < kLoadsInFlight; ++t)
            dv[t] = __ldg(reinterpret_cast<const float2*>(
                g + static_cast<size_t>(li + t) * p.s_n));
#pragma unroll
          for (int t = 0; t < kLoadsInFlight; ++t) {
            const float d[kSlots] = {dv[t].x, dv[t].y};
            strat_step<R>(best, kj, r2, d, li + t);
          }
        }
        for (; li < p.l; ++li) {
          const float2 dv = __ldg(reinterpret_cast<const float2*>(
              g + static_cast<size_t>(li) * p.s_n));
          const float d[kSlots] = {dv.x, dv.y};
          strat_step<R>(best, kj, r2, d, li);
        }
      } else {
        const float inf = __int_as_float(0x7f800000);
#pragma unroll 4
        for (int li = 0; li < p.l; ++li) {
          float d[kSlots];
#pragma unroll
          for (int j = 0; j < kSlots; ++j)
            d[j] = live[j] ? __ldg(g + static_cast<size_t>(li) * p.s_n + j) : inf;
          strat_step<R>(best, kj, r2, d, li);
        }
      }

      // decode the winners and store [C, R, 3, K, S]
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int li_w[kSlots], high[kSlots];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const bool hit = best[r][j] != kNoHit;
          const int li = static_cast<int>(
              (static_cast<unsigned>(best[r][j]) - kj[j]) >> 1);
          int rank = li - o[j];
          if (rank < 0) rank += p.l;
          li_w[j] = hit ? li : -1;
          high[j] = (hit ? rank : p.l) << kQBits;
        }
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          int v[kSlots];
#pragma unroll
          for (int j = 0; j < kSlots; ++j) {
            int low = 0;
            if (live[j])
              low = li_w[j] >= 0
                        ? qtile[(x * p.l + li_w[j]) * kTile + slot + j]
                        : qmin[x * kTile + slot + j];
            v[j] = high[j] + low;
          }
          int32_t* dst = p.out +
                         ((static_cast<size_t>(c) * R + r) * 3 + x) * p.kq *
                             p.s_n +
                         static_cast<size_t>(k) * p.s_n + s0 + slot;
          if (VECTOR) {
            *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
          } else {
#pragma unroll
            for (int j = 0; j < kSlots; ++j)
              if (live[j]) dst[j] = v[j];
          }
        }
      }
    }
    u += n_seg;
  }
}

// Sizes the grid from the work and the resident blocks, and launches.
template <int R, bool VECTOR>
cudaError_t launch(StratParams p, cudaStream_t stream) {
  // per device, asked once: SMs; per device and L: resident blocks an SM
  static std::mutex mu;
  static int sms[kMaxDevices], per_sm[kMaxDevices], asked_l[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const size_t smem = (3 + static_cast<size_t>(3) * p.l) * kTile * 4;
  auto kernel = strat_kernel<R, VECTOR>;
  std::lock_guard<std::mutex> lock(mu);
  if (sms[dev] == 0) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  if (asked_l[dev] != p.l) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm[dev] < 1) return cudaErrorInvalidConfiguration;
    asked_l[dev] = p.l;
  }
  p.n_tiles = (p.s_n + kTile - 1) / kTile;
  p.units = static_cast<long long>(p.c_n) * p.n_tiles * p.kq;
  const long long resident = static_cast<long long>(sms[dev]) * per_sm[dev];
  const int grid = static_cast<int>(p.units < resident ? p.units : resident);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_r(const StratParams& p, bool aligned, cudaStream_t stream) {
  return aligned ? launch<R, true>(p, stream) : launch<R, false>(p, stream);
}

}  // namespace

// d2: C clouds of [K, L*S] f32, d2_cloud_stride elements apart; off
// [C, K, S] i32; q [C, 3, L, S] i32; radii2 [C, R] f32 -> out [C, R, 3, K, S]
// i32. 1 <= R <= 4, 1 <= L < 128.
extern "C" int bx_strat(const float* d2, const int32_t* off, const int32_t* q,
                        const float* radii2, int c_n, long long d2_cloud_stride,
                        int num_r, int kq, int l, int s_n, int32_t* out,
                        cudaStream_t stream) {
  if (c_n < 1 || kq < 1 || l < 1 || l > 127 || s_n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  StratParams p = {};
  p.d2 = d2;
  p.off = off;
  p.q = q;
  p.radii2 = radii2;
  p.out = out;
  p.d2_cloud_stride = d2_cloud_stride;
  p.c_n = c_n;
  p.kq = kq;
  p.l = l;
  p.s_n = s_n;
  auto aligned8 = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 7u) == 0;
  };
  // even row starts and an even cloud stride keep every 8-byte access aligned
  const bool aligned = s_n % 4 == 0 && d2_cloud_stride % 2 == 0 &&
                       aligned8(d2) && aligned8(off) && aligned8(out);
  cudaError_t err;
  switch (num_r) {
    case 1: err = launch_r<1>(p, aligned, stream); break;
    case 2: err = launch_r<2>(p, aligned, stream); break;
    case 3: err = launch_r<3>(p, aligned, stream); break;
    case 4: err = launch_r<4>(p, aligned, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
