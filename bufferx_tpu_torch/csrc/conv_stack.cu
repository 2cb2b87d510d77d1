// K5: the fused 8-layer cylindrical conv stack (BatchNorm folded).
//
// Replaces the Pallas kernel bufferx_tpu/kernels/conv_pallas.py: _kernel
// (:124, called through cyl_conv_stack_fused :235). Per patch: the input
// [3, 7, 20, 16] becomes a 7 x 20 map of 48 channels (channel dr*16 + m);
// then eight 3x3 convs (ci, co) = (48,64) (64,64) (64,128) (128,128)
// (128,64) (64,64) (64,32) (32,32) that wrap azimuth and zero-pad elevation.
// Products are bf16, sums f32; bias is added in f32; every layer but the
// last takes a ReLU; activations round to bf16 between layers; the output
// is the last layer's bf16 value as f32, out[k, e, a, 32].
//
// What bounds it: operations. The main path's call does 3000 patches x
// 140 positions x 9 taps x 47104 (ci*co summed over layers) x 2 = 3.56e11
// flops, 0.36 ms at the bf16 tensor-core peak, against 80 MB of input and
// 54 MB of output (0.04 ms at 3.35 TB/s). Only wgmma reaches that peak, and
// only when both operands wait in shared memory, so the design feeds the
// tensor cores from shared memory alone:
//
// * One persistent block per SM (512 threads) walks over patches. Three
//   consumer warpgroups own one 64-row tile each of the 192-row implicit
//   GEMM (140 rows are real); the fourth warpgroup gives its registers away
//   (setmaxnreg) and one of its threads is the weight producer.
// * The activation map lives in shared memory across all eight layers,
//   ping-ponged between two buffers. A buffer row is one cell of the 9 x 22
//   padded map (elevation rows 0 and 8 stay zero, azimuth columns 0 and 21
//   repeat azimuths 19 and 0, row 0 is a guard), so output row
//   m = e * 22 + a' reads tap (de, da) at buffer row m + 22 de + da and each
//   tap is a plain matrix. A is read by wgmma through a shared-memory
//   descriptor, not from registers: the buffers are channel-chunked,
//   [ci/8][240 rows][8] bf16 without swizzle, where eight consecutive rows of
//   one chunk are one contiguous 128-byte core matrix at ANY row start
//   (16-byte aligned), so a tap's row shift is just another descriptor start
//   address (stride between 8-row groups 128 B, between the two k-halves of
//   a k16 step the chunk stride). That costs no register and no ldmatrix
//   instruction per tap, which the register route would.
// * Weights come packed per (layer, tap) as [ci/8][co][8] bf16 (the same
//   core-matrix order, B as its transpose with k contiguous), so a 1-D
//   cp.async.bulk lands a tile ready for wgmma. The producer keeps a ring of
//   three 32 KB stages in flight, each one to nine taps of a layer, completing
//   on an mbarrier per stage; consumers release a stage once the wgmma group
//   that read it has retired (one group stays in flight). The producer runs
//   ahead across layers and patches: weights do not depend on activations.
// * The epilogue adds the bias in f32, applies the ReLU, rounds to bf16 and
//   writes the next layer's buffer (with the two wrap columns) from the
//   accumulator registers; fence.proxy.async and one named barrier over the
//   consumers separate a layer's generic-proxy writes from the next layer's
//   wgmma reads. Padding rows of the tiles are never stored. The next patch's
//   input is fetched into registers before the last layer and staged
//   (f32 -> bf16) into buffer 0 while that layer's wgmma group, which reads
//   buffer 1, is in flight.
//
// Shared memory: 2 x 61440 (activations) + 3 x 32768 (ring) + 4096 (bias) +
// barriers = 225344 B of the 232448 a block may take.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kEle = 7;
constexpr int kAzi = 20;
constexpr int kW = kAzi + 2;              // padded azimuth width
constexpr int kRows = 240;                // rows read: up to 191 + 2 * kW + 2
constexpr int kChunkBytes = kRows * 16;   // one 8-channel chunk of a buffer
constexpr int kActBytes = 16 * kChunkBytes;
constexpr int kStages = 3;
constexpr int kStageBytes = 32768;
constexpr int kLayers = 8;
constexpr int kLanes = 128;               // columns of the bias matrix
constexpr int kConsumers = 384;           // three warpgroups
constexpr int kThreads = 512;
constexpr int kRingOff = 2 * kActBytes;
constexpr int kBiasOff = kRingOff + kStages * kStageBytes;
constexpr int kBarOff = kBiasOff + kLayers * kLanes * 4;
constexpr int kSmemBytes = kBarOff + 2 * kStages * 8;
constexpr int kInPerPatch = 3 * kEle * kAzi * 16;
constexpr int kInItems = kInPerPatch / 8;           // 8 floats each
constexpr int kInPerThread = (kInItems + kConsumers - 1) / kConsumers;
constexpr int kOutDim = 32;
// registers a thread after the role split: 128 x 24 + 384 x 160 = 64512 of
// the SM's 65536 (at 152 for the consumers ptxas spilled 32 bytes)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;

// channels in and out, and the taps that share one ring stage, per layer
template <int L> struct Layer;
template <> struct Layer<0> { static constexpr int ci = 48, co = 64, taps = 3; };
template <> struct Layer<1> { static constexpr int ci = 64, co = 64, taps = 3; };
template <> struct Layer<2> { static constexpr int ci = 64, co = 128, taps = 2; };
template <> struct Layer<3> { static constexpr int ci = 128, co = 128, taps = 1; };
template <> struct Layer<4> { static constexpr int ci = 128, co = 64, taps = 2; };
template <> struct Layer<5> { static constexpr int ci = 64, co = 64, taps = 3; };
template <> struct Layer<6> { static constexpr int ci = 64, co = 32, taps = 3; };
template <> struct Layer<7> { static constexpr int ci = 32, co = 32, taps = 9; };

// offset of layer L in the packed weights, in elements
template <int L> struct PackedOff {
  static constexpr int value =
      PackedOff<L - 1>::value + 9 * Layer<L - 1>::ci * Layer<L - 1>::co;
};
template <> struct PackedOff<0> { static constexpr int value = 0; };

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// 1-D bulk copy global -> shared, completing `bytes` on the mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int NR>
__device__ __forceinline__ void fence_operands(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle, k contiguous: core matrices of
// 8 rows x 16 bytes, contiguous (128 B); `kgap` bytes between the two core
// matrices of a k16 step, 128 B between 8-row groups.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t kgap) {
  const uint64_t lbo = kgap >> 4, sbo = 128 >> 4;
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) | (lbo << 16) |
         (sbo << 32);
}

// D (+)= A @ B for one 64 x N x 16 tile, both operands through descriptors,
// bf16 in, f32 accumulate; D is overwritten when accumulate == 0.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, int accumulate) {
  if constexpr (N == 32) wgmma_n32(d, a, b, accumulate);
  else if constexpr (N == 64) wgmma_n64(d, a, b, accumulate);
  else wgmma_n128(d, a, b, accumulate);
}

// ---- consumers ------------------------------------------------------------

struct Ring {
  uint32_t base;    // shared address of stage 0
  uint32_t full;    // shared address of full[0]; empty[s] is full[s] + 8 * kStages
  int stage;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// A consumer thread's share of a patch's input: items of 8 consecutive
// floats (one cell, half of one radial slice's 16 channels).
struct InputRegs {
  float4 v[kInPerThread][2];
};

__device__ __forceinline__ void load_input(const float* __restrict__ xk,
                                           InputRegs& r) {
#pragma unroll
  for (int q = 0; q < kInPerThread; ++q) {
    // every register is written on every call (a thread past the last item
    // re-reads that item and never stores it), so none stays live across
    // the layers
    const int it = min(static_cast<int>(threadIdx.x) + q * kConsumers,
                       kInItems - 1);
    const float4* src = reinterpret_cast<const float4*>(xk + it * 8);
    r.v[q][0] = __ldg(src);
    r.v[q][1] = __ldg(src + 1);
  }
}

// Rounds the fetched input to bf16 into buffer 0: channel dr*16 + m of cell
// (e + 1, a + 1), and the wrap columns.
__device__ __forceinline__ void store_input(const InputRegs& r,
                                            unsigned char* act0) {
#pragma unroll
  for (int q = 0; q < kInPerThread; ++q) {
    const int it = threadIdx.x + q * kConsumers;
    if (it < kInItems) {
      const int half = it & 1;
      const int a = (it >> 1) % kAzi;
      const int e = (it / (2 * kAzi)) % kEle;
      const int dr = it / (2 * kAzi * kEle);
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(r.v[q][0].x, r.v[q][0].y);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(r.v[q][0].z, r.v[q][0].w);
      const __nv_bfloat162 p2 = __floats2bfloat162_rn(r.v[q][1].x, r.v[q][1].y);
      const __nv_bfloat162 p3 = __floats2bfloat162_rn(r.v[q][1].z, r.v[q][1].w);
      uint4 pk;
      pk.x = *reinterpret_cast<const uint32_t*>(&p0);
      pk.y = *reinterpret_cast<const uint32_t*>(&p1);
      pk.z = *reinterpret_cast<const uint32_t*>(&p2);
      pk.w = *reinterpret_cast<const uint32_t*>(&p3);
      unsigned char* o = act0 + (dr * 2 + half) * kChunkBytes +
                         (1 + (e + 1) * kW + a + 1) * 16;
      *reinterpret_cast<uint4*>(o) = pk;
      if (a == 0) *reinterpret_cast<uint4*>(o + kAzi * 16) = pk;
      if (a == kAzi - 1) *reinterpret_cast<uint4*>(o - kAzi * 16) = pk;
    }
  }
}

// One layer for one consumer warpgroup: rows m0 .. m0 + 63 of the implicit
// GEMM from `in` (shared address) to `out_act` (shared), or to `gout`
// (global, this patch) for the last layer. The last layer reads buffer 1 and
// writes no buffer, so while its wgmma group runs the thread stages the next
// patch's input `xin` into buffer 0 (`out_act`).
template <int L>
__device__ __forceinline__ void conv_layer(uint32_t in, unsigned char* out_act,
                                           Ring& ring, const float* s_bias,
                                           float* __restrict__ gout, int m0,
                                           const InputRegs* xin = nullptr) {
  constexpr int CI = Layer<L>::ci, CO = Layer<L>::co, G = Layer<L>::taps;
  constexpr bool kLast = L == kLayers - 1;
  constexpr int kTapBytes = CI * CO * 2;
  static_assert(G * kTapBytes <= kStageBytes, "stage overflow");
  const int lane = threadIdx.x & 31;
  const int wq = (threadIdx.x >> 5) & 3;        // warp of the warpgroup

  float acc[CO / 2];
  fence_operands(acc);
  int held = 0;                                 // stage of the group in flight
#pragma unroll 1
  for (int t0 = 0; t0 < 9; t0 += G) {
    bx_mbar_wait(ring.full + 8 * ring.stage, ring.phase);
    wgmma_fence();
    const uint32_t wbase = ring.base + ring.stage * kStageBytes;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int tap = t0 + g;
      if (tap < 9) {
        const int shift = (tap / 3) * kW + tap % 3;
        const uint32_t a0 = in + (m0 + shift) * 16;
        const uint32_t b0 = wbase + g * kTapBytes;
#pragma unroll
        for (int kc = 0; kc < CI / 16; ++kc)
          wgmma<CO>(acc, smem_desc(a0 + kc * 2 * kChunkBytes, kChunkBytes),
                    smem_desc(b0 + kc * 2 * CO * 16, CO * 16),
                    (tap | kc) != 0);
      }
    }
    wgmma_commit();
    if (t0 > 0) {
      wgmma_wait<1>();                          // the group before this one
      if (lane == 0) mbar_arrive(ring.full + 8 * (kStages + held));
    }
    held = ring.stage;
    ring.advance();
  }
  if (kLast) store_input(*xin, out_act);
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(ring.full + 8 * (kStages + held));
  fence_operands(acc);

  // epilogue: the thread holds rows r and r + 8 of its warp's 16, columns
  // 8j + 2t and 8j + 2t + 1
  const int t = lane & 3;
  const float* bias = s_bias + L * kLanes + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wq * 16 + (lane >> 2) + 8 * h;
    const int e = m / kW;
    const int ap = m - e * kW;
    if (e >= kEle || ap < 1 || ap > kAzi) continue;      // padding rows
    unsigned char* orow = out_act + (m + kW + 1) * 16 + t * 4;   // unused if kLast
    float* grow = gout + (e * kAzi + ap - 1) * kOutDim + 2 * t;
#pragma unroll
    for (int j = 0; j < CO / 8; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(bias + 8 * j);
      float v0 = __fadd_rn(acc[4 * j + 2 * h], bj.x);
      float v1 = __fadd_rn(acc[4 * j + 2 * h + 1], bj.y);
      if (!kLast) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      const __nv_bfloat162 pv = __floats2bfloat162_rn(v0, v1);
      if (kLast) {
        *reinterpret_cast<float2*>(grow + 8 * j) = __bfloat1622float2(pv);
      } else {
        unsigned char* o = orow + j * kChunkBytes;
        *reinterpret_cast<__nv_bfloat162*>(o) = pv;
        if (ap == 1)        // azimuth 0 is also the right wrap column
          *reinterpret_cast<__nv_bfloat162*>(o + kAzi * 16) = pv;
        if (ap == kAzi)     // azimuth 19 is also the left wrap column
          *reinterpret_cast<__nv_bfloat162*>(o - kAzi * 16) = pv;
      }
    }
  }
  if (!kLast) {
    fence_proxy_async();    // generic-proxy writes before the next wgmma reads
    consumer_barrier();
  }
}

// ---- producer -------------------------------------------------------------

template <int L>
__device__ __forceinline__ void produce_layer(const unsigned short* wp,
                                              Ring& ring) {
  constexpr int kTapElems = Layer<L>::ci * Layer<L>::co;
  constexpr int G = Layer<L>::taps;
#pragma unroll 1
  for (int t0 = 0; t0 < 9; t0 += G) {
    const int taps = 9 - t0 < G ? 9 - t0 : G;
    const uint32_t bytes = static_cast<uint32_t>(taps) * kTapElems * 2;
    const uint32_t full = ring.full + 8 * ring.stage;
    bx_mbar_wait(full + 8 * kStages, ring.phase ^ 1u);    // stage released
    mbar_expect_tx(full, bytes);
    bulk_copy(ring.base + ring.stage * kStageBytes,
              wp + PackedOff<L>::value + t0 * kTapElems, bytes, full);
    ring.advance();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv_stack_kernel(const float* __restrict__ x,            // [K, 3, 7, 20, 16]
                  const unsigned short* __restrict__ wp,  // packed bf16
                  const float* __restrict__ b,            // [8, 128]
                  int kq, float* __restrict__ out) {      // [K, 7, 20, 32]
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* act0 = smem;
  unsigned char* act1 = smem + kActBytes;
  float* s_bias = reinterpret_cast<float*>(smem + kBiasOff);
  const int tid = threadIdx.x;

  // zero both activation buffers once: the zero rows and the channels past a
  // layer's width are never written afterwards
  uint4* z = reinterpret_cast<uint4*>(smem);
  for (int i = tid; i < 2 * kActBytes / 16; i += kThreads)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kLayers * kLanes; i += kThreads) s_bias[i] = b[i];
  Ring ring;
  ring.base = bx_smem_u32(smem + kRingOff);
  ring.full = bx_smem_u32(smem + kBarOff);
  ring.stage = 0;
  ring.phase = 0u;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);                         // the producer
      mbar_init(ring.full + 8 * (kStages + s), kConsumers / 32);  // each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- the weight producer: one thread, the rest give up their registers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      for (int k = blockIdx.x; k < kq; k += gridDim.x) {
        produce_layer<0>(wp, ring);
        produce_layer<1>(wp, ring);
        produce_layer<2>(wp, ring);
        produce_layer<3>(wp, ring);
        produce_layer<4>(wp, ring);
        produce_layer<5>(wp, ring);
        produce_layer<6>(wp, ring);
        produce_layer<7>(wp, ring);
      }
    }
  } else {
    // ---- three consumer warpgroups, one 64-row tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int m0 = (tid >> 7) * 64;
    const uint32_t a0 = bx_smem_u32(act0);
    const uint32_t a1 = bx_smem_u32(act1);
    InputRegs xin;
    load_input(x + static_cast<size_t>(blockIdx.x) * kInPerPatch, xin);
    store_input(xin, act0);
    for (int k = blockIdx.x; k < kq; k += gridDim.x) {
      fence_proxy_async();      // the staged input, before layer 0's wgmma
      consumer_barrier();
      conv_layer<0>(a0, act1, ring, s_bias, nullptr, m0);
      conv_layer<1>(a1, act0, ring, s_bias, nullptr, m0);
      conv_layer<2>(a0, act1, ring, s_bias, nullptr, m0);
      conv_layer<3>(a1, act0, ring, s_bias, nullptr, m0);
      conv_layer<4>(a0, act1, ring, s_bias, nullptr, m0);
      conv_layer<5>(a1, act0, ring, s_bias, nullptr, m0);
      conv_layer<6>(a0, act1, ring, s_bias, nullptr, m0);
      // fetch the next patch while the last layer runs (after the last
      // patch, the same one again: staged, never used); buffer 0 is free
      // now that layer 6 has read it
      const int step = static_cast<int>(gridDim.x);
      const int kn = k + step < kq ? k + step : k;
      load_input(x + static_cast<size_t>(kn) * kInPerPatch, xin);
      conv_layer<7>(a1, act0, ring, s_bias,
                    out + static_cast<size_t>(k) * kEle * kAzi * kOutDim, m0,
                    &xin);
    }
  }
}

}  // namespace

// x [K, 3, 7, 20, 16] f32, wp: the folded weights packed per (layer, tap) as
// [ci/8][co][8] bf16 (423936 elements, see pack_cyl_weights), b [8, 128] f32
// -> out [K, 7, 20, 32] f32.
extern "C" int bx_conv_stack(const float* x, const unsigned short* wp,
                             const float* b, int kq, float* out,
                             cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conv_stack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = kq < sms ? kq : sms;
  conv_stack_kernel<<<grid, kThreads, kSmemBytes, stream>>>(x, wp, b, kq, out);
  return static_cast<int>(cudaGetLastError());
}
