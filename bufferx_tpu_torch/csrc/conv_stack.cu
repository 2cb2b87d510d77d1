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
// 54 MB of output (0.04 ms at 3.35 TB/s). Design: one block (8 warps) per
// patch; the activation map lives in shared memory across all eight layers,
// ping-ponged between two buffers of 208 rows x 136 bf16 (113 KB in all,
// two blocks per SM), so device memory sees one input read and one output
// write per patch. A buffer row is one cell of the 9 x 22 padded map:
// elevation rows 0 and 8 stay zero, azimuth columns 0 and 21 repeat
// azimuths 19 and 0 (the wrap), and row 0 is a guard. Output position
// m = e * 22 + a' (a' = a + 1) reads tap (de, da) from buffer row
// m + 22 de + da, so each tap of a 16-row tile is a plain strided matrix:
// the conv is an implicit GEMM [160 x 9ci] @ [9ci x co] per layer on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), 160 rows of which 140 are
// real. The row stride of 136 bf16 (68 words, 4 mod 32) makes the fragment
// loads conflict-free. Folded weights [5328, 128] bf16 (1.4 MB) are read
// from global memory, where they stay in L2 for all blocks; each warp loads
// a B fragment once per k-step and reuses it over its 5 or 10 row tiles.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kEle = 7;
constexpr int kAzi = 20;
constexpr int kW = kAzi + 2;        // padded azimuth width
constexpr int kMTiles = 10;         // 160 output rows m = e * kW + a'
constexpr int kRows = 208;          // rows read: up to 159 + 2 * kW + 2 = 205
constexpr int kLd = 136;            // bf16 per buffer row
constexpr int kLanes = 128;         // columns of the packed weight matrix
constexpr int kThreads = 256;
constexpr int kBufElems = kRows * kLd;
constexpr size_t kSmemBytes = 2 * sizeof(__nv_bfloat16) * kBufElems;
constexpr int kInPerPatch = 3 * kEle * kAzi * 16;
constexpr int kOutDim = 32;

__device__ __forceinline__ int cell_row(int eh, int ah) {
  return 1 + eh * kW + ah;
}

// D += A @ B for one 16x8x16 tile: A row-major, B column-major, bf16 in,
// f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(const unsigned short* p, int stride) {
  return static_cast<uint32_t>(__ldg(p)) |
         (static_cast<uint32_t>(__ldg(p + stride)) << 16);
}

// One layer: in (shared) -> out_act (shared), or -> gout (global) when
// kLast. Warps split the co/8 column tiles first, then the 10 row tiles.
template <int CI, int CO, bool kLast>
__device__ __forceinline__ void conv_layer(
    const __nv_bfloat16* __restrict__ in, __nv_bfloat16* __restrict__ out_act,
    const unsigned short* __restrict__ w, int w_off,
    const float* __restrict__ bias, float* __restrict__ gout) {
  constexpr int kNTiles = CO / 8;
  constexpr int kWarpsN = kNTiles < 8 ? kNTiles : 8;
  constexpr int kWarpsM = 8 / kWarpsN;
  constexpr int NT = kNTiles / kWarpsN;
  constexpr int MT = kMTiles / kWarpsM;
  static_assert(CI % 16 == 0 && CO % 8 == 0, "tile shapes");
  static_assert(8 % kWarpsN == 0 && kMTiles % kWarpsM == 0, "warp split");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = (warp % kWarpsN) * NT * 8;
  const int m0 = (warp / kWarpsN) * MT * 16;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = (tap / 3) * kW + tap % 3;
    const unsigned short* wt = w + static_cast<size_t>(w_off + tap * CI) * kLanes;
#pragma unroll
    for (int kc = 0; kc < CI / 16; ++kc) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned short* wc =
            wt + static_cast<size_t>(kc * 16 + 2 * t) * kLanes + n0 + j * 8 + g;
        bf[j][0] = pack2(wc, kLanes);
        bf[j][1] = pack2(wc + 8 * kLanes, kLanes);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* ar =
            in + (m0 + i * 16 + shift + g) * kLd + kc * 16 + 2 * t;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(ar);
        af[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kLd);
        af[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kLd + 8);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af, bf[j][0], bf[j][1]);
      }
    }
  }

  // epilogue: C rows g and g + 8, columns 2t and 2t + 1 of each tile
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + i * 16 + g + 8 * h;
      const int e = m / kW;
      const int ap = m - e * kW;
      if (e >= kEle || ap < 1 || ap > kAzi) continue;   // padding rows
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        float v0 = __fadd_rn(acc[i][j][2 * h], bias[n]);
        float v1 = __fadd_rn(acc[i][j][2 * h + 1], bias[n + 1]);
        if (!kLast) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        const __nv_bfloat162 pv = __floats2bfloat162_rn(v0, v1);
        if (kLast) {
          *reinterpret_cast<float2*>(
              gout + (e * kAzi + ap - 1) * kOutDim + n) = __bfloat1622float2(pv);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(
              out_act + cell_row(e + 1, ap) * kLd + n) = pv;
          if (ap == 1)      // azimuth 0 is also the right wrap column
            *reinterpret_cast<__nv_bfloat162*>(
                out_act + cell_row(e + 1, kAzi + 1) * kLd + n) = pv;
          if (ap == kAzi)   // azimuth 19 is also the left wrap column
            *reinterpret_cast<__nv_bfloat162*>(
                out_act + cell_row(e + 1, 0) * kLd + n) = pv;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
conv_stack_kernel(const float* __restrict__ x,            // [K, 3, 7, 20, 16]
                  const unsigned short* __restrict__ w,   // [5328, 128] bf16
                  const float* __restrict__ b,            // [8, 128]
                  float* __restrict__ out) {              // [K, 7, 20, 32]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* buf1 = buf0 + kBufElems;
  const int k = blockIdx.x;

  uint4* z = reinterpret_cast<uint4*>(smem_raw);
  for (int i = threadIdx.x; i < static_cast<int>(kSmemBytes / 16); i += kThreads)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // stage the input as bf16: channel dr*16 + m of cell (e, a), and the wrap
  const float* xk = x + static_cast<size_t>(k) * kInPerPatch;
  for (int i = threadIdx.x; i < kInPerPatch; i += kThreads) {
    const int mm = i & 15;
    int r = i >> 4;
    const int a = r % kAzi;
    r /= kAzi;
    const int e = r % kEle;
    const int c = (r / kEle) * 16 + mm;
    const __nv_bfloat16 v = __float2bfloat16_rn(xk[i]);
    buf0[cell_row(e + 1, a + 1) * kLd + c] = v;
    if (a == 0) buf0[cell_row(e + 1, kAzi + 1) * kLd + c] = v;
    if (a == kAzi - 1) buf0[cell_row(e + 1, 0) * kLd + c] = v;
  }
  __syncthreads();

  float* ok = out + static_cast<size_t>(k) * kEle * kAzi * kOutDim;
  conv_layer<48, 64, false>(buf0, buf1, w, 0, b + 0 * kLanes, nullptr);
  __syncthreads();
  conv_layer<64, 64, false>(buf1, buf0, w, 432, b + 1 * kLanes, nullptr);
  __syncthreads();
  conv_layer<64, 128, false>(buf0, buf1, w, 1008, b + 2 * kLanes, nullptr);
  __syncthreads();
  conv_layer<128, 128, false>(buf1, buf0, w, 1584, b + 3 * kLanes, nullptr);
  __syncthreads();
  conv_layer<128, 64, false>(buf0, buf1, w, 2736, b + 4 * kLanes, nullptr);
  __syncthreads();
  conv_layer<64, 64, false>(buf1, buf0, w, 3888, b + 5 * kLanes, nullptr);
  __syncthreads();
  conv_layer<64, 32, false>(buf0, buf1, w, 4464, b + 6 * kLanes, nullptr);
  __syncthreads();
  conv_layer<32, 32, true>(buf1, nullptr, w, 5040, b + 7 * kLanes, ok);
}

}  // namespace

// x [K, 3, 7, 20, 16] f32, w [5328, 128] bf16 (fold_cyl_stack), b [8, 128]
// f32 -> out [K, 7, 20, 32] f32.
extern "C" int bx_conv_stack(const float* x, const unsigned short* w,
                             const float* b, int kq, float* out,
                             cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_stack_kernel<<<kq, kThreads, kSmemBytes, stream>>>(x, w, b, out);
  return static_cast<int>(cudaGetLastError());
}
