// The serving epilogue of one conv layer of the nets, in one pass.
//
// Replaces no Pallas kernel. On the TPU, XLA fuses what follows a
// convolution into it; PyTorch runs it as an eager chain of some ten
// full-size passes a layer (models/layers.py: ConvBNRelu.forward in serving
// bf16): the bias added in bf16, a widen to f32, BatchNorm from the running
// statistics as (x - mean) * mul (+ bn_bias), a rounding to bf16, a widen
// again, the ReLU, and the next layer's cylindrical pad (an azimuth cat and
// an elevation F.pad, in f32) and its cast to bf16. This kernel reads the
// conv's (or the stem's matmul's) bf16 output once and writes what the
// consumer reads, with every rounding point of that chain where it was:
//   t = bf16(y + bias)                          (bf16 add: f32 sum, RNE)
//   t = (t - mean[c]) * mul[c] (+ bn_bias[c])   (f32, each op rounded alone:
//                                                __fsub_rn/__fmul_rn/__fadd_rn,
//                                                never contracted into an FMA,
//                                                as PyTorch runs them as
//                                                separate kernels)
//   t = bf16(t)                                 (flag kRoundBn)
//   t = relu(t)                                 (NaN kept, as torch.relu)
// so its output is bit-equal to the eager chain's. mul is rsqrt(var + eps)
// (* scale), made by the caller with batch_norm's own torch ops.
//
// Output forms (the caller picks its consumer's), each in the memory layout
// that the eager chain gives it, so that cuDNN and every later reduction
// see the same strides (the descriptor backbone runs channels-last: the
// stem's permuted output makes its pad channels-last, and every op after
// keeps the layout):
//   kSame   [N, C, S] or channels-last [rows, C] -> the same layout, bf16
//           (the next VALID conv's input) or f32 (a consumer that is not a
//           conv);
//   kPadCl  channels-last planes [P, E, A, C] -> bf16 [P, E + 2, A + 2, C]:
//           azimuth wrapped, elevation zero-padded, pad_cyl_2d(x, 3) in the
//           next cylindrical conv's dtype: a channels-last conv's output (a
//           3D conv's rad = 1 axis dropped) as the next layer's input
//           (P = N), or the moments stem's [N, R*E*A, C] as the first
//           layer's channels-last 3D input (P = N*R);
//   kAmax   [N*G, S, C] (the sampled stem's matmul) -> f32 [N*G, C], the max
//           over the S samples (NaN propagates, as torch.amax);
//   kCost  A [N, C, H, L] and C2d [N, C, H, L - 2] (the factored cost stem's
//          two convs) -> [N, C, L - 2, H, L - 2] of
//          bf16(A[.., (l - s) mod L] - C2d[.., l]) through the epilogue: the
//          rolls, the stack and the subtraction of the eager stem in the same
//          pass; bf16 (the first 3D conv's input) or f32.
//
// What bounds it: bytes. Each input byte is read once (kCost reads A once a
// shift, from L2) and each output byte written once; the arithmetic is a few
// operations an element, and the index arithmetic would cost more than the
// bytes if it were done an element. Design: kPadCl gives a thread V
// channels (16-byte loads and stores where C is a multiple of 8) of kUnroll
// positions, so that its channels' constants are loaded once; kSame and kCost
// take V neighbouring elements and kUnroll independent items a thread. All
// loads of a thread are issued before the first is used. Indices are 32-bit
// where the tensor allows.

#include "common.cuh"

#include <cuda_bf16.h>

#include <cstdint>

namespace {

enum Form : int { kSame = 0, kPadCl = 1, kAmax = 2, kCost = 3 };
enum Flag : int {
  kHasBn = 1,
  kHasBnBias = 2,
  kRoundBn = 4,
  kRelu = 8,
  kOutF32 = 16,
  kChannelsLast = 32,                              // kSame: channel = i % C
};

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// One channel's constants, in f32.
struct Channel {
  float bias, mean, mul, bn_bias;
};

struct Epilogue {
  const __nv_bfloat16* bias;  // [C], the compute dtype
  const float* mean;          // [C] (kHasBn)
  const float* mul;           // [C] (kHasBn)
  const float* bn_bias;       // [C] (kHasBnBias)
  int flags;

  __device__ __forceinline__ Channel at(int c) const {
    Channel k;
    k.bias = __bfloat162float(bias[c]);
    k.mean = (flags & kHasBn) ? __ldg(mean + c) : 0.0f;
    k.mul = (flags & kHasBn) ? __ldg(mul + c) : 0.0f;
    k.bn_bias = (flags & kHasBnBias) ? __ldg(bn_bias + c) : 0.0f;
    return k;
  }

  __device__ __forceinline__ float apply(float v, const Channel& k) const {
    float t = bf16_round(__fadd_rn(v, k.bias));
    if (flags & kHasBn) {
      t = __fmul_rn(__fsub_rn(t, k.mean), k.mul);
      if (flags & kHasBnBias) t = __fadd_rn(t, k.bn_bias);
      if (flags & kRoundBn) t = bf16_round(t);
    }
    if ((flags & kRelu) && !(t != t)) t = fmaxf(t, 0.0f);
    return t;
  }

  __device__ __forceinline__ float operator()(float v, int c) const {
    return apply(v, at(c));
  }
};

__device__ __forceinline__ void store(void* out, bool f32, size_t i, float v) {
  if (f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

// two neighbours at an even index i
__device__ __forceinline__ void store2(void* out, bool f32, size_t i, float a,
                                       float b) {
  if (f32)
    reinterpret_cast<float2*>(static_cast<float*>(out) + i)[0] =
        make_float2(a, b);
  else
    reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i)[0] =
        __floats2bfloat162_rn(a, b);
}

// ---- kSame: [N][C][S], or channels-last [rows][C] -> the same layout -----
// V = 4 (S, or C when channels-last, a multiple of 4; 8-byte aligned) or 1;
// an item is V neighbouring elements, which share a channel (channels
// first) or take C's consecutive channels (channels-last).
template <typename Idx, int V>
__global__ void __launch_bounds__(kThreads)
same_kernel(const __nv_bfloat16* __restrict__ y, Epilogue e, void* out,
            Idx items, Idx s_n, Idx c_n, bool f32, bool cl) {
  const Idx first = static_cast<Idx>(blockIdx.x) * (kThreads * kUnroll) +
                    threadIdx.x;
  float v[kUnroll][V];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const Idx it = first + u * kThreads;
    if (it >= items) continue;
    if constexpr (V == 4) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(y) + it);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      v[u][0] = __low2float(lo);
      v[u][1] = __high2float(lo);
      v[u][2] = __low2float(hi);
      v[u][3] = __high2float(hi);
    } else {
      v[u][0] = bf16_load(y + it);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const Idx it = first + u * kThreads;
    if (it >= items) continue;
    const Idx i = it * V;
    const int c = static_cast<int>(cl ? i % c_n : (i / s_n) % c_n);
    const Channel k0 = e.at(c);
    if constexpr (V == 4) {
      // channels-last neighbours take the next channels, else the same one
      const Channel k1 = cl ? e.at(c + 1) : k0;
      const Channel k2 = cl ? e.at(c + 2) : k0;
      const Channel k3 = cl ? e.at(c + 3) : k0;
      store2(out, f32, i, e.apply(v[u][0], k0), e.apply(v[u][1], k1));
      store2(out, f32, i + 2, e.apply(v[u][2], k2), e.apply(v[u][3], k3));
    } else {
      store(out, f32, i, e.apply(v[u][0], k0));
    }
  }
}

// ---- kPadCl: [P][E][A][C] -> bf16 [P][E + 2][A + 2][C] ------------------
// A thread owns V channels (threadIdx.x: C / V of them a position; V = 8,
// 16-byte loads and stores, where C % 8 == 0 and the tensors are 16-byte
// aligned; else V = 2) and kUnroll positions (threadIdx.y and the unroll),
// so that its channels' constants are loaded once.
template <typename Idx, int V>
__global__ void __launch_bounds__(kThreads)
padcl_kernel(const __nv_bfloat16* __restrict__ y, Epilogue e,
             __nv_bfloat16* __restrict__ out, Idx positions, int c_n, int ele,
             int azi) {
  const int w = azi + 2;
  const Idx plane_out = static_cast<Idx>(ele + 2) * w;
  const int c = threadIdx.x * V;
  Channel k[V];
#pragma unroll
  for (int j = 0; j < V; ++j) k[j] = e.at(c + j);
  const Idx first = static_cast<Idx>(blockIdx.x) * (blockDim.y * kUnroll) +
                    threadIdx.y;
  float v[kUnroll][V];
  bool zero[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const Idx pos = first + u * blockDim.y;
    zero[u] = true;                                // an elevation pad row
    if (pos >= positions) continue;
    const Idx plane = pos / plane_out;
    const int rem = static_cast<int>(pos - plane * plane_out);
    const int eo = rem / w;
    const int ao = rem - eo * w;
    if (eo == 0 || eo == ele + 1) continue;
    zero[u] = false;
    // padded column a reads column (a - 1) mod azi
    const int ai = ao == 0 ? azi - 1 : (ao == azi + 1 ? 0 : ao - 1);
    const __nv_bfloat16* src =
        y + ((plane * ele + (eo - 1)) * azi + ai) * c_n + c;
    if constexpr (V == 8) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[u][2 * j] = __low2float(h[j]);
        v[u][2 * j + 1] = __high2float(h[j]);
      }
    } else {
      const __nv_bfloat162 h =
          __ldg(reinterpret_cast<const __nv_bfloat162*>(src));
      v[u][0] = __low2float(h);
      v[u][1] = __high2float(h);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const Idx pos = first + u * blockDim.y;
    if (pos >= positions) continue;
    uint4 pack;                                    // 16-byte aligned
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&pack);
#pragma unroll
    for (int j = 0; j < V / 2; ++j)
      h[j] = zero[u] ? __floats2bfloat162_rn(0.0f, 0.0f)
                     : __floats2bfloat162_rn(e.apply(v[u][2 * j], k[2 * j]),
                                             e.apply(v[u][2 * j + 1],
                                                     k[2 * j + 1]));
    __nv_bfloat16* dst = out + pos * c_n + c;
    if constexpr (V == 8)
      *reinterpret_cast<uint4*>(dst) = pack;
    else
      *reinterpret_cast<__nv_bfloat162*>(dst) = h[0];
  }
}

// ---- kAmax: [rows][S][C] -> f32 [rows][C], max over S ---------------------
// An item is a (row, channel pair); C even.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
amax_kernel(const __nv_bfloat16* __restrict__ y, Epilogue e,
            float* __restrict__ out, Idx items, int s_n, int c_n) {
  const Idx it = static_cast<Idx>(blockIdx.x) * kThreads + threadIdx.x;
  if (it >= items) return;
  const int half = c_n / 2;
  const Idx row = it / half;
  const int c = static_cast<int>(it - row * half) * 2;
  const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(
      y + row * s_n * c_n + c);
  const __nv_bfloat162 p0 = __ldg(src);
  float m0 = e(__low2float(p0), c);
  float m1 = e(__high2float(p0), c + 1);
  for (int s = 1; s < s_n; ++s) {
    const __nv_bfloat162 p = __ldg(src + s * half);
    const float a = e(__low2float(p), c);
    const float b = e(__high2float(p), c + 1);
    // torch.amax: a NaN, once met, stays; else the larger
    if (m0 == m0 && (a != a || a > m0)) m0 = a;
    if (m1 == m1 && (b != b || b > m1)) m1 = b;
  }
  reinterpret_cast<float2*>(out + row * c_n + c)[0] = make_float2(m0, m1);
}

// ---- kCost: A [planes = N*C][H][L], C2d [planes][H][W = L - 2] ------------
// -> [planes][W (shift s)][H][W (l)]; an item is an output pair (W even).
// (A thread a whole output row, 36-byte rows of 4-byte stores, took 1.96 ms
// against this layout's 1.26 ms at 12000 matches on an H100.)
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
cost_kernel(const __nv_bfloat16* __restrict__ a_in,
            const __nv_bfloat16* __restrict__ c2d, Epilogue e, void* out,
            Idx items, Idx c_n, int h_n, int l_n, bool f32) {
  const int w = l_n - 2;
  const Idx first = static_cast<Idx>(blockIdx.x) * (kThreads * kUnroll) +
                    threadIdx.x;
  float v[kUnroll][2];
  int ch[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const Idx it = first + u * kThreads;
    ch[u] = 0;
    if (it >= items) continue;
    const Idx o = it * 2;
    const Idx t = o / w;
    const int l = static_cast<int>(o - t * w);
    const Idx t2 = t / h_n;
    const int h = static_cast<int>(t - t2 * h_n);
    const Idx plane = t2 / w;
    const int s = static_cast<int>(t2 - plane * w);
    const __nv_bfloat16* arow = a_in + (plane * h_n + h) * l_n;
    const __nv_bfloat162 cc = __ldg(reinterpret_cast<const __nv_bfloat162*>(
        c2d + (plane * h_n + h) * w + l));
    // torch.roll(A, s)[l] = A[(l - s) mod L]; l - s > -L
    const int j0 = l - s < 0 ? l - s + l_n : l - s;
    const int j1 = j0 + 1 == l_n ? 0 : j0 + 1;
    // the eager stem's bf16 (recon - C2d)
    v[u][0] = bf16_round(__fsub_rn(bf16_load(arow + j0), __low2float(cc)));
    v[u][1] = bf16_round(__fsub_rn(bf16_load(arow + j1), __high2float(cc)));
    ch[u] = static_cast<int>(plane % c_n);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const Idx it = first + u * kThreads;
    if (it >= items) continue;
    const Channel k = e.at(ch[u]);
    store2(out, f32, it * 2, e.apply(v[u][0], k), e.apply(v[u][1], k));
  }
}

unsigned blocks_for(size_t items, size_t per_block) {
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

template <typename Idx>
cudaError_t launch(int form, const void* y, const void* y2, Epilogue e,
                   void* out, size_t n, int c_n, int d0, int d1, bool vec_ok,
                   bool vec16, bool f32, bool cl, cudaStream_t stream) {
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  const size_t per_block = static_cast<size_t>(kThreads) * kUnroll;
  switch (form) {
    case kSame: {
      const size_t total = n * c_n * static_cast<size_t>(d0);
      if (vec_ok && (cl ? c_n : d0) % 4 == 0) {
        const size_t items = total / 4;
        same_kernel<Idx, 4><<<blocks_for(items, per_block), kThreads, 0,
                              stream>>>(yb, e, out, static_cast<Idx>(items),
                                        static_cast<Idx>(d0),
                                        static_cast<Idx>(c_n), f32, cl);
      } else {
        same_kernel<Idx, 1><<<blocks_for(total, per_block), kThreads, 0,
                              stream>>>(yb, e, out, static_cast<Idx>(total),
                                        static_cast<Idx>(d0),
                                        static_cast<Idx>(c_n), f32, cl);
      }
      break;
    }
    case kPadCl: {
      if (c_n % 2) return cudaErrorInvalidValue;
      const size_t positions = n * static_cast<size_t>(d0 + 2) * (d1 + 2);
      auto* o = static_cast<__nv_bfloat16*>(out);
      const int v = vec16 && c_n % 8 == 0 ? 8 : 2;
      const int tx = c_n / v;                      // threads a position
      if (tx > kThreads) return cudaErrorInvalidValue;
      const dim3 block(tx, kThreads / tx);
      const unsigned grid = blocks_for(positions, block.y * kUnroll);
      if (v == 8)
        padcl_kernel<Idx, 8><<<grid, block, 0, stream>>>(
            yb, e, o, static_cast<Idx>(positions), c_n, d0, d1);
      else
        padcl_kernel<Idx, 2><<<grid, block, 0, stream>>>(
            yb, e, o, static_cast<Idx>(positions), c_n, d0, d1);
      break;
    }
    case kAmax: {
      if (c_n % 2) return cudaErrorInvalidValue;
      const size_t items = n * (c_n / 2);
      amax_kernel<Idx><<<blocks_for(items, kThreads), kThreads, 0, stream>>>(
          yb, e, static_cast<float*>(out), static_cast<Idx>(items), d0, c_n);
      break;
    }
    case kCost: {
      if (d1 % 2) return cudaErrorInvalidValue;
      const size_t w = d1 - 2;
      const size_t items = n * c_n * w * d0 * w / 2;
      cost_kernel<Idx><<<blocks_for(items, per_block), kThreads, 0, stream>>>(
          yb, static_cast<const __nv_bfloat16*>(y2), e, out,
          static_cast<Idx>(items), static_cast<Idx>(c_n), d0, d1, f32);
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// y: the conv's bf16 output (kCost: A), y2: kCost's C2d, else null; bias:
// [C] bf16; mean, mul, bn_bias: [C] f32 or null as the flags say; out: the
// form's output. n: kSame N (channels-last: rows), kPadCl P, kAmax N*G
// rows, kCost N; d0, d1: kSame S (channels-last: 1); kPadCl E, A; kAmax S;
// kCost H, L. Every tensor dense in the layout its form names.
extern "C" int bx_conv_epilogue(const void* y, const void* y2, const void* bias,
                                const void* mean, const void* mul,
                                const void* bn_bias, void* out, int form,
                                int flags, long long n, int c_n, int d0, int d1,
                                cudaStream_t stream) {
  if (n < 0 || c_n < 1 || d0 < 1 || d1 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if ((flags & kHasBn) && (mean == nullptr || mul == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((flags & kHasBnBias) && bn_bias == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Epilogue e;
  e.bias = static_cast<const __nv_bfloat16*>(bias);
  e.mean = static_cast<const float*>(mean);
  e.mul = static_cast<const float*>(mul);
  e.bn_bias = static_cast<const float*>(bn_bias);
  e.flags = flags;
  const bool f32 = (flags & kOutF32) != 0;
  const bool cl = (flags & kChannelsLast) != 0;
  const bool vec_ok = (reinterpret_cast<uintptr_t>(y) & 7u) == 0 &&
                      (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  const bool vec16 = (reinterpret_cast<uintptr_t>(y) & 15u) == 0 &&
                     (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  // the largest element index any form touches, for the index type
  size_t biggest = static_cast<size_t>(n) * c_n;
  switch (form) {
    case kSame: biggest *= d0; break;
    case kPadCl: biggest *= static_cast<size_t>(d0 + 2) * (d1 + 2); break;
    case kAmax: biggest *= d0; break;
    case kCost: biggest *= static_cast<size_t>(d1) * d0 * d1; break;
    default: break;
  }
  const cudaError_t err =
      biggest < (1ull << 31)
          ? launch<uint32_t>(form, y, y2, e, out, n, c_n, d0, d1, vec_ok,
                             vec16, f32, cl, stream)
          : launch<uint64_t>(form, y, y2, e, out, n, c_n, d0, d1, vec_ok,
                             vec16, f32, cl, stream);
  return static_cast<int>(err);
}
