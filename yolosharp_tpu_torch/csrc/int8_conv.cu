// int8 post-training quantisation of a folded ConvBN (the JAX package's
// int8_conv, yolosharp_tpu/nn/common.py:635-652, and the ConvBN int8 branch
// after it), in two kernels:
//
//   quantize_kernel   xq = clip(round(x / a_scale), -127, 127)      NHWC T -> int8
//   int8_conv_kernel  y  = act(round_T(round_T(acc * scale) + b))   int8 -> NHWC T
//
// with acc the int32 sum of the k x k x Ci window of xq against the int8
// weights (zero padding), scale[co] = a_scale * w_scale[co] (formed in float32
// by the wrapper, as JAX forms the product first), b the folded-BN bias in the
// working type T (float32, bfloat16 or float16), act identity / SiLU / ReLU.
//
// Neither replaces a Pallas kernel: the JAX package leaves its int8 conv to
// lax.conv_general_dilated with preferred_element_type=int32. PyTorch has no
// int8 convolution on CUDA, and an im2col + int8 GEMM would multiply a 3x3
// conv's input bytes by nine, so the conv is written here. Its purpose on this
// card is the int8 tensor-core rate (1,979 dense TOP/s on an H100 SXM against
// 989 TFLOP/s in bf16).
//
// quantize_kernel: one thread a 16-channel group of one pixel, 16-byte stores.
// The output has Cp = Ci rounded up to 16 channels (the pad is 0, which is
// the conv's zero padding too), so that every row the conv copies is 16-byte
// aligned. Full groups of an aligned input are read with 16-byte loads. The
// division is IEEE (__fdiv_rn, not a multiply by the reciprocal) and the
// rounding half to even (__float2int_rn), as jnp.round / torch.round. Bound by
// the bytes it moves.
//
// int8_conv_kernel: an implicit GEMM, M = B*Ho*Wo output pixels, N = Co,
// K = k*k*Cp ordered (ky, kx, channel), on mma.sync.m16n8k32 s8 x s8 -> s32.
// A block owns 128 pixels x 64 channels (4 warps, 64 x 32 each). Each K step
// of 64 bytes copies one 16-byte row a pixel (the pixel each output pixel
// reads at that tap; zero-filled outside the image, past K and past M) and a
// weight row a channel with cp.async into a 3-slot ring of shared memory
// (rows of 80 bytes, so the 8 rows of an ldmatrix fall in 8 bank groups), two
// steps ahead of the MMAs. The int32 sums are exact. The epilogue takes the
// JAX order: __int2float_rn, __fmul_rn by scale, round to T, __fadd_rn of the
// bias, round to T, the activation, round to T (built without fast math, so
// nothing contracts into an FMA); in float32 with the identity it equals the
// plain version to the bit. What bounds it: the operand copies L2 -> shared
// (a 3x3 conv's input row is copied once a tap) and mma.sync's issue rate,
// about half of what wgmma reaches; the stem (Ci = 3 padded to 16) computes
// 16/3 of its products on zeros. wgmma s8, TMA and a quantise fused into the
// previous layer's epilogue are later work.
#include "common.cuh"

using namespace ys;

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 128, kBN = 64, kBK = 64;  // block tile; K bytes a step
constexpr int kStages = 3;
constexpr int kRow = kBK + 16;                // shared row: 64 bytes + 16 pad
constexpr int kA = kBM * kRow, kB = kBN * kRow;

__device__ __forceinline__ int8_t quant1(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return static_cast<int8_t>(min(max(q, -127), 127));
}

// Sixteen consecutive elements from a 16-byte aligned address.
__device__ __forceinline__ void load16(const float* p, float o[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) load4(p + 4 * i, o + 4 * i);
}
template <typename T>
__device__ __forceinline__ void load16(const T* p, float o[16]) {
  const uint4 v[2] = {reinterpret_cast<const uint4*>(p)[0],
                      reinterpret_cast<const uint4*>(p)[1]};
  const T* e = reinterpret_cast<const T*>(v);
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = to_f(e[i]);
}

template <typename T>
__global__ void __launch_bounds__(256)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ a_scale,
                int8_t* __restrict__ xq, long long groups, int Ci, int Cp, int vec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const int G = Cp / 16;
  const long long p = i / G;
  const int c0 = (int)(i - p * G) * 16;
  const float s = *a_scale;
  const T* src = x + p * Ci + c0;
  float v[16];
  if (vec && c0 + 16 <= Ci) {
    load16(src, v);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = c0 + j < Ci ? to_f(src[j]) : 0.f;
  }
  union {
    int4 u;
    int8_t b[16];
  } out;
#pragma unroll
  for (int j = 0; j < 16; ++j) out.b[j] = quant1(v[j], s);
  *reinterpret_cast<int4*>(xq + p * Cp + c0) = out.u;
}

// Four 8x8 b16 matrices = a 16 x 32 (A) or 8 x 64 / 16 x 32 (B) int8 tile.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct ConvShape {
  int H, W, Cp, Co, k, s, p, Ho, Wo, M, K;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ scale, const T* __restrict__ bias,
                 T* __restrict__ y, ConvShape sh, int act) {
  __shared__ __align__(128) int8_t sA[kStages][kA];
  __shared__ __align__(128) int8_t sB[kStages][kB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // this thread copies the A row of pixel m0 + tid (4 chunks of 16 bytes a
  // step) and half the B row of channel n0 + tid / 2 (2 chunks)
  const int am = m0 + tid;
  const bool m_ok = am < sh.M;
  int iy0 = 0, ix0 = 0;
  const int8_t* xb = xq;
  if (m_ok) {
    const int hw = sh.Ho * sh.Wo;
    const int b = am / hw, r = am - b * hw;
    const int oy = r / sh.Wo, ox = r - oy * sh.Wo;
    iy0 = oy * sh.s - sh.p;
    ix0 = ox * sh.s - sh.p;
    xb = xq + (size_t)b * sh.H * sh.W * sh.Cp;
  }
  const int bn = n0 + (tid >> 1);
  const bool n_ok = bn < sh.Co;
  const int8_t* wb = wq + (size_t)(n_ok ? bn : 0) * sh.K;
  const int bc0 = (tid & 1) * 2;

  auto load = [&](int slot, int kt) {
    const int kbase = kt * kBK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = kbase + j * 16;
      bool ok = m_ok && kk < sh.K;
      const int8_t* src = xq;
      if (ok) {
        const int tap = kk / sh.Cp, c = kk - tap * sh.Cp;
        const int ky = tap / sh.k, kx = tap - ky * sh.k;
        const int iy = iy0 + ky, ix = ix0 + kx;
        ok = iy >= 0 && iy < sh.H && ix >= 0 && ix < sh.W;
        if (ok) src = xb + ((size_t)iy * sh.W + ix) * sh.Cp + c;
      }
      cp_async16(smem_u32(&sA[slot][tid * kRow + j * 16]), src, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = kbase + (bc0 + j) * 16;
      const bool ok = n_ok && kk < sh.K;
      cp_async16(smem_u32(&sB[slot][(tid >> 1) * kRow + (bc0 + j) * 16]), ok ? wb + kk : wq,
                 ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int nk = (sh.K + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step kt has landed; every warp is done with kt - 1
    const int next = kt + kStages - 1;
    if (next < nk) load(next % kStages, next);
    cp_async_commit();
    const int8_t* a_s = sA[kt % kStages];
    const int8_t* b_s = sB[kt % kStages];
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(a[mi], smem_u32(a_s + row * kRow + ks * 32 + (lane >> 4) * 16));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int row = wn * 32 + nj * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(b_s + row * kRow + ks * 32 + ((lane >> 3) & 1) * 16));
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * 32 + ni * 8 + 2 * q + e;
      if (n >= sh.Co) continue;
      const float sc = scale[n];
      const float bv = to_f(bias[n]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
          if (m >= sh.M) continue;
          float v = round_t<T>(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + e]), sc));
          v = round_t<T>(__fadd_rn(v, bv));
          y[(size_t)m * sh.Co + n] = from_f<T>(apply_act(v, act));
        }
    }
}

template <typename T>
cudaError_t launch_quantize(const void* x, const void* a_scale, void* xq, long long pixels,
                            int Ci, int Cp, int vec, cudaStream_t stream) {
  const long long groups = pixels * (Cp / 16);
  const int threads = 256;
  const long long blocks = (groups + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a_scale), static_cast<int8_t*>(xq),
      groups, Ci, Cp, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_conv(const void* xq, const void* wq, const void* scale, const void* b, void* y,
                        const ConvShape& sh, int act, cudaStream_t stream) {
  const dim3 grid((sh.M + kBM - 1) / kBM, (sh.Co + kBN - 1) / kBN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int8_conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const T*>(b), static_cast<T*>(y), sh, act);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). dtype: 0 float32,
// 1 bfloat16, 2 float16 (x's type). x: (pixels, Ci) NHWC; xq: (pixels, Cp),
// Cp = Ci rounded up to 16; vec: x's rows are 16-byte aligned.
extern "C" int ys_quantize_int8(const void* x, const void* a_scale, void* xq, long long pixels,
                                int Ci, int Cp, int vec, int dtype, void* stream) {
  if (pixels == 0) return 0;
  if (Cp % 16 || Cp < Ci) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_quantize<float>(x, a_scale, xq, pixels, Ci, Cp, vec, st);
  if (dtype == 1) return launch_quantize<bf16>(x, a_scale, xq, pixels, Ci, Cp, vec, st);
  if (dtype == 2) return launch_quantize<f16>(x, a_scale, xq, pixels, Ci, Cp, vec, st);
  return cudaErrorInvalidValue;
}

// xq: (B, H, W, Cp) int8; wq: (Co, k, k, Cp) int8; scale: (Co,) float32;
// b: (Co,) and y: (B, Ho, Wo, Co) of the dtype's type; square k, stride s,
// zero padding p on every side.
extern "C" int ys_int8_conv(const void* xq, const void* wq, const void* scale, const void* b,
                            void* y, int B, int H, int W, int Cp, int Co, int k, int s, int p,
                            int act, int dtype, void* stream) {
  if (Cp % 16 || k < 1 || s < 1 || p < 0) return cudaErrorInvalidValue;
  ConvShape sh;
  sh.H = H;
  sh.W = W;
  sh.Cp = Cp;
  sh.Co = Co;
  sh.k = k;
  sh.s = s;
  sh.p = p;
  sh.Ho = (H + 2 * p - k) / s + 1;
  sh.Wo = (W + 2 * p - k) / s + 1;
  const long long M = (long long)B * sh.Ho * sh.Wo;
  const long long K = (long long)k * k * Cp;
  if (M > 0x7fffffffLL - kBM || K > 0x7fffffffLL) return cudaErrorInvalidValue;
  sh.M = (int)M;
  sh.K = (int)K;
  if (sh.M <= 0 || Co == 0 || sh.Ho <= 0 || sh.Wo <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_conv<float>(xq, wq, scale, b, y, sh, act, st);
  if (dtype == 1) return launch_conv<bf16>(xq, wq, scale, b, y, sh, act, st);
  if (dtype == 2) return launch_conv<f16>(xq, wq, scale, b, y, sh, act, st);
  return cudaErrorInvalidValue;
}
