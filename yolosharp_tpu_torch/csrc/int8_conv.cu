// int8 post-training quantisation of a folded ConvBN (the JAX package's
// int8_conv, yolosharp_tpu/nn/common.py:635-652, and the ConvBN int8 branch
// after it):
//
//   quantize_kernel   xq = clip(round(x / a_scale), -127, 127)      NHWC T -> int8
//   int8 conv         y  = act(round_T(round_T(acc * scale) + b))   int8 -> NHWC T
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
// 989 TFLOP/s in bf16); at the models' shapes what bounds it is the bytes it
// moves (a YOLO int8 layer reads Cp bytes a pixel and writes Co elements of T).
//
// quantize_kernel: one thread a 16-channel group of one pixel, 16-byte stores.
// The output has Cp = Ci rounded up to 16 channels (the pad is 0, which is
// the conv's zero padding too), so that every row the conv copies is 16-byte
// aligned. Full groups of an aligned input are read with 16-byte loads. The
// division is IEEE (__fdiv_rn, not a multiply by the reciprocal) and the
// rounding half to even (__float2int_rn), as jnp.round / torch.round. Bound by
// the bytes it moves.
//
// The conv takes one of three routes, static by shape (kernels/int8_conv.py
// int8_route; the tile from int8_plan):
// - 1x1 stride 1 (route 1, a GEMM: M = B*H*W, K = Cp, N = Co) and 3x3 pad 1
//   stride 1 or 2 with Cp >= 32 (route 2): int8_tc_kernel, one persistent
//   warp-specialised kernel on wgmma.mma_async.m64nNk32.s32.s8.s8, the
//   pipeline of the 16-bit conv_tc_kernel (csrc/conv3x3.cu): one block an SM
//   walks its tiles; a producer thread loads, per channel chunk of BK bytes
//   (128, or 64 at stride 2 and at Cp <= 64), the A tile by TMA once for all
//   nine taps (route 1: 128 rows of xq viewed as (M, Cp); route 2: the padded
//   band or four parity planes of the flat-row tile, the zero padding from
//   TMA's out-of-bounds fill) and each tap's BN x BK weights (a box of wq
//   viewed as (Co, k*k, Cp)) into a ring, against mbarriers; two consumer
//   warpgroups issue the wgmma (both operands K-major: 8-bit wgmma has no
//   transposed B, and the int8 layouts already keep K contiguous; a tap
//   starts at any pixel row, off the swizzle atom, which the 8-bit
//   descriptor probe shows reads right with a base offset of 0). The
//   epilogue dequantises each warp's rows, stages 64 columns at a time in
//   the warp's shared memory and stores whole 16-byte units of each output
//   row, so the output, the larger half of the bytes, leaves in full
//   sectors.
// - everything else (route 0: the stems with Ci = 3 padded to Cp = 16, v5u's
//   6x6/2, any other k): int8_mma_kernel, an implicit GEMM on
//   mma.sync.m16n8k32 s8 x s8 -> s32. A block owns 128 pixels x 64 channels
//   (4 warps, 64 x 32 each). Each K step of 64 bytes copies one 16-byte row
//   a pixel (the pixel each output pixel reads at that tap; zero-filled
//   outside the image, past K and past M) and a weight row a channel with
//   cp.async into a 3-slot ring of shared memory (rows of 80 bytes, so the 8
//   rows of an ldmatrix fall in 8 bank groups), two steps ahead of the MMAs;
//   it copies a pixel's row once a tap and issues mma.sync at about half of
//   what wgmma reaches, and the stems compute 16/3 of their products on
//   zeros. Packing the stems' taps into K is later work.
// Every route's int32 sums are exact (K * 127^2 < 2^31 for K up to ~133,000)
// and its epilogue takes the JAX order: __int2float_rn, __fmul_rn by scale,
// round to T, __fadd_rn of the bias, round to T, the activation, round to T
// (built without fast math, so nothing contracts into an FMA); in float32
// with the identity every route equals the plain version to the bit, and
// with SiLU too (silu_rn gives the IEEE-division SiLU's bits at every
// float32 input, without its branch).
//
// What bounds the wgmma routes (chip_smoke phase 17a on an H100 80GB HBM3,
// 700 W, bf16 b32, its 76 shapes): not the bytes (their bound is ~1 ms)
// but the epilogue, ~20-40 instructions an output element
// (dequantise, two roundings, SiLU) on 8 warps an SM, not overlapped with
// the next tile's products. The activation is a template argument and the
// SiLU branch-free, so a warp's elements overlap; the GEMM takes 128-row
// tiles (one accumulator a thread) and the flat route a 64-channel N tile,
// which leave the epilogue the registers to do so. The GEMM shapes sum to
// ~1.7x torch._int_mm's time (which writes int32 and dequantises nothing).
// An epilogue overlapped with the next tile's products (a ping-pong of the
// two warpgroups) is the next lever.
#include <algorithm>
#include <cstring>

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
int8_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
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
cudaError_t launch_mma(const void* xq, const void* wq, const void* scale, const void* b, void* y,
                       const ConvShape& sh, int act, cudaStream_t stream) {
  const dim3 grid((sh.M + kBM - 1) / kBM, (sh.Co + kBN - 1) / kBN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int8_mma_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const T*>(b), static_cast<T*>(y), sh, act);
  return cudaGetLastError();
}

// ---- the Hopper routes: wgmma s8 fed by TMA, one block an SM

// SiLU to the bit of silu() (v / (1 + expf(-v)) with the IEEE division)
// without the division's slow-path branch: a branch in every element splits
// the epilogue into basic blocks one element long, and a warp then waits out
// each element's latency in turn. The quotient x / y (y = 1 + expf(-v) >= 1,
// both scaled by 2^-64 where y > 2^64 so that 1 / y stays normal) starts
// from rcp.approx and one correction, then of it and its two neighbours the
// one with the least residual |x - c y| (an exact FMA) is the quotient
// rounded to nearest: no quotient of two floats lies on a tie. Selected
// apart: 0 and |v| < 2^-90 (y = 2 there: v / 2 is v * 0.5 rounded), the
// infinities, and y = inf (v < -88.7: -0). tests/test_torch_cuda.py and
// chip_smoke phase 17a hold it to silu() at all 2^32 float32 inputs
// (int8_silu_check).
__device__ __forceinline__ float silu_rn(float v) {
  const float y = 1.f + expf(-v);
  const float sc = y > 0x1p64f ? 0x1p-64f : 1.f;
  const float xs = v * sc, ys = y * sc;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(ys));
  float q = xs * r;
  q = fmaf(fmaf(-q, ys, xs), r, q);
  const float qm = __int_as_float(__float_as_int(q) - 1);
  const float qp = __int_as_float(__float_as_int(q) + 1);
  const float e0 = fabsf(fmaf(-q, ys, xs)), em = fabsf(fmaf(-qm, ys, xs)),
              ep = fabsf(fmaf(-qp, ys, xs));
  float out = em < e0 ? qm : q;
  out = ep < fminf(e0, em) ? qp : out;
  out = y == INFINITY ? copysignf(0.f, v) : out;
  out = fabsf(v) < 0x1p-90f ? v * 0.5f : out;
  out = v == INFINITY ? v : out;
  return v == -INFINITY ? __int_as_float(0x7fffffff) : out;
}

// The epilogue of one int32 sum, in the JAX order: __int2float_rn, times
// the float32 scale, round to T, plus the bias, round to T, the activation
// ACT (rounded to T by the store). ACT is a template argument and SiLU
// silu_rn: a runtime switch or branch per element would serialise the
// elements (silu_rn's note).
template <typename T, int ACT>
__device__ __forceinline__ float dequant(int acc, float sc, float bv) {
  float v = round_t<T>(__fmul_rn(__int2float_rn(acc), sc));
  v = round_t<T>(__fadd_rn(v, bv));
  if constexpr (ACT == kSilu) return silu_rn(v);
  if constexpr (ACT == kRelu) return fmaxf(v, 0.f);
  return v;
}

// D (64 x N, int32) += A (64 x 32, K-major) * B (32 x N, K-major), both
// int8 read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// A K-major int8 operand of BK-byte rows (128 or 64 channels) under the
// 128- or 64-byte swizzle: the byte layout of the 16-bit kernels' A operand
// of BK / 2 elements (a_desc), and the same for B, whose rows are output
// channels (8-bit wgmma takes both operands K-major).
template <int BK>
__device__ __forceinline__ uint64_t desc8(uint32_t addr) {
  return a_desc<BK / 2>(addr);
}

constexpr int kI8Consumers = 2;                    // warpgroups that issue wgmma
constexpr int kI8Threads = 128 * (kI8Consumers + 1);
constexpr int kI8Rows = 128 * kI8Consumers;        // flat rows of a 3x3 block: 2 m64 subtiles a warpgroup
constexpr int kI8GemmRows = 64 * kI8Consumers;     // rows of a GEMM block: 1 m64 subtile a warpgroup
constexpr int kI8MinB = 4, kI8MaxB = 8;            // slots of the weight ring

// What a launch computes and how a block walks it. S = 0: the GEMM of a
// 1x1 stride-1 conv, M = B*H*W rows of Cp bytes in tiles of kI8GemmRows
// rows (one m64 subtile a warpgroup: the GEMM's few k steps leave its
// epilogue the larger cost, and one accumulator a thread leaves the
// epilogue the registers to overlap its elements).
// S = 1 / 2: the 3x3 flat-row tile of conv_tc_kernel (csrc/conv3x3.cu): R
// output rows x Wt columns of one image stored as rows of P pixels (the
// padded band at S = 1, four parity planes at S = 2), each tap's A operand
// one run of rows from the tap's offset.
struct I8Geo {
  int M, H, W, Cp, Co, Ho, Wo;
  int R, Wt, P, rows, wgs;
  int nco, nwt, nbands, nchunks, ntiles;
  int plane, nbs, a_stage, a_tx, planes, taps;
  int act;
};

struct I8Maps {
  CUtensorMap a[4];  // S = 0: xq as (M, Cp); S = 1: xq; S = 2: the parity planes
  CUtensorMap w;     // wq as (Co, k*k, Cp)
};

template <typename T>
__host__ __device__ constexpr int stage_row() {  // bytes of a staged 64-column output row (+16: banks)
  return 64 * (int)sizeof(T) + 16;
}

// One warp's 16 flat rows r0.. of a 64 x BN accumulator to y: dequantise,
// stage 64 columns at a time in the warp's shared memory, then store whole
// 16-byte units of each output row (element stores where Co * sizeof(T) is
// no multiple of 16 and at the Co edge).
template <typename T, int S, int BN, int ACT>
__device__ __forceinline__ void i8_epilogue(const int (&d)[BN / 2], uint8_t* __restrict__ st,
                                            T* __restrict__ y, const float* __restrict__ scale,
                                            const T* __restrict__ bias, const I8Geo& g, int r0,
                                            int b, int h0, int w0, int co0, int m0) {
  constexpr int kE = 16 / (int)sizeof(T);  // elements of a 16-byte unit
  constexpr int kUnits = 64 / kE;          // units of a staged row
  constexpr int kRow = stage_row<T>();
  const int lane = threadIdx.x & 31, gr = lane >> 2, q = lane & 3;
  const bool vec = (g.Co * (int)sizeof(T)) % 16 == 0;
#pragma unroll
  for (int h = 0; h < BN / 64; ++h) {
    // dequantise 64 columns of the warp's 16 rows into its staging buffer
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = ni * 8 + 2 * q;
      const int co = co0 + h * 64 + col;
      const float s0 = co < g.Co ? scale[co] : 0.f;
      const float s1 = co + 1 < g.Co ? scale[co + 1] : 0.f;
      const float b0 = co < g.Co ? to_f(bias[co]) : 0.f;
      const float b1 = co + 1 < g.Co ? to_f(bias[co + 1]) : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i0 = (h * 8 + ni) * 4 + 2 * half;
        const float v0 = dequant<T, ACT>(d[i0], s0, b0);
        const float v1 = dequant<T, ACT>(d[i0 + 1], s1, b1);
        uint8_t* p = st + (gr + 8 * half) * kRow + col * (int)sizeof(T);
        if constexpr (sizeof(T) == 4)
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(p) = Half16<T>::pack(v0, v1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 16 * kUnits / 32; ++it) {
      const int idx = it * 32 + lane;
      const int r = idx / kUnits, u = idx - r * kUnits;
      const int m = r0 + r;
      long long pix = -1;  // the output pixel of flat row m, -1 for a junk row
      if (S == 0) {
        if (m0 + m < g.M) pix = m0 + m;
      } else {
        const int i = m / g.P, j = m - i * g.P;
        if (m < g.rows && j < g.Wt && w0 + j < g.Wo && h0 + i < g.Ho)
          pix = ((long long)b * g.Ho + h0 + i) * g.Wo + w0 + j;
      }
      const int co = co0 + h * 64 + u * kE;
      if (pix >= 0 && co < g.Co) {
        const uint8_t* src = st + r * kRow + u * 16;
        T* dst = y + pix * g.Co + co;
        if (vec && co + kE <= g.Co) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < kE && co + e < g.Co; ++e) dst[e] = reinterpret_cast<const T*>(src)[e];
        }
      }
    }
    __syncwarp();
  }
}

// The persistent warp-specialised int8 conv. Warpgroups 0..wgs-1 issue
// wgmma.m64nBNk32.s32.s8.s8 on two m64 subtiles each (the rows past `rows`
// computed and not stored); the last warpgroup's first thread is the
// producer: per channel chunk it loads the A tile once (S = 0: one box of
// kI8GemmRows rows; S = 1: the padded band; S = 2: four parity planes; zero
// padding, image edges and channels past Cp from TMA's out-of-bounds fill)
// into one of two A slots, then each tap's BN x BK weights into a ring of
// nbs slots, against mbarriers, running ahead into the next tile. The
// consumers only wait, issue the wgmma unconditionally (a wgmma on a branch
// makes ptxas serialise them), keep one group in flight and release a slot
// once the group that read it is done; then each warp dequantises its rows
// and stores them through its staging buffer.
template <typename T, int S, int BK, int BN>
__global__ void __launch_bounds__(kI8Threads, 1)
int8_tc_kernel(const __grid_constant__ I8Maps maps, const float* __restrict__ scale,
               const T* __restrict__ bias, T* __restrict__ y, const __grid_constant__ I8Geo g) {
  constexpr int kBSlot = BK * BN;
  constexpr int kStageWarp = 16 * stage_row<T>();
  extern __shared__ __align__(1024) uint8_t i8_smem[];
  const uint32_t base = smem_u32(i8_smem);
  const uint32_t a0 = (base + 1023) & ~1023u;
  const uint32_t b0 = a0 + 2 * g.a_stage;
  const uint32_t st0 = b0 + g.nbs * kBSlot;
  const uint32_t bars = st0 + 4 * kI8Consumers * kStageWarp;
  // a_full[2], a_empty[2], b_full[kI8MaxB], b_empty[kI8MaxB]
  const uint32_t a_full = bars, a_empty = bars + 16, b_full = bars + 32,
                 b_empty = bars + 32 + 8 * kI8MaxB;

  // tile t -> (image b, first output row h0, column w0 | first GEMM row m0,
  // channel co0), the N tile fastest: blocks working at once share their A
  // tile in L2
  int b = 0, h0 = 0, w0 = 0, co0 = 0, m0 = 0;
  auto tile_at = [&](int t) {
    co0 = (t % g.nco) * BN;
    t /= g.nco;
    if (S == 0) {
      m0 = t * kI8GemmRows;
      return;
    }
    w0 = (t % g.nwt) * g.Wt;
    t /= g.nwt;
    h0 = (t % g.nbands) * g.R;
    b = t / g.nbands;
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, 4 * g.wgs);
    }
    for (int s = 0; s < g.nbs; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, 4 * g.wgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kI8Consumers) {
    // ---- producer
    setmaxnreg_dec<40>();
    if (tid == 128 * kI8Consumers) {
      int as = 0, aph = 0, bs = 0, bph = 0;
      for (int t = blockIdx.x; t < g.ntiles; t += gridDim.x) {
        tile_at(t);
        for (int c = 0; c < g.nchunks; ++c) {
          const int c0 = c * BK;
          mbar_wait(a_empty + 8 * as, aph ^ 1);
          mbar_expect(a_full + 8 * as, g.a_tx);
          const uint32_t dst = a0 + as * g.a_stage;
          if (S == 0) {
            tma2(dst, &maps.a[0], a_full + 8 * as, c0, m0);
          } else if (S == 1) {
            tma4(dst, &maps.a[0], a_full + 8 * as, c0, w0 - 1, h0 - 1, b);
          } else {
#pragma unroll
            for (int p = 0; p < 4; ++p)  // odd columns start one left, odd rows one up
              if ((g.planes >> p) & 1)
                tma4(dst + p * g.plane * BK, &maps.a[p], a_full + 8 * as, c0, w0 - (p & 1),
                     h0 - (p >> 1), b);
          }
          if (++as == 2) {
            as = 0;
            aph ^= 1;
          }
          for (int tap = 0; tap < 9; ++tap) {
            if (!((g.taps >> tap) & 1)) continue;
            mbar_wait(b_empty + 8 * bs, bph ^ 1);
            mbar_expect(b_full + 8 * bs, kBSlot);
            tma3(b0 + bs * kBSlot, &maps.w, b_full + 8 * bs, c0, tap, co0);
            if (++bs == g.nbs) {
              bs = 0;
              bph ^= 1;
            }
          }
        }
      }
    }
  } else if (warp < 4 * g.wgs) {
    // ---- consumers
    setmaxnreg_inc<232>();
    constexpr int MS = S == 0 ? 1 : 2;  // m64 subtiles a warpgroup
    const int mw = 64 * MS * (warp >> 2);  // this warpgroup's first flat row
    const int last_tap = 31 - __clz(g.taps);
    uint8_t* const st = i8_smem + (st0 - base) + warp * kStageWarp;
    int acc0[BN / 2], acc1[MS == 2 ? BN / 2 : 1];
    int as = 0, aph = 0, bs = 0, bph = 0;
    for (int t = blockIdx.x; t < g.ntiles; t += gridDim.x) {
      tile_at(t);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc0[i] = 0;
      if constexpr (MS == 2) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc1[i] = 0;
      }
      int rel_b = -1, rel_a = -1;  // slots whose reads the group in flight may still make
      for (int c = 0; c < g.nchunks; ++c) {
        mbar_wait(a_full + 8 * as, aph);
        const uint32_t abase = a0 + as * g.a_stage + mw * BK;
        for (int tap = 0; tap < 9; ++tap) {
          if (!((g.taps >> tap) & 1)) continue;
          const int dy = tap / 3, dx = tap - 3 * dy;
          const int off = S == 0   ? 0
                          : S == 1 ? dy * g.P + dx
                                   : ((dy == 1 ? 0 : 2) + (dx == 1 ? 0 : 1)) * g.plane +
                                         (dy == 2 ? g.P : 0) + (dx == 2 ? 1 : 0);
          const uint32_t at = abase + off * BK;
          mbar_wait(b_full + 8 * bs, bph);
          const uint32_t bsm = b0 + bs * kBSlot;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < BK / 32; ++ks) {
            const uint64_t db = desc8<BK>(bsm + ks * 32);
            wgmma_s8(acc0, desc8<BK>(at + ks * 32), db);
            if constexpr (MS == 2) wgmma_s8(acc1, desc8<BK>(at + 64 * BK + ks * 32), db);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous tap's group is done: release its slots
          if (lane == 0) {
            if (rel_b >= 0) mbar_arrive(b_empty + 8 * rel_b);
            if (rel_a >= 0) mbar_arrive(a_empty + 8 * rel_a);
          }
          rel_b = bs;
          rel_a = tap == last_tap ? as : -1;
          if (++bs == g.nbs) {
            bs = 0;
            bph ^= 1;
          }
        }
        if (++as == 2) {
          as = 0;
          aph ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) {  // the producer may fill the last slots with the next tile
        mbar_arrive(b_empty + 8 * rel_b);
        mbar_arrive(a_empty + 8 * rel_a);
      }
      const int r0 = mw + (warp & 3) * 16;
      // the activation picked once a tile (g.act is the same for every
      // thread), each epilogue compiled for its own
      auto epilogue = [&](const int (&d)[BN / 2], int r) {
        if (g.act == kSilu)
          i8_epilogue<T, S, BN, kSilu>(d, st, y, scale, bias, g, r, b, h0, w0, co0, m0);
        else if (g.act == kRelu)
          i8_epilogue<T, S, BN, kRelu>(d, st, y, scale, bias, g, r, b, h0, w0, co0, m0);
        else
          i8_epilogue<T, S, BN, kIdentity>(d, st, y, scale, bias, g, r, b, h0, w0, co0, m0);
      };
      epilogue(acc0, r0);
      if constexpr (MS == 2) epilogue(acc1, r0 + 64);
    }
  }
}

// The route's geometry and shared memory (kernels/int8_conv.py int8_smem
// mirrors it); false where the plan does not fit.
template <typename T, int S, int BK, int BN>
bool i8_geometry(I8Geo& g, int B, int H, int W, int Cp, int Co, int R, int Wt, long& blocks,
                 int& smem) {
  g.H = H;
  g.W = W;
  g.Cp = Cp;
  g.Co = Co;
  g.nco = (Co + BN - 1) / BN;
  g.nchunks = (Cp + BK - 1) / BK;
  int rows;
  if constexpr (S == 0) {
    const long long M = (long long)B * H * W;
    if (M > INT32_MAX - kI8GemmRows) return false;
    g.M = (int)M;
    g.Ho = H;
    g.Wo = W;
    g.R = g.Wt = g.P = 0;
    g.rows = kI8GemmRows;
    g.wgs = kI8Consumers;
    g.nwt = g.nbands = 1;
    g.plane = 0;
    g.planes = 1;
    g.taps = 1;
    g.a_tx = kI8GemmRows * BK;
    rows = kI8GemmRows;
    blocks = (long)((M + kI8GemmRows - 1) / kI8GemmRows) * g.nco;
  } else {
    g.M = 0;
    g.Ho = (H - 1) / S + 1;
    g.Wo = (W - 1) / S + 1;
    g.R = R;
    g.Wt = Wt;
    g.P = Wt + 3 - S;
    g.rows = R * g.P;
    if (R < 1 || Wt < 1 || g.P > 256 || g.rows > kI8Rows) return false;
    g.wgs = (g.rows + 127) / 128;
    g.nwt = (g.Wo + Wt - 1) / Wt;
    g.nbands = (g.Ho + R - 1) / R;
    const int reach = 128 * g.wgs;  // flat rows the wgmma read from a tap's start
    if (S == 1) {
      g.plane = 0;
      g.planes = 1;
      g.taps = 0x1FF;
      g.a_tx = (R + 2) * g.P * BK;
      rows = reach + 2 * g.P + 2;  // the last tap starts 2 P + 2 rows in
    } else {
      g.plane = ((R + 1) * g.P + 15) / 16 * 16;
      g.planes = 0;
      g.taps = 0;
      for (int p = 0; p < 4; ++p)
        if ((!(p >> 1) || H > 1) && (!(p & 1) || W > 1)) g.planes |= 1 << p;
      for (int t = 0; t < 9; ++t)
        if ((t / 3 == 1 || H > 1) && (t % 3 == 1 || W > 1)) g.taps |= 1 << t;
      g.a_tx = __builtin_popcount(g.planes) * (R + 1) * g.P * BK;
      rows = 3 * g.plane + reach + g.P + 1;  // plane 3's last tap starts P + 1 rows in
    }
    blocks = (long)B * g.nbands * g.nwt * g.nco;
  }
  g.a_stage = (rows * BK + 1023) / 1024 * 1024;
  const int fixed = 1024 + 2 * g.a_stage + 4 * kI8Consumers * 16 * stage_row<T>() +
                    8 * (4 + 2 * kI8MaxB);
  g.nbs = std::min(kI8MaxB, (232448 - fixed) / (BK * BN));
  if (g.nbs < kI8MinB) return false;
  smem = fixed + g.nbs * BK * BN;
  g.ntiles = (int)blocks;
  return blocks <= INT32_MAX;
}

template <typename T, int S, int BK, int BN>
cudaError_t launch_tc(const void* xq, const void* wq, const void* scale, const void* b, void* y,
                      int B, int H, int W, int Cp, int Co, int k, int R, int Wt, int act,
                      cudaStream_t stream) {
  I8Geo g;
  long blocks;
  int smem;
  if (!i8_geometry<T, S, BK, BN>(g, B, H, W, Cp, Co, R, Wt, blocks, smem))
    return cudaErrorInvalidValue;
  g.act = act;
  auto kernel = int8_tc_kernel<T, S, BK, BN>;
  // a runtime call before the encode: the driver's encode needs a current
  // context, which a thread that has made no runtime call lacks
  cudaError_t e = allow_smem(kernel, smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  I8Maps maps;
  memset(&maps, 0, sizeof(maps));
  const CUtensorMapSwizzle swz = BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  int err = 0;
  if (S == 0) {
    const uint64_t dims[2] = {(uint64_t)Cp, (uint64_t)g.M};
    const uint64_t str[1] = {(uint64_t)Cp};
    const uint32_t box[2] = {BK, kI8GemmRows};
    err = encode(&maps.a[0], u8, 2, xq, dims, str, box, swz, 1);
  } else if (S == 1) {
    const uint64_t dims[4] = {(uint64_t)Cp, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t str[3] = {(uint64_t)Cp, (uint64_t)W * Cp, (uint64_t)H * W * Cp};
    const uint32_t box[4] = {BK, (uint32_t)g.P, (uint32_t)(R + 2), 1};
    err = encode(&maps.a[0], u8, 4, xq, dims, str, box, swz, 1);
  } else {
    const uint32_t box[4] = {BK, (uint32_t)g.P, (uint32_t)(R + 1), 1};
    for (int p = 0; p < 4 && !err; ++p) {
      if (!((g.planes >> p) & 1)) continue;
      const int py = p >> 1, px = p & 1;
      const uint64_t dims[4] = {(uint64_t)Cp, (uint64_t)(W - px + 1) / 2,
                                (uint64_t)(H - py + 1) / 2, (uint64_t)B};
      const uint64_t str[3] = {2 * (uint64_t)Cp, 2 * (uint64_t)W * Cp, (uint64_t)H * W * Cp};
      const int8_t* pb = static_cast<const int8_t*>(xq) + ((size_t)py * W + px) * Cp;
      err = encode(&maps.a[p], u8, 4, pb, dims, str, box, swz, 1);
    }
  }
  if (!err) {
    const uint64_t dims[3] = {(uint64_t)Cp, (uint64_t)(k * k), (uint64_t)Co};
    const uint64_t str[2] = {(uint64_t)Cp, (uint64_t)(k * k) * Cp};
    const uint32_t box[3] = {BK, 1, BN};
    err = encode(&maps.w, u8, 3, wq, dims, str, box, swz, 1);
  }
  if (err) return static_cast<cudaError_t>(err);
  // persistent: one block an SM walks the tiles
  kernel<<<(unsigned)std::min<long>(blocks, sms), kI8Threads, smem, stream>>>(
      maps, static_cast<const float*>(scale), static_cast<const T*>(b), static_cast<T*>(y), g);
  return cudaGetLastError();
}

// route 0: the mma.sync kernel (any k, s, p); 1: the GEMM (k = 1, s = 1,
// p = 0; BK 128, bn 64 or 128); 2: the 3x3 flat-row tile (p = 1, Cp >= 32;
// BK 128 or 64 at stride 1, 64 at stride 2; bn 64; R x Wt output pixels a
// block). The wrapper's int8_plan picks it; the launch checks it.
template <typename T>
cudaError_t launch_route(const void* xq, const void* wq, const void* scale, const void* b,
                         void* y, int B, int H, int W, const ConvShape& sh, int act, int route,
                         int bk, int bn, int R, int Wt, cudaStream_t st) {
  if (route == 0) return launch_mma<T>(xq, wq, scale, b, y, sh, act, st);
  if (bn != 64 && bn != 128) return cudaErrorInvalidValue;
  const bool n128 = bn == 128;
  const int Cp = sh.Cp, Co = sh.Co, k = sh.k;
  if (route == 1) {
    if (k != 1 || sh.s != 1 || sh.p != 0 || bk != 128) return cudaErrorInvalidValue;
    return n128 ? launch_tc<T, 0, 128, 128>(xq, wq, scale, b, y, B, H, W, Cp, Co, k, 0, 0, act, st)
                : launch_tc<T, 0, 128, 64>(xq, wq, scale, b, y, B, H, W, Cp, Co, k, 0, 0, act, st);
  }
  // the flat route's two m64 subtiles a warpgroup leave its epilogue the
  // registers only at BN 64
  if (route != 2 || k != 3 || sh.p != 1 || Cp < 32 || n128) return cudaErrorInvalidValue;
  if (sh.s == 1 && bk == 128)
    return launch_tc<T, 1, 128, 64>(xq, wq, scale, b, y, B, H, W, Cp, Co, k, R, Wt, act, st);
  if (sh.s == 1 && bk == 64)
    return launch_tc<T, 1, 64, 64>(xq, wq, scale, b, y, B, H, W, Cp, Co, k, R, Wt, act, st);
  if (sh.s == 2 && bk == 64)
    return launch_tc<T, 2, 64, 64>(xq, wq, scale, b, y, B, H, W, Cp, Co, k, R, Wt, act, st);
  return cudaErrorInvalidValue;
}

// The 8-bit descriptor probe: out[r0] = A[r0 : r0 + 64] B^T (int32) for r0 =
// blockIdx.x, A (128 x BK) and B (64 x BK) int8 loaded by TMA under the
// kernel's swizzle and read through desc8<BK> as a tap reads its rows and
// its weights.
template <int BK>
__global__ void __launch_bounds__(128)
desc8_probe_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap, int* __restrict__ out) {
  extern __shared__ __align__(1024) uint8_t probe_smem[];
  const uint32_t a = (smem_u32(probe_smem) + 1023) & ~1023u;
  const uint32_t bb = a + 128 * BK, bar = bb + 64 * BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar, 128 * BK + 64 * BK);
    tma2(a, &amap, bar, 0, 0);
    tma2(bb, &bmap, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  int d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 32; ++ks)
    wgmma_s8(d, desc8<BK>(a + blockIdx.x * BK + ks * 32), desc8<BK>(bb + ks * 32));
  wgmma_commit();
  wgmma_wait<0>();
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, q = lane & 3;
  int* o = out + (size_t)blockIdx.x * 64 * 64;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[(warp * 16 + gr + (j >> 1) * 8) * 64 + ni * 8 + 2 * q + (j & 1)] = d[ni * 4 + j];
}

template <int BK>
cudaError_t launch_probe(const void* a, const void* b, void* out, int nr0, cudaStream_t st) {
  const int smem = 1024 + 192 * BK + 64;
  cudaError_t e = allow_smem(desc8_probe_kernel<BK>, smem);
  if (e != cudaSuccess) return e;
  CUtensorMap am, bm;
  const CUtensorMapSwizzle swz = BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const uint64_t adims[2] = {BK, 128}, bdims[2] = {BK, 64}, str[1] = {BK};
  const uint32_t abox[2] = {BK, 128}, bbox[2] = {BK, 64};
  int err = encode(&am, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a, adims, str, abox, swz, 1);
  if (!err) err = encode(&bm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, b, bdims, str, bbox, swz, 1);
  if (err) return static_cast<cudaError_t>(err);
  desc8_probe_kernel<BK><<<nr0, 128, smem, st>>>(am, bm, static_cast<int*>(out));
  return cudaGetLastError();
}

// silu_rn against silu() at every float32 bit pattern: the count of inputs
// whose results differ in their bits (NaN results compared as NaN) goes to
// *bad.
__global__ void __launch_bounds__(256) silu_check_kernel(unsigned long long* bad) {
  unsigned long long n = 0;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32);
       i += stride) {
    const float v = __uint_as_float((unsigned)i);
    const float got = silu_rn(v), want = silu(v);
    const bool same = __float_as_uint(got) == __float_as_uint(want) ||
                      (isnan(got) && isnan(want));
    n += !same;
  }
  if (n) atomicAdd(bad, n);
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

// Returns the CUDA error of the launch (0 on success; 10000 + a CUresult
// where a TMA tensor map could not be encoded). xq: (B, H, W, Cp) int8; wq:
// (Co, k, k, Cp) int8; scale: (Co,) float32; b: (Co,) and y: (B, Ho, Wo,
// Co) of the dtype's type; square k, stride s, zero padding p on every
// side; route, bk, bn, R, Wt: the wrapper's route and plan (launch_route).
extern "C" int ys_int8_conv(const void* xq, const void* wq, const void* scale, const void* b,
                            void* y, int B, int H, int W, int Cp, int Co, int k, int s, int p,
                            int act, int dtype, int route, int bk, int bn, int R, int Wt,
                            void* stream) {
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
  if (dtype == 0)
    return launch_route<float>(xq, wq, scale, b, y, B, H, W, sh, act, route, bk, bn, R, Wt, st);
  if (dtype == 1)
    return launch_route<bf16>(xq, wq, scale, b, y, B, H, W, sh, act, route, bk, bn, R, Wt, st);
  if (dtype == 2)
    return launch_route<f16>(xq, wq, scale, b, y, B, H, W, sh, act, route, bk, bn, R, Wt, st);
  return cudaErrorInvalidValue;
}

// silu_rn against silu() at all 2^32 float32 inputs (tests/test_torch_cuda.py,
// chip_smoke.py): *bad (zeroed by the caller) gets the count that differ.
extern "C" int ys_int8_silu_check(void* bad, void* stream) {
  silu_check_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad));
  return cudaGetLastError();
}

// The 8-bit descriptor probe (tests/test_torch_cuda.py, chip_smoke.py): a
// (128, bk) and b (64, bk) int8 row-major, bk 64 or 128; out (nr0, 64, 64)
// int32 gets A[r0 : r0 + 64] B^T for each r0 < nr0 <= 64.
extern "C" int ys_int8_desc_probe(const void* a, const void* b, void* out, int nr0, int bk,
                                  void* stream) {
  if (nr0 < 1 || nr0 > 64) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bk == 128) return launch_probe<128>(a, b, out, nr0, st);
  if (bk == 64) return launch_probe<64>(a, b, out, nr0, st);
  return cudaErrorInvalidValue;
}
