// The stem convolution: a k x k conv whose input has at most 7 channels (a
// network's first layer reads RGB), with the folded-BN bias and an
// activation. One streaming kernel, stem_kernel<T, I8, KST>, serves two
// routes:
// - the 16-bit stem of the conv3x3 kernels (csrc/conv3x3.cu, I8 false: a
//   3x3 SAME conv in bfloat16 or float16, float32 sums on mma.sync
//   m16n8k16; it replaces the Pallas conv3x3s2_silu / conv3x3_silu of
//   yolosharp_tpu/kernels/conv3x3.py at Ci <= 7);
// - the int8 stem route of the int8 conv (csrc/int8_conv.cu, I8 true: any
//   k, stride and padding with k k Ci <= 128; the input in its working type
//   T, float32 / bfloat16 / float16, quantised as it is staged, int32 sums
//   on mma.sync m16n8k32 s8, the int8 routes' dequantising epilogue).
//
// What bounds it: bytes. K = k k Ci is 27 (108 for v5u's 6x6/2), so the
// products are a rounding error (5.7 GFLOP at 640^2 3->32 b32, ~6 us of
// tensor-core time against an 86 us byte bound), and the output, Co = 32 to
// 96 channels a pixel against 3 read, is 73-89% of the bytes. The design
// keeps the card's memory busy in both directions:
// - persistent: 1-2 blocks an SM walk the tiles; a tile is `rows` output
//   rows x `strips` strips of 32 output columns, and one block computes
//   every output channel of its pixels, so a band is read from device
//   memory once (a Co wider than the plan's chunk `cg` loops over channel
//   chunks inside the block). The weights are packed once per block into
//   shared memory as the mma's B fragments, K packed (k = tap Ci + ci, 27 ->
//   32, 108 -> 128), the bias and scale beside them as float32.
// - the input band of each strip (IH = (rows - 1) s + k rows of the strip's
//   (31 s + k) Ci elements, from the 16-byte unit its first element lies in,
//   rounded up to 16 bytes: TMA starts a box's rows 16-byte aligned or
//   faults) arrives by TMA from a
//   3-D tensor map over (B, H, W Ci): negative coordinates and the rows and
//   columns past the image read as zero (the padding; a band never crosses
//   into the next image). One producer warp keeps a ring of up to four band
//   slots in flight against mbarriers, so the next tiles' bands load while
//   this one computes and stores. Where TMA cannot map the input (the row
//   W Ci sizeof(T) is no multiple of 16 bytes, or a strip's row is wider
//   than a box's 256 elements), the same producer warp loads the band with
//   plain loads instead (cp.async moves 4, 8 or 16 bytes from an address
//   aligned to its size, and such a row of 2-byte elements may start at any
//   even address); the ragged shapes that take it are small.
// - the int8 route quantises the staged band in shared memory into an int8
//   copy, each element to the value quantize_kernel gives it (__fdiv_rn by
//   a_scale, __float2int_rn, a clip to +-127; quant4 takes a checked
//   multiply by the reciprocal and the division only where that could
//   round otherwise), so the int8 values are bitwise those the quantise
//   pass would have written; that pass and its 16-channel int8 copy of the
//   image (210 MB at b32 640^2) are gone. Its epilogue keeps the JAX
//   rounding order (two roundings to T, the exact SiLU) and so is bound by
//   the SM's conversion and MUFU units, not by bytes: it converts the sums
//   on the FP32 pipe and rounds two values at a time (dequant2).
// - eight consumer warps each take a strip of a tile: their A fragments are
//   gathered from the staged rows through offsets computed once a thread
//   (k -> tap, ci), the B fragments come from shared memory. mma.sync and
//   not wgmma: the products are ~7% of the byte bound, and wgmma would need
//   an im2col copy of A in swizzled shared memory, which buys nothing here.
// - the epilogue (bias and activation in registers, or the int8 dequantise)
//   writes the strip's NHWC rows into the warp's staging buffer (a pixel's
//   row padded by 16 bytes: the fragment writes are free of bank conflicts),
//   and the warp then stores them as whole 16-byte units of contiguous
//   output, so every 32-byte sector leaves full; a warp's stores overlap the
//   other warps' and the other block's products and the producer's loads.
#pragma once

#include <algorithm>
#include <cstring>

#include "common.cuh"

namespace ys {

// ---- int8 pieces shared by the int8 conv's routes and the int8 stem

__device__ __forceinline__ int8_t quant1(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return static_cast<int8_t>(min(max(q, -127), 127));
}

// Four elements quantised as quant1 quantises them, packed low byte first:
// the quotient taken as v r (r = 1 / s rounded) lies within 3 2^-24 |v / s|
// (< 2^-15 below 128) of the IEEE quotient, so where it is at least 2^-13
// from the nearest half-integer both round to the same integer, and where
// it is 128 or more both clip to +-127; elsewhere (ties by construction,
// NaN) the IEEE division itself, on a branch a warp rarely takes.
__device__ __forceinline__ uint32_t quant4(const float (&v)[4], float s, float r) {
  int q[4];
  bool safe = true, ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float q0 = v[e] * r;
    ok[e] = fabsf(q0) >= 128.f || fabsf(q0 - rintf(q0)) <= 0.5f - 0x1p-13f;
    q[e] = min(max(__float2int_rn(q0), -127), 127);
    safe = safe && ok[e];
  }
  if (__builtin_expect(!safe, 0)) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!ok[e]) q[e] = quant1(v[e], s);
  }
  uint32_t packed = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) packed |= (uint32_t)(uint8_t)q[e] << (8 * e);
  return packed;
}

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
template <int ACT>
__device__ __forceinline__ float act_rn(float v) {
  if constexpr (ACT == kSilu) return silu_rn(v);
  if constexpr (ACT == kRelu) return fmaxf(v, 0.f);
  return v;
}

template <typename T, int ACT>
__device__ __forceinline__ float dequant(int acc, float sc, float bv) {
  float v = round_t<T>(__fmul_rn(__int2float_rn(acc), sc));
  return act_rn<ACT>(round_t<T>(__fadd_rn(v, bv)));
}

// What bounds the int8 stem's epilogue is the SM's quarter-rate units (16
// results a clock: conversions and MUFU; SiLU's exp and reciprocal among
// them), so it spends as few as the JAX order allows: the int32 sum to
// float32 on the FP32 pipe (i2f22), and every rounding to the 16-bit T two
// values at a time (round2: one packed conversion) -- the same bits as
// dequant's.

// An int32 to float32, exact for |a| < 2^22 (the stems' sums: K <= 128, so
// |a| <= 128 x 127^2), by the 1.5 2^23 bias and one FADD.
__device__ __forceinline__ float i2f22(int a) {
  return __int_as_float(a + 0x4B400000) - 12582912.f;
}

// x0 and x1 rounded to T and back to float32 (round_t of each), in one
// packed conversion.
template <typename T>
__device__ __forceinline__ void round2(float& x0, float& x1) {
  const uint32_t p = Half16<T>::pack(x0, x1);
  if constexpr (std::is_same<T, bf16>::value) {
    x0 = __uint_as_float(p << 16);
    x1 = __uint_as_float(p & 0xFFFF0000u);
  } else {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&p));
    x0 = f.x;
    x1 = f.y;
  }
}

// dequant<T, kIdentity> of two sums at once.
template <typename T>
__device__ __forceinline__ void dequant2(int a0, int a1, float s0, float s1, float b0, float b1,
                                         float& v0, float& v1) {
  v0 = __fmul_rn(i2f22(a0), s0);
  v1 = __fmul_rn(i2f22(a1), s1);
  round2<T>(v0, v1);
  v0 = __fadd_rn(v0, b0);
  v1 = __fadd_rn(v1, b1);
  round2<T>(v0, v1);
}

// c += a (16 x 32 int8, row) * b (32 x 8 int8, col), int32 sums.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the stem kernel

constexpr int kStemWarps = 8;                         // consumer warps; one more loads
constexpr int kStemThreads = 32 * (kStemWarps + 1);
constexpr int kStemStrip = 32;                        // output columns of a strip: two m16 tiles
constexpr int kStemMaxRing = 4;                       // band slots at most

// What a launch computes, its tiles and its shared-memory layout
// (kernels/conv3x3.py stem_smem mirrors it). Element counts are of T.
struct StemGeo {
  int B, H, W, Ci, Co, Cp;  // Cp: the int8 weights' padded channels
  int k, s, p, Ho, Wo, K;   // K = k k Ci
  int R, NB, ns, cg;        // the plan: rows, strips, ring slots, channels a chunk
  int IH, IWB;              // a strip's band: rows, elements a row (16-byte multiple)
  int shift;                // elements of the band row before the strip's first
  int sub_elems, box_bytes, slot_bytes;  // sub_elems: a strip's band stride (128 bytes)
  int nbands, ncols, ntiles;
  int cop32;                // Co rounded up to 32: the bias / scale arrays
  int off_q, q_bytes, off_w, off_bias, off_stage, pstride, off_bar, smem;
  int tma;                  // 1: bands by TMA; 0: plain loads
  int vec;                  // Co of the output type fills 16-byte units
  int act;
};

// The geometry of one launch; false where the plan does not fit. isz / osz:
// bytes of an input / output element; kst: the k steps the kernel's A
// fragments hold (16 K values each for 16 bits, 32 for int8).
inline bool stem_geometry(StemGeo& g, int B, int H, int W, int Ci, int Co, int Cp, int k, int s,
                          int p, int isz, int osz, bool i8, int kst, int R, int NB, int ns, int cg,
                          int act) {
  memset(&g, 0, sizeof(g));
  g.B = B;
  g.H = H;
  g.W = W;
  g.Ci = Ci;
  g.Co = Co;
  g.Cp = Cp;
  g.k = k;
  g.s = s;
  g.p = p;
  g.act = act;
  if (Ci < 1 || Ci > 7 || k < 1 || s < 1 || p < 0 || R < 1 || NB < 1 || ns < 2 ||
      ns > kStemMaxRing || cg < 32 || cg % 32 || R * NB > 64)
    return false;
  g.Ho = (H + 2 * p - k) / s + 1;
  g.Wo = (W + 2 * p - k) / s + 1;
  g.K = k * k * Ci;
  if (g.Ho < 1 || g.Wo < 1 || g.K > (i8 ? 32 : 16) * kst) return false;
  g.R = R;
  g.NB = NB;
  g.ns = ns;
  g.cg = cg;
  g.IH = (R - 1) * s + k;
  // a box starts its rows 16-byte aligned (TMA refuses any other start): a
  // strip's first element, column 32 j s - p, lies shift elements in
  const int unit = 16 / isz;
  g.shift = ((-p * Ci) % unit + unit) % unit;
  g.IWB = (g.shift + ((kStemStrip - 1) * s + k) * Ci + unit - 1) / unit * unit;
  const long box = (long)g.IH * g.IWB * isz;
  if (box > 65536) return false;
  g.box_bytes = (int)box;
  g.sub_elems = (g.box_bytes + 127) / 128 * 128 / isz;  // TMA writes to 128-byte aligned shared memory
  g.slot_bytes = NB * g.sub_elems * isz;
  g.nbands = (g.Ho + R - 1) / R;
  g.ncols = (g.Wo + kStemStrip * NB - 1) / (kStemStrip * NB);
  const long tiles = (long)B * g.nbands * g.ncols;
  if (tiles > INT32_MAX) return false;
  g.ntiles = (int)tiles;
  g.cop32 = (Co + 31) / 32 * 32;
  const int nt = (Co + 7) / 8;
  g.off_q = ns * g.slot_bytes;
  g.q_bytes = i8 ? (NB * g.sub_elems + 127) / 128 * 128 : 0;
  g.off_w = g.off_q + 2 * g.q_bytes;
  g.off_bias = g.off_w + kst * nt * 32 * 8;
  g.off_stage = g.off_bias + 2 * 4 * g.cop32;
  g.pstride = cg * osz + 16;
  g.off_bar = g.off_stage + kStemWarps * kStemStrip * g.pstride;
  g.smem = 128 + g.off_bar + 16 * kStemMaxRing;
  g.tma = (long)W * Ci * isz % 16 == 0 && g.IWB <= 256 && g.IH <= 256;
  g.vec = Co * osz % 16 == 0;
  return g.smem <= 232448;
}

// tile t -> (image b, first output row h0, first output column w0), the
// column tile fastest: blocks working at once share their bands' halos in L2
__device__ __forceinline__ void stem_tile(const StemGeo& g, int t, int& b, int& h0, int& w0) {
  w0 = (t % g.ncols) * kStemStrip * g.NB;
  t /= g.ncols;
  h0 = (t % g.nbands) * g.R;
  b = t / g.nbands;
}

// The activation of the 16-bit stem, its value rounded to 16 bits right
// after: SiLU in one MUFU operation for bfloat16 (silu16: |v| 2^-12 off at
// most, under a sixteenth of a bfloat16 step), in two for float16, whose
// step is 8 times finer (silu_fast: a few float32 ulp).
template <typename T, int ACT>
__device__ __forceinline__ float stem_act(float v) {
  if constexpr (ACT == kSilu) {
    if constexpr (std::is_same<T, bf16>::value)
      return silu16(v);
    else
      return silu_fast(v);
  }
  if constexpr (ACT == kRelu) return fmaxf(v, 0.f);
  return v;
}

// One n-group (four n8 tiles from channel ng) of MT m16 tiles from m16
// tile mt into the warp's staging rows: the 16-bit route adds the bias and
// the activation, the int8 route dequantises. The channels of the chunk
// start at cg0.
template <typename T, bool I8, int ACT, int MT, typename Acc>
__device__ __forceinline__ void stem_epilogue(const Acc (&acc)[MT][4][4], uint8_t* stage,
                                              const float* sbias, const float* sscale,
                                              const StemGeo& g, int mt, int ng, int cg0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mm = 0; mm < MT; ++mm)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int co = ng + ni * 8 + 2 * q;
      const float b0 = sbias[co], b1 = sbias[co + 1];
      float s0 = 0.f, s1 = 0.f;
      if constexpr (I8) {
        s0 = sscale[co];
        s1 = sscale[co + 1];
      }
      // the int8 route into 16 bits: the four values' roundings in pairs
      float sv[4];
      if constexpr (I8 && sizeof(T) == 2) {
        dequant2<T>(acc[mm][ni][0], acc[mm][ni][1], s0, s1, b0, b1, sv[0], sv[1]);
        dequant2<T>(acc[mm][ni][2], acc[mm][ni][3], s0, s1, b0, b1, sv[2], sv[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[e] = act_rn<ACT>(sv[e]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (mt + mm) * 16 + gq + 8 * h;
        uint8_t* dst = stage + m * g.pstride + (co - cg0) * (int)sizeof(T);
        float v0, v1;
        if constexpr (I8 && sizeof(T) == 2) {
          v0 = sv[2 * h];
          v1 = sv[2 * h + 1];
        } else if constexpr (I8) {  // float32: dequant's, the sum converted by i2f22
          v0 = act_rn<ACT>(__fadd_rn(__fmul_rn(i2f22(acc[mm][ni][2 * h]), s0), b0));
          v1 = act_rn<ACT>(__fadd_rn(__fmul_rn(i2f22(acc[mm][ni][2 * h + 1]), s1), b1));
        } else {
          v0 = stem_act<T, ACT>(acc[mm][ni][2 * h] + b0);
          v1 = stem_act<T, ACT>(acc[mm][ni][2 * h + 1] + b1);
        }
        if constexpr (sizeof(T) == 4)
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(dst) = Half16<T>::pack(v0, v1);
      }
    }
}

// The warp's staged pixels [0, nvalid) x channels [cg0, cg0 + n) to y at
// output row ho, columns wo0..: whole 16-byte units where the output's
// channels fill them (a chunk of the whole Co is one contiguous run of the
// output), else one element at a time.
template <typename T>
__device__ __forceinline__ void stem_store(const uint8_t* stage, T* __restrict__ y, const StemGeo& g,
                                           int b, int ho, int wo0, int nvalid, int cg0, int n) {
  const int lane = threadIdx.x & 31;
  T* row = y + ((size_t)(b * g.Ho + ho) * g.Wo + wo0) * g.Co + cg0;
  if (g.vec) {
    constexpr int kE = 16 / (int)sizeof(T);
    const int upp = n / kE;  // units a pixel
    if (upp <= 32) {
      const int ppi = 32 / upp, pl = lane / upp, c = lane - pl * upp;
      if (pl < ppi)
        for (int m = pl; m < nvalid; m += ppi)
          *reinterpret_cast<uint4*>(row + (size_t)m * g.Co + c * kE) =
              *reinterpret_cast<const uint4*>(stage + m * g.pstride + c * 16);
    } else {
      for (int m = 0; m < nvalid; ++m)
        for (int c = lane; c < upp; c += 32)
          *reinterpret_cast<uint4*>(row + (size_t)m * g.Co + c * kE) =
              *reinterpret_cast<const uint4*>(stage + m * g.pstride + c * 16);
    }
  } else {
    for (int e = lane; e < nvalid * n; e += 32) {
      const int m = e / n, c = e - m * n;
      row[(size_t)m * g.Co + c] = reinterpret_cast<const T*>(stage + m * g.pstride)[c];
    }
  }
}

// w: the 16-bit route's (k, k, Ci, Co) HWIO weights of T, or the int8
// route's (Co, k, k, Cp) int8 ones; bias (Co,) of T; scale (Co,) float32 and
// a_scale (one float32) on the int8 route only. KST: k16 steps (16 bits) or
// k32 steps (int8) of the packed K.
template <typename T, bool I8, int KST>
__global__ void __launch_bounds__(kStemThreads, 2)
stem_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ x,
            const void* __restrict__ wv, const T* __restrict__ bias,
            const float* __restrict__ scale, const float* __restrict__ a_scale,
            T* __restrict__ y, const __grid_constant__ StemGeo g) {
  // m16 tiles that share their B fragments: two, or one where the A
  // fragments of 128 K values take the registers
  constexpr int MT = (I8 ? 32 : 16) * KST > 64 ? 1 : 2;
  // this lane's K values a k step: 4 (16-bit: 2q, 2q + 1, 2q + 8, 2q + 9)
  // or 8 (int8: 4q .. 4q + 3 and 16 + 4q ..)
  constexpr int NK = I8 ? 8 : 4;
  extern __shared__ uint8_t stem_smem[];
  uint8_t* const sm = stem_smem + ((128 - (smem_u32(stem_smem) & 127)) & 127);
  const uint32_t sbase = smem_u32(sm);
  uint2* const wfrag = reinterpret_cast<uint2*>(sm + g.off_w);
  float* const sbias = reinterpret_cast<float*>(sm + g.off_bias);
  float* const sscale = sbias + g.cop32;
  const uint32_t full = sbase + g.off_bar, empty = full + 8 * kStemMaxRing;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, q = lane & 3;
  const int nt_all = (g.Co + 7) / 8;

  if (tid == 0) {
    for (int s = 0; s < g.ns; ++s) {
      mbar_init(full + 8 * s, g.tma ? 1 : 32);
      mbar_init(empty + 8 * s, I8 ? 1 : kStemWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the weights as B fragments [k step][n8 tile][lane], K packed
  for (int i = tid; i < KST * nt_all * 32; i += kStemThreads) {
    const int ln = i & 31, nt = (i >> 5) % nt_all, ks = (i >> 5) / nt_all;
    const int co = nt * 8 + (ln >> 2), qq = ln & 3;
    uint2 v;
    if constexpr (I8) {
      const int8_t* w = static_cast<const int8_t*>(wv);
      auto w4 = [&](int k0) {
        uint32_t r = 0;
        for (int e = 0; e < 4; ++e) {
          const int kk = k0 + e;
          if (kk < g.K && co < g.Co) {
            const int tap = kk / g.Ci, ci = kk - tap * g.Ci;
            r |= (uint32_t)(uint8_t)w[((size_t)co * g.k * g.k + tap) * g.Cp + ci] << (8 * e);
          }
        }
        return r;
      };
      v.x = w4(ks * 32 + 4 * qq);
      v.y = w4(ks * 32 + 4 * qq + 16);
    } else {
      const T* w = static_cast<const T*>(wv);
      auto w2 = [&](int k0) {
        uint32_t r = 0;
        for (int e = 0; e < 2; ++e)
          if (k0 + e < g.K && co < g.Co)
            r |= (uint32_t)Half16<T>::bits(w[(size_t)(k0 + e) * g.Co + co]) << (16 * e);
        return r;
      };
      v.x = w2(ks * 16 + 2 * qq);
      v.y = w2(ks * 16 + 2 * qq + 8);
    }
    wfrag[i] = v;
  }
  for (int c = tid; c < g.cop32; c += kStemThreads) {
    sbias[c] = c < g.Co ? to_f(bias[c]) : 0.f;
    if constexpr (I8) sscale[c] = c < g.Co ? scale[c] : 0.f;
  }
  __syncthreads();

  if (warp == kStemWarps) {
    // ---- the producer warp: each tile's bands into the ring
    const int rowlen = g.W * g.Ci;
    int i = 0;
    for (int t = blockIdx.x; t < g.ntiles; t += gridDim.x, ++i) {
      const int s = i % g.ns, ph = (i / g.ns) & 1;
      int b, h0, w0;
      stem_tile(g, t, b, h0, w0);
      const int nbx = min(g.NB, (g.Wo - w0 + kStemStrip - 1) / kStemStrip);
      const int hi0 = h0 * g.s - g.p;
      mbar_wait(empty + 8 * s, ph ^ 1);
      if (g.tma) {
        if (lane == 0) {
          mbar_expect(full + 8 * s, nbx * g.box_bytes);
          for (int j = 0; j < nbx; ++j)
            tma3(sbase + s * g.slot_bytes + j * g.sub_elems * (int)sizeof(T), &xmap, full + 8 * s,
                 ((w0 + kStemStrip * j) * g.s - g.p) * g.Ci - g.shift, hi0, b);
        }
      } else {
        const T* xb = x + (size_t)b * g.H * rowlen;
        const T zero = from_f<T>(0.f);
        for (int j = 0; j < nbx; ++j) {
          T* dst = reinterpret_cast<T*>(sm + s * g.slot_bytes) + j * g.sub_elems;
          const int e0 = ((w0 + kStemStrip * j) * g.s - g.p) * g.Ci - g.shift;
          for (int r = 0; r < g.IH; ++r) {
            const int hi = hi0 + r;
            const bool rok = hi >= 0 && hi < g.H;
            for (int e = lane; e < g.IWB; e += 32) {
              const int ge = e0 + e;
              dst[r * g.IWB + e] =
                  rok && ge >= 0 && ge < rowlen ? xb[(size_t)hi * rowlen + ge] : zero;
            }
          }
        }
        mbar_arrive(full + 8 * s);  // each lane's stores, released
      }
    }
    return;
  }

  // ---- the consumer warps
  // this lane's K values as offsets (elements) from its pixel's window
  // origin; past K: -1 (16 bits: read as 0) or 0 (int8: any byte, against
  // zero weights, adds an exact 0)
  int koff[KST * NK];
#pragma unroll
  for (int ks = 0; ks < KST; ++ks)
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int kk = I8 ? ks * 32 + 4 * q + (j & 3) + (j >> 2) * 16
                        : ks * 16 + 2 * q + (j & 1) + (j >> 1) * 8;
      const int tap = kk / g.Ci, ci = kk - tap * g.Ci;
      const int ky = tap / g.k, kx = tap - ky * g.k;
      koff[ks * NK + j] = kk < g.K ? ky * g.IWB + kx * g.Ci + ci : (I8 ? 0 : -1);
    }
  const float as = I8 ? *a_scale : 0.f, ar = I8 ? __frcp_rn(as) : 0.f;
  uint8_t* const stage = sm + g.off_stage + warp * kStemStrip * g.pstride;
  using Acc = typename std::conditional<I8, int, float>::type;

  int i = 0;
  for (int t = blockIdx.x; t < g.ntiles; t += gridDim.x, ++i) {
    const int s = i % g.ns, ph = (i / g.ns) & 1;
    int b, h0, w0;
    stem_tile(g, t, b, h0, w0);
    mbar_wait(full + 8 * s, ph);
    const uint8_t* src = sm + s * g.slot_bytes;
    if constexpr (I8) {
      // quantise the band into this tile's int8 copy (two, alternating: the
      // barrier below also orders every warp's reads of the copy two tiles
      // back before these writes)
      const T* raw = reinterpret_cast<const T*>(src);
      int8_t* qd = reinterpret_cast<int8_t*>(sm + g.off_q + (i & 1) * g.q_bytes);
      const int total = g.NB * g.sub_elems;
      for (int v = tid * 4; v < total; v += kStemWarps * 32 * 4) {
        float f[4];
        load4(raw + v, f);
        *reinterpret_cast<uint32_t*>(qd + v) = quant4(f, as, ar);
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kStemWarps * 32) : "memory");
      if (tid == 0) mbar_arrive(empty + 8 * s);  // the raw band is free
      src = reinterpret_cast<const uint8_t*>(qd);
    }
    for (int st = warp; st < g.R * g.NB; st += kStemWarps) {
      const int ir = st / g.NB, j = st - ir * g.NB;
      const int ho = h0 + ir, wo0 = w0 + kStemStrip * j;
      if (ho >= g.Ho || wo0 >= g.Wo) continue;
      const int nvalid = min(kStemStrip, g.Wo - wo0);
      const int nmt = (nvalid + 15) >> 4;
      // the strip's window origin (elements into the band)
      const int org = j * g.sub_elems + ir * g.s * g.IWB + g.shift;
      for (int cg0 = 0; cg0 < g.Co; cg0 += g.cg) {
        const int cge = min(g.Co, cg0 + g.cg);
        for (int mt = 0; mt < nmt; mt += MT) {
          uint32_t a[MT][KST][4];
#pragma unroll
          for (int mm = 0; mm < MT; ++mm) {
            const bool live = mt + mm < nmt;
            const int base0 = org + ((mt + mm) * 16 + gq) * g.s * g.Ci;
            const int base1 = base0 + 8 * g.s * g.Ci;
#pragma unroll
#pragma unroll
            for (int ks = 0; ks < KST; ++ks) {
              const int o = ks * NK;  // this k step's offsets in koff
              if constexpr (I8) {
                auto b4 = [&](int base, int j0) {
                  uint32_t r = 0;
#pragma unroll
                  for (int e = 0; e < 4; ++e) r |= (uint32_t)src[base + koff[o + j0 + e]] << (8 * e);
                  return live ? r : 0u;
                };
                a[mm][ks][0] = b4(base0, 0);
                a[mm][ks][1] = b4(base1, 0);
                a[mm][ks][2] = b4(base0, 4);
                a[mm][ks][3] = b4(base1, 4);
              } else {
                const uint16_t* r16 = reinterpret_cast<const uint16_t*>(src);
                auto h2 = [&](int base, int j0) {
                  const int o0 = koff[o + j0], o1 = koff[o + j0 + 1];
                  const uint32_t lo = o0 >= 0 ? r16[base + o0] : 0u;
                  const uint32_t hi = o1 >= 0 ? r16[base + o1] : 0u;
                  return live ? lo | (hi << 16) : 0u;
                };
                a[mm][ks][0] = h2(base0, 0);
                a[mm][ks][1] = h2(base1, 0);
                a[mm][ks][2] = h2(base0, 2);
                a[mm][ks][3] = h2(base1, 2);
              }
            }
          }
          for (int ng = cg0; ng < cge; ng += 32) {
            Acc acc[MT][4][4];
#pragma unroll
            for (int mm = 0; mm < MT; ++mm)
#pragma unroll
              for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mm][ni][e] = 0;
#pragma unroll
            for (int ks = 0; ks < KST; ++ks)
#pragma unroll
              for (int ni = 0; ni < 4; ++ni) {
                const int nt = (ng >> 3) + ni;
                if (nt >= nt_all) continue;
                const uint2 bw = wfrag[(ks * nt_all + nt) * 32 + lane];
#pragma unroll
                for (int mm = 0; mm < MT; ++mm) {
                  if constexpr (I8)
                    mma_s8(acc[mm][ni], a[mm][ks], bw.x, bw.y);
                  else
                    Half16<T>::mma(acc[mm][ni], a[mm][ks], bw.x, bw.y);
                }
              }
            // the activation picked once an n-group (g.act is the same for
            // every thread), each epilogue compiled for its own
            if (g.act == kSilu)
              stem_epilogue<T, I8, kSilu, MT>(acc, stage, sbias, sscale, g, mt, ng, cg0);
            else if (g.act == kRelu)
              stem_epilogue<T, I8, kRelu, MT>(acc, stage, sbias, sscale, g, mt, ng, cg0);
            else
              stem_epilogue<T, I8, kIdentity, MT>(acc, stage, sbias, sscale, g, mt, ng, cg0);
          }
        }
        __syncwarp();
        stem_store<T>(stage, y, g, b, ho, wo0, nvalid, cg0, cge - cg0);
        __syncwarp();
      }
    }
    if constexpr (!I8) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the band
    }
  }
}

// Encode the band's tensor map (where g.tma) and launch. blocks: blocks an
// SM of the persistent grid.
template <typename T, bool I8, int KST>
cudaError_t launch_stem_kernel(const void* x, const void* w, const void* b, const void* scale,
                               const void* a_scale, void* y, const StemGeo& g, int blocks,
                               cudaStream_t stream) {
  auto kernel = stem_kernel<T, I8, KST>;
  // a runtime call before the encode: the driver's encode needs a current
  // context, which a thread that has made no runtime call lacks
  cudaError_t e = allow_smem(kernel, g.smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (g.tma) {
    const uint64_t dims[3] = {(uint64_t)g.W * g.Ci, (uint64_t)g.H, (uint64_t)g.B};
    const uint64_t str[2] = {(uint64_t)g.W * g.Ci, (uint64_t)g.H * g.W * g.Ci};
    const uint32_t box[3] = {(uint32_t)g.IWB, (uint32_t)g.IH, 1};
    const int err = encode(&map, tma_type<T>(), 3, x, dims, str, box, CU_TENSOR_MAP_SWIZZLE_NONE,
                           (int)sizeof(T));
    if (err) return static_cast<cudaError_t>(err);
  }
  const long grid = std::min<long>(g.ntiles, (long)sms * blocks);
  kernel<<<(unsigned)grid, kStemThreads, g.smem, stream>>>(
      map, static_cast<const T*>(x), w, static_cast<const T*>(b), static_cast<const float*>(scale),
      static_cast<const float*>(a_scale), static_cast<T*>(y), g);
  return cudaGetLastError();
}

}  // namespace ys
