// 3x3 convolution, stride 1 or 2, zero padding 1, with a per-channel bias
// (the folded BatchNorm) and an activation in the epilogue. Replaces the
// Pallas kernels yolosharp_tpu/kernels/conv3x3.py conv3x3_silu (stride 1)
// and conv3x3s2_silu (stride 2).
//
// x: (B, H, W, Ci) NHWC, w: (3, 3, Ci, Co) HWIO, bias: (Co,), y: (B, Ho, Wo, Co),
// all contiguous and of one type (float32, bfloat16 or float16); sums in
// float32.
//
// bfloat16 and float16, Ci >= 8 (one template on the element type: both are
// 2 bytes, so layouts and descriptors are shared and only the MMA type
// suffix and the conversions differ): conv_tc_kernel, an implicit GEMM on
// Hopper's warpgroup MMA whose input tile is loaded once per channel chunk
// for all nine taps, the Pallas kernel's own flat-row trick
// (yolosharp_tpu/kernels/conv3x3.py:10-20). Ci and Co are multiples of 8
// here (the wrapper zero-pads the rare others: TMA needs 16-byte strides).
// - A block owns R output rows x Wt columns of one image x BN = 64 or 128
//   channels (the wrapper's plan, kernels/conv3x3.py conv_plan). Its input
//   tile is stored as rows of P pixels: at stride 1 the padded band, R + 2
//   rows of P = Wt + 2; at stride 2 four parity planes (even / odd rows x
//   even / odd columns) of R + 1 rows of P = Wt + 1, each a TMA box of the
//   input viewed with doubled strides. Flat output row m = i P + j then
//   reads, at each tap, the tile row m + the tap's offset, so each tap's A
//   operand is one contiguous run of rows: the nine wgmma of a k16 step
//   read the same tile through shifted descriptors. Rows with j >= Wt are
//   junk, computed and never stored; R P <= 256.
// - The zero padding, the image edges, a band past the image's last row and
//   channels past Ci come from TMA's zero fill of out-of-bounds boxes (the
//   box coordinates start at -1), so no thread masks a tap. A box never
//   leaves its image: the batch index is a box coordinate.
// - Warp specialisation in a persistent grid: one block an SM walks its
//   tiles. One producer thread issues the TMA loads (the input tile into one
//   of two A slots a chunk, each tap's BK x BN weights into a ring of 4-8
//   slots, as many as the shared memory holds) against mbarriers, running
//   ahead into the next tile; two consumer warpgroups (each 128 flat rows,
//   MS = 2 m64 subtiles; one warpgroup, MS = 1 or 2, for a tile of up to
//   128 rows) only wait, issue wgmma.m64nBNk16 from the swizzled slots and
//   keep one group in flight; setmaxnreg moves registers from the producer
//   to them. The wgmma are issued unconditionally (k16 steps past Ci read
//   TMA's zeros): a wgmma on a branch makes ptxas serialise them.
// - BK, the channels of a chunk: 64 at stride 1 (128-byte rows, the
//   128-byte swizzle), 32 at stride 2 (64-byte rows and swizzle: four
//   planes of R + 1 rows fill twice the shared memory a flop). A tap starts
//   its rows at any pixel row, off the swizzle atom: the swizzle follows the
//   absolute shared-memory address, so a base offset of 0 reads it right at
//   every start (ys_conv3x3_desc_probe shows it on the card).
// - The epilogue adds the bias and the activation in float32 and rounds
//   once to the element type (paired stores).
// What bounds it: per chunk a block copies its input tile once (S = 1 at
// 80^2: 5 x 82 pixel rows for 240 outputs, against 9 x 128 rows for 128
// outputs in the flat-M kernel this one replaced) and the weights of nine
// taps once for up to 256 flat rows, so the L2 -> shared copies no longer
// bound it. What is left, as the clocks fitted to its times on an H100
// (kernels/conv3x3.py COST_*) apportion it: the epilogue (~0.5 clocks an
// output element an SM, not overlapped with the next tile's products; a
// ping-pong schedule that overlaps it lost more to its 128-row tiles, see
// PERF.md), each k step's barrier round trip (~280 clocks: many short
// steps at stride 2 and at small Ci), and junk rows (P - Wt of every P,
// the subtile rows past R P); the largest layers run at ~0.55 of the bf16
// peak. At 640^2 bf16 batch 32 on an H100 80GB HBM3 (700 W) its stride-1
// and stride-2 shapes sum to 0.92x and 0.75x of F.conv2d's time (PERF.md).
// - The stem (Ci <= 7) takes csrc/stem.cuh's streaming kernel instead
//   (ys_conv3x3_stem): K packed (9 taps x Ci channels, 27 -> 32) on
//   mma.sync, persistent blocks fed a ring of input bands by TMA, every
//   output channel of a pixel in one block, whole 16-byte output lines. It
//   replaced a kernel of small blocks that staged its band with scalar
//   loads and wrote every 32-byte sector half at a time (0.18-0.22 of the
//   byte bound at b32 640^2); the note of csrc/stem.cuh says what bounds
//   it.
//
// float32: conv_f32_kernel, float32 FMAs on the CUDA cores (TF32 in any
// form would break the float32 contract), so what bounds it is the 67
// TFLOP/s float32 pipe. What held the kernel it replaced at 0.15-0.17 of
// that bound (H100 80GB HBM3, 700 W, B=2): one-float staging with an
// integer divide an element, load and products in series, a 4 x 8 tile a
// thread (32 FMAs per 6 shared loads) and one tile for every shape (a 20 x
// 20 x 512 layer at B=2 gave 96 blocks for 132 SMs). The design: a thread
// keeps an 8-pixel x 8-channel tile, its input read as float4 units of 4
// channels of a pixel (the columns of a staged row split by parity at
// stride 2, so a thread's pixels are consecutive units) and its weights as
// two float4, ~20 FMAs a 16-byte shared load; the channel chunks come
// through a two-stage ring of 16-byte cp.async copies, so chunk c + 1's
// copy overlaps chunk c's products; f32_plan (kernels/conv3x3.py) picks a
// tile of 32 to 256 channels and 8 x 8 to 32 x 8 pixels and splits the Ci
// sum over blocks where the tiles alone leave SMs idle, the splits added
// in a fixed order by f32_split_sum (no atomics: the same bits every run).
// The stem (Ci <= 4) runs one chunk of 4 channels with plain loads. On that
// card at B=2 the stride-1 and stride-2 shapes of every path sum to about
// 0.4 of the bound and below F.conv2d's full-float32 time (PERF.md §6).
#include <cuda.h>

#include <algorithm>
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "f32_tile.cuh"
#include "stem.cuh"

using namespace ys;

namespace {

// ---------------------------------------------------------------- float32

// float32: conv_f32_kernel<S, TN, SW, VEC, CK>. A block of 256
// threads owns TH x TW output pixels x TN channels; thread (cg, strip), cg =
// tid % (TN / 8), keeps an 8-pixel x 8-channel register tile: the 8
// consecutive output columns of its strip (row strip / SW, columns 8 (strip
// % SW)..) x channels 4 cg.. and TN / 2 + 4 cg.. (so that the 8 threads of
// a shared-memory phase read 8 consecutive float4 of the weights). The input
// channels go in chunks of CK (8; 4 for the stem, Ci <= 4) through a
// two-stage ring: chunk c + 1 is copied by 16-byte cp.async (VEC: Ci and Co
// multiples of 4; else plain loads) while chunk c's products run. The input tile is stored as float4
// units of 4 channels of one pixel, [channel group][row][column], the
// columns of each row split by parity at stride 2 (even, then odd), so that
// a thread's taps read runs of consecutive float4: at stride 1 ten units a
// (group, kernel row) for its 8 pixels x 3 taps, at stride 2 nine even and
// eight odd. Each float4 of input feeds 4 x 8 FMAs, each weight float4 8 x
// 4. The Ci sum may be split over `splits` blocks (kernels/conv3x3.py
// f32_plan fills the card with it where the tiles alone leave SMs idle):
// each writes its partial sums to a workspace, and f32_split_sum adds them
// in split order, then the bias and the activation: no atomics, so a result
// is the same bits from run to run.
constexpr int kThreads = 256;  // a block of the float32 kernel
constexpr int kStemCi = 4;  // the stem: Ci <= 4, one chunk of 4 channels

template <int S, int TN, int SW, int CK>
struct F32Tile {
  static constexpr int NG = TN / 8;                  // channel groups of threads
  static constexpr int TH = kThreads / NG / SW;  // output rows
  static constexpr int TW = 8 * SW;                  // output columns
  static constexpr int IH = (TH - 1) * S + 3;
  static constexpr int IW = (TW - 1) * S + 3;
  static constexpr int IWE = S == 1 ? IW : (IW + 1) / 2;  // even columns first at stride 2
  static constexpr int XROW = IW;                     // float4 units a staged row
  static constexpr int XS = CK / 4 * IH * XROW;   // float4 units of the input tile
  static constexpr int WS = CK * 9 * TN / 4;      // float4 units of the weights
  static constexpr int STAGE = XS + WS;
  static constexpr int kBytes = 2 * STAGE * 16;
};

template <int S, int TN, int SW, bool VEC, int CK>
__global__ void __launch_bounds__(kThreads, 1)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y,
                float* __restrict__ part, int B, int H, int W, int Ci, int Co, int Ho,
                int Wo, int splits, int act) {
  using G = F32Tile<S, TN, SW, CK>;
  extern __shared__ float4 f32_smem[];
  const int tid = threadIdx.x;
  const int cg = tid % G::NG, strip = tid / G::NG;
  const int r = strip / SW, sc = (strip % SW) * 8;  // output row, first column in the tile

  // block -> (channel tile, column tile, row tile, split, image), the
  // channel tile fastest: blocks working at once share their input in L2
  int t = blockIdx.x;
  const int nco = (Co + TN - 1) / TN, ntw = (Wo + G::TW - 1) / G::TW,
            nth = (Ho + G::TH - 1) / G::TH;
  const int co0 = (t % nco) * TN;
  t /= nco;
  const int w0 = (t % ntw) * G::TW;
  t /= ntw;
  const int h0 = (t % nth) * G::TH;
  t /= nth;
  const int split = t % splits, b = t / splits;
  const int nck = (Ci + CK - 1) / CK;
  const int per = (nck + splits - 1) / splits;
  const int cbeg = split * per, cend = min(nck, cbeg + per);

  const int hi0 = h0 * S - 1, wi0 = w0 * S - 1;
  const float* xb = x + (size_t)b * H * W * Ci;

  auto load = [&](int stage, int c) {
    float4* xs = f32_smem + stage * G::STAGE;
    float4* ws = xs + G::XS;
    const int ci0 = c * CK;
    for (int u = tid; u < CK / 4 * G::IH * G::IW; u += kThreads) {
      const int g4 = u / (G::IH * G::IW), rem = u - g4 * (G::IH * G::IW);
      const int pr = rem / G::IW, q = rem - pr * G::IW;
      const int hi = hi0 + pr, wi = wi0 + q, ci = ci0 + 4 * g4;
      const bool ok = hi >= 0 && hi < H && wi >= 0 && wi < W && ci < Ci;
      const int col = S == 1 ? q : (q & 1 ? G::IWE + (q >> 1) : q >> 1);
      float4* dst = xs + (g4 * G::IH + pr) * G::XROW + col;
      const float* src = xb + ((size_t)hi * W + wi) * Ci + ci;
      if (VEC) {
        cp_async16(smem_u32(dst), ok ? src : x, ok);
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = ok && ci + e < Ci ? src[e] : 0.f;
        *dst = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int u = tid; u < G::WS; u += kThreads) {
      const int n4 = u % (TN / 4), ct = u / (TN / 4);  // ct = channel * 9 + tap
      const int cc = ct / 9, tap = ct - cc * 9;
      const int ci = ci0 + cc, co = co0 + 4 * n4;
      const bool ok = ci < Ci && co < Co;
      const float* src = w + ((size_t)tap * Ci + ci) * Co + co;
      if (VEC) {
        cp_async16(smem_u32(ws + u), ok ? src : w, ok);
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = ok && co + e < Co ? src[e] : 0.f;
        ws[u] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // wt: this thread's weights of one tap, channel stride 9 * TN / 4 units
  auto tap = [&](const float4 (&px)[8], const float4* wt) {
    fma_group<9 * (TN / 4), G::NG>(acc, px, wt);
  };

  if (cbeg < cend) load(0, cbeg);
  cp_async_commit();
  for (int c = cbeg; c < cend; ++c) {
    const int stage = (c - cbeg) & 1;
    if (c + 1 < cend) load(stage ^ 1, c + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk c has landed in every thread's view
    const float4* xs = f32_smem + stage * G::STAGE;
    const float4* ws = xs + G::XS;
    // one (channel group, kernel row) an iteration: its 768 FMAs give the
    // scheduler enough to overlap; unrolled further, the tiles'
    // instantiations made the library's build several times longer
#pragma unroll 1
    for (int g4 = 0; g4 < CK / 4; ++g4) {
#pragma unroll 1
      for (int kh = 0; kh < 3; ++kh) {
        const float4* row = xs + (g4 * G::IH + r * S + kh) * G::XROW;
        const float4* wk = ws + (g4 * 4 * 9 + kh * 3) * (TN / 4) + cg;
        if constexpr (S == 1) {
          float4 a[10];
#pragma unroll
          for (int i = 0; i < 10; ++i) a[i] = row[sc + i];
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            float4 px[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) px[i] = a[i + kw];
            tap(px, wk + kw * (TN / 4));
          }
        } else {
          float4 e[9];
#pragma unroll
          for (int i = 0; i < 9; ++i) e[i] = row[sc + i];
          float4 px[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) px[i] = e[i];
          tap(px, wk);
#pragma unroll
          for (int i = 0; i < 8; ++i) px[i] = e[i + 1];
          tap(px, wk + 2 * (TN / 4));
#pragma unroll
          for (int i = 0; i < 8; ++i) px[i] = row[G::IWE + sc + i];
          tap(px, wk + (TN / 4));
        }
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }
  cp_async_wait<0>();

  const int ho = h0 + r;
  if (ho >= Ho) return;
  const int cob[2] = {co0 + 4 * cg, co0 + TN / 2 + 4 * cg};
  float bv[2][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[hf][e] = cob[hf] + e < Co ? bias[cob[hf] + e] : 0.f;
  const size_t npix = (size_t)B * Ho * Wo;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int wo = w0 + sc + i;
    if (wo >= Wo) continue;
    const size_t pix = ((size_t)b * Ho + ho) * Wo + wo;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int co = cob[hf];
      if (co >= Co) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[i][4 * hf + e];
      float* dst;
      if (splits > 1) {
        dst = part + ((size_t)split * npix + pix) * Co + co;  // raw partial sums
      } else {
        dst = y + pix * Co + co;
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = apply_act(v[e] + bv[hf][e], act);
      }
      if (VEC) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (co + e < Co) dst[e] = v[e];
      }
    }
  }
}

// y = act(part[0] + part[1] + ... + bias), the splits added in order.
__global__ void __launch_bounds__(256)
f32_split_sum(const float* __restrict__ part, const float* __restrict__ bias,
              float* __restrict__ y, long long n, int Co, int splits, int act) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[k * n + i];
  y[i] = apply_act(s + bias[i % Co], act);
}

template <int S, int TN, int SW, bool VEC, int CK = 8>
cudaError_t launch_f32_tile(const float* x, const float* w, const float* b, float* y, float* part,
                            int B, int H, int W, int Ci, int Co, int splits, int act,
                            cudaStream_t stream) {
  using G = F32Tile<S, TN, SW, CK>;
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const long long blocks = (long long)((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW) *
                           ((Co + TN - 1) / TN) * splits * B;
  if (blocks > INT32_MAX || splits < 1 || (splits > 1 && !part)) return cudaErrorInvalidValue;
  auto kernel = conv_f32_kernel<S, TN, SW, VEC, CK>;
  cudaError_t err = allow_smem(kernel, G::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, G::kBytes, stream>>>(x, w, b, y, part, B, H, W, Ci, Co,
                                                               Ho, Wo, splits, act);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)B * Ho * Wo * Co;
  f32_split_sum<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, b, y, n, Co, splits, act);
  return cudaGetLastError();
}

// The float32 route: the tile tn channels x sw strips of 8 columns a row,
// the Ci sum split `splits` ways (the wrapper's plan, kernels/conv3x3.py
// f32_plan); the stem (Ci <= 4) in one chunk of 4 channels with plain
// loads. The launch checks the plan.
template <int S>
cudaError_t launch_f32(const void* xv, const void* wv, const void* bv, void* yv, void* pv, int B,
                       int H, int W, int Ci, int Co, int act, int tn, int sw, int splits,
                       cudaStream_t st) {
  const float *x = static_cast<const float*>(xv), *w = static_cast<const float*>(wv),
              *b = static_cast<const float*>(bv);
  float *y = static_cast<float*>(yv), *p = static_cast<float*>(pv);
  if (Ci <= kStemCi) {
    if (splits != 1) return cudaErrorInvalidValue;
    if (tn == 32 && sw == 4)
      return launch_f32_tile<S, 32, 4, false, 4>(x, w, b, y, p, B, H, W, Ci, Co, 1, act, st);
    if (tn == 64 && sw == 2)
      return launch_f32_tile<S, 64, 2, false, 4>(x, w, b, y, p, B, H, W, Ci, Co, 1, act, st);
    return cudaErrorInvalidValue;
  }
  if (Ci % 4 || Co % 4) {
    if (tn == 64 && sw == 2)
      return launch_f32_tile<S, 64, 2, false>(x, w, b, y, p, B, H, W, Ci, Co, splits, act, st);
    return cudaErrorInvalidValue;
  }
#define YS_F32_TILE(TN, SW)                                                                   \
  if (tn == TN && sw == SW)                                                                   \
    return launch_f32_tile<S, TN, SW, true>(x, w, b, y, p, B, H, W, Ci, Co, splits, act, st);
  YS_F32_TILE(32, 4)
  YS_F32_TILE(64, 1)
  YS_F32_TILE(64, 2)
  YS_F32_TILE(128, 1)
  YS_F32_TILE(256, 1)
#undef YS_F32_TILE
  return cudaErrorInvalidValue;
}

// ------------------------------------------- 16-bit: bfloat16 and float16

// ---- the implicit GEMM with the input tile shared by the nine taps

// input channels of a chunk: 64 at stride 1 (128-byte A rows, half the
// barrier round trips a flop), 32 at stride 2 (its four parity planes fill
// twice the shared memory a flop)
template <int S>
__host__ __device__ constexpr int chunk_of() {
  return S == 1 ? 64 : 32;
}
// weight ring: one tap x BK channels x BN a slot; as many slots as the
// shared memory left by the input tile holds, at least kMinBStages
constexpr int kMinBStages = 4, kMaxBStages = 8;
constexpr int kConsumers = 2;    // warpgroups that issue wgmma
constexpr int kTcThreads = 128 * (kConsumers + 1);
constexpr int kTcRows = 128 * kConsumers;  // flat rows of a block

// What a launch computes, the tile of a block, and the shared-memory layout.
// A block owns output rows [h0, h0 + R) x columns [w0, w0 + Wt) of one image
// x BN channels. Its input tile is laid out as rows of P pixels (S = 1: the
// padded band, P = Wt + 2, R + 2 rows; S = 2: four parity planes of R + 1
// rows of P = Wt + 1, rows (even, odd) x columns (even, odd)), so that each
// tap's A operand, the pixel that output (i, j) reads at that tap for every
// flat row m = i P + j, is one contiguous run of rows starting at the tap's
// offset. Rows with j >= Wt are junk: computed, never stored.
struct TcGeo {
  int H, W, Ci, Co, Ho, Wo;
  int R, Wt, P, rows;             // rows = R * P <= kTcRows
  int wgs;                        // consumer warpgroups with rows (of MS m64 subtiles each)
  int nco, nwt, nbands, nchunks;  // tiles of Co, W chunks, bands, channel chunks
  int ntiles;                     // B * nbands * nwt * nco, walked by a persistent grid
  int plane;                      // S = 2: rows from one parity plane to the next
  int nbs;                        // slots of the weight ring
  int a_stage;                    // bytes of an A slot (a multiple of 1024)
  int a_tx;                       // bytes the TMA loads write into an A slot
  int planes;                     // bit p: plane p is loaded (S = 2, H or W of 1: no odd plane)
  int taps;                       // bit t: tap t is computed (the others read only zeros)
  int act;
};

struct TcMaps {
  CUtensorMap a[4];  // S = 1: a[0], the input; S = 2: plane (row parity, column parity)
  CUtensorMap w;     // the weights as (Co, Ci, 9)
};

// Bias, activation, one rounding to T, paired stores of one warp's 16 flat
// rows m0.. of a 64 x BN accumulator.
template <typename T, int BN>
__device__ __forceinline__ void store_rows(const float (&d)[BN / 2], T* __restrict__ y,
                                           const T* __restrict__ bias, const TcGeo& g, int m0,
                                           int b, int h0, int w0, int co0) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, q = lane & 3;
  float bv[BN / 8][2];
#pragma unroll
  for (int ni = 0; ni < BN / 8; ++ni) {
    const int co = co0 + ni * 8 + 2 * q;
    bv[ni][0] = co < g.Co ? to_f(bias[co]) : 0.f;
    bv[ni][1] = co + 1 < g.Co ? to_f(bias[co + 1]) : 0.f;
  }
  const bool pairs = (g.Co & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + gr + half * 8;
    const int i = m / g.P, j = m - i * g.P;
    if (m >= g.rows || j >= g.Wt || w0 + j >= g.Wo || h0 + i >= g.Ho) continue;
    T* yp = y + (((size_t)b * g.Ho + h0 + i) * g.Wo + w0 + j) * g.Co;
#pragma unroll
    for (int ni = 0; ni < BN / 8; ++ni) {
      const int co = co0 + ni * 8 + 2 * q;
      if (co >= g.Co) continue;
      const float v0 = apply_act_fast(d[ni * 4 + 2 * half] + bv[ni][0], g.act);
      const float v1 = apply_act_fast(d[ni * 4 + 2 * half + 1] + bv[ni][1], g.act);
      if (pairs) {
        *reinterpret_cast<uint32_t*>(yp + co) = Half16<T>::pack(v0, v1);
      } else {
        yp[co] = from_f<T>(v0);
        if (co + 1 < g.Co) yp[co + 1] = from_f<T>(v1);
      }
    }
  }
}

// Warpgroups 0..wgs-1 issue wgmma, each on MS m64 subtiles of flat rows (the
// rows past `rows` computed and not stored; a warpgroup past wgs idles); the
// last warpgroup's first thread is the producer. The wgmma of a tap are
// issued unconditionally (k16 steps past Ci read TMA's zeros): a wgmma on a
// branch makes the compiler serialise them. Per channel chunk the producer loads the input tile once (one
// TMA box, or four for the parity planes) into one of two A slots, then the
// weights of each tap into a ring of nbs slots; the consumers wait on the full
// barriers, run each tap's wgmma from the shifted A descriptor, keep one
// group in flight, and release a slot once the group that read it is done.
template <typename T, int S, int BN, int MS>
__global__ void __launch_bounds__(kTcThreads, 1)
conv_tc_kernel(const __grid_constant__ TcMaps maps, const T* __restrict__ bias,
               T* __restrict__ y, const __grid_constant__ TcGeo g) {
  constexpr int kBK = chunk_of<S>();
  constexpr int kARow = kBK * 2;  // bytes of an A row: one pixel's kBK channels
  constexpr int kBSlot = kBK * BN * 2;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t a0 = (smem_u32(tc_smem) + 1023) & ~1023u;
  const uint32_t b0 = a0 + 2 * g.a_stage;
  const uint32_t bars = b0 + g.nbs * kBSlot;
  // a_full[2], a_empty[2], b_full[kMaxBStages], b_empty[kMaxBStages]
  const uint32_t a_full = bars, a_empty = bars + 16, b_full = bars + 32,
                 b_empty = bars + 32 + 8 * kMaxBStages;

  // tile t -> (image b, first output row h0, column w0, channel co0), the
  // N tile fastest: blocks working at once share their input tile in L2
  int b, h0, w0, co0;
  auto tile_at = [&](int t) {
    co0 = (t % g.nco) * BN;
    t /= g.nco;
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

  if (warp >= 4 * kConsumers) {
    // ---- producer
    setmaxnreg_dec<40>();
    if (tid == 128 * kConsumers) {
      int as = 0, aph = 0, bs = 0, bph = 0;
      for (int t = blockIdx.x; t < g.ntiles; t += gridDim.x) {
        tile_at(t);
        for (int c = 0; c < g.nchunks; ++c) {
          const int c0 = c * kBK;
          mbar_wait(a_empty + 8 * as, aph ^ 1);
          mbar_expect(a_full + 8 * as, g.a_tx);
          const uint32_t dst = a0 + as * g.a_stage;
          if (S == 1) {
            tma4(dst, &maps.a[0], a_full + 8 * as, c0, w0 - 1, h0 - 1, b);
          } else {
#pragma unroll
            for (int p = 0; p < 4; ++p)  // odd columns start one left, odd rows one up
              if ((g.planes >> p) & 1)
                tma4(dst + p * g.plane * kARow, &maps.a[p], a_full + 8 * as, c0, w0 - (p & 1),
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
            const uint32_t bd = b0 + bs * kBSlot;
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma3(bd + j * kBK * 128, &maps.w, b_full + 8 * bs, co0 + 64 * j, c0, tap);
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
    const int mw = 64 * MS * (warp >> 2);  // this warpgroup's first flat row
    const int last_tap = 31 - __clz(g.taps);
    float acc0[BN / 2], acc1[BN / 2];
    int as = 0, aph = 0, bs = 0, bph = 0;
    for (int t = blockIdx.x; t < g.ntiles; t += gridDim.x) {
      tile_at(t);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.f;
      int rel_b = -1, rel_a = -1;  // slots whose reads the group in flight may still make
      for (int c = 0; c < g.nchunks; ++c) {
        mbar_wait(a_full + 8 * as, aph);
        const uint32_t abase = a0 + as * g.a_stage + mw * kARow;
        for (int tap = 0; tap < 9; ++tap) {
          if (!((g.taps >> tap) & 1)) continue;
          const int dy = tap / 3, dx = tap - 3 * dy;
          const int off = S == 1 ? dy * g.P + dx
                                 : ((dy == 1 ? 0 : 2) + (dx == 1 ? 0 : 1)) * g.plane +
                                       (dy == 2 ? g.P : 0) + (dx == 2 ? 1 : 0);
          const uint32_t at = abase + off * kARow;
          mbar_wait(b_full + 8 * bs, bph);
          const uint32_t bsm = b0 + bs * kBSlot;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks) {
            // B: k rows 16 ks.., 128-byte swizzle, 8-row groups 1024 bytes
            // apart, 64-column blocks kBK * 128 bytes apart
            const uint64_t db = smem_desc(bsm + ks * 16 * 128, kBK * 128, 1024, 1);
            wgmma16<T, BN>(acc0, a_desc<kBK>(at + ks * 32), db);
            if constexpr (MS == 2)
              wgmma16<T, BN>(acc1, a_desc<kBK>(at + 64 * kARow + ks * 32), db);
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
      const int m0 = mw + (warp & 3) * 16;
      store_rows<T, BN>(acc0, y, bias, g, m0, b, h0, w0, co0);
      if constexpr (MS == 2) store_rows<T, BN>(acc1, y, bias, g, m0 + 64, b, h0, w0, co0);
    }
  }
}

// The tile plan's geometry and shared memory (kernels/conv3x3.py tc_smem
// mirrors it); false where the plan does not fit.
template <int S, int BN, int MS>
bool tc_geometry(TcGeo& g, int B, int H, int W, int Ci, int Co, int R, int Wt, long& blocks,
                 int& smem) {
  constexpr int kBK = chunk_of<S>(), kARow = kBK * 2;
  g.H = H;
  g.W = W;
  g.Ci = Ci;
  g.Co = Co;
  g.Ho = (H - 1) / S + 1;
  g.Wo = (W - 1) / S + 1;
  g.R = R;
  g.Wt = Wt;
  g.P = Wt + 3 - S;
  g.rows = R * g.P;
  if (R < 1 || Wt < 1 || g.P > 256 || g.rows > kTcRows) return false;
  g.wgs = (g.rows + 64 * MS - 1) / (64 * MS);
  if (g.wgs > kConsumers) return false;
  g.nco = (Co + BN - 1) / BN;
  g.nwt = (g.Wo + Wt - 1) / Wt;
  g.nbands = (g.Ho + R - 1) / R;
  g.nchunks = (Ci + kBK - 1) / kBK;
  const int reach = 64 * MS * g.wgs;  // flat rows the wgmma read from a tap's start
  int rows;
  if (S == 1) {
    g.plane = 0;
    g.planes = 1;
    g.taps = 0x1FF;
    g.a_tx = (R + 2) * g.P * kARow;
    rows = reach + 2 * g.P + 2;  // the last tap starts 2 P + 2 rows in
  } else {
    g.plane = ((R + 1) * g.P + 15) / 16 * 16;
    g.planes = 0;
    g.taps = 0;
    for (int p = 0; p < 4; ++p)
      if ((!(p >> 1) || H > 1) && (!(p & 1) || W > 1)) g.planes |= 1 << p;
    for (int t = 0; t < 9; ++t)
      if ((t / 3 == 1 || H > 1) && (t % 3 == 1 || W > 1)) g.taps |= 1 << t;
    g.a_tx = __builtin_popcount(g.planes) * (R + 1) * g.P * kARow;
    rows = 3 * g.plane + reach + g.P + 1;  // plane 3's last tap starts P + 1 rows in
  }
  g.a_stage = (rows * kARow + 1023) / 1024 * 1024;
  const int bslot = kBK * BN * 2, fixed = 1024 + 2 * g.a_stage + 8 * (4 + 2 * kMaxBStages);
  g.nbs = std::min(kMaxBStages, (232448 - fixed) / bslot);
  if (g.nbs < kMinBStages) return false;
  smem = fixed + g.nbs * bslot;
  blocks = (long)B * g.nbands * g.nwt * g.nco;
  g.ntiles = (int)blocks;
  return blocks <= INT32_MAX;
}

template <typename T, int S, int BN, int MS>
cudaError_t launch_tc(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
                      int Ci, int Co, int Cop, int R, int Wt, int act, cudaStream_t stream) {
  TcGeo g;
  long blocks;
  int smem;
  if (!tc_geometry<S, BN, MS>(g, B, H, W, Ci, Co, R, Wt, blocks, smem))
    return cudaErrorInvalidValue;
  g.act = act;
  TcMaps maps;
  memset(&maps, 0, sizeof(maps));
  constexpr int kBK = chunk_of<S>();
  const uint32_t abox[4] = {kBK, (uint32_t)g.P, (uint32_t)(R + 3 - S), 1};
  const CUtensorMapSwizzle a_swz = kBK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B;
  int err = 0;
  if (S == 1) {
    const uint64_t dims[4] = {(uint64_t)Ci, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t str[3] = {(uint64_t)Ci, (uint64_t)W * Ci, (uint64_t)H * W * Ci};
    err = encode(&maps.a[0], tma_type<T>(), 4, x, dims, str, abox, a_swz);
  } else {
    for (int p = 0; p < 4 && !err; ++p) {
      if (!((g.planes >> p) & 1)) continue;
      const int py = p >> 1, px = p & 1;
      const uint64_t dims[4] = {(uint64_t)Ci, (uint64_t)(W - px + 1) / 2,
                                (uint64_t)(H - py + 1) / 2, (uint64_t)B};
      const uint64_t str[3] = {2 * (uint64_t)Ci, 2 * (uint64_t)W * Ci, (uint64_t)H * W * Ci};
      const T* base = static_cast<const T*>(x) + ((size_t)py * W + px) * Ci;
      err = encode(&maps.a[p], tma_type<T>(), 4, base, dims, str, abox, a_swz);
    }
  }
  if (!err) {
    const uint64_t dims[3] = {(uint64_t)Cop, (uint64_t)Ci, 9};
    const uint64_t str[2] = {(uint64_t)Cop, (uint64_t)Ci * Cop};
    const uint32_t box[3] = {64, kBK, 1};
    err = encode(&maps.w, tma_type<T>(), 3, w, dims, str, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err) return static_cast<cudaError_t>(err);
  auto kernel = conv_tc_kernel<T, S, BN, MS>;
  cudaError_t e = allow_smem(kernel, smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // persistent: one block an SM walks the tiles
  kernel<<<(unsigned)std::min<long>(blocks, sms), kTcThreads, smem, stream>>>(
      maps, static_cast<const T*>(b), static_cast<T*>(y), g);
  return cudaGetLastError();
}

// The tensor-core kernel with bn channels a block and R x Wt output pixels
// (the wrapper's plan, kernels/conv3x3.py conv_plan); the launch checks it.
// The stem (Ci <= 7) has an entry of its own (ys_conv3x3_stem).
template <typename T, int S>
cudaError_t launch_conv(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
                        int Ci, int Co, int Cop, int act, int bn, int R, int Wt,
                        cudaStream_t stream) {
  if (Ci <= 7 || (Ci & 7) || (Cop & 7) || Cop < Co) return cudaErrorInvalidValue;
  // one m64 subtile a consumer warpgroup up to 128 flat rows, else two
  const bool two = R * (Wt + 3 - S) > 128;
  if (bn == 128)
    return two ? launch_tc<T, S, 128, 2>(x, w, b, y, B, H, W, Ci, Co, Cop, R, Wt, act, stream)
               : launch_tc<T, S, 128, 1>(x, w, b, y, B, H, W, Ci, Co, Cop, R, Wt, act, stream);
  if (bn == 64)
    return two ? launch_tc<T, S, 64, 2>(x, w, b, y, B, H, W, Ci, Co, Cop, R, Wt, act, stream)
               : launch_tc<T, S, 64, 1>(x, w, b, y, B, H, W, Ci, Co, Cop, R, Wt, act, stream);
  return cudaErrorInvalidValue;
}

// The 16-bit stem on csrc/stem.cuh's streaming kernel: K = 9 Ci in two k16
// steps (Ci <= 3) or four (Ci <= 7); the plan's rows, strips, ring slots,
// blocks an SM and channels a chunk.
template <typename T>
cudaError_t launch_stem16(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
                          int Ci, int Co, int S, int act, int R, int NB, int ns, int blocks,
                          int cg, cudaStream_t stream) {
  const int kst = 9 * Ci <= 32 ? 2 : 4;
  StemGeo g;
  if (blocks < 1 || blocks > 2 ||
      !stem_geometry(g, B, H, W, Ci, Co, 0, 3, S, 1, 2, 2, false, kst, R, NB, ns, cg, act))
    return cudaErrorInvalidValue;
  return kst == 2 ? launch_stem_kernel<T, false, 2>(x, w, b, nullptr, nullptr, y, g, blocks, stream)
                  : launch_stem_kernel<T, false, 4>(x, w, b, nullptr, nullptr, y, g, blocks, stream);
}

// The descriptor probe: D = A[r0 : r0 + 64] B for r0 = blockIdx.x, with A
// (128 x 64) loaded by TMA under the 128-byte swizzle and read through
// a_desc<64> from row r0, as conv_tc_kernel reads a tap's rows.
__global__ void __launch_bounds__(128)
desc_probe_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                  float* __restrict__ out) {
  extern __shared__ __align__(1024) uint8_t probe_smem[];
  const uint32_t a = (smem_u32(probe_smem) + 1023) & ~1023u;
  const uint32_t b = a + 128 * 128, bar = b + 64 * 128;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bar, 128 * 128 + 64 * 128);
    tma3(a, &amap, bar, 0, 0, 0);
    tma3(b, &bmap, bar, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma16<bf16, 64>(d, a_desc<64>(a + blockIdx.x * 128 + ks * 32),
                      smem_desc(b + ks * 16 * 128, 64 * 128, 1024, 1));
  wgmma_commit();
  wgmma_wait<0>();
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, q = lane & 3;
  float* o = out + (size_t)blockIdx.x * 64 * 64;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[(warp * 16 + gr + (j >> 1) * 8) * 64 + ni * 8 + 2 * q + (j & 1)] = d[ni * 4 + j];
}

}  // namespace

// Returns the CUDA error of the launch (0 on success; 10000 + a CUresult
// where a TMA tensor map could not be encoded). dtype: 0 float32 (CUDA
// cores; bn, R, Wt the plan's channel tile, strips of 8
// columns a row and Ci splits; part: the splits' (splits, B, Ho, Wo, Co)
// float32 workspace where splits > 1; Cop unused), 1 bfloat16 or 2 float16
// (tensor cores: bn 64 or 128 channels a block, R x Wt output pixels a
// block; Ci and Cop, the weights' Co, multiples of 8; part unused; the stem,
// Ci <= 7, is ys_conv3x3_stem).
extern "C" int ys_conv3x3(const void* x, const void* w, const void* b, void* y, void* part,
                          int B, int H, int W, int Ci, int Co, int Cop, int stride, int act,
                          int dtype, int bn, int R, int Wt, void* stream) {
  if (B == 0 || H == 0 || W == 0 || Co == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stride != 1 && stride != 2) return cudaErrorInvalidValue;
  if (dtype == 0)  // bn, R, Wt: the float32 plan's tn, sw, splits
    return stride == 1 ? launch_f32<1>(x, w, b, y, part, B, H, W, Ci, Co, act, bn, R, Wt, st)
                       : launch_f32<2>(x, w, b, y, part, B, H, W, Ci, Co, act, bn, R, Wt, st);
  if (dtype == 1)
    return stride == 1
               ? launch_conv<bf16, 1>(x, w, b, y, B, H, W, Ci, Co, Cop, act, bn, R, Wt, st)
               : launch_conv<bf16, 2>(x, w, b, y, B, H, W, Ci, Co, Cop, act, bn, R, Wt, st);
  if (dtype == 2)
    return stride == 1
               ? launch_conv<f16, 1>(x, w, b, y, B, H, W, Ci, Co, Cop, act, bn, R, Wt, st)
               : launch_conv<f16, 2>(x, w, b, y, B, H, W, Ci, Co, Cop, act, bn, R, Wt, st);
  return cudaErrorInvalidValue;
}

// The 16-bit stem (Ci <= 7): x (B, H, W, Ci), w (3, 3, Ci, Co), b (Co,), y
// (B, Ho, Wo, Co) of dtype 1 bfloat16 or 2 float16; stride 1 or 2, padding
// 1; the plan of kernels/conv3x3.py stem_plan. Returns the CUDA error of the
// launch (10000 + a CUresult where the band's tensor map could not be
// encoded).
extern "C" int ys_conv3x3_stem(const void* x, const void* w, const void* b, void* y, int B,
                               int H, int W, int Ci, int Co, int stride, int act, int dtype,
                               int rows, int strips, int ring, int blocks, int cg, void* stream) {
  if (B == 0 || H == 0 || W == 0 || Co == 0) return 0;
  if (stride != 1 && stride != 2) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_stem16<bf16>(x, w, b, y, B, H, W, Ci, Co, stride, act, rows, strips, ring,
                               blocks, cg, st);
  if (dtype == 2)
    return launch_stem16<f16>(x, w, b, y, B, H, W, Ci, Co, stride, act, rows, strips, ring,
                              blocks, cg, st);
  return cudaErrorInvalidValue;
}

// The descriptor probe (tests/test_torch_cuda.py): a (128, 64) and b (64, 64)
// bfloat16, row-major; out (nr0, 64, 64) float32 gets A[r0 : r0 + 64] B for
// each r0 < nr0 <= 64, read through the kernel's A descriptor.
extern "C" int ys_conv3x3_desc_probe(const void* a, const void* b, void* out, int nr0,
                                     void* stream) {
  if (nr0 < 1 || nr0 > 64) return cudaErrorInvalidValue;
  CUtensorMap am, bm;
  const uint64_t dims[3] = {64, 128, 1}, str[2] = {64, 64 * 128};
  const uint32_t abox[3] = {64, 128, 1}, bbox[3] = {64, 64, 1};
  int err = encode(&am, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a, dims, str, abox,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  const uint64_t bdims[3] = {64, 64, 1}, bstr[2] = {64, 64 * 64};
  if (!err)
    err = encode(&bm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, b, bdims, bstr, bbox,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const int smem = 1024 + 128 * 128 + 64 * 128 + 64;
  cudaError_t e = allow_smem(desc_probe_kernel, smem);
  if (e != cudaSuccess) return e;
  desc_probe_kernel<<<nr0, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      am, bm, static_cast<float*>(out));
  return cudaGetLastError();
}
