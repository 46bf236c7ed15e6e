// 3x3 convolution, stride 1 or 2, zero padding 1, with a per-channel bias
// (the folded BatchNorm) and an activation in the epilogue. Replaces the
// Pallas kernels yolosharp_tpu/kernels/conv3x3.py conv3x3_silu (stride 1)
// and conv3x3s2_silu (stride 2).
//
// x: (B, H, W, Ci) NHWC, w: (3, 3, Ci, Co) HWIO, bias: (Co,), y: (B, Ho, Wo, Co),
// all contiguous and of one type (float32, bfloat16 or float16); sums in
// float32.
// No divisibility limits: the ragged edges of the image, of Ci and of Co are
// masked or zero-filled.
//
// bfloat16 and float16 (the 16-bit routes, one template on the element type:
// both are 2 bytes, so layouts and descriptors are shared and only the MMA
// type suffix and the conversions differ): an implicit GEMM on Hopper's
// warpgroup MMA (conv_wg_kernel).
// M runs over the flat output pixels (b, ho, wo), N over Co, K = 9 * Ci one
// tap x 32 channels at a time. A block owns 128 pixels (two warpgroups of
// 64) x BN = 128 or 64 channels (128 where that grid still covers every SM;
// the wrapper picks BN).
// - Each k step copies A (128 pixels x 32 channels of one tap, 64 bytes a
//   row) and B (the weight rows [tap * Ci + ci][co]) into a 5-slot shared
//   ring with 16-byte cp.async, three steps ahead. A thread's A rows are
//   fixed for the whole K walk, so it computes their tap-(0, 0) input
//   offsets and which taps fall inside the image once; a tap outside (the
//   zero padding) or channels past Ci are zero-filled by the copy, and
//   stride 2 only changes the offsets. Ci % 8 != 0 and Co % 8 != 0 take a
//   scalar fill; the second k16 half of a chunk past Ci is skipped.
// - A is stored K-major with the 64-byte swizzle, B N-major with the
//   128-byte swizzle, the layouts wgmma reads through shared-memory
//   descriptors: each k16 half is one wgmma.m64nBNk16 (16-bit in, float32
//   sums) per warpgroup, with no ldmatrix and no operand registers. One
//   step's wgmma group stays in flight across the next barrier. The
//   epilogue adds the bias and the activation in float32 and rounds once to
//   the element type (paired stores).
// - The stem (Ci <= 7) packs its 9 taps x Ci channels into one K <= 64
//   instead, on mma.sync (conv_stem_kernel).
// Why flat M and not a halo tile of one image: an 8 x 16 halo tile covers a
// 20 x 20 map with half its rows empty; flat M fills every tile at any map
// size, at the price of reading each input pixel once per tap from L2.
// What bounds it: each k step copies 16 KB (BN = 128) from L2 into shared
// memory for 1 MFLOP, 64 flop per byte, and A is copied once per tap. At
// 80^2 128->128, batch 32, on an H100 80GB HBM3 at 700 W it runs at 271
// TFLOP/s (28% of the bf16 peak) while two blocks per SM copy ~17 bytes a
// cycle from L2, about what L2 delivers to one SM: fewer bytes per flop
// (wider tiles, A shared across taps) is what would take it further. The
// tensor cores read the operands from shared memory directly; an mma.sync
// version, whose warps loaded 3 KB of fragments per 16 products, ran at
// 0.6-0.8x this kernel's speed at batch 32.
//
// float32: the CUDA-core kernel (conv_f32_kernel) — TF32 would break the
// float32 contract. A block owns 8 x 16 output pixels x 64 channels, stages
// the halo tile and the weight slice 16 channels at a time as float32, and
// every thread accumulates a 4-pixel x 8-channel micro-tile.
#include "common.cuh"

using namespace ys;

namespace {

// ---------------------------------------------------------------- float32

constexpr int kTH = 8;     // output rows per block
constexpr int kTW = 16;    // output columns per block
constexpr int kTCO = 64;   // output channels per block
constexpr int kThreads = 256;

template <int S, int CK>
struct Geom {
  static constexpr int IH = (kTH - 1) * S + 3;  // staged input rows
  static constexpr int IW = (kTW - 1) * S + 3;  // staged input columns
  static constexpr int XS = (CK * IH * IW + 3) / 4 * 4;  // floats, 16-B aligned
  static constexpr int WS = 9 * CK * kTCO;
  static constexpr int kBytes = (XS + WS) * 4;
};

template <typename T, int S, int CK>
__global__ void __launch_bounds__(kThreads)
conv_f32_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
                T* __restrict__ y, int H, int W, int Ci, int Co, int Ho, int Wo, int act) {
  using G = Geom<S, CK>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [CK][IH][IW]
  float* ws = xs + G::XS;                       // [9 * CK][kTCO]

  const int tiles_w = (Wo + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / tiles_w) * kTH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const int co0 = blockIdx.y * kTCO;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 7;            // channels co0 + 8 tx .. + 8
  const int ty = tid >> 3;           // pixels: row ty / 4, columns 4 (ty % 4) .. + 4
  const int r = ty >> 2;
  const int c0 = (ty & 3) * 4;
  const int hi0 = h0 * S - 1;
  const int wi0 = w0 * S - 1;
  const T* xb = x + (size_t)b * H * W * Ci;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Ci; ci0 += CK) {
    // consecutive threads read consecutive channels of one pixel
    for (int i = tid; i < CK * G::IH * G::IW; i += kThreads) {
      const int c = i % CK;
      const int pix = i / CK;
      const int pr = pix / G::IW;
      const int pq = pix % G::IW;
      const int hi = hi0 + pr;
      const int wi = wi0 + pq;
      const int ci = ci0 + c;
      float v = 0.f;
      if (hi >= 0 && hi < H && wi >= 0 && wi < W && ci < Ci)
        v = to_f(xb[((size_t)hi * W + wi) * Ci + ci]);
      xs[(c * G::IH + pr) * G::IW + pq] = v;
    }
    for (int i = tid; i < G::WS; i += kThreads) {
      const int n = i % kTCO;
      const int kk = i / kTCO;  // tap * CK + c
      const int c = kk % CK;
      const int tap = kk / CK;
      const int ci = ci0 + c;
      const int co = co0 + n;
      float v = 0.f;
      if (ci < Ci && co < Co) v = to_f(w[((size_t)tap * Ci + ci) * Co + co]);
      ws[i] = v;
    }
    __syncthreads();

    for (int c = 0; c < CK; ++c) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const float* xrow = xs + (c * G::IH + r * S + kh) * G::IW + c0 * S;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = xrow[i * S + kw];
          const float4* wp =
              reinterpret_cast<const float4*>(ws + ((kh * 3 + kw) * CK + c) * kTCO + tx * 8);
          const float4 wa = wp[0];
          const float4 wb = wp[1];
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const int ho = h0 + r;
  if (ho >= Ho) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int wo = w0 + c0 + i;
    if (wo >= Wo) continue;
    T* yp = y + (((size_t)b * Ho + ho) * Wo + wo) * Co;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = co0 + tx * 8 + j;
      if (co < Co) yp[co] = from_f<T>(apply_act(acc[i][j] + to_f(bias[co]), act));
    }
  }
}

template <int S, int CK>
cudaError_t launch_f32(const void* x, const void* w, const void* b, void* y, int B, int H,
                       int W, int Ci, int Co, int act, cudaStream_t stream) {
  using G = Geom<S, CK>;
  const int Ho = (H - 1) / S + 1;
  const int Wo = (W - 1) / S + 1;
  auto kernel = conv_f32_kernel<float, S, CK>;
  cudaError_t err = allow_smem(kernel, G::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((Ho + kTH - 1) / kTH) * ((Wo + kTW - 1) / kTW), (Co + kTCO - 1) / kTCO, B);
  kernel<<<grid, kThreads, G::kBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(y), H, W, Ci, Co, Ho, Wo, act);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_f32_ck(const void* x, const void* w, const void* b, void* y, int B, int H,
                          int W, int Ci, int Co, int act, cudaStream_t stream) {
  // the 3-channel stem would waste 13 of 16 staged channels
  if (Ci <= 4) return launch_f32<S, 4>(x, w, b, y, B, H, W, Ci, Co, act, stream);
  return launch_f32<S, 16>(x, w, b, y, B, H, W, Ci, Co, act, stream);
}

// ------------------------------------------- 16-bit: bfloat16 and float16

constexpr int kBK = 32;     // input channels of one k step (of one tap)
constexpr int kStages = 5;  // cp.async ring: 3 steps in flight ahead of the one in use,
                            // one more that the previous step's wgmma may still read

// Byte offset of 16-byte unit u (0..3) of A row r (64 bytes a row), XOR-swizzled
// by the row's 128-byte line: the 64-byte swizzle of a K-major wgmma operand.
__device__ __forceinline__ int a_off(int r, int u) { return r * 64 + ((u ^ ((r >> 1) & 3)) << 4); }
// Byte offset of unit nu of B row k: BN / 64 column blocks of [kBK][64] with
// 128-byte rows and the 128-byte swizzle of an N-major wgmma operand.
__device__ __forceinline__ int b_off(int k, int nu) {
  return ((nu >> 3) * kBK + k) * 128 + (((nu & 7) ^ (k & 7)) << 4);
}

// Eight elements [i, i + 8) of a row of n, zero past n (unaligned rows).
template <typename T>
__device__ __forceinline__ uint4 load8_masked(const T* p, int i, int n, bool ok) {
  __align__(16) T v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = ok && i + e < n ? p[e] : from_f<T>(0.f);
  return *reinterpret_cast<const uint4*>(v);
}

// Bias, activation, one rounding to T, paired stores. acc[mi][ni] is the
// m16 x n8 tile at flat output pixels m0 + 16 mi (y row m is pixel m, Co
// channels a row), channels co0 + 8 ni.
template <typename T, int MI, int NI>
__device__ __forceinline__ void store_tile(const float (&acc)[MI][NI][4], T* __restrict__ y,
                                           const T* __restrict__ bias, int M, int Co, int m0,
                                           int co0, int act) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  float bv[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int co = co0 + ni * 8 + 2 * q;
    bv[ni][0] = co < Co ? to_f(bias[co]) : 0.f;
    bv[ni][1] = co + 1 < Co ? to_f(bias[co + 1]) : 0.f;
  }
  const bool pairs = (Co & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + mi * 16 + g + half * 8;
      if (m >= M) continue;
      T* yp = y + (size_t)m * Co;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int co = co0 + ni * 8 + 2 * q;
        if (co >= Co) continue;
        const float v0 = apply_act_fast(acc[mi][ni][2 * half] + bv[ni][0], act);
        const float v1 = apply_act_fast(acc[mi][ni][2 * half + 1] + bv[ni][1], act);
        if (pairs) {
          *reinterpret_cast<uint32_t*>(yp + co) = Half16<T>::pack(v0, v1);
        } else {
          yp[co] = from_f<T>(v0);
          if (co + 1 < Co) yp[co + 1] = from_f<T>(v1);
        }
      }
    }
  }
}

// ---- the implicit GEMM on Hopper's warpgroup MMA (wgmma)

// D (64 x N, float32) += A (64 x 16, K-major) * B (16 x N, N-major), both
// read from shared memory through their descriptors; TY is the PTX type of
// A and B ("bf16" or "f16").
#define YS_WGMMA_N64(TY)                                                                         \
  asm volatile(                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                                \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, " \
      "1;\n}\n"                                                                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])            \
      : "l"(da), "l"(db), "r"(1))

#define YS_WGMMA_N128(TY)                                                                        \
  asm volatile(                                                                                  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                               \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "    \
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "     \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "     \
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),     \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),           \
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),           \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),           \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),           \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
        "+f"(d[62]), "+f"(d[63])                                                                 \
      : "l"(da), "l"(db), "r"(1))

template <typename T, int N>
__device__ __forceinline__ void wgmma16(float (&d)[N / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma16<bf16, 64>(float (&d)[32], uint64_t da, uint64_t db) {
  YS_WGMMA_N64("bf16");
}
template <>
__device__ __forceinline__ void wgmma16<f16, 64>(float (&d)[32], uint64_t da, uint64_t db) {
  YS_WGMMA_N64("f16");
}
template <>
__device__ __forceinline__ void wgmma16<bf16, 128>(float (&d)[64], uint64_t da, uint64_t db) {
  YS_WGMMA_N128("bf16");
}
template <>
__device__ __forceinline__ void wgmma16<f16, 128>(float (&d)[64], uint64_t da, uint64_t db) {
  YS_WGMMA_N128("f16");
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
// Shared-memory matrix descriptor: start address, leading / stride byte
// offsets, swizzle (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swz << 62);
}

// Implicit GEMM: C[m][co] = sum_k A[m][k] B[k][co] with m the flat output pixel
// (b, ho, wo), k = (chunk, tap, ci) and A[m][k] = x[b][ho*S-1+kh][wo*S-1+kw][ci].
// A block owns 128 pixels x BN channels: two warpgroups of 64 pixels each.
// Each k step (one tap x 32 channels) lands in a kStages-slot cp.async ring;
// its two k16 halves are two wgmma, read straight from the swizzled slot.
template <int BN>
struct Wg {
  static constexpr int AB = 128 * kBK * 2;                // A slot [128][kBK]
  static constexpr int BB = kBK * BN * 2;                 // B slot
  static constexpr int kStage = AB + BB;                  // a multiple of 1024
  static constexpr int kBytes = kStages * kStage + 1024;  // + alignment slack
};

template <typename T, int S, int BN>
__global__ void __launch_bounds__(kThreads, 2)
conv_wg_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ y, int H, int W, int Ci, int Co,
               int Ho, int Wo, int M, int act) {
  using G = Wg<BN>;
  constexpr int BM = 128, AR = 2, BU = BN / 64;
  extern __shared__ __align__(128) uint4 smem[];
  const uint32_t raw_base = smem_u32(smem);
  const uint32_t sbase = (raw_base + 1023) & ~1023u;
  char* const sptr = reinterpret_cast<char*>(smem) + (sbase - raw_base);

  const int ntiles = (Co + BN - 1) / BN;
  const int m0 = (blockIdx.x / ntiles) * BM;
  const int co0 = (blockIdx.x % ntiles) * BN;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const bool xvec = (Ci & 7) == 0;
  const bool wvec = (Co & 7) == 0;
  const int KT = 9 * ((Ci + kBK - 1) / kBK);

  const int au = tid & 3;
  long aoff[AR];
  int amask[AR];
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int m = m0 + (tid >> 2) + 64 * i;
    amask[i] = 0;
    aoff[i] = 0;
    if (m < M) {
      const int hw = Ho * Wo;
      const int b = m / hw, rem = m - b * hw;
      const int ho = rem / Wo, wo = rem - ho * Wo;
      const int hi = ho * S - 1, wi = wo * S - 1;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int h = hi + tap / 3, v = wi + tap % 3;
        if (h >= 0 && h < H && v >= 0 && v < W) amask[i] |= 1 << tap;
      }
      aoff[i] = (((long)b * H + hi) * W + wi) * Ci;
    }
  }

  auto stage = [&](int kt, int s) {
    const int ch = kt / 9, tap = kt - ch * 9;
    const int ci = ch * kBK + au * 8;
    const long toff = ((long)(tap / 3) * W + tap % 3) * Ci + ci;
    const uint32_t as = sbase + s * G::kStage;
    char* const ap = sptr + s * G::kStage;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const int r = (tid >> 2) + 64 * i;
      const bool ok = ((amask[i] >> tap) & 1) && ci < Ci;
      const T* src = ok ? x + aoff[i] + toff : x;
      if (xvec)
        cp_async16(as + a_off(r, au), src, ok);
      else
        *reinterpret_cast<uint4*>(ap + a_off(r, au)) = load8_masked(src, ci, Ci, ok);
    }
#pragma unroll
    for (int j = 0; j < BU; ++j) {
      const int idx = tid + kThreads * j;
      const int k = idx / (BN / 8), nu = idx % (BN / 8);
      const int cik = ch * kBK + k, co = co0 + nu * 8;
      const bool ok = cik < Ci && co < Co;
      const T* src = ok ? w + ((size_t)tap * Ci + cik) * Co + co : w;
      if (wvec)
        cp_async16(as + G::AB + b_off(k, nu), src, ok);
      else
        *reinterpret_cast<uint4*>(ap + G::AB + b_off(k, nu)) = load8_masked(src, co, Co, ok);
    }
  };

  float acc[1][BN / 8][4];
#pragma unroll
  for (int ni = 0; ni < BN / 8; ++ni)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[0][ni][j] = 0.f;
  float(&d)[BN / 2] = reinterpret_cast<float(&)[BN / 2]>(acc);

  constexpr int kAhead = kStages - 2;  // k steps in flight ahead of the one in use
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < KT) stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kAhead - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // copies -> wgmma's view
    __syncthreads();
    // the slot of step kt - 2 is free: its wgmma finished before step kt - 1's
    // wait returned, and every thread is past this barrier
    if (kt + kAhead < KT) stage(kt + kAhead, (kt + kAhead) % kStages);
    cp_async_commit();
    const uint32_t as = sbase + (kt % kStages) * G::kStage;
    const uint32_t bs = as + G::AB;
    // a second k16 half past Ci is all zero and skipped
    const int nks = Ci - (kt / 9) * kBK > 16 ? 2 : 1;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks >= nks) break;
      // A: 64 rows of the warpgroup, 64-byte swizzle, 8-row groups 512 bytes
      // apart; B: k rows 16 ks.., 128-byte swizzle, 8-row groups 1024 bytes
      // apart, 64-column blocks kBK * 128 bytes apart
      const uint64_t da = smem_desc(as + wg * 64 * 64 + ks * 32, 16, 512, 2);
      const uint64_t db = smem_desc(bs + ks * 16 * 128, kBK * 128, 1024, 1);
      wgmma16<T, BN>(d, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // step kt's products may run on past the next barrier
  }
  wgmma_wait<0>();
  const int warp = tid >> 5;
  store_tile<T, 1, BN / 8>(acc, y, bias, M, Co, m0 + wg * 64 + (warp & 3) * 16, co0, act);
}

template <typename T, int S, int BN>
cudaError_t launch_wg(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
                      int Ci, int Co, int act, cudaStream_t stream) {
  using G = Wg<BN>;
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const long M = (long)B * Ho * Wo;
  const long blocks = (M + 127) / 128 * ((Co + BN - 1) / BN);
  if (M > INT32_MAX || blocks > INT32_MAX) return cudaErrorInvalidValue;
  auto kernel = conv_wg_kernel<T, S, BN>;
  cudaError_t err = allow_smem(kernel, G::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, G::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), H, W, Ci, Co, Ho, Wo, (int)M, act);
  return cudaGetLastError();
}

// The stem (Ci <= 7): the 9 taps x Ci channels are packed into one K of at
// most 64 (k = tap * Ci + ci, the HWIO order) in KS k16 steps, instead of a
// zero-padded k16 step per tap. A block owns 8 x 32 output pixels x 32
// channels: it stages the input rows the tile reads as they lie in memory
// (IW * Ci elements a row), and each lane gathers its A fragments from them
// through offsets computed once (k -> tap, ci); its B fragments stay in
// registers. The stem reads 3 and writes 32 channels a pixel, so it is
// bound by memory latency: the block is small, for many blocks per SM.
template <int S>
struct Stem {
  static constexpr int TH = 8, TW = 32, BN = 32;
  static constexpr int IH = (TH - 1) * S + 3, IW = (TW - 1) * S + 3;
  static constexpr int kBytes = IH * IW * 7 * 2;
};

template <typename T, int S, int KS>
__global__ void __launch_bounds__(kThreads, 3)
conv_stem_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ bias, T* __restrict__ y, int H, int W, int Ci,
                 int Co, int Ho, int Wo, int act) {
  using G = Stem<S>;
  extern __shared__ __align__(128) uint4 smem[];
  T* raw = reinterpret_cast<T*>(smem);  // [IH][IW * Ci]
  const int K = 9 * Ci;
  const int rowlen = G::IW * Ci;

  const int tiles_w = (Wo + G::TW - 1) / G::TW;
  const int h0 = (blockIdx.x / tiles_w) * G::TH;
  const int w0 = (blockIdx.x % tiles_w) * G::TW;
  const int co0 = blockIdx.y * G::BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int hi0 = h0 * S - 1, wi0 = w0 * S - 1;
  const T* xb = x + (size_t)b * H * W * Ci;
  const T zero = from_f<T>(0.f);

  for (int i = tid; i < G::IH * rowlen; i += kThreads) {
    const int r = i / rowlen, e = i - r * rowlen;
    const int hi = hi0 + r, wi = wi0 + e / Ci;
    const bool ok = hi >= 0 && hi < H && wi >= 0 && wi < W;
    raw[i] = ok ? xb[((long)hi * W + wi0) * Ci + e] : zero;
  }
  // this lane's A elements k = 16 ks + 2q + {0, 1, 8, 9}: offsets from the
  // pixel's tap-(0, 0) element, -1 past K; its B fragments (column g)
  int koff[KS][4];
  uint32_t bw[KS][4][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = ks * 16 + 2 * q + (j & 1) + (j >> 1) * 8;
      const int tap = k / Ci, ci = k - tap * Ci;
      koff[ks][j] = k < K ? (tap / 3) * rowlen + (tap % 3) * Ci + ci : -1;
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int co = co0 + ni * 8 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = ks * 16 + 2 * q + h * 8;
        const float v0 = k < K && co < Co ? to_f(w[(size_t)k * Co + co]) : 0.f;
        const float v1 = k + 1 < K && co < Co ? to_f(w[(size_t)(k + 1) * Co + co]) : 0.f;
        bw[ks][ni][h] = Half16<T>::pack(v0, v1);
      }
    }
  }
  __syncthreads();

  // warp owns output row h0 + warp: two m16 tiles of 16 columns
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;
  auto at = [&](int base, int off) { return off >= 0 ? raw[base + off] : zero; };
  auto pack2 = [](T lo, T hi) { return Half16<T>::bits(lo) | (Half16<T>::bits(hi) << 16); };
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int base0 = warp * S * rowlen + (mi * 16 + g) * S * Ci;
    const int base1 = base0 + 8 * S * Ci;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int* o = koff[ks];
      const uint32_t a[4] = {pack2(at(base0, o[0]), at(base0, o[1])),
                             pack2(at(base1, o[0]), at(base1, o[1])),
                             pack2(at(base0, o[2]), at(base0, o[3])),
                             pack2(at(base1, o[2]), at(base1, o[3]))};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) Half16<T>::mma(acc[mi][ni], a, bw[ks][ni][0], bw[ks][ni][1]);
    }
  }
  const int ho = h0 + warp;
  if (ho >= Ho) return;
  const bool pairs = (Co & 1) == 0;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int co = co0 + ni * 8 + 2 * q;
    if (co >= Co) continue;
    const float b0 = to_f(bias[co]);
    const float b1 = co + 1 < Co ? to_f(bias[co + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int wo = w0 + mi * 16 + g + half * 8;
        if (wo >= Wo) continue;
        T* yp = y + (((size_t)b * Ho + ho) * Wo + wo) * Co + co;
        const float v0 = apply_act_fast(acc[mi][ni][2 * half] + b0, act);
        const float v1 = apply_act_fast(acc[mi][ni][2 * half + 1] + b1, act);
        if (pairs) {
          *reinterpret_cast<uint32_t*>(yp) = Half16<T>::pack(v0, v1);
        } else {
          yp[0] = from_f<T>(v0);
          if (co + 1 < Co) yp[1] = from_f<T>(v1);
        }
      }
  }
}

template <typename T, int S>
cudaError_t launch_stem(const void* x, const void* w, const void* b, void* y, int B, int H,
                        int W, int Ci, int Co, int act, cudaStream_t stream) {
  using G = Stem<S>;
  const int Ho = (H - 1) / S + 1, Wo = (W - 1) / S + 1;
  const dim3 grid(((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW),
                  (Co + G::BN - 1) / G::BN, B);
  auto kernel = conv_stem_kernel<T, S, 4>;
  switch ((9 * Ci + 15) / 16) {  // k16 steps of the packed K
    case 1: kernel = conv_stem_kernel<T, S, 1>; break;
    case 2: kernel = conv_stem_kernel<T, S, 2>; break;
    case 3: kernel = conv_stem_kernel<T, S, 3>; break;
    default: break;
  }
  cudaError_t err = allow_smem(kernel, G::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, G::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), H, W, Ci, Co, Ho, Wo, act);
  return cudaGetLastError();
}

// The stem (bn 0, Ci <= 7), else the wgmma kernel with bn channels a block:
// the wrapper picks bn (kernels/conv3x3.py n_tile: 128 where that grid still
// covers every SM, else 64) and the launch checks it.
template <typename T, int S>
cudaError_t launch_conv(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
                        int Ci, int Co, int act, int bn, cudaStream_t stream) {
  if ((bn == 0) != (Ci <= 7)) return cudaErrorInvalidValue;
  if (bn == 0) return launch_stem<T, S>(x, w, b, y, B, H, W, Ci, Co, act, stream);
  if (bn == 128) return launch_wg<T, S, 128>(x, w, b, y, B, H, W, Ci, Co, act, stream);
  if (bn == 64) return launch_wg<T, S, 64>(x, w, b, y, B, H, W, Ci, Co, act, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). dtype: 0 float32 (CUDA
// cores; bn unused), 1 bfloat16 or 2 float16 (tensor cores, bn channels a
// block: 0 for the stem, 64 or 128).
extern "C" int ys_conv3x3(const void* x, const void* w, const void* b, void* y, int B, int H,
                          int W, int Ci, int Co, int stride, int act, int dtype, int bn,
                          void* stream) {
  if (B == 0 || H == 0 || W == 0 || Co == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stride != 1 && stride != 2) return cudaErrorInvalidValue;
  if (dtype == 0)
    return stride == 1 ? launch_f32_ck<1>(x, w, b, y, B, H, W, Ci, Co, act, st)
                       : launch_f32_ck<2>(x, w, b, y, B, H, W, Ci, Co, act, st);
  if (dtype == 1)
    return stride == 1 ? launch_conv<bf16, 1>(x, w, b, y, B, H, W, Ci, Co, act, bn, st)
                       : launch_conv<bf16, 2>(x, w, b, y, B, H, W, Ci, Co, act, bn, st);
  if (dtype == 2)
    return stride == 1 ? launch_conv<f16, 1>(x, w, b, y, B, H, W, Ci, Co, act, bn, st)
                       : launch_conv<f16, 2>(x, w, b, y, B, H, W, Ci, Co, act, bn, st);
  return cudaErrorInvalidValue;
}
