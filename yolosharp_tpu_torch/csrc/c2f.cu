// One whole inference C2f block (n = 1, shortcut) with folded-BN biases:
//
//   y1 = silu(x @ w1 + b1)                    1x1, Cin -> 2c, split into a | bh
//   t  = silu(conv3x3(bh, wm1) + bm1)         zero padding
//   z  = bh + silu(conv3x3(t, wm2) + bm2)     the bottleneck's residual
//   y  = silu([a, bh, z] @ w2 + b2)           1x1, 3c -> C2
//
// x: (B, H, W, Cin) NHWC, w1: (Cin, 2c), wm1 / wm2: (3, 3, c, c) HWIO,
// w2: (3c, C2), biases 1-D, y: (B, H, W, C2); float32, bfloat16 or float16,
// sums in float32, every intermediate rounded to the working type as the plain
// version stores it. Replaces the Pallas kernel yolosharp_tpu/kernels/c2f.py
// c2f_fused.
//
// bfloat16 and float16 (c2f_tc_kernel, one template on the 16-bit element
// type T; the layouts are the same for both): the block's four GEMMs in one
// persistent, cooperative launch on Hopper's warpgroup MMA, in order over
// the whole batch, each ending at a grid barrier:
//   cv1  y1 = silu(x @ w1 + b1)           M = B H W pixels, K = Cin, N = 2c
//   t    silu(conv3x3(bh) + bm1)          flat-row tiles, K = 9c, N = c
//   z    bh + silu(conv3x3(t) + bm2)      the same tiles, K = 9c, N = c
//   cv2  y = silu([y1 | z] @ w2 + b2)     M = B H W, K = 3c, N = C2
// y1 (= [a | bh]), t and z go to a scratch buffer of the wrapper (B H W 4c
// elements: 26 MB at v8s layer 8 and batch 32, held by the 50 MB L2), so no
// block recomputes a halo and each weight tile serves a tile of up to 256
// pixel rows, where the tile-per-SM kernel this one replaced streamed all
// 3.7 MB of layer 8's weights for every 64 pixels and computed 1.83x its
// products. The 3x3 GEMMs take the TPU kernel's flat-row layout (a band of
// R + 2 rows of P = Wt + 2 pixels; every tap one shifted wgmma descriptor
// into it; junk columns computed and never stored), and their zero padding
// is TMA's out-of-bounds fill of boxes that start at -1, so no thread masks
// a pad ring. Each GEMM is tiled as conv3x3.cu's conv_tc_kernel is: one
// block an SM walks the tiles, a producer thread loads the A tiles (BK
// channels a chunk, up to 6 in flight) and each tap's BK x BN weights by
// TMA against mbarriers, two consumer warpgroups issue wgmma (MS m64
// subtiles each, BN = 64 or 128 columns). The epilogue adds the bias, takes
// the SiLU in one MUFU operation (tanh.approx), rounds to T where the plain
// chain rounds, stages the tile in shared memory under the 128-byte swizzle
// and writes it with TMA stores. The plan (BK, BN, MS and the 3x3 tile)
// comes from the wrapper (kernels/c2f.py c2f_plan).
// What bounds it (H100 80GB HBM3, bf16, batch 32; numbers in PERF.md): at v8s
// layer 2 (160^2, c = 32) the consumers, not the bytes: with the products
// and the epilogues switched off (a debug build) the loads alone take about
// half of the launch, and the epilogues, which the next tile's products do
// not overlap, most of the rest. Fusing t and z into one pass a tile (t on
// a halo window in shared memory, the narrow class's other design) halved
// the 3x3 GEMMs' traffic but lengthened each tile's serial chain, and did
// not pay; nor did letting each consumer warpgroup stage and store its own
// rows, so that one's epilogue could overlap the other's products. At layer
// 8 (20^2, c = 256) the products, at about a third of the peak, and three
// grid barriers; 128-wide N tiles take one m64 subtile a warpgroup (two
// would hold 128 accumulators a thread, which spill).
//
// float32 (c2f_f32_kernel): the CUDA-core kernel. A block owns a TT x TT
// tile of output pixels of one image. Two chained 3x3 convolutions need a
// 2-pixel halo, so the block computes bh on the (TT+4)^2 window, t on the
// (TT+2)^2 window and a, z and y on the tile, all in shared memory: only y
// goes back to device memory. bh and t are zeroed outside the image after
// their SiLU (silu(bias) != 0 there), which is the zero padding the plain
// convolutions see. The footprint (float32 intermediates) grows with c, so
// the tile is 8 for c <= 64 and 4 above; the input is staged in chunks of 32
// channels. Each thread computes 4-pixel x 4-channel micro-tiles; weights
// are read from device memory through the caches.
#include <algorithm>
#include <cstring>

#include "common.cuh"

using namespace ys;

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;  // input channels staged per chunk

template <int TT>
struct Geom {
  static constexpr int E2 = TT + 4, E1 = TT + 2;
  static constexpr int R2 = E2 * E2, R1 = E1 * E1, R0 = TT * TT;
  static int floats(int c) { return R2 * kKC + c * (R2 + R1 + 2 * R0); }
};

template <typename T, int TT>
__global__ void __launch_bounds__(kThreads)
c2f_f32_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
               const T* __restrict__ wm1, const T* __restrict__ bm1, const T* __restrict__ wm2,
               const T* __restrict__ bm2, const T* __restrict__ w2, const T* __restrict__ b2,
               T* __restrict__ y, int H, int W, int Cin, int c, int C2) {
  using G = Geom<TT>;
  constexpr int E2 = G::E2, E1 = G::E1, R2 = G::R2, R1 = G::R1, R0 = G::R0;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [R2][kKC] input chunk
  float* bh = xs + R2 * kKC;                    // [R2][c]
  float* ts = bh + R2 * c;                      // [R1][c]
  float* as = ts + R1 * c;                      // [R0][c]
  float* zs = as + R0 * c;                      // [R0][c]

  const int tiles_w = (W + TT - 1) / TT;
  const int h0 = (blockIdx.x / tiles_w) * TT;
  const int w0 = (blockIdx.x % tiles_w) * TT;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int G4 = c / 4;          // channel groups of 4
  const int c2x = 2 * c;
  const T* xb = x + (size_t)b * H * W * Cin;

  // ---- cv1: bh on the (TT+4)^2 window, a on the tile; sums kept in smem
  const int n_bh = (R2 / 4) * G4;
  const int n_a = (R0 / 4) * G4;
  for (int ci0 = 0; ci0 < Cin; ci0 += kKC) {
    for (int i = tid; i < R2 * kKC; i += kThreads) {
      const int k = i % kKC;
      const int p = i / kKC;
      const int hi = h0 - 2 + p / E2;
      const int wi = w0 - 2 + p % E2;
      const int ci = ci0 + k;
      float v = 0.f;
      if (hi >= 0 && hi < H && wi >= 0 && wi < W && ci < Cin)
        v = to_f(xb[((size_t)hi * W + wi) * Cin + ci]);
      xs[i] = v;
    }
    __syncthreads();
    const int kn = min(kKC, Cin - ci0);
    for (int item = tid; item < n_bh + n_a; item += kThreads) {
      const bool is_a = item >= n_bh;
      const int it = is_a ? item - n_bh : item;
      const int pg = it / G4;
      const int g = it % G4;
      int src[4];
      float* dst[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = pg * 4 + i;
        src[i] = is_a ? ((p / TT + 2) * E2 + p % TT + 2) : p;
        dst[i] = (is_a ? as : bh) + p * c + g * 4;
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = ci0 == 0 ? 0.f : dst[i][j];
      const T* wp = w1 + (size_t)ci0 * c2x + (is_a ? 0 : c) + g * 4;
      for (int k = 0; k < kn; ++k) {
        float wv[4];
        load4(wp + (size_t)k * c2x, wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = xs[src[i] * kKC + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[i][j] = acc[i][j];
    }
    __syncthreads();
  }
  for (int i = tid; i < R2 * c; i += kThreads) {
    const int p = i / c;
    const int n = i % c;
    const int hi = h0 - 2 + p / E2;
    const int wi = w0 - 2 + p % E2;
    const bool inside = hi >= 0 && hi < H && wi >= 0 && wi < W;
    bh[i] = inside ? round_t<T>(silu(bh[i] + to_f(b1[c + n]))) : 0.f;
  }
  for (int i = tid; i < R0 * c; i += kThreads)
    as[i] = round_t<T>(silu(as[i] + to_f(b1[i % c])));
  __syncthreads();

  // ---- bottleneck cv1: t on the (TT+2)^2 window
  for (int item = tid; item < (R1 / 4) * G4; item += kThreads) {
    const int pg = item / G4;
    const int g = item % G4;
    int base[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pg * 4 + i;
      base[i] = (p / E1) * E2 + p % E1;  // tap (0, 0) in the bh window
    }
    float acc[4][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * E2 + tap % 3;
      const T* wp = wm1 + (size_t)tap * c * c + g * 4;
      for (int k = 0; k < c; ++k) {
        float wv[4];
        load4(wp + (size_t)k * c, wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = bh[(base[i] + off) * c + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pg * 4 + i;
      const int hi = h0 - 1 + p / E1;
      const int wi = w0 - 1 + p % E1;
      const bool inside = hi >= 0 && hi < H && wi >= 0 && wi < W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = g * 4 + j;
        ts[p * c + n] = inside ? round_t<T>(silu(acc[i][j] + to_f(bm1[n]))) : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- bottleneck cv2 + residual: z on the tile
  for (int item = tid; item < (R0 / 4) * G4; item += kThreads) {
    const int pg = item / G4;
    const int g = item % G4;
    int base[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pg * 4 + i;
      base[i] = (p / TT) * E1 + p % TT;  // tap (0, 0) in the t window
    }
    float acc[4][4] = {};
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * E1 + tap % 3;
      const T* wp = wm2 + (size_t)tap * c * c + g * 4;
      for (int k = 0; k < c; ++k) {
        float wv[4];
        load4(wp + (size_t)k * c, wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = ts[(base[i] + off) * c + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pg * 4 + i;
      const int center = ((p / TT + 2) * E2 + p % TT + 2) * c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = g * 4 + j;
        const float u = round_t<T>(silu(acc[i][j] + to_f(bm2[n])));
        zs[p * c + n] = round_t<T>(bh[center + n] + u);
      }
    }
  }
  __syncthreads();

  // ---- cv2 over the concat [a, bh, z]: the block output
  const int G2 = C2 / 4;
  for (int item = tid; item < (R0 / 4) * G2; item += kThreads) {
    const int pg = item / G2;
    const int g = item % G2;
    const float* srcs[3][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pg * 4 + i;
      srcs[0][i] = as + p * c;
      srcs[1][i] = bh + ((p / TT + 2) * E2 + p % TT + 2) * c;
      srcs[2][i] = zs + p * c;
    }
    float acc[4][4] = {};
#pragma unroll
    for (int part = 0; part < 3; ++part) {
      const T* wp = w2 + (size_t)part * c * C2 + g * 4;
      for (int k = 0; k < c; ++k) {
        float wv[4];
        load4(wp + (size_t)k * C2, wv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = srcs[part][i][k];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = pg * 4 + i;
      const int ho = h0 + p / TT;
      const int wo = w0 + p % TT;
      if (ho >= H || wo >= W) continue;
      T* yp = y + (((size_t)b * H + ho) * W + wo) * C2 + g * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) yp[j] = from_f<T>(silu(acc[i][j] + to_f(b2[g * 4 + j])));
    }
  }
}


template <int TT>
cudaError_t launch_f32(const void* const* p, void* y, int B, int H, int W, int Cin, int c,
                       int C2, cudaStream_t stream) {
  const int bytes = Geom<TT>::floats(c) * 4;
  auto kernel = c2f_f32_kernel<float, TT>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((H + TT - 1) / TT) * ((W + TT - 1) / TT), B);
  const float* const* f = reinterpret_cast<const float* const*>(p);
  kernel<<<grid, kThreads, bytes, stream>>>(f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8],
                                            static_cast<float*>(y), H, W, Cin, c, C2);
  return cudaGetLastError();
}


// ------------------------------------------- 16-bit: bfloat16 and float16

constexpr int kTcConsumers = 2;  // warpgroups that issue wgmma
constexpr int kTcThreads = 128 * (kTcConsumers + 1);
constexpr int kMinBStages = 4, kMaxBStages = 8;  // slots of the weight ring
constexpr int kMaxAStages = 6;                   // slots of A tiles (at least 2)
constexpr int kBlockBarrier = 1;                 // the named barrier of all threads
constexpr int kEpiBarrier = 2;                   // the consumers' (those with rows)

// The block's four GEMMs, in the order the launch runs them.
enum Gemm : int { kCv1 = 0, kT = 1, kZ = 2, kCv2 = 3, kGemms = 4 };

// One GEMM of the launch and its tiles. 1x1 (cv1, cv2): a tile is `rows`
// consecutive pixels of the batch (flat over B, H, W) x BN channels. 3x3
// (t, z): a tile is R output rows x Wt columns of one image x BN channels;
// its input is the padded band of R + 2 rows of P = Wt + 2 pixels, so
// output (i, j) is flat row m = i P + j and tap (dy, dx) reads row
// m + dy P + dx: one run of rows a tap, read through a shifted descriptor.
// Rows with j >= Wt are junk, computed and never stored.
struct GemmGeo {
  int spatial;  // 1 for the 3x3 GEMMs
  int N, nco;   // output channels, their tiles of BN
  int wgs;      // consumer warpgroups with rows; the other passes the slots on
  int rows;     // flat rows of a tile: R P (3x3) or 64 MS wgs (1x1)
  int R, Wt, P, nwt, nbands;
  int ntiles;
  int nk0, nk1;  // K chunks of the first and the second A source
  int kb1;       // the weight row of the second source's first chunk
  int a_tx;      // bytes one A load writes
};

struct C2fGeo {
  int H, W, c, npix;
  int a_stage;  // bytes of an A slot (a multiple of 1024)
  int nas;      // A slots: as many as leave room for kMinBStages weight slots
  int nbs;      // slots of the weight ring
  GemmGeo gm[kGemms];
};

// Loads: x, y1 (= [a | bh], cv1's output) and z as 2-d (channels, pixels);
// bh (y1's last c channels) and t as 4-d (channels, W, H, B), whose
// out-of-bounds boxes read the zero padding; the weights as (N, K, taps).
// Stores (64 channels a box, the rows of a tile): y1 and y 2-d, t and z 4-d,
// whose boxes are cut at the tensor's edges.
struct C2fMaps {
  CUtensorMap x, y1, z, bh, t;
  CUtensorMap w1, wm1, wm2, w2;
  CUtensorMap y1s, ts, zs, ys;
};

template <typename T>
struct C2fOut {
  const T *b1, *bm1, *bm2, *b2;
  T *y1, *t, *z, *y;  // y1, t and z: the wrapper's scratch (in L2 at the deep shapes)
  unsigned* bar;      // the grid barrier: arrivals, generation
};

__device__ __forceinline__ void sync_block() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBlockBarrier), "n"(kTcThreads) : "memory");
}

// The consumer warpgroups with rows in this GEMM (n threads).
__device__ __forceinline__ void sync_consumers(int n) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kEpiBarrier), "r"(n) : "memory");
}

__device__ __forceinline__ void st_shared32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// TMA stores from shared memory (one bulk group a tile): elements outside
// the tensor are not written.
__device__ __forceinline__ void tma_store2(const CUtensorMap* m, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::
                   "l"(reinterpret_cast<uint64_t>(m)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store4(const CUtensorMap* m, uint32_t src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the stores in flight have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and written the device memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Every block of the grid has arrived: the global stores each thread made
// before are visible to every block's loads (TMA included) after. bar[0]
// counts the arrivals and is reset by the last one, which then moves bar[1],
// the generation, on, so the barrier needs no reset between launches. The
// launch is cooperative, so every block is resident; a wait of more than
// ~10 s traps all the same instead of hanging the card.
__device__ __forceinline__ void sync_grid(unsigned* bar) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  sync_block();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long start = clock64();
      while (*gen == g0)
        if (clock64() - start > 20000000000LL) __trap();
    }
    __threadfence();
  }
  sync_block();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

struct Tile {
  int b, h0, w0, pix0, co0;
};

// tile t of a GEMM, the N tile fastest: blocks working at once share their
// A tile in L2
__device__ __forceinline__ Tile tile_of(const GemmGeo& q, int t, int BN) {
  Tile r;
  r.co0 = (t % q.nco) * BN;
  t /= q.nco;
  if (q.spatial) {
    r.w0 = (t % q.nwt) * q.Wt;
    t /= q.nwt;
    r.h0 = (t % q.nbands) * q.R;
    r.b = t / q.nbands;
    r.pix0 = 0;
  } else {
    r.pix0 = t * q.rows;
    r.b = r.h0 = r.w0 = 0;
  }
  return r;
}

// SiLU of a value that is rounded to 16 bits right after, in one MUFU
// operation: silu(v) = v/2 (1 + tanh(v/2)) through tanh.approx (relative
// error ~2^-11, so at most |v| 2^-12 off), against two for ex2 and rcp: the
// MUFU rate bounds the epilogues at c = 32.
__device__ __forceinline__ float silu16(float v) {
  const float h = 0.5f * v;
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(h));
  return fmaf(h, th, h);
}

// The value of the low T of a pair of T.
template <typename T>
__device__ __forceinline__ float unpack_lo(uint32_t pair) {
  if constexpr (std::is_same<T, bf16>::value)
    return __uint_as_float(pair << 16);
  else
    return __half2float(__ushort_as_half((unsigned short)(pair & 0xFFFFu)));
}

// Bias, SiLU and the roundings of this warp's 16 rows m0.. of a 64 x BN
// accumulator of GEMM G, as the plain chain stores them: y1 = silu(.),
// t = silu(.), z = bh + silu(.) with both terms rounded to T, y = silu(.).
// The rounded pairs go to the tile's staging buffer: the tile's output
// pixels (1x1: flat row m; 3x3: i Wt + j, the junk rows left out) as
// 128-byte rows of 64 channels under the 128-byte swizzle, one block of
// rows per 64 channels, which the TMA stores read. bv holds the tile's
// biases (loaded before its mainloop); z's residual pairs are all loaded
// before the first is used.
template <typename T, int BN, int G>
__device__ __forceinline__ void stage_rows(const float (&d)[BN / 2], const float (&bv)[BN / 8][2],
                                           const C2fGeo& g, const GemmGeo& q,
                                           const C2fOut<T>& o, int m0, const Tile& tl,
                                           uint32_t stage, int block_bytes) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, qd = lane & 3;
  int sr[2];
  long pix[2];
  bool ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + gr + half * 8;
    if (G == kT || G == kZ) {
      const int i = m / q.P, j = m - i * q.P;
      ok[half] = i < q.R && j < q.Wt && tl.w0 + j < g.W && tl.h0 + i < g.H;
      sr[half] = i * q.Wt + j;
      pix[half] = ((long)tl.b * g.H + tl.h0 + i) * g.W + tl.w0 + j;
    } else {
      sr[half] = m;
      pix[half] = (long)tl.pix0 + m;
      ok[half] = pix[half] < g.npix;
    }
  }
  uint32_t res[2][BN / 8];  // z: bh's pairs, two T each
  if (G == kZ) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const T* r = o.y1 + pix[half] * 2 * g.c + g.c + tl.co0 + 2 * qd;
#pragma unroll
      for (int ni = 0; ni < BN / 8; ++ni)
        res[half][ni] = ok[half] && tl.co0 + ni * 8 < q.N
                            ? *reinterpret_cast<const uint32_t*>(r + ni * 8)
                            : 0u;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t row = stage + sr[half] * 128;
    const int sw = sr[half] & 7;
#pragma unroll
    for (int ni = 0; ni < BN / 8; ++ni) {
      if (tl.co0 + ni * 8 >= q.N) break;  // the same for the whole warp
      float v0 = silu16(d[ni * 4 + 2 * half] + bv[ni][0]);
      float v1 = silu16(d[ni * 4 + 2 * half + 1] + bv[ni][1]);
      if (G == kZ) {
        const uint32_t r = res[half][ni];
        v0 = unpack_lo<T>(r) + round_t<T>(v0);
        v1 = unpack_lo<T>(r >> 16) + round_t<T>(v1);
      }
      if (ok[half])
        st_shared32(row + (ni >> 3) * block_bytes + ((((ni & 7) ^ sw) << 4) | (qd * 4)),
                    Half16<T>::pack(v0, v1));
    }
  }
}

// The whole block in one persistent launch: the four GEMMs run in order over
// the batch, each ending at a grid barrier (the next reads what every block
// wrote). Warp specialisation as in conv3x3.cu's conv_tc_kernel: the last
// warpgroup's first thread is the producer, which for every tile and K chunk
// loads the A tile by TMA into a ring of nas slots and each tap's BK x BN
// weights into a ring of nbs slots, against mbarriers; warpgroups
// 0..wgs-1 wait, issue wgmma from the swizzled slots (MS m64 subtiles each,
// one group in flight) and release a slot once the group that read it is
// done; a consumer warpgroup without rows in a GEMM passes the slots on.
template <typename T, int BK, int BN, int MS>
__global__ void __launch_bounds__(kTcThreads, 1)
c2f_tc_kernel(const __grid_constant__ C2fMaps maps, const __grid_constant__ C2fGeo g,
              const C2fOut<T> o) {
  constexpr int kARow = BK * 2;  // bytes of an A row: one pixel's BK channels
  constexpr int kBSlot = BK * BN * 2;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  const uint32_t a0 = (smem_u32(tc_smem) + 1023) & ~1023u;
  // the staging buffer: BN / 64 blocks of 128 MS rows of 128 bytes
  constexpr int kStageBlock = 128 * MS * 128;
  const uint32_t stage = a0 + g.nas * g.a_stage;
  const uint32_t b0 = stage + BN / 64 * kStageBlock;
  const uint32_t bars = b0 + g.nbs * kBSlot;
  // a_full[kMaxAStages], a_empty[kMaxAStages], b_full[kMaxBStages], b_empty[kMaxBStages]
  const uint32_t a_full = bars, a_empty = bars + 8 * kMaxAStages,
                 b_full = bars + 16 * kMaxAStages, b_empty = b_full + 8 * kMaxBStages;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < g.nas; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, 4 * kTcConsumers);
    }
    for (int s = 0; s < g.nbs; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, 4 * kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int as = 0, aph = 0, bs = 0, bph = 0;
  auto next_a = [&] {
    if (++as == g.nas) {
      as = 0;
      aph ^= 1;
    }
  };
  auto next_b = [&] {
    if (++bs == g.nbs) {
      bs = 0;
      bph ^= 1;
    }
  };
  if (warp >= 4 * kTcConsumers) {
    // ---- producer
    setmaxnreg_dec<40>();
    for (int gi = 0; gi < kGemms; ++gi) {
      const GemmGeo& q = g.gm[gi];
      if (tid == 128 * kTcConsumers) {
        const CUtensorMap* wmap =
            gi == kCv1 ? &maps.w1 : gi == kT ? &maps.wm1 : gi == kZ ? &maps.wm2 : &maps.w2;
        const int taps = q.spatial ? 9 : 1;
        for (int t = blockIdx.x; t < q.ntiles; t += gridDim.x) {
          const Tile tl = tile_of(q, t, BN);
          for (int kc = 0; kc < q.nk0 + q.nk1; ++kc) {
            const bool second = kc >= q.nk0;
            const int c0 = (second ? kc - q.nk0 : kc) * BK;
            mbar_wait(a_empty + 8 * as, aph ^ 1);
            mbar_expect(a_full + 8 * as, q.a_tx);
            const uint32_t dst = a0 + as * g.a_stage, full = a_full + 8 * as;
            if (gi == kCv1)
              tma2(dst, &maps.x, full, c0, tl.pix0);
            else if (gi == kCv2)
              tma2(dst, second ? &maps.z : &maps.y1, full, c0, tl.pix0);
            else  // the band starts one row up and one column left: the padding
              tma4(dst, gi == kT ? &maps.bh : &maps.t, full, c0, tl.w0 - 1, tl.h0 - 1, tl.b);
            next_a();
            const int krow = second ? q.kb1 + c0 : c0;
            for (int tap = 0; tap < taps; ++tap) {
              mbar_wait(b_empty + 8 * bs, bph ^ 1);
              mbar_expect(b_full + 8 * bs, kBSlot);
              const uint32_t bd = b0 + bs * kBSlot;
#pragma unroll
              for (int j = 0; j < BN / 64; ++j)
                tma3(bd + j * BK * 128, wmap, b_full + 8 * bs, tl.co0 + 64 * j, krow, tap);
              next_b();
            }
          }
        }
      }
      if (gi + 1 < kGemms) sync_grid(o.bar);
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<232>();
    const int wg = warp >> 2;
    const int mw = 64 * MS * wg;  // this warpgroup's first flat row
    float acc0[BN / 2], acc1[BN / 2];
    for (int gi = 0; gi < kGemms; ++gi) {
      const GemmGeo q = g.gm[gi];
      const int taps = q.spatial ? 9 : 1;
      const int nk = q.nk0 + q.nk1;
      const T* bias = gi == kCv1 ? o.b1 : gi == kT ? o.bm1 : gi == kZ ? o.bm2 : o.b2;
      if (wg < q.wgs) {
        for (int t = blockIdx.x; t < q.ntiles; t += gridDim.x) {
          const Tile tl = tile_of(q, t, BN);
          float bv[BN / 8][2];  // in flight during the mainloop
#pragma unroll
          for (int ni = 0; ni < BN / 8; ++ni) {
            const int co = tl.co0 + ni * 8 + 2 * (lane & 3);
            bv[ni][0] = co < q.N ? to_f(bias[co]) : 0.f;
            bv[ni][1] = co < q.N ? to_f(bias[co + 1]) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0.f;
          int rel_b = -1, rel_a = -1;  // slots whose reads the group in flight may still make
          for (int kc = 0; kc < nk; ++kc) {
            mbar_wait(a_full + 8 * as, aph);
            const uint32_t abase = a0 + as * g.a_stage + mw * kARow;
            for (int tap = 0; tap < taps; ++tap) {
              const int off = q.spatial ? (tap / 3) * q.P + tap % 3 : 0;
              const uint32_t at = abase + off * kARow;
              mbar_wait(b_full + 8 * bs, bph);
              const uint32_t bsm = b0 + bs * kBSlot;
              wgmma_fence();
#pragma unroll
              for (int ks = 0; ks < BK / 16; ++ks) {
                // B: k rows 16 ks.., 128-byte swizzle, 8-row groups 1024
                // bytes apart, 64-column blocks BK * 128 bytes apart
                const uint64_t db = smem_desc(bsm + ks * 16 * 128, BK * 128, 1024, 1);
                wgmma16<T, BN>(acc0, a_desc<BK>(at + ks * 32), db);
                if constexpr (MS == 2)
                  wgmma16<T, BN>(acc1, a_desc<BK>(at + 64 * kARow + ks * 32), db);
              }
              wgmma_commit();
              wgmma_wait<1>();  // the previous tap's group is done: release its slots
              if (lane == 0) {
                if (rel_b >= 0) mbar_arrive(b_empty + 8 * rel_b);
                if (rel_a >= 0) mbar_arrive(a_empty + 8 * rel_a);
              }
              rel_b = bs;
              rel_a = tap == taps - 1 ? as : -1;
              next_b();
            }
            next_a();
          }
          wgmma_wait<0>();
          if (lane == 0) {  // the producer may fill the last slots with the next tile
            mbar_arrive(b_empty + 8 * rel_b);
            mbar_arrive(a_empty + 8 * rel_a);
          }
          // the last tile's stores have read the staging buffer
          if (tid == 0) bulk_wait_read();
          sync_consumers(128 * q.wgs);
          const int m0 = mw + (warp & 3) * 16;
          auto staged = [&](auto kind) {
            constexpr int G = decltype(kind)::value;
            stage_rows<T, BN, G>(acc0, bv, g, q, o, m0, tl, stage, kStageBlock);
            if constexpr (MS == 2)
              stage_rows<T, BN, G>(acc1, bv, g, q, o, m0 + 64, tl, stage, kStageBlock);
          };
          switch (gi) {
            case kCv1: staged(std::integral_constant<int, kCv1>()); break;
            case kT: staged(std::integral_constant<int, kT>()); break;
            case kZ: staged(std::integral_constant<int, kZ>()); break;
            default: staged(std::integral_constant<int, kCv2>());
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          sync_consumers(128 * q.wgs);
          if (tid == 0) {
            const CUtensorMap* m =
                gi == kCv1 ? &maps.y1s : gi == kT ? &maps.ts : gi == kZ ? &maps.zs : &maps.ys;
#pragma unroll
            for (int jb = 0; jb < BN / 64; ++jb) {
              const int co = tl.co0 + 64 * jb;
              if (co >= q.N) continue;
              const uint32_t src = stage + jb * kStageBlock;
              if (q.spatial)
                tma_store4(m, src, co, tl.w0, tl.h0, tl.b);
              else
                tma_store2(m, src, co, tl.pix0);
            }
            bulk_commit();
          }
        }
        if (tid == 0) bulk_wait();  // the GEMM's output is in device memory
      } else {
        // no rows in this GEMM: pass every slot on as it fills
        for (int t = blockIdx.x; t < q.ntiles; t += gridDim.x) {
          for (int kc = 0; kc < nk; ++kc) {
            mbar_wait(a_full + 8 * as, aph);
            for (int tap = 0; tap < taps; ++tap) {
              mbar_wait(b_full + 8 * bs, bph);
              if (lane == 0) mbar_arrive(b_empty + 8 * bs);
              next_b();
            }
            if (lane == 0) mbar_arrive(a_empty + 8 * as);
            next_a();
          }
        }
      }
      if (gi + 1 < kGemms) sync_grid(o.bar);
    }
  }
}

// The plan's geometry and shared memory (kernels/c2f.py tc_smem mirrors
// it); false where the plan does not fit.
template <int BK, int MS>
bool tc_geometry(C2fGeo& g, int B, int H, int W, int Cin, int c, int C2, int BN, int R,
                 int Wt, int& smem) {
  const long npix = (long)B * H * W;
  if (npix > INT32_MAX / 4) return false;
  g.H = H;
  g.W = W;
  g.c = c;
  g.npix = (int)npix;
  auto cdiv = [](long a, long b) { return (int)((a + b - 1) / b); };
  // 1x1: both consumer warpgroups where the batch has the pixels
  const int wgs1 = g.npix > 64 * MS ? 2 : 1;
  auto one = [&](GemmGeo& q, int N, int nk0, int nk1, int kb1) {
    q.spatial = 0;
    q.N = N;
    q.nco = cdiv(N, BN);
    q.wgs = wgs1;
    q.rows = 64 * MS * wgs1;
    q.R = q.Wt = q.P = q.nwt = q.nbands = 0;
    q.ntiles = cdiv(npix, q.rows) * q.nco;
    q.nk0 = nk0;
    q.nk1 = nk1;
    q.kb1 = kb1;
    q.a_tx = q.rows * BK * 2;
  };
  auto three = [&](GemmGeo& q) {
    q.spatial = 1;
    q.N = c;
    q.nco = cdiv(c, BN);
    q.R = R;
    q.Wt = Wt;
    q.P = Wt + 2;
    q.rows = R * q.P;
    q.wgs = cdiv(q.rows, 64 * MS);
    q.nwt = cdiv(W, Wt);
    q.nbands = cdiv(H, R);
    q.ntiles = B * q.nbands * q.nwt * q.nco;
    q.nk0 = cdiv(c, BK);
    q.nk1 = q.kb1 = 0;
    q.a_tx = (R + 2) * q.P * BK * 2;
  };
  if (R < 1 || Wt < 1 || Wt + 2 > 256 || R + 2 > 256 || R * (Wt + 2) > 64 * MS * kTcConsumers)
    return false;
  one(g.gm[kCv1], 2 * c, cdiv(Cin, BK), 0, 0);
  three(g.gm[kT]);
  three(g.gm[kZ]);
  one(g.gm[kCv2], C2, cdiv(2 * c, BK), cdiv(c, BK), 2 * c);
  // an A slot: the rows the wgmma read (a tap starts up to 2 P + 2 rows in)
  const int reach1 = 64 * MS * wgs1, reach3 = 64 * MS * g.gm[kT].wgs + 2 * (Wt + 2) + 2;
  g.a_stage = (std::max(reach1, reach3) * BK * 2 + 1023) / 1024 * 1024;
  // the A slots first (up to kMaxAStages, so that the narrow GEMMs keep
  // several tiles' loads in flight), then the weight ring in what is left
  const int bslot = BK * BN * 2,
            fixed = 1024 + BN / 64 * 128 * MS * 128 + 16 * (kMaxAStages + kMaxBStages);
  g.nas = std::min(kMaxAStages, (232448 - fixed - kMinBStages * bslot) / g.a_stage);
  if (g.nas < 2) return false;
  g.nbs = std::min(kMaxBStages, (232448 - fixed - g.nas * g.a_stage) / bslot);
  if (g.nbs < kMinBStages) return false;
  smem = fixed + g.nas * g.a_stage + g.nbs * bslot;
  return true;
}

template <typename T, int BK, int BN, int MS>
cudaError_t launch_tc(const void* const* p, void* y, void* scratch, void* bar, int B, int H,
                      int W, int Cin, int c, int C2, int R, int Wt, cudaStream_t stream) {
  C2fGeo g;
  int smem;
  if (!tc_geometry<BK, MS>(g, B, H, W, Cin, c, C2, BN, R, Wt, smem))
    return cudaErrorInvalidValue;
  const T* const* t = reinterpret_cast<const T* const*>(p);
  T* s = static_cast<T*>(scratch);  // y1 (npix, 2c), t (npix, c), z (npix, c)
  const size_t npix = g.npix;
  const C2fOut<T> out{t[2], t[4], t[6], t[8], s, s + npix * 2 * c, s + npix * 3 * c,
                      static_cast<T*>(y), static_cast<unsigned*>(bar)};
  C2fMaps maps;
  memset(&maps, 0, sizeof(maps));
  const CUtensorMapSwizzle a_swz = BK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_64B;
  const uint32_t box2[2] = {(uint32_t)BK, (uint32_t)g.gm[kCv1].rows};
  const GemmGeo& q3 = g.gm[kT];
  const uint32_t box4[4] = {(uint32_t)BK, (uint32_t)q3.P, (uint32_t)(R + 2), 1};
  const uint32_t wbox[3] = {64, (uint32_t)BK, 1};
  const uint64_t hw = (uint64_t)H * W;
  auto flat = [&](CUtensorMap* m, const void* base, int C) {
    const uint64_t dims[2] = {(uint64_t)C, npix}, str[1] = {(uint64_t)C};
    return encode(m, tma_type<T>(), 2, base, dims, str, box2, a_swz);
  };
  auto image = [&](CUtensorMap* m, const void* base, int ld) {
    const uint64_t dims[4] = {(uint64_t)c, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t str[3] = {(uint64_t)ld, (uint64_t)ld * W, (uint64_t)ld * hw};
    return encode(m, tma_type<T>(), 4, base, dims, str, box4, a_swz);
  };
  auto weights = [&](CUtensorMap* m, const void* base, int N, int K, int taps) {
    const uint64_t dims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)taps};
    const uint64_t str[2] = {(uint64_t)N, (uint64_t)N * K};
    return encode(m, tma_type<T>(), 3, base, dims, str, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  int err = flat(&maps.x, t[0], Cin);
  if (!err) err = flat(&maps.y1, out.y1, 2 * c);
  if (!err) err = flat(&maps.z, out.z, c);
  if (!err) err = image(&maps.bh, out.y1 + c, 2 * c);
  if (!err) err = image(&maps.t, out.t, c);
  if (!err) err = weights(&maps.w1, t[1], 2 * c, Cin, 1);
  if (!err) err = weights(&maps.wm1, t[3], c, c, 9);
  if (!err) err = weights(&maps.wm2, t[5], c, c, 9);
  if (!err) err = weights(&maps.w2, t[7], C2, 3 * c, 1);
  // the stores: 64 channels x a tile's rows (1x1) or its R x Wt pixels (3x3)
  const uint32_t sbox2[2] = {64, box2[1]}, sbox4[4] = {64, (uint32_t)Wt, (uint32_t)R, 1};
  auto flat_out = [&](CUtensorMap* m, void* base, int C) {
    const uint64_t dims[2] = {(uint64_t)C, npix}, str[1] = {(uint64_t)C};
    return encode(m, tma_type<T>(), 2, base, dims, str, sbox2, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  auto image_out = [&](CUtensorMap* m, void* base) {
    const uint64_t dims[4] = {(uint64_t)c, (uint64_t)W, (uint64_t)H, (uint64_t)B};
    const uint64_t str[3] = {(uint64_t)c, (uint64_t)c * W, (uint64_t)c * hw};
    return encode(m, tma_type<T>(), 4, base, dims, str, sbox4, CU_TENSOR_MAP_SWIZZLE_128B);
  };
  if (!err) err = flat_out(&maps.y1s, out.y1, 2 * c);
  if (!err) err = flat_out(&maps.ys, out.y, C2);
  if (!err) err = image_out(&maps.ts, out.t);
  if (!err) err = image_out(&maps.zs, out.z);
  if (err) return static_cast<cudaError_t>(err);
  auto kernel = c2f_tc_kernel<T, BK, BN, MS>;
  cudaError_t e = allow_smem(kernel, smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int tiles = 0;
  for (const GemmGeo& q : g.gm) tiles = std::max(tiles, q.ntiles);
  // persistent and cooperative: one block an SM, every block resident (the
  // grid barriers wait for all of them)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)std::min(tiles, sms));
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, maps, g, out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// BK 32 (with BN 64) or 64; BN 64 (MS 1 or 2 m64 subtiles a warpgroup) or 128
// (MS 1: two would hold 128 accumulators a thread, which spill)
template <typename T>
cudaError_t launch_tc_plan(const void* const* p, void* y, void* scratch, void* bar, int B,
                           int H, int W, int Cin, int c, int C2, int bk, int bn, int ms, int R,
                           int Wt, cudaStream_t st) {
  // 16-byte rows for TMA: every channel count a multiple of 8
  if ((c & 15) || (C2 & 7) || (Cin & 7) || !scratch || !bar) return cudaErrorInvalidValue;
#define YS_C2F_PLAN(BK, BN, MS)                                                                 \
  if (bk == BK && bn == BN && ms == MS)                                                         \
    return launch_tc<T, BK, BN, MS>(p, y, scratch, bar, B, H, W, Cin, c, C2, R, Wt, st);
  YS_C2F_PLAN(32, 64, 1)
  YS_C2F_PLAN(32, 64, 2)
  YS_C2F_PLAN(64, 64, 1)
  YS_C2F_PLAN(64, 64, 2)
  YS_C2F_PLAN(64, 128, 1)
#undef YS_C2F_PLAN
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success; 10000 + a CUresult
// where a TMA tensor map could not be encoded). dtype: 0 float32 (CUDA
// cores: tile 8 or 4; scratch, bar and the plan unused), 1 bfloat16 or 2
// float16 (tensor cores: the plan bk, bn, ms, rows x wt of
// kernels/c2f.py c2f_plan; scratch holds B H W 4c elements, bar two
// unsigned ints, zero before the first launch and left so by each).
extern "C" int ys_c2f(const void* x, const void* w1, const void* b1, const void* wm1,
                      const void* bm1, const void* wm2, const void* bm2, const void* w2,
                      const void* b2, void* y, void* scratch, void* bar, int B, int H, int W,
                      int Cin, int c, int C2, int dtype, int tile, int bk, int bn, int ms,
                      int rows, int wt, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (c % 4 || C2 % 4) return cudaErrorInvalidValue;
  const void* p[9] = {x, w1, b1, wm1, bm1, wm2, bm2, w2, b2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (tile == 8) return launch_f32<8>(p, y, B, H, W, Cin, c, C2, st);
    if (tile == 4) return launch_f32<4>(p, y, B, H, W, Cin, c, C2, st);
    return cudaErrorInvalidValue;
  }
  if (dtype == 1)
    return launch_tc_plan<bf16>(p, y, scratch, bar, B, H, W, Cin, c, C2, bk, bn, ms, rows, wt,
                                st);
  if (dtype == 2)
    return launch_tc_plan<f16>(p, y, scratch, bar, B, H, W, Cin, c, C2, bk, bn, ms, rows, wt,
                               st);
  return cudaErrorInvalidValue;
}
