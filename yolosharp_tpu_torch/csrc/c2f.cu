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
// A block owns a TT x TT tile of output pixels of one image. Two chained 3x3
// convolutions need a 2-pixel halo, so the block computes bh on the
// (TT+4)^2 window, t on the (TT+2)^2 window and a, z and y on the tile, all
// in shared memory: only y goes back to device memory. bh and t are zeroed
// outside the image after their SiLU (silu(bias) != 0 there), which is the
// zero padding the plain convolutions see.
//
// bfloat16 and float16 (c2f_tc_kernel, one template on the 16-bit element
// type T; the layouts are the same for both): five GEMMs with A in shared
// memory on the tensor cores (mma.sync m16n8k16, float32 sums), in order
//   bh  M = (TT+4)^2  K = Cin  (x staged 32 channels a chunk)
//   t   M = (TT+2)^2  K = 9c   (shifted ldmatrix row addresses into bh)
//   z   M = TT^2      K = 9c   (into t; + the bh residual)
//   a   M = TT^2      K = Cin  (x at the tile again; a takes t's room)
//   y   M = TT^2      K = 3c   ([a | bh | z]) -> device memory
// bh, t/a and z are stored as T (exact: they are rounded to T anyway),
// one pixel a row of c + 8 elements, so the 8 rows of an ldmatrix fall in 8
// bank groups. Weights stream from L2 in 32-row x up to 256-column chunks
// through 16-byte cp.async, double-buffered with the x chunks. Shared memory
// is 2 (c + 8)((TT+4)^2 + (TT+2)^2 + TT^2) bytes + 2 x chunk buffers.
// The tile edge comes from the wrapper (kernels/c2f.py launch_tile: 16 for
// c <= 32, 8 while the block fits shared memory, else 4, halved while the
// grid has fewer blocks than the card has SMs); the launch checks its bytes.
// What bounds it (clock64 stamps per phase, H100 80GB HBM3, 700 W, batch
// 32): at c = 32 (v8s layer 2, 160^2, tile 16) a block spends ~37% of its
// time in the epilogues (SiLU, pad-ring test and stores of 56K outputs
// against GEMMs only 32 columns wide; hence the SFU SiLU and the constant
// tile edge) and ~28% in products. At c = 256 (layer 8, 20^2, tile 8) ~50%
// goes to products and ~28% to issuing and waiting for the weight copies:
// each 8 x 8 tile streams all 3.6 MB of the block's weights from L2 for 64
// output pixels, one block per SM, and the halo plus the ragged third tile
// of a 20-wide map make it compute 1.83x the block's FLOPs. There the
// unfused plain version, which reuses each weight over every pixel, is ~4x
// faster.
//
// float32 (c2f_f32_kernel): the CUDA-core kernel. The footprint (float32
// intermediates) grows with c, so the tile is 8 for c <= 64 and 4 above; the
// input is staged in chunks of 32 channels. Each thread computes 4-pixel x
// 4-channel micro-tiles; weights are read from device memory through the
// caches.
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

constexpr int kMaxJ = 5;              // m16 tiles a warp owns in one GEMM pass
constexpr int kXP = kKC + 8;          // x chunk row pitch (elements): 80 bytes
constexpr int kWP = 256 + 8;          // weight chunk row pitch (elements)
constexpr int kWBuf = kKC * kWP * 2;  // bytes of one weight chunk buffer

template <typename T>
struct TcArgs {
  const T *x, *w1, *b1, *wm1, *bm1, *wm2, *bm2, *w2, *b2;
  T* y;
  int H, W, Cin, c, C2;
};

// Shared memory of one block: bh, t (then a) and z as 16-bit rows of c + 8,
// two x chunks and two weight chunks.
inline int tc_bytes(int TT, int c) {
  const int R2 = (TT + 4) * (TT + 4), R1 = (TT + 2) * (TT + 2), R0 = TT * TT;
  return 2 * (c + 8) * (R2 + R1 + R0) + 2 * R2 * kXP * 2 + 2 * kWBuf;
}

// 32-column slices of one GEMM pass (1, 2, 4 or 8): as wide as the columns
// left need, narrowed until each warp owns at most kMaxJ m16 tiles.
__device__ __forceinline__ int pass_slices(int MT, int ncols) {
  int s = 1;
  while (s < 8 && s * 32 < ncols) s *= 2;
  while (s > 1 && (MT + 8 / s - 1) / (8 / s) > kMaxJ) s /= 2;
  return s;
}

// out[m][n] = sum_k A[m][k] w[k][n] for m < M, n < N on the tensor cores.
// A's shared address of row m's 8 elements at k (k % 8 == 0) is
// a_addr(a_row(m), a_k(k, buf)): a_row runs once per row and pass, a_k once
// per k16 step (buf is the chunk buffer the x staging of chunk k / 32 went
// to), so the inner loop does no integer division. x_stage(kc, buf) issues
// the cp.async copies of A's chunk kc where A is staged.
// w (K x N, row pitch ldw, 16-byte aligned rows) streams through shared
// memory 32 rows at a time; rows >= K and columns >= N are zero-filled.
// epi(m, n, v0, v1) receives the float32 sums of columns n, n + 1 plus their
// bias (read into registers once per pass). Ends with a barrier, so the
// next GEMM may read what epi wrote.
template <typename T, class ARow, class AK, class AAddr, class XStage, class Epi>
__device__ __forceinline__ void gemm(int M, int N, int K, const T* __restrict__ w, int ldw,
                                     const T* __restrict__ bias, uint32_t wsm, ARow a_row,
                                     AK a_k, AAddr a_addr, XStage x_stage, Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int MT = (M + 15) / 16;
  const int nk = (K + kKC - 1) / kKC;
  const int bk = ((lane >> 3) & 1) * 8 + (lane & 7);  // ldmatrix.trans row
  const int bn = (lane >> 4) * 8;                     // and column offset
  const int ak = (lane >> 4) * 8;                     // ldmatrix A k offset
  const int g = lane >> 2, q = lane & 3;
  for (int n0 = 0; n0 < N;) {
    const int S = pass_slices(MT, N - n0);
    const int NB = 32 * S, WPS = 8 / S;
    const int slice = warp % S, mt0 = warp / S;
    const int ushift = __ffs(S) + 1;  // log2(NB / 8)
    auto w_stage = [&](int kc, int buf) {
      const uint32_t dst = wsm + buf * kWBuf;
      for (int i = tid; i < kKC << ushift; i += kThreads) {
        const int r = i >> ushift, u = i & ((1 << ushift) - 1);
        const int k = kc * kKC + r, n = n0 + u * 8;
        const bool ok = k < K && n < N;
        cp_async16(dst + (r * kWP + u * 8) * 2, ok ? w + (size_t)k * ldw + n : w, ok);
      }
    };
    float acc[kMaxJ][4][4];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][ni][e] = 0.f;
    decltype(a_row(0)) rows[kMaxJ];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j)
      rows[j] = a_row(min((mt0 + j * WPS) * 16 + (lane & 15), M - 1));

    x_stage(0, 0);
    w_stage(0, 0);
    cp_async_commit();
    for (int kc = 0; kc < nk; ++kc) {
      if (kc + 1 < nk) {
        x_stage(kc + 1, (kc + 1) & 1);
        w_stage(kc + 1, (kc + 1) & 1);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const uint32_t wb = wsm + (kc & 1) * kWBuf;
      const int ksteps = min(2, (K - kc * kKC + 15) / 16);
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t b[2][4];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          ldmatrix_x4_trans(b[nj], wb + ((ks * 16 + bk) * kWP + slice * 32 + nj * 16 + bn) * 2);
        // every fragment of the step is loaded before the first product
        const auto kk = a_k(kc * kKC + ks * 16 + ak, kc & 1);
        uint32_t a[kMaxJ][4];
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j)
          if (mt0 + j * WPS < MT) ldmatrix_x4(a[j], a_addr(rows[j], kk));
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          if (mt0 + j * WPS < MT) {
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              Half16<T>::mma(acc[j][ni], a[j], b[ni >> 1][(ni & 1) * 2],
                             b[ni >> 1][(ni & 1) * 2 + 1]);
          }
        }
      }
      __syncthreads();
    }
    float bv[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + slice * 32 + ni * 8 + 2 * q;
      bv[ni][0] = n < N ? to_f(bias[n]) : 0.f;
      bv[ni][1] = n < N ? to_f(bias[n + 1]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int mt = mt0 + j * WPS;
      if (mt >= MT) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + slice * 32 + ni * 8 + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = mt * 16 + g + half * 8;
          if (m < M && n < N)
            epi(m, n, acc[j][ni][2 * half] + bv[ni][0], acc[j][ni][2 * half + 1] + bv[ni][1]);
        }
      }
    }
    n0 += NB;
  }
  __syncthreads();
}

// TT is a template argument so that every pixel index / window edge
// divides by a constant.
template <typename T, int TT>
__global__ void __launch_bounds__(kThreads) c2f_tc_kernel(const TcArgs<T> p) {
  constexpr int E2 = TT + 4, E1 = TT + 2;
  constexpr int R2 = E2 * E2, R1 = E1 * E1, R0 = TT * TT;
  static_assert(R2 <= 8 * 16 * kMaxJ, "the window's m16 tiles fit kMaxJ per warp");
  const int H = p.H, W = p.W, Cin = p.Cin, c = p.c, C2 = p.C2;
  const int P = c + 8;  // row pitch of bh, t / a, z (elements)
  extern __shared__ __align__(128) uint4 smem[];
  T* bh = reinterpret_cast<T*>(smem);  // [R2][P]
  T* ta = bh + R2 * P;                 // [R1][P]: t, then a
  T* zs = ta + R1 * P;                 // [R0][P]
  const uint32_t xs = smem_u32(zs + R0 * P);  // 2 x [R2][kXP]
  const uint32_t wsm = xs + 2 * R2 * kXP * 2;  // 2 x [kKC][kWP]
  const uint32_t bh_s = smem_u32(bh), ta_s = smem_u32(ta), zs_s = smem_u32(zs);

  const int tiles_w = (W + TT - 1) / TT;
  const int h0 = (blockIdx.x / tiles_w) * TT;
  const int w0 = (blockIdx.x % tiles_w) * TT;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const T* xb = p.x + (size_t)b * H * W * Cin;
  auto inside = [&](int hi, int wi) { return hi >= 0 && hi < H && wi >= 0 && wi < W; };
  auto store2 = [](T* dst, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(dst) = Half16<T>::pack(v0, v1);
  };
  // rows r of the x chunk kc: pixel (h0 + off + r / e, w0 + off + r % e)
  auto x_rows = [&](int rows, int e, int off) {
    return [=](int kc, int buf) {
      const uint32_t dst = xs + buf * R2 * kXP * 2;
      for (int i = tid; i < rows * (kKC / 8); i += kThreads) {
        const int r = i >> 2, u = i & 3;
        const int hi = h0 + off + r / e, wi = w0 + off + r % e;
        const int ci = kc * kKC + u * 8;
        const bool ok = hi >= 0 && hi < H && wi >= 0 && wi < W && ci < Cin;
        cp_async16(dst + (r * kXP + u * 8) * 2, ok ? xb + ((size_t)hi * W + wi) * Cin + ci : xb,
                   ok);
      }
    };
  };
  // A row handles and k offsets, in bytes: address = row + k offset
  auto add = [](uint32_t row, uint32_t koff) { return row + koff; };
  auto x_row = [](int m) { return (uint32_t)(m * kXP * 2); };
  auto x_k = [&](int k, int buf) {
    return xs + (uint32_t)((buf * R2 * kXP + (k & (kKC - 1))) * 2);
  };
  // 3x3 over a window of edge e: k = tap * c + ci shifts the pixel
  auto tap_k = [&](int e) {
    return [=](int k, int) {
      const int tap = k / c, ci = k - tap * c;
      return (uint32_t)((((tap / 3) * e + tap % 3) * P + ci) * 2);
    };
  };
  auto none = [](int, int) {};

  // bh = silu(x @ w1[:, c:] + b1[c:]) on the (TT+4)^2 window, zero outside the image
  gemm(R2, c, Cin, p.w1 + c, 2 * c, p.b1 + c, wsm, x_row, x_k, add, x_rows(R2, E2, -2),
       [&](int m, int n, float v0, float v1) {
         const bool in = inside(h0 - 2 + m / E2, w0 - 2 + m % E2);
         store2(bh + m * P + n, in ? silu_fast(v0) : 0.f, in ? silu_fast(v1) : 0.f);
       });
  // t = silu(conv3x3(bh) + bm1) on the (TT+2)^2 window, zero outside the image
  gemm(R1, c, 9 * c, p.wm1, c, p.bm1, wsm,
       [&](int m) { return bh_s + (uint32_t)(((m / E1) * E2 + m % E1) * P * 2); }, tap_k(E2),
       add, none,
       [&](int m, int n, float v0, float v1) {
         const bool in = inside(h0 - 1 + m / E1, w0 - 1 + m % E1);
         store2(ta + m * P + n, in ? silu_fast(v0) : 0.f, in ? silu_fast(v1) : 0.f);
       });
  // z = bh + silu(conv3x3(t) + bm2) on the tile
  gemm(R0, c, 9 * c, p.wm2, c, p.bm2, wsm,
       [&](int m) { return ta_s + (uint32_t)(((m / TT) * E1 + m % TT) * P * 2); }, tap_k(E1),
       add, none,
       [&](int m, int n, float v0, float v1) {
         const T* r = bh + ((m / TT + 2) * E2 + m % TT + 2) * P + n;
         const float u0 = round_t<T>(silu_fast(v0));
         const float u1 = round_t<T>(silu_fast(v1));
         store2(zs + m * P + n, to_f(r[0]) + u0, to_f(r[1]) + u1);
       });
  // a = silu(x @ w1[:, :c] + b1[:c]) on the tile, into t's room
  gemm(R0, c, Cin, p.w1, 2 * c, p.b1, wsm, x_row, x_k, add, x_rows(R0, TT, 0),
       [&](int m, int n, float v0, float v1) {
         store2(ta + m * P + n, silu_fast(v0), silu_fast(v1));
       });
  // y = silu([a | bh | z] @ w2 + b2) -> device memory
  // over [a | bh | z]: row handle (a / z row, bh centre row), k -> (part, ci)
  gemm(R0, C2, 3 * c, p.w2, C2, p.b2, wsm,
       [&](int m) {
         return make_uint2(m * P * 2, ((m / TT + 2) * E2 + m % TT + 2) * P * 2);
       },
       [&](int k, int) {
         const int part = k / c;
         return make_uint2(part, (k - part * c) * 2);
       },
       [&](uint2 row, uint2 kk) {
         return (kk.x == 1 ? bh_s + row.y : (kk.x == 0 ? ta_s : zs_s) + row.x) + kk.y;
       },
       none,
       [&](int m, int n, float v0, float v1) {
         const int ho = h0 + m / TT, wo = w0 + m % TT;
         if (ho < H && wo < W)
           store2(p.y + (((size_t)b * H + ho) * W + wo) * C2 + n, silu_fast(v0), silu_fast(v1));
       });
}

template <typename T, int TT>
cudaError_t launch_tc_tile(const TcArgs<T>& args, int B, cudaStream_t stream) {
  const int bytes = tc_bytes(TT, args.c);
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(c2f_tc_kernel<T, TT>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((args.H + TT - 1) / TT) * ((args.W + TT - 1) / TT), B);
  c2f_tc_kernel<T, TT><<<grid, kThreads, bytes, stream>>>(args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tc(const void* const* p, void* y, int B, int H, int W, int Cin, int c, int C2,
                      int TT, cudaStream_t stream) {
  // widths the GEMMs take: 16-byte rows, k16 steps inside one 3x3 tap
  if (c % 16 || C2 % 8 || Cin % 8) return cudaErrorInvalidValue;
  const T* const* t = reinterpret_cast<const T* const*>(p);
  const TcArgs<T> args{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8],
                       static_cast<T*>(y), H, W, Cin, c, C2};
  switch (TT) {
    case 16: return launch_tc_tile<T, 16>(args, B, stream);
    case 8: return launch_tc_tile<T, 8>(args, B, stream);
    case 4: return launch_tc_tile<T, 4>(args, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). dtype: 0 float32 (CUDA
// cores, tile 8 or 4), 1 bfloat16 or 2 float16 (tensor cores, tile 16, 8 or
// 4).
extern "C" int ys_c2f(const void* x, const void* w1, const void* b1, const void* wm1,
                      const void* bm1, const void* wm2, const void* bm2, const void* w2,
                      const void* b2, void* y, int B, int H, int W, int Cin, int c, int C2,
                      int tile, int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (c % 4 || C2 % 4) return cudaErrorInvalidValue;
  const void* p[9] = {x, w1, b1, wm1, bm1, wm2, bm2, w2, b2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (tile == 8) return launch_f32<8>(p, y, B, H, W, Cin, c, C2, st);
    if (tile == 4) return launch_f32<4>(p, y, B, H, W, Cin, c, C2, st);
    return cudaErrorInvalidValue;
  }
  if (dtype == 1) return launch_tc<bf16>(p, y, B, H, W, Cin, c, C2, tile, st);
  if (dtype == 2) return launch_tc<f16>(p, y, B, H, W, Cin, c, C2, tile, st);
  return cudaErrorInvalidValue;
}
