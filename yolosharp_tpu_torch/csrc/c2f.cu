// One whole inference C2f block (n = 1, shortcut) with folded-BN biases:
//
//   y1 = silu(x @ w1 + b1)                    1x1, Cin -> 2c, split into a | bh
//   t  = silu(conv3x3(bh, wm1) + bm1)         zero padding
//   z  = bh + silu(conv3x3(t, wm2) + bm2)     the bottleneck's residual
//   y  = silu([a, bh, z] @ w2 + b2)           1x1, 3c -> C2
//
// x: (B, H, W, Cin) NHWC, w1: (Cin, 2c), wm1 / wm2: (3, 3, c, c) HWIO,
// w2: (3c, C2), biases 1-D, y: (B, H, W, C2); float32 or bfloat16, sums in
// float32, every intermediate rounded to the working type as the plain
// version stores it.
//
// A block owns a TT x TT tile of output pixels of one image. Two chained 3x3
// convolutions need a 2-pixel halo, so the block computes bh on the
// (TT+4)^2 window, t on the (TT+2)^2 window and a, z and y on the tile, all
// in shared memory: only y goes back to device memory. bh and t are zeroed
// outside the image after their SiLU (silu(bias) != 0 there), which is the
// zero padding the plain convolutions see. The shared-memory footprint grows
// with c, so the tile shrinks from 8 to 4 for c > 64; the input is staged in
// chunks of 32 channels. Each thread computes 4-pixel x 4-channel
// micro-tiles; weights are read from device memory through the caches.
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
c2f_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
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

template <typename T, int TT>
cudaError_t launch(const void* const* p, void* y, int B, int H, int W, int Cin, int c, int C2,
                   cudaStream_t stream) {
  const int bytes = Geom<TT>::floats(c) * 4;
  auto kernel = c2f_kernel<T, TT>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((H + TT - 1) / TT) * ((W + TT - 1) / TT), B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]),
      static_cast<const T*>(p[3]), static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]), static_cast<const T*>(p[8]),
      static_cast<T*>(y), H, W, Cin, c, C2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(const void* const* p, void* y, int B, int H, int W, int Cin, int c,
                        int C2, int tile, cudaStream_t stream) {
  if (tile == 8) return launch<T, 8>(p, y, B, H, W, Cin, c, C2, stream);
  if (tile == 4) return launch<T, 4>(p, y, B, H, W, Cin, c, C2, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). dtype: 0 float32, 1 bfloat16.
extern "C" int ys_c2f(const void* x, const void* w1, const void* b1, const void* wm1,
                      const void* bm1, const void* wm2, const void* bm2, const void* w2,
                      const void* b2, void* y, int B, int H, int W, int Cin, int c, int C2,
                      int tile, int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (c % 4 || C2 % 4) return cudaErrorInvalidValue;
  const void* p[9] = {x, w1, b1, wm1, bm1, wm2, bm2, w2, b2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tile<float>(p, y, B, H, W, Cin, c, C2, tile, st);
  if (dtype == 1) return launch_tile<__nv_bfloat16>(p, y, B, H, W, Cin, c, C2, tile, st);
  return cudaErrorInvalidValue;
}
