// 3x3 convolution, stride 1 or 2, zero padding 1, with a per-channel bias
// (the folded BatchNorm) and an activation in the epilogue.
//
// x: (B, H, W, Ci) NHWC, w: (3, 3, Ci, Co) HWIO, bias: (Co,), y: (B, Ho, Wo, Co),
// all contiguous and of one type (float32 or bfloat16); sums in float32.
//
// Implicit GEMM on the CUDA cores. A block owns an 8 x 16 tile of output
// pixels of one image and 64 output channels. It walks the input channels in
// chunks of CK: each chunk stages the input tile with its 1-pixel halo
// (stride 2: the 2x-wide window) and the 9 x CK x 64 weight slice in shared
// memory, converted to float32, and every thread accumulates a 4-pixel x
// 8-channel micro-tile in registers. No row-divisibility limit: the ragged
// edges of the image and of Co are masked.
#include "common.cuh"

using namespace ys;

namespace {

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
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
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

template <typename T, int S, int CK>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
                   int Ci, int Co, int act, cudaStream_t stream) {
  using G = Geom<S, CK>;
  const int Ho = (H - 1) / S + 1;
  const int Wo = (W - 1) / S + 1;
  auto kernel = conv3x3_kernel<T, S, CK>;
  cudaError_t err = allow_smem(kernel, G::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((Ho + kTH - 1) / kTH) * ((Wo + kTW - 1) / kTW), (Co + kTCO - 1) / kTCO, B);
  kernel<<<grid, kThreads, G::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), H, W, Ci, Co, Ho, Wo, act);
  return cudaGetLastError();
}

template <typename T, int S>
cudaError_t launch_ck(const void* x, const void* w, const void* b, void* y, int B, int H, int W,
                      int Ci, int Co, int act, cudaStream_t stream) {
  // the 3-channel stem would waste 13 of 16 staged channels
  if (Ci <= 4) return launch<T, S, 4>(x, w, b, y, B, H, W, Ci, Co, act, stream);
  return launch<T, S, 16>(x, w, b, y, B, H, W, Ci, Co, act, stream);
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). dtype: 0 float32, 1 bfloat16.
extern "C" int ys_conv3x3(const void* x, const void* w, const void* b, void* y, int B, int H,
                          int W, int Ci, int Co, int stride, int act, int dtype, void* stream) {
  if (B == 0 || H == 0 || W == 0 || Co == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stride != 1 && stride != 2) return cudaErrorInvalidValue;
  if (dtype == 0)
    return stride == 1 ? launch_ck<float, 1>(x, w, b, y, B, H, W, Ci, Co, act, st)
                       : launch_ck<float, 2>(x, w, b, y, B, H, W, Ci, Co, act, st);
  if (dtype == 1)
    return stride == 1 ? launch_ck<__nv_bfloat16, 1>(x, w, b, y, B, H, W, Ci, Co, act, st)
                       : launch_ck<__nv_bfloat16, 2>(x, w, b, y, B, H, W, Ci, Co, act, st);
  return cudaErrorInvalidValue;
}
