// Fused softmax attention: o = softmax(q k^T * scale) v for every (batch, head)
// sequence, with the (N, N) scores kept out of device memory.
//
// q, k, v, o: (B, H, N, D) element-strided views (unit stride in D, 16-byte
// aligned rows), one type (float32 or bfloat16); D in {16, 32, 64, 128}.
// Everything is computed in float32; o is rounded to the working type once.
//
// Flash-style forward on the CUDA cores. A block owns kBQ query rows of one
// sequence; each row belongs to G = max(1, D / 32) neighbouring threads, each
// holding a DT-wide slice of q (pre-scaled) and of the float32 output sum in
// registers. The block walks the keys in tiles of kBK, staged in shared memory
// as float32 (ragged last tile zero-filled), and folds them into the running
// max / running sum / output of each row kKC keys at a time (online softmax).
// The partial dot products of a row's G threads meet by warp shuffles. No
// limit on N and no row padding: query rows and keys past N are masked.
#include <math.h>

#include "common.cuh"

using namespace ys;

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per staged tile
constexpr int kKC = 16;  // keys per online-softmax step

struct Strides {
  long long b, h, n;  // elements
};

template <int D>
struct Geom {
  static constexpr int G = D >= 32 ? D / 32 : 1;  // threads per query row
  static constexpr int DT = D / G;                // head-dim slice of a thread
  // A staged key holds its G slices SEG floats apart; the 4-float pad puts the
  // G slices that one warp reads at once in different banks.
  static constexpr int SEG = G > 1 ? DT + 4 : DT;
  static constexpr int ROW = G * SEG;
  static constexpr int kThreads = kBQ * G;
  static constexpr int kBytes = 2 * kBK * ROW * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(Geom<D>::kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int N, Strides sq, Strides sk, Strides sv, Strides so,
                 float scale) {
  using Gm = Geom<D>;
  constexpr int G = Gm::G;
  constexpr int DT = Gm::DT;
  constexpr int SEG = Gm::SEG;
  constexpr int ROW = Gm::ROW;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBK][ROW]
  float* vs = ks + kBK * ROW;                   // [kBK][ROW]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int gi = tid % G;
  const int row = blockIdx.y * kBQ + tid / G;
  const bool live = row < N;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  float qr[DT];
  float acc[DT];
#pragma unroll
  for (int d = 0; d < DT; d += 4) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) load4(q + b * sq.b + h * sq.h + row * sq.n + gi * DT + d, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qr[d + i] = t[i] * scale;
      acc[d + i] = 0.f;
    }
  }
  float m = -INFINITY;  // running max of the scores
  float l = 0.f;        // running sum of exp(score - m)

  for (int k0 = 0; k0 < N; k0 += kBK) {
    const int nk = min(kBK, N - k0);
    // neighbouring threads read neighbouring 4-element chunks of one key
    for (int i = tid; i < kBK * (D / 4); i += Gm::kThreads) {
      const int j = i / (D / 4);
      const int d = (i - j * (D / 4)) * 4;
      float tk[4] = {0.f, 0.f, 0.f, 0.f};
      float tv[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nk) {
        load4(kb + (k0 + j) * sk.n + d, tk);
        load4(vb + (k0 + j) * sv.n + d, tv);
      }
      const int dst = j * ROW + (d / DT) * SEG + d % DT;
      *reinterpret_cast<float4*>(ks + dst) = make_float4(tk[0], tk[1], tk[2], tk[3]);
      *reinterpret_cast<float4*>(vs + dst) = make_float4(tv[0], tv[1], tv[2], tv[3]);
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += kKC) {
      float s[kKC];
      float mc = m;
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        const float* kp = ks + (j0 + jj) * ROW + gi * SEG;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DT; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kp + d);
          dot = fmaf(qr[d], kv.x, dot);
          dot = fmaf(qr[d + 1], kv.y, dot);
          dot = fmaf(qr[d + 2], kv.z, dot);
          dot = fmaf(qr[d + 3], kv.w, dot);
        }
#pragma unroll
        for (int off = 1; off < G; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[jj] = j0 + jj < nk ? dot : -INFINITY;
        mc = fmaxf(mc, s[jj]);
      }
      // mc is finite: key j0 < nk is live. The first step has m = -inf, alpha 0.
      const float alpha = expf(m - mc);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kKC; ++jj) {
        const float p = expf(s[jj] - mc);  // 0 for masked keys, whose V rows are 0
        l += p;
        const float* vp = vs + (j0 + jj) * ROW + gi * SEG;
#pragma unroll
        for (int d = 0; d < DT; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vp + d);
          acc[d] = fmaf(p, vv.x, acc[d]);
          acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
        }
      }
      m = mc;
    }
    __syncthreads();
  }

  if (!live) return;
  const float inv = 1.f / l;
  T* op = o + b * so.b + h * so.h + row * so.n + gi * DT;
#pragma unroll
  for (int d = 0; d < DT; ++d) op[d] = from_f<T>(acc[d] * inv);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                   const Strides* st, float scale, cudaStream_t stream) {
  using Gm = Geom<D>;
  auto kernel = attention_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, Gm::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (N + kBQ - 1) / kBQ);
  kernel<<<grid, Gm::kThreads, Gm::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, N, st[0], st[1], st[2], st[3], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                     int D, const Strides* st, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, N, st, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, N, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, N, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, N, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Strides are in elements,
// (batch, head, row) for each of q, k, v, o. dtype: 0 float32, 1 bfloat16.
extern "C" int ys_attention(const void* q, const void* k, const void* v, void* o, int B, int H,
                            int N, int D, long long qb, long long qh, long long qn, long long kb,
                            long long kh, long long kn, long long vb, long long vh, long long vn,
                            long long ob, long long oh, long long on, float scale, int dtype,
                            void* stream) {
  if (B == 0 || H == 0 || N == 0) return 0;
  const Strides st[4] = {{qb, qh, qn}, {kb, kh, kn}, {vb, vh, vn}, {ob, oh, on}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, o, B, H, N, D, st, scale, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(q, k, v, o, B, H, N, D, st, scale, s);
  return cudaErrorInvalidValue;
}
