// Fused softmax attention: o = softmax(q k^T * scale) v for every (batch, head)
// sequence, with the (N, N) scores kept out of device memory. Replaces the
// Pallas kernel yolosharp_tpu/kernels/attention.py fused_attention
// (_attn_kernel). Its backward is csrc/attention_bwd.cu.
//
// q, k, v, o: (B, H, N, D) element-strided views (unit stride in D, 16-byte
// aligned rows), one type (float32, bfloat16 or float16); D in {16, 32, 64,
// 128}; any N. The route is static, by type:
//
// bfloat16 and float16: attention_mma_kernel, one template on the 16-bit
// element type (both are 2 bytes: the staging, swizzle and fragments are the
// same), on the tensor cores (mma.sync.m16n8k16, 16-bit products, f32 sums). What bounds it on an H100: a v12s layer-6 call at
// batch 32 (512 sequences of N = 400, D = 32) moves 52 MB (q, k, v and o once:
// 15.6 us at 3.35 TB/s) for 10.5 GFLOP (10.6 us at 989 TFLOP/s) and 82 M
// exponentials (22 us at 16 ex2 per clock per SM): memory, then the exp unit.
// Design:
// - A block stages the K and V of its sequence in shared memory as 16-bit rows
//   whose 16-byte chunks are XOR-swizzled (ldmatrix reads 8 rows from 8
//   different bank groups), through 16-byte cp.async with zero fill past N.
//   Where the whole sequence fits (kcap >= N: every main-path shape; 51 KB at
//   N = 400, D = 32, so four blocks an SM) it is staged once and the block's
//   warps then walk all their query tiles without another load or barrier;
//   otherwise it is streamed in chunks of kcap keys per round of query tiles.
// - Each warp owns 16 query rows (a warp tile), their Q as mma A fragments in
//   registers. Per 64-key tile: S = Q K^T from ldmatrix fragments of K; the
//   row max and the rescale of the online softmax meet over the four threads
//   of a quad by shuffles; P = exp2(S * scale * log2(e) - max) by ex2.approx,
//   one exponential per live score (16-key subtiles past N are skipped);
//   P stays in registers, its C fragments packed to 16-bit pairs as the A fragments
//   of P V, with V through ldmatrix.trans.
// - Under autograd the wrapper passes `lse` and `o32`: each row's
//   log2-sum-exp m + log2(l) (f32, 4 bytes a row) and its output in f32
//   before the rounding to T, for the backward (which takes the row terms
//   D_i = g_i . o_i from it); the inference forward passes null pointers.
// - Warp tiles are spread over a grid of (sequences, splits) of blocks of W
//   warps: warp w of split s takes tiles s + splits * (w + W r). The wrapper
//   picks splits from the card's SM count so that small batches still cover
//   the SMs, and W = 8 where a staged sequence leaves room for at most two
//   blocks an SM, else 4 (kernels/attention.py launch_geometry); this file
//   only checks them.
// mma.sync and not wgmma: the products are 16-row tiles per warp with
// D = 32, P must go from the accumulators straight into the next product,
// and at these shapes the kernel is bound by bytes and exponentials, not by
// the tensor cores (the MMA share is under half of its bound at 60 % of the
// dense peak). A warp-specialised wgmma forward (a TMA ring fed by a
// producer warpgroup, two consumer warpgroups, 128-row units of a persistent
// grid: the backward's skeleton, csrc/attention16.cuh) was slower than this
// kernel on an H100 at every batch-32 shape: each warpgroup waits on its
// wgmma where these warps interleave a subtile's exponentials with the
// products of the one before, and its 8-16 consumer warps an SM hide less
// latency than 16 independent ones.
// Numerics: S sums 16-bit x 16-bit products (exact in f32) in f32, as the
// TPU kernel's f32 upcast does, in another order; P (in [0, 1]) is rounded
// to the element type for P V, as the JAX package's own off-TPU path does
// (_einsum_attention); the row sums and the output are f32 until o is
// rounded once.
//
// float32: attention_kernel, the flash-style forward on the CUDA cores. A
// block owns kBQ query rows of one sequence; each row belongs to G = max(1,
// D / 32) neighbouring threads, each holding a DT-wide slice of q (pre-scaled)
// and of the float32 output sum in registers. The block walks the keys in
// tiles of kBK, staged in shared memory as float32 (ragged last tile
// zero-filled), and folds them into the running max / running sum / output of
// each row kKC keys at a time (online softmax). The partial dot products of a
// row's G threads meet by warp shuffles. Query rows and keys past N are
// masked. TF32 would break the float32 contract (2e-5 + 2e-4 |p|).
#include <math.h>

#include "common.cuh"

using namespace ys;

namespace {

struct Strides {
  long long b, h, n;  // elements
};

// ---- float32: CUDA cores -------------------------------------------------------

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per staged tile
constexpr int kKC = 16;  // keys per online-softmax step

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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                       const Strides* st, float scale, cudaStream_t stream) {
  using Gm = Geom<D>;
  auto kernel = attention_kernel<float, D>;
  cudaError_t err = allow_smem(kernel, Gm::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (N + kBQ - 1) / kBQ);
  kernel<<<grid, Gm::kThreads, Gm::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, N, st[0], st[1], st[2], st[3], scale);
  return cudaGetLastError();
}


// ---- bfloat16 and float16: tensor cores --------------------------------------

constexpr int kMaxWarps = 8;       // warps per block (4 or 8), each on its own 16-row tiles
constexpr int kKT = 64;            // keys per online-softmax step
constexpr int kMaxSmem = 232448;   // shared memory one block may use
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t ld_u32(const T* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Shared bytes of one block: K and V rows of kcap keys.
template <int D>
constexpr int mma_smem_bytes(int kcap) {
  return 2 * kcap * D * 2;
}

// Byte offset of 16-byte chunk c of staged row j: the chunk index is XORed
// with the row's place among the rows that share a 128-byte line, so the 8
// rows an ldmatrix phase reads at one chunk fall in 8 different bank groups.
template <int D>
__device__ __forceinline__ uint32_t swz(int j, int c) {
  constexpr int CH = D / 8;                    // chunks of a row
  constexpr int GROUP = CH >= 8 ? 1 : 8 / CH;  // rows of one 128-byte line
  constexpr int MASK = (CH >= 8 ? 8 : CH) - 1;
  return (j * CH + (c ^ ((j / GROUP) & MASK))) * 16;
}

// One step of the online softmax for a warp's 16 query rows against keys
// [k0, k0 + nkt) of the staged chunk (kb, vb: their byte addresses in shared
// memory). FULL: nkt == kKT, with no edge guards, so that the compiler can
// interleave the exponentials of one 16-key subtile with the P V products of
// the one before.
template <typename T, int D, bool FULL>
__device__ __forceinline__ void attn_tile(const uint32_t (&qa)[D / 16][4], float (&acc)[D / 8][4],
                                          float (&mx)[2], float (&ls)[2], uint32_t kb, uint32_t vb,
                                          const uint32_t (&koff)[D / 16],
                                          const uint32_t (&voff)[D / 16], int nkt, int tg,
                                          float sl2) {
  constexpr int KC = D / 16;
  const int nsub = FULL ? 4 : (nkt + 15) >> 4;  // live 16-key subtiles (warp-uniform)
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // S = Q K^T: ldmatrix matrix lane/8 holds keys +8 (bit 1), d +8 (bit 0)
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    if (FULL || jp < nsub) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kb + jp * 16 * D * 2 + koff[kk]);
        Half16<T>::mma(s[2 * jp], qa[kk], bk[0], bk[1]);
        Half16<T>::mma(s[2 * jp + 1], qa[kk], bk[2], bk[3]);
      }
    }
  }
  // scores in log2 units (any sign of scale); keys past N at -inf
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = FULL || j * 8 + 2 * tg + (e & 1) < nkt ? s[j][e] * sl2 : -INFINITY;
    }
  }
  // online softmax: the new row maxima (a tree, then over the quad)
  float t0[8], t1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    t0[j] = fmaxf(s[j][0], s[j][1]);
    t1[j] = fmaxf(s[j][2], s[j][3]);
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) {
      t0[j] = fmaxf(t0[j], t0[j + w]);
      t1[j] = fmaxf(t1[j], t1[j + w]);
    }
  }
  float m0 = fmaxf(mx[0], t0[0]), m1 = fmaxf(mx[1], t1[0]);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  // m0, m1 are finite (key k0 is live); the first tile rescales by 0
  const float a0 = exp2_approx(mx[0] - m0);
  const float a1 = exp2_approx(mx[1] - m1);
  mx[0] = m0;
  mx[1] = m1;
  ls[0] *= a0;
  ls[1] *= a1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] *= a0;
    acc[n][1] *= a0;
    acc[n][2] *= a1;
    acc[n][3] *= a1;
  }
  // per 16-key subtile: P = exp2(S - max), packed to T as the A fragment of
  // O += P V; ldmatrix.trans matrix lane/8 holds keys +8 (bit 0), d +8 (bit 1)
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    if (FULL || kc < nsub) {
      float* p0 = s[2 * kc];
      float* p1 = s[2 * kc + 1];
      p0[0] = exp2_approx(p0[0] - m0);
      p0[1] = exp2_approx(p0[1] - m0);
      p0[2] = exp2_approx(p0[2] - m1);
      p0[3] = exp2_approx(p0[3] - m1);
      p1[0] = exp2_approx(p1[0] - m0);
      p1[1] = exp2_approx(p1[1] - m0);
      p1[2] = exp2_approx(p1[2] - m1);
      p1[3] = exp2_approx(p1[3] - m1);
      ls[0] += (p0[0] + p0[1]) + (p1[0] + p1[1]);
      ls[1] += (p0[2] + p0[3]) + (p1[2] + p1[3]);
      const uint32_t pa[4] = {Half16<T>::pack(p0[0], p0[1]), Half16<T>::pack(p0[2], p0[3]),
                              Half16<T>::pack(p1[0], p1[1]), Half16<T>::pack(p1[2], p1[3])};
#pragma unroll
      for (int dp = 0; dp < KC; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vb + kc * 16 * D * 2 + voff[dp]);
        Half16<T>::mma(acc[2 * dp], pa, bv[0], bv[1]);
        Half16<T>::mma(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }
}

// STATS: also write the rows' statistics for the backward (under autograd);
// the inference forward is compiled without that epilogue.
template <typename T, int D, bool STATS>
__global__ void __launch_bounds__(kMaxWarps * 32)
attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H, int N, Strides sq,
                     Strides sk, Strides sv, Strides so, float scale, int kcap,
                     float* __restrict__ lse, float* __restrict__ o32, int np) {
  constexpr int KC = D / 16;   // k16 steps of Q K^T, d16 pairs of P V
  constexpr int CH = D / 8;    // 16-byte chunks of a row
  extern __shared__ uint4 smem_tc[];
  T* ks = reinterpret_cast<T*>(smem_tc);  // [kcap][D], swizzled
  T* vs = ks + kcap * D;                  // [kcap][D], swizzled
  const uint32_t ks_u = smem_u32(ks);
  const uint32_t vs_u = smem_u32(vs);

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;   // row of the quad in the fragment
  const int tg = lane & 3;   // thread of the quad
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;
  const float sl2 = scale * kLog2e;

  const int warps = blockDim.x >> 5;
  const int wtiles = (N + 15) / 16;
  const int split = blockIdx.y;
  const int stride = gridDim.y * warps;  // warp tiles between two rounds
  const int rounds = split < wtiles ? (wtiles - split + stride - 1) / stride : 0;
  const int nchunks = (N + kcap - 1) / kcap;
  // this lane's ldmatrix row offsets within a 16-key subtile, per 16-wide d
  // step (the swizzle repeats every 8 rows, so a subtile adds k0 * D * 2)
  uint32_t koff[KC], voff[KC];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    koff[kk] = swz<D>(((lane >> 4) << 3) + (lane & 7), kk * 2 + ((lane >> 3) & 1));
    voff[kk] = swz<D>(lane & 15, kk * 2 + (lane >> 4));
  }

  for (int r = 0; r < rounds; ++r) {
    const int t = split + gridDim.y * (warp + warps * r);
    const bool live = t < wtiles;
    const int ra = t * 16 + g;  // the thread's two rows: ra and ra + 8
    const int rb = ra + 8;

    uint32_t qa[KC][4];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const int d = kk * 16 + 2 * tg;
      const bool oka = live && ra < N, okb = live && rb < N;
      qa[kk][0] = oka ? ld_u32(qb + ra * sq.n + d) : 0u;
      qa[kk][1] = okb ? ld_u32(qb + rb * sq.n + d) : 0u;
      qa[kk][2] = oka ? ld_u32(qb + ra * sq.n + d + 8) : 0u;
      qa[kk][3] = okb ? ld_u32(qb + rb * sq.n + d + 8) : 0u;
    }
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float mx[2] = {-INFINITY, -INFINITY};  // running max of rows ra, rb (log2 units)
    float ls[2] = {0.f, 0.f};              // this thread's share of the running sums

    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * kcap;
      const int nk = min(kcap, N - c0);
      if (nchunks > 1 || r == 0) {
        // every warp is done with the previous chunk before it is overwritten
        if (r > 0 || c > 0) __syncthreads();
        const int rows = (nk + 15) & ~15;  // past nk: zero rows (finite V)
        for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
          const int j = i / CH;
          const int ch = i - j * CH;
          const bool ok = j < nk;
          const long long key = c0 + (ok ? j : 0);
          const uint32_t dst = swz<D>(j, ch);
          cp_async16(ks_u + dst, kb + key * sk.n + ch * 8, ok);
          cp_async16(vs_u + dst, vb + key * sv.n + ch * 8, ok);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!live) continue;

      // whole key tiles of the chunk, then its ragged end
      int k0 = 0;
      for (; k0 + kKT <= nk; k0 += kKT) {
        attn_tile<T, D, true>(qa, acc, mx, ls, ks_u + k0 * D * 2, vs_u + k0 * D * 2, koff, voff,
                           kKT, tg, sl2);
      }
      if (k0 < nk) {
        attn_tile<T, D, false>(qa, acc, mx, ls, ks_u + k0 * D * 2, vs_u + k0 * D * 2, koff, voff,
                            nk - k0, tg, sl2);
      }
    }
    if (!live) continue;
    float l0 = ls[0], l1 = ls[1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (STATS && tg == 0) {  // the rows' log2-sum-exp, for the backward
      float* lp = lse + (long long)blockIdx.x * np;
      if (ra < N) lp[ra] = mx[0] + log2f(l0);
      if (rb < N) lp[rb] = mx[1] + log2f(l1);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    if (STATS) {  // the output before its rounding, for the backward
      float* op = o32 + (long long)blockIdx.x * N * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int d = n * 8 + 2 * tg;
        if (ra < N) *reinterpret_cast<float2*>(op + (long long)ra * D + d) =
            make_float2(acc[n][0] * i0, acc[n][1] * i0);
        if (rb < N) *reinterpret_cast<float2*>(op + (long long)rb * D + d) =
            make_float2(acc[n][2] * i1, acc[n][3] * i1);
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = n * 8 + 2 * tg;
      if (ra < N) {
        *reinterpret_cast<uint32_t*>(ob + ra * so.n + d) =
            Half16<T>::pack(acc[n][0] * i0, acc[n][1] * i0);
      }
      if (rb < N) {
        *reinterpret_cast<uint32_t*>(ob + rb * so.n + d) =
            Half16<T>::pack(acc[n][2] * i1, acc[n][3] * i1);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                        const Strides* st, float scale, int splits, int kcap, int warps,
                        float* lse, float* o32, int np, cudaStream_t stream) {
  // the geometry comes from kernels/attention.py launch_geometry; checked here
  const int bytes = mma_smem_bytes<D>(kcap);
  if ((warps != 4 && warps != kMaxWarps) || splits < 1 || splits > (N + 15) / 16 || kcap < 16 ||
      kcap % 16 != 0 ||
      (kcap < N && kcap % kKT != 0) || kcap >= N + 16 || bytes > kMaxSmem ||
      (lse == nullptr) != (o32 == nullptr) || (lse != nullptr && (np < N || np % 4 != 0))) {
    return cudaErrorInvalidValue;
  }
  auto kernel =
      lse != nullptr ? attention_mma_kernel<T, D, true> : attention_mma_kernel<T, D, false>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, splits);
  kernel<<<grid, warps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, N, st[0], st[1], st[2], st[3], scale, kcap, lse, o32, np);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                   const Strides* st, float scale, int dtype, int splits, int kcap, int warps,
                   float* lse, float* o32, int np, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, B, H, N, st, scale, stream);
  if (dtype == 1) {
    return launch_mma<bf16, D>(q, k, v, o, B, H, N, st, scale, splits, kcap, warps, lse, o32,
                               np, stream);
  }
  if (dtype == 2) {
    return launch_mma<f16, D>(q, k, v, o, B, H, N, st, scale, splits, kcap, warps, lse, o32,
                              np, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Strides are in elements,
// (batch, head, row) for each of q, k, v, o. dtype: 0 float32, 1 bfloat16,
// 2 float16. splits, kcap, warps: the 16-bit kernel's blocks per sequence,
// staged keys and warps per block (kernels/attention.py launch_geometry);
// lse, o32: where non-null (16-bit only), each row's log2-sum-exp (row s *
// np + i of sequence s = b * H + h) and its float32 output ((s, i, d) of a
// contiguous (B H, N, D) array); the float32 kernel ignores the six.
extern "C" int ys_attention(const void* q, const void* k, const void* v, void* o, int B, int H,
                            int N, int D, long long qb, long long qh, long long qn, long long kb,
                            long long kh, long long kn, long long vb, long long vh, long long vn,
                            long long ob, long long oh, long long on, float scale, int dtype,
                            int splits, int kcap, int warps, float* lse, float* o32, int np,
                            void* stream) {
  if (B == 0 || H == 0 || N == 0) return 0;
  const Strides st[4] = {{qb, qh, qn}, {kb, kh, kn}, {vb, vh, vn}, {ob, oh, on}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, H, N, st, scale, dtype, splits, kcap, warps, lse, o32, np,
                       s);
    case 32:
      return launch<32>(q, k, v, o, B, H, N, st, scale, dtype, splits, kcap, warps, lse, o32, np,
                       s);
    case 64:
      return launch<64>(q, k, v, o, B, H, N, st, scale, dtype, splits, kcap, warps, lse, o32, np,
                       s);
    case 128:
      return launch<128>(q, k, v, o, B, H, N, st, scale, dtype, splits, kcap, warps, lse, o32, np,
                         s);
    default: return cudaErrorInvalidValue;
  }
}
