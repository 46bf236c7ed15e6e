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
// float32: attention_f32_kernel, the flash-style forward on the CUDA cores
// (float32 FMAs; TF32 would break the float32 contract, 2e-5 + 2e-4 |p|),
// so what bounds it is the 67 TFLOP/s float32 pipe: at the 1280^2 canvas
// the v12s calls (N = 1600, D = 32) are ~95% of phase 2's bound at B = 2.
// The kernel it replaced (one query row a thread) fed each float4 of K or
// V read from shared memory into 4 FMAs, so the shared-memory pipe, not the
// FMA pipe, bound it (0.23 of the bound). Design:
// - Register micro-tiles on both products. A warp owns a tile of 32 query
//   rows (16 at D >= 64) in row groups of NX lanes; in S = Q K^T a lane
//   holds 8 rows x 8 keys (x 4 at D >= 64), so each Q unit it reads feeds 8
//   keys and each K unit 8 rows (16 FMAs a 16-byte load); P goes through
//   the warp's own rows of shared memory, and in O += P V a lane holds 8
//   rows x D / NX columns (~11 FMAs a load at D = 32). The layouts put the
//   units a shared-memory phase reads in distinct bank groups (K and V rows
//   XOR-swizzled, Q and P rows padded).
// - K and V are staged by 16-byte cp.async: the whole sequence once where it
//   fits beside the warps' Q and P (N = 400 at D = 32: 102 KB), else streamed
//   through two stages of kcap keys, the next chunk's copy in flight while
//   the warps use the current one.
// - The online softmax runs on scores pre-scaled to log2 units (q * scale *
//   log2(e)), one ex2.approx a score; each lane keeps its share of the row
//   sums, added over the row group at the end.
// - Warp tiles are spread over a grid of (sequences, splits) blocks of 8
//   warps (4 at D >= 64), as the 16-bit kernel's; where a block has fewer
//   tiles than warps, groups of warps share a tile's key steps and merge
//   their rows' max, sum and output sums through shared memory. The
//   wrapper picks splits, kcap and the group (kernels/attention.py
//   f32_geometry) and this file checks them.
// On that card (H100 80GB HBM3, 700 W) chip_smoke phase 2's 14 B = 2
// shapes sum to 0.966 ms against SDPA's 1.660 and the bound's 0.327 (0.34
// of it), each faster than SDPA; N = 1600 runs at 0.44 of its bound, where
// the rounds of 32-row warp tiles leave ~22% of the warps idle, and the
// N <= 400 shapes give an SM a warp or two (PERF.md §6).
#include <math.h>

#include "common.cuh"

using namespace ys;

namespace {

struct Strides {
  long long b, h, n;  // elements
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- float32: CUDA cores -------------------------------------------------------

constexpr int kF32KT = 64;  // keys a softmax step of the float32 kernel

// The float32 kernel's layout at head dim D: a row group of NX lanes owns 8
// query rows (rows rg, rg + RG, ..., of its warp tile of WR rows); in
// S = Q K^T a lane holds its 8 rows x KT keys (keys x, x + NX, ...), in
// O += P V its 8 rows x DT columns (x DT..). Q (pre-scaled) and P are
// staged a warp in shared memory, their rows QS and PS floats apart.
template <int D>
struct F32Attn {
  static constexpr int NX = D <= 32 ? 8 : 16;
  static constexpr int RG = 32 / NX;
  static constexpr int WR = 8 * RG;
  static constexpr int KT = kF32KT / NX;
  static constexpr int DT = D / NX;
  static constexpr int QS = D + 8;
  static constexpr int PS = kF32KT + NX;
  static constexpr int WARP_FLOATS = WR * (QS + PS);
};

// float4 unit c of staged K or V row j: the unit index is XORed with the
// row's place among the rows that share a 128-byte line, so the 8 rows a
// shared-memory phase reads at one unit fall in 8 different bank groups.
template <int D>
__device__ __forceinline__ int fswz(int j, int c) {
  constexpr int CH = D / 4;                    // units of a row
  constexpr int GROUP = CH >= 8 ? 1 : 8 / CH;  // rows of one 128-byte line
  constexpr int MASK = (CH >= 8 ? 8 : CH) - 1;
  return j * CH + (c ^ ((j / GROUP) & MASK));
}

// One step of the online softmax for a warp tile against keys k0 .. k0 +
// live of the staged chunk (ks, vs; live <= kF32KT). FULL: live ==
// kF32KT, with no edge guards. wq, wp: the warp's Q and P.
template <int D, bool FULL>
__device__ __forceinline__ void f32_attn_tile(const float* wq, float* wp, const float4* ks,
                                              const float4* vs, int k0, int live, int rg, int x,
                                              float (&m)[8], float (&l)[8],
                                              float (&acc)[8][F32Attn<D>::DT]) {
  using A = F32Attn<D>;
  constexpr int KT = A::KT, DT = A::DT, NX = A::NX, RG = A::RG;
  // S = Q K^T in log2 units: 8 rows x KT keys, each Q unit read once for
  // KT keys and each K unit for 8 rows
  int krow[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) krow[j] = k0 + (FULL ? x + NX * j : min(x + NX * j, live - 1));
  float s[8][KT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < KT; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d4 = 0; d4 < D / 4; ++d4) {
    float4 kv[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) kv[j] = ks[fswz<D>(krow[j], d4)];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(wq + (rg + RG * i) * A::QS + 4 * d4);
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        float t = fmaf(qv.x, kv[j].x, s[i][j]);
        t = fmaf(qv.y, kv[j].y, t);
        t = fmaf(qv.z, kv[j].z, t);
        s[i][j] = fmaf(qv.w, kv[j].w, t);
      }
    }
  }
  // the online softmax: new row maxima over the row group's lanes, the
  // rescale, P = 2^(S - max) to the warp's P rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (!FULL && x + NX * j >= live) s[i][j] = -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 1; off < NX; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // mx is finite (key k0 is live); the first step rescales by 0
    const float mn = fmaxf(m[i], mx), alpha = exp2_approx(m[i] - mn);
    m[i] = mn;
    l[i] *= alpha;
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[i][d] *= alpha;
    float* pr = wp + (rg + RG * i) * A::PS + x;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = exp2_approx(s[i][j] - mn);
      l[i] += p;
      pr[NX * j] = p;
    }
  }
  __syncwarp();
  // O += P V: 4 keys a step, each P unit read once for DT columns and each
  // V unit for 8 rows; V rows past the sequence are staged as zeros
  const int kend = FULL ? kF32KT : (live + 3) & ~3;
#pragma unroll 4
  for (int kk = 0; kk < kend; kk += 4) {
    float4 pv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      pv[i] = *reinterpret_cast<const float4*>(wp + (rg + RG * i) * A::PS + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int vr = k0 + kk + e;
      float vv[DT];
      if constexpr (DT == 2) {
        const float2 t = reinterpret_cast<const float2*>(vs + fswz<D>(vr, x >> 1))[x & 1];
        vv[0] = t.x;
        vv[1] = t.y;
      } else {
#pragma unroll
        for (int c = 0; c < DT / 4; ++c) {
          const float4 t = vs[fswz<D>(vr, x * (DT / 4) + c)];
          vv[4 * c] = t.x;
          vv[4 * c + 1] = t.y;
          vv[4 * c + 2] = t.z;
          vv[4 * c + 3] = t.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int d = 0; d < DT; ++d) acc[i][d] = fmaf(p, vv[d], acc[i][d]);
      }
    }
  }
  __syncwarp();  // the P rows are read before the next step writes them
}

template <int D>
__global__ void __launch_bounds__(256, 1)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int H, int N, Strides sq,
                     Strides sk, Strides sv, Strides so, float sl2, int kcap, int ksplit) {
  using A = F32Attn<D>;
  constexpr int CH = D / 4;  // float4 units of a row
  constexpr int DT = A::DT, RG = A::RG, NX = A::NX;
  extern __shared__ float4 attn_f32_smem[];
  const int nchunks = (N + kcap - 1) / kcap;
  const int stages = nchunks > 1 ? 2 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int rg = lane / NX, x = lane % NX;
  float* wq = reinterpret_cast<float*>(attn_f32_smem + stages * 2 * kcap * CH) +
              warp * A::WARP_FLOATS;
  float* wp = wq + A::WR * A::QS;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;
  // the warps go in groups of ksplit, each group on one warp tile, its
  // warps on every ksplit-th key step of it (part); the parts' sums meet in
  // shared memory at the end
  const int groups = warps / ksplit, group = warp / ksplit, part = warp - group * ksplit;
  const int wtiles = (N + A::WR - 1) / A::WR;
  const int split = blockIdx.y, stride = gridDim.y * groups;
  const int rounds = split < wtiles ? (wtiles - split + stride - 1) / stride : 0;

  // chunk ch of K and V into stage s, rows past N zero up to a multiple of 16
  auto stage_chunk = [&](int s, int ch) {
    const int c0 = ch * kcap, nk = min(kcap, N - c0), rows = (nk + 15) & ~15;
    float4* ks = attn_f32_smem + s * 2 * kcap * CH;
    float4* vs = ks + kcap * CH;
    for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
      const int j = i / CH, c = i - j * CH;
      const bool ok = j < nk;
      const long long key = c0 + (ok ? j : 0);
      const int dst = fswz<D>(j, c);
      cp_async16(smem_u32(ks + dst), kb + key * sk.n + c * 4, ok);
      cp_async16(smem_u32(vs + dst), vb + key * sv.n + c * 4, ok);
    }
    cp_async_commit();
  };

  for (int r = 0; r < rounds; ++r) {
    const int t = split + gridDim.y * (group + groups * r);
    const bool live = t < wtiles;
    const int row0 = t * A::WR;
    if (live) {  // the warp's Q rows, pre-scaled to log2 units; rows past N zero
      for (int i = lane; i < A::WR * CH; i += 32) {
        const int j = i / CH, c = i - j * CH;
        float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + j < N) qv = *reinterpret_cast<const float4*>(qb + (row0 + j) * sq.n + 4 * c);
        *reinterpret_cast<float4*>(wq + j * A::QS + 4 * c) =
            make_float4(qv.x * sl2, qv.y * sl2, qv.z * sl2, qv.w * sl2);
      }
      __syncwarp();
    }
    float m[8], l[8], acc[8][DT];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int d = 0; d < DT; ++d) acc[i][d] = 0.f;
    }
    // a sequence that fits is staged once; a longer one streams through two
    // stages, chunk ch + 1's copy in flight while chunk ch is used
    if (nchunks > 1 || r == 0) stage_chunk(0, 0);
    for (int ch = 0; ch < nchunks; ++ch) {
      if (nchunks > 1 && ch + 1 < nchunks) stage_chunk((ch + 1) & 1, ch + 1);
      if (nchunks > 1 && ch + 1 < nchunks)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // the chunk has landed in every thread's view
      if (live) {
        const float4* ks = attn_f32_smem + (ch & 1) * 2 * kcap * CH;
        const float4* vs = ks + kcap * CH;
        const int nk = min(kcap, N - ch * kcap);
        // this part's key steps: every ksplit-th of the sequence's (kcap is a
        // multiple of the step where the sequence streams)
        const int step0 = ch * kcap / kF32KT;
        int k0 = ((part - step0) % ksplit + ksplit) % ksplit * kF32KT;
        for (; k0 + kF32KT <= nk; k0 += ksplit * kF32KT)
          f32_attn_tile<D, true>(wq, wp, ks, vs, k0, kF32KT, rg, x, m, l, acc);
        if (k0 < nk) f32_attn_tile<D, false>(wq, wp, ks, vs, k0, nk - k0, rg, x, m, l, acc);
      }
      if (nchunks > 1) __syncthreads();  // every warp is done with the stage before its refill
    }
    // each row's sum over its row group's lanes
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int off = 1; off < NX; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    if (ksplit > 1) {
      // the parts meet: each writes its rows' max, sum and output sums over
      // its own Q and P rows (rows of D + 2 floats), and part 0 merges them
      if (live) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* pr = wq + (rg + RG * i) * (D + 2);
#pragma unroll
          for (int d = 0; d < DT; ++d) pr[x * DT + d] = acc[i][d];
          if (x == 0) {
            pr[D] = m[i];
            pr[D + 1] = l[i];
          }
        }
      }
      __syncthreads();
      if (live && part == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int rr = rg + RG * i;
          float mx = -INFINITY;
          for (int p = 0; p < ksplit; ++p)
            mx = fmaxf(mx, wq[p * A::WARP_FLOATS + rr * (D + 2) + D]);
          float lt = 0.f, sum[DT];
#pragma unroll
          for (int d = 0; d < DT; ++d) sum[d] = 0.f;
          for (int p = 0; p < ksplit; ++p) {
            const float* pr = wq + p * A::WARP_FLOATS + rr * (D + 2);
            const float f = exp2_approx(pr[D] - mx);
            lt = fmaf(pr[D + 1], f, lt);
#pragma unroll
            for (int d = 0; d < DT; ++d) sum[d] = fmaf(pr[x * DT + d], f, sum[d]);
          }
          l[i] = lt;
#pragma unroll
          for (int d = 0; d < DT; ++d) acc[i][d] = sum[d];
        }
      }
      __syncthreads();  // the partials are read before the next round's Q rows
      if (part != 0) continue;
    }
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + rg + RG * i;
      if (row >= N) continue;
      const float inv = 1.f / l[i];
      float* op = ob + row * so.n + x * DT;
      if constexpr (DT == 2) {
        *reinterpret_cast<float2*>(op) = make_float2(acc[i][0] * inv, acc[i][1] * inv);
      } else {
#pragma unroll
        for (int c = 0; c < DT / 4; ++c)
          *reinterpret_cast<float4*>(op + 4 * c) =
              make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv, acc[i][4 * c + 2] * inv,
                          acc[i][4 * c + 3] * inv);
      }
    }
  }
}

// Shared bytes of one float32 block (kernels/attention.py f32_smem_bytes):
// one or two stages of K and V rows of kcap keys, and each warp's Q and P.
template <int D>
constexpr int f32_smem_bytes(int kcap, int stages, int warps) {
  return stages * 2 * kcap * D * 4 + warps * F32Attn<D>::WARP_FLOATS * 4;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                       const Strides* st, float scale, int splits, int kcap, int warps,
                       int ksplit, cudaStream_t stream) {
  // the geometry comes from kernels/attention.py f32_geometry; checked here
  const int stages = kcap < N ? 2 : 1;
  const int bytes = f32_smem_bytes<D>(kcap, stages, warps);
  const int wtiles = (N + F32Attn<D>::WR - 1) / F32Attn<D>::WR;
  if (warps < 1 || warps > 8 || splits < 1 || splits > wtiles || kcap < 16 || kcap % 16 != 0 ||
      (kcap < N && kcap % kF32KT != 0) || kcap >= N + 16 || bytes > 232448 || ksplit < 1 ||
      warps % ksplit != 0)
    return cudaErrorInvalidValue;
  auto kernel = attention_f32_kernel<D>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, splits);
  kernel<<<grid, warps * 32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, N, st[0], st[1], st[2], st[3], scale * kLog2e, kcap, ksplit);
  return cudaGetLastError();
}


// ---- bfloat16 and float16: tensor cores --------------------------------------

constexpr int kMaxWarps = 8;       // warps per block (4 or 8), each on its own 16-row tiles
constexpr int kKT = 64;            // keys per online-softmax step
constexpr int kMaxSmem = 232448;   // shared memory one block may use

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
                   int ksplit, float* lse, float* o32, int np, cudaStream_t stream) {
  if (dtype == 0) {
    if (lse != nullptr || o32 != nullptr) return cudaErrorInvalidValue;
    return launch_f32<D>(q, k, v, o, B, H, N, st, scale, splits, kcap, warps, ksplit, stream);
  }
  if (ksplit != 1) return cudaErrorInvalidValue;
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
// 2 float16. splits, kcap, warps: the blocks per sequence, staged keys and
// warps per block (kernels/attention.py launch_geometry, f32_geometry);
// ksplit: the float32 kernel's warps on one warp tile (1 in 16 bits);
// lse, o32: where non-null (16-bit only), each row's log2-sum-exp (row s *
// np + i of sequence s = b * H + h) and its float32 output ((s, i, d) of a
// contiguous (B H, N, D) array).
extern "C" int ys_attention(const void* q, const void* k, const void* v, void* o, int B, int H,
                            int N, int D, long long qb, long long qh, long long qn, long long kb,
                            long long kh, long long kn, long long vb, long long vh, long long vn,
                            long long ob, long long oh, long long on, float scale, int dtype,
                            int splits, int kcap, int warps, int ksplit, float* lse, float* o32,
                            int np, void* stream) {
  if (B == 0 || H == 0 || N == 0) return 0;
  const Strides st[4] = {{qb, qh, qn}, {kb, kh, kn}, {vb, vh, vn}, {ob, oh, on}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, H, N, st, scale, dtype, splits, kcap, warps, ksplit, lse,
                       o32, np, s);
    case 32:
      return launch<32>(q, k, v, o, B, H, N, st, scale, dtype, splits, kcap, warps, ksplit, lse,
                       o32, np, s);
    case 64:
      return launch<64>(q, k, v, o, B, H, N, st, scale, dtype, splits, kcap, warps, ksplit, lse,
                       o32, np, s);
    case 128:
      return launch<128>(q, k, v, o, B, H, N, st, scale, dtype, splits, kcap, warps, ksplit, lse,
                         o32, np, s);
    default: return cudaErrorInvalidValue;
  }
}
