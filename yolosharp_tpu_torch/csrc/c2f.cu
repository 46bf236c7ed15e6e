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
// float32 (c2f_f32_kernel): the same four GEMMs in order over the whole
// batch in one cooperative launch, each ending at a grid barrier, with y1,
// t and z in the wrapper's scratch buffer, so no block recomputes a halo
// (the kernel this one replaced computed cv1 on (T+4)^2 and the first 3x3
// on (T+2)^2 pixels for a T x T tile: 4x and 2.25x the products at c = 256)
// and its shared memory no longer grows with c. Float32 FMAs on the CUDA
// cores (TF32 in any form would break the float32 contract), so what
// bounds it is the 67 TFLOP/s float32 pipe. Each GEMM is tiled as
// conv3x3.cu's conv_f32_kernel is (the register tile of f32_tile.cuh): a
// block of 256 threads, one an SM, owns TM = 16384 / TN flat rows x TN
// output channels (TN 32 to 256; the 1x1s' TN is a template argument, as
// a runtime choice among their bodies slowed every body of the kernel), a
// thread an 8-row x 8-channel tile, input read as float4 units of 4
// channels of a pixel and weights as two float4.
// - 1x1 (cv1, cv2 over [y1 | z]): the rows are pixels of the flat batch; a
//   thread's 8 rows are NS (= 256 / (TN / 8)) apart, so the threads of a
//   shared-memory phase read neighbouring units.
// - 3x3 (t, z): the 16-bit route's flat-row band: a tile is R output rows x
//   Wt columns of one image; its input is the padded band of rows of P =
//   Wt + 2 pixels, so output (i, j) is flat row m = i P + j and tap (dy, dx)
//   reads row m + dy P + dx; a thread's 8 consecutive rows read 10 units a
//   kernel row for its three taps. Rows with j >= Wt or m >= R P are junk,
//   computed and never stored. The padding is the zero fill of the copies
//   that fall outside the image. A pad unit after every 8 staged units puts
//   the strips that share a shared-memory phase in different banks.
// - The K chunks (32 channels for the 1x1s, 8 channels x 9 taps for the
//   3x3s) come through a two-stage ring of 16-byte cp.async copies, one
//   sequence across a block's items, neighbouring threads copying
//   neighbouring units of a pixel. Each chunk's copies are issued a part
//   at a time between the products of the chunk before: issued at once,
//   their issue held the threads for 1-3 us a chunk while no thread
//   computed.
// - Where the tiles alone leave SMs idle (v8s layer 8 at B = 2: 800 pixels)
//   the K sum of a tile is split over blocks: each writes its partial sums
//   to the scratch buffer and, after a grid barrier, the whole grid adds
//   them in split order with the GEMM's epilogue: no atomics, so a result is
//   the same bits from run to run.
// - The epilogue loads its biases and z's residuals before its first store
//   and takes the SiLU on the special function unit (silu_fast).
// The plan (each GEMM's TN and split, the 3x3 tile) comes from the wrapper
// (kernels/c2f.py f32_c2f_plan, a cost model whose clocks chip_c2f_plans.py
// --f32 fits on the card). What bounds it (H100 80GB HBM3, 700 W, B = 2;
// per-step %globaltimer stamps): the products run at ~0.73 of the FMA
// peak inside a chunk; around them each GEMM pays a grid barrier (~2 us),
// its first copy and its rounds of items over 132 SMs, which the small
// maps (v8s-cls's 7 x 7 and 56 x 56) cannot fill. On that card chip_smoke
// phase 2's four B = 2 shapes sum to 0.410 ms against the plain chain's
// 0.786 and the bound's 0.098 (0.24 of it), the classify b32 shapes to
// 0.531 against 0.790 (PERF.md §6). Float32 throughout; the epilogues
// compute what the plain chain stores (round_t of float32 is the
// identity).
#include <algorithm>
#include <cstring>

#include "common.cuh"
#include "f32_tile.cuh"

using namespace ys;

namespace {

// The block's four GEMMs, in the order the launch runs them.
enum Gemm : int { kCv1 = 0, kT = 1, kZ = 2, kCv2 = 3, kGemms = 4 };

// Every block of the grid has arrived: the global stores each thread made
// before are visible to every block's loads (TMA included) after. bar[0]
// counts the arrivals (an acquire-release add, after the block's barrier)
// and is reset by the last one, which then moves bar[1], the generation,
// on with a release; the others spin on acquire loads of it. So the
// barrier needs no reset between launches, and no full fence (one took
// ~3% more of the float32 launch at B = 2). The launch is cooperative, so
// every block is resident; a wait of more than ~10 s traps all the same
// instead of hanging the card. THREADS: the block's threads (named
// barrier 1).
constexpr int kBlockBarrier = 1;  // the named barrier of all threads

template <int THREADS>
__device__ __forceinline__ void sync_grid(unsigned* bar) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBlockBarrier), "n"(THREADS) : "memory");
  if (threadIdx.x == 0) {
    unsigned g0, arrived, g;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(g0) : "l"(bar + 1) : "memory");
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(arrived)
                 : "l"(bar)
                 : "memory");
    if (arrived == gridDim.x - 1) {
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" ::"l"(bar) : "memory");
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar + 1) : "memory");
    } else {
      const long long start = clock64();
      for (int n = 0;; ++n) {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(g) : "l"(bar + 1) : "memory");
        if (g != g0) break;
        if ((n & 1023) == 1023 && clock64() - start > 20000000000LL) __trap();
      }
    }
  }
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBlockBarrier), "n"(THREADS) : "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Launches one cooperative kernel of `grid` blocks (every block resident:
// the grid barriers wait for all of them).
template <typename K, typename... Args>
cudaError_t launch_cooperative(K kernel, int grid, int threads, int smem, cudaStream_t stream,
                               Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- float32

constexpr int kF32Threads = 256;
constexpr int kF32Rows = 16384;  // a tile's flat rows x its channels (256 threads x 8 x 8)
constexpr int kF32Ck1 = 32;      // input channels a K chunk of the 1x1 GEMMs
constexpr int kF32Ck3 = 8;       // ... of the 3x3 GEMMs (each with its nine taps)

// One GEMM of the float32 launch and its tiles.
struct F32Gemm {
  int tn;           // output channels a tile; the tile has kF32Rows / tn flat rows
  int splits;       // blocks the K sum of a tile is split over
  int R, Wt, P;     // 3x3: output rows and columns of a tile, P = Wt + 2 (1x1: 0)
  int nwt, nbands;  // 3x3: column tiles and row bands of an image
  int mtiles, ntiles, nchunks;
};

struct F32Args {
  const float *x, *w1, *b1, *wm1, *bm1, *wm2, *bm2, *w2, *b2;
  float *y, *y1, *t, *z, *part;  // y1, t, z and the split sums: the wrapper's scratch
  unsigned* bar;                 // the grid barrier: arrivals, generation
  int B, H, W, Cin, c, C2, npix;
  F32Gemm g[kGemms];
};

// The operands of GEMM gi: A's channels [0, ksplit) from a0 (rows of lda0
// elements), the rest from a1 (cv2 reads [y1 | z]); the weights (K, N) or
// (3, 3, K, N); the output rows of ldo elements; z's residual bh.
struct F32Op {
  const float* a0;
  int lda0, ksplit;
  const float* a1;
  int lda1, K, N;
  const float *w, *bias;
  float* out;
  int ldo;
  const float* res;  // rows of 2c elements
};

__device__ __forceinline__ F32Op f32_op(const F32Args& a, int gi) {
  const int c = a.c;
  switch (gi) {
    case kCv1:
      return {a.x, a.Cin, a.Cin, a.x, a.Cin, a.Cin, 2 * c, a.w1, a.b1, a.y1, 2 * c, nullptr};
    case kT: return {a.y1 + c, 2 * c, c, a.y1 + c, 2 * c, c, c, a.wm1, a.bm1, a.t, c, nullptr};
    case kZ: return {a.t, c, c, a.t, c, c, c, a.wm2, a.bm2, a.z, c, a.y1 + c};
    default: return {a.y1, 2 * c, 2 * c, a.z, c, 3 * c, a.C2, a.w2, a.b2, a.y, a.C2, nullptr};
  }
}

// The output of 4 channels from their float32 sums s and biases bv:
// silu(s + bv). The SiLU on the special function unit (a few float32 ulp,
// well inside the 1e-4 + 1e-4 |p| the kernel is held to): the precise
// one's division took about a fifth of the launch at v8s layer 2.
__device__ __forceinline__ float4 f32_act(const float4& s, const float4& bv) {
  return make_float4(silu_fast(s.x + bv.x), silu_fast(s.y + bv.y), silu_fast(s.z + bv.z),
                     silu_fast(s.w + bv.w));
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// a staged unit of the 3x3 band: one pad unit after every 8
__device__ __forceinline__ int band_unit(int r) { return r + (r >> 3); }

// A units of one group of 4 channels in a stage (host: f32_stage_units):
// 1x1, the tile's TM pixels and a pad unit, so that the 8 groups of a pixel
// that neighbouring threads copy fall in different bank groups; 3x3, the
// padded band (TM + 2P + 2 pixels and a pad unit every 8), rounded to 4
// units past a multiple of 8 for the same reason between its 2 groups.
__host__ __device__ __forceinline__ int f32_a_units(int taps, int tm, int P) {
  if (taps == 1) return tm + 1;
  const int n = tm + 2 * P + 2;
  return ((n + (n >> 3) + 1 + 7) & ~7) + 4;
}

// One (tile, split) item of a GEMM: its first output channel, split, first
// pixel (1x1) or image and band origin (3x3), and its K chunks.
struct F32Item {
  int n0, split, p0, b, h0, w0, cbeg, cend;
};

// This block's items of one GEMM (TAPS 1: 1x1, 9: 3x3) at TN channels a
// tile, each a run of K chunks through the two-stage ring, then its
// epilogue or (splits > 1) its raw partial sums. The block's chunks are one
// sequence across its items, so the next item's first chunk is copied
// while this item's last chunk is used.
template <int TAPS, int TN>
__device__ void f32_gemm(const F32Args& a, const F32Gemm q, const F32Op& o, float4* smem) {
  constexpr int NG = TN / 8, NS = kF32Threads / NG, TM = 8 * NS;
  constexpr int CK = TAPS == 1 ? kF32Ck1 : kF32Ck3;
  constexpr int WU = CK * TAPS * TN / 4;  // weight units a stage
  const int units = f32_a_units(TAPS, TM, q.P);
  const int stage_units = CK / 4 * units + WU;
  const int tid = threadIdx.x, cg = tid % NG, strip = tid / NG;
  const int items = q.mtiles * q.ntiles * q.splits;
  const int per = (q.nchunks + q.splits - 1) / q.splits;
  auto item_of = [&](int item) {
    // the N tile fastest: blocks working at once share their A tile in L2
    F32Item it;
    it.n0 = (item % q.ntiles) * TN;
    item /= q.ntiles;
    it.split = item % q.splits;
    const int mt = item / q.splits;
    it.p0 = it.b = it.h0 = it.w0 = 0;
    if constexpr (TAPS == 1) {
      it.p0 = mt * TM;
    } else {
      it.w0 = (mt % q.nwt) * q.Wt;
      const int r = mt / q.nwt;
      it.h0 = (r % q.nbands) * q.R;
      it.b = r / q.nbands;
    }
    it.cbeg = it.split * per;
    it.cend = min(q.nchunks, it.cbeg + per);
    return it;
  };

  // part `part` of `parts` of chunk ch of item it into stage s:
  // neighbouring threads copy neighbouring 16-byte units of one pixel's
  // channels, then of the next pixel's
  auto load = [&](int s, const F32Item& it, int ch, int part, int parts) {
    const int u0 = tid + part * kF32Threads, du = kF32Threads * parts;
    float4* xs = smem + s * stage_units;
    float4* ws = xs + CK / 4 * units;
    const int k0 = ch * CK;
    if constexpr (TAPS == 1) {
      const bool second = k0 >= o.ksplit;
      const float* src = second ? o.a1 : o.a0;
      const int lda = second ? o.lda1 : o.lda0, kc = second ? k0 - o.ksplit : k0;
      for (int u = u0; u < CK / 4 * TM; u += du) {
        const int g4 = u % (CK / 4), r = u / (CK / 4);
        const long long p = (long long)it.p0 + r;
        const bool ok = p < a.npix && k0 + 4 * g4 < o.K;
        cp_async16(smem_u32(xs + g4 * units + r), ok ? src + p * lda + kc + 4 * g4 : src, ok);
      }
    } else {
      const int n = TM + 2 * q.P + 2;
      for (int u = u0; u < CK / 4 * n; u += du) {
        const int g4 = u % (CK / 4), r = u / (CK / 4);
        const int row = r / q.P, col = r - row * q.P;
        const int hi = it.h0 - 1 + row, wi = it.w0 - 1 + col;
        const bool ok = hi >= 0 && hi < a.H && wi >= 0 && wi < a.W;
        const long long p = ((long long)it.b * a.H + hi) * a.W + wi;
        cp_async16(smem_u32(xs + g4 * units + band_unit(r)),
                   ok ? o.a0 + p * o.lda0 + k0 + 4 * g4 : o.a0, ok);
      }
    }
    for (int u = u0; u < WU; u += du) {
      const int n4 = u % (TN / 4), kt = u / (TN / 4);  // kt = channel (x 9 + tap)
      const int n = it.n0 + 4 * n4;
      const float* src;
      bool ok;
      if constexpr (TAPS == 1) {
        const int k = k0 + kt;
        ok = k < o.K && n < o.N;
        src = o.w + (long long)k * o.N + n;
      } else {
        const int cc = kt / 9, tap = kt - cc * 9;
        ok = n < o.N;
        src = o.w + ((long long)tap * o.K + k0 + cc) * o.N + n;
      }
      cp_async16(smem_u32(ws + u), ok ? src : o.w, ok);
    }
  };

  // the item's sums: the epilogue, or its split's raw partial sums. The
  // biases and z's residuals are loaded before the first store: a store
  // may alias them, so a load after it would wait for it
  auto store = [&](const F32Item& it, const float (&acc)[8][8]) {
    long long pix[8];
    bool ok[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (TAPS == 1) {
        pix[i] = (long long)it.p0 + strip + NS * i;
        ok[i] = pix[i] < a.npix;
      } else {
        const int m = 8 * strip + i, ti = m / q.P, tj = m - ti * q.P;
        ok[i] = ti < q.R && tj < q.Wt && it.h0 + ti < a.H && it.w0 + tj < a.W;
        pix[i] = ((long long)it.b * a.H + it.h0 + ti) * a.W + it.w0 + tj;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = it.n0 + TN / 2 * hf + 4 * cg;
      if (n >= o.N) continue;
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f), rv[8];
      if (q.splits == 1) {
        bv = *reinterpret_cast<const float4*>(o.bias + n);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          rv[i] = o.res && ok[i]
                      ? __ldcg(reinterpret_cast<const float4*>(o.res + pix[i] * (2 * o.N) + n))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (!ok[i]) continue;
        const float4 s = make_float4(acc[i][4 * hf], acc[i][4 * hf + 1], acc[i][4 * hf + 2],
                                     acc[i][4 * hf + 3]);
        if (q.splits > 1)  // raw partial sums, added in order by f32_split_sum
          __stcg(reinterpret_cast<float4*>(a.part + ((long long)it.split * a.npix + pix[i]) * o.N +
                                           n),
                 s);
        else  // z: bh + silu(.), the plain chain's order
          *reinterpret_cast<float4*>(o.out + pix[i] * o.ldo + n) =
              o.res ? add4(rv[i], f32_act(s, bv)) : f32_act(s, bv);
      }
    }
  };

  int item = blockIdx.x;
  if (item >= items) return;
  F32Item cur = item_of(item);
  int ch = cur.cbeg, stage = 0;
  load(0, cur, ch, 0, 1);
  cp_async_commit();
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  while (true) {
    // the block's next chunk: this item's next, else its next item's first
    F32Item nxt = cur;
    int nitem = item, nch = ch + 1;
    if (nch >= cur.cend) {
      nitem = item + gridDim.x;
      if (nitem < items) {
        nxt = item_of(nitem);
        nch = nxt.cbeg;
      }
    }
    const bool more = nitem < items;
    cp_async_wait<0>();
    // chunk ch has landed in every thread's view, and every thread is done
    // with the other stage, which the products below refill
    __syncthreads();
    const float4* xs = smem + stage * stage_units;
    const float4* ws = xs + CK / 4 * units;
    // the next chunk's copies are issued a part at a time between the
    // products: issued at once, they stall their threads (each SM keeps
    // only so many copies in flight) while no thread computes
    if constexpr (TAPS == 1) {
#pragma unroll 1
      for (int g2 = 0; g2 < CK / 8; ++g2) {
        if (more) load(stage ^ 1, nxt, nch, g2, CK / 8);
#pragma unroll
        for (int g4 = 2 * g2; g4 < 2 * g2 + 2; ++g4) {
          float4 px[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) px[i] = xs[g4 * units + strip + NS * i];
          fma_group<TN / 4, NG>(acc, px, ws + 4 * g4 * (TN / 4) + cg);
        }
      }
    } else {
      // one (channel group, kernel row) an iteration, as conv_f32_kernel
#pragma unroll 1
      for (int g4 = 0; g4 < CK / 4; ++g4) {
#pragma unroll 1
        for (int kh = 0; kh < 3; ++kh) {
          if (more) load(stage ^ 1, nxt, nch, g4 * 3 + kh, CK / 4 * 3);
          const float4* row = xs + g4 * units;
          const int r0 = 8 * strip + kh * q.P;
          float4 a10[10];
#pragma unroll
          for (int i = 0; i < 10; ++i) a10[i] = row[band_unit(r0 + i)];
          const float4* wk = ws + (g4 * 4 * 9 + kh * 3) * (TN / 4) + cg;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            float4 px[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) px[i] = a10[i + kw];
            fma_group<9 * (TN / 4), NG>(acc, px, wk + kw * (TN / 4));
          }
        }
      }
    }
    cp_async_commit();
    if (ch + 1 >= cur.cend) {
      store(cur, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (!more) break;
    cur = nxt;
    item = nitem;
    ch = nch;
    stage ^= 1;
  }
  cp_async_wait<0>();
}

// The split sums of one GEMM, over the whole grid: out = epilogue(part[0] +
// part[1] + ...), the splits in order.
__device__ void f32_split_sum(const F32Args& a, const F32Gemm q, const F32Op& o) {
  // 32-bit offsets: the launch admits splits x B H W x N below 2^31
  const int n4 = o.N / 4, total = a.npix * n4, plane = a.npix * o.N;
  for (int i = blockIdx.x * kF32Threads + threadIdx.x; i < total; i += gridDim.x * kF32Threads) {
    const int pix = i / n4, n = (i - pix * n4) * 4;
    const float* pp = a.part + pix * o.N + n;
    float4 s = __ldcg(reinterpret_cast<const float4*>(pp));
#pragma unroll 4
    for (int k = 1; k < q.splits; ++k) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(pp + k * plane));
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    const float4 v = f32_act(s, *reinterpret_cast<const float4*>(o.bias + n));
    const float* res = o.res + (long long)pix * (2 * o.N) + n;
    *reinterpret_cast<float4*>(o.out + (long long)pix * o.ldo + n) =
        o.res ? add4(__ldcg(reinterpret_cast<const float4*>(res)), v) : v;
  }
}

// TN1: the 1x1 GEMMs' tile width, a template argument (one 1x1 body a
// kernel: with a runtime choice among three the launch at v8s layer 2 was
// ~10% slower)
template <int TN1>
__global__ void __launch_bounds__(kF32Threads, 1)
c2f_f32_kernel(const __grid_constant__ F32Args a) {
  extern __shared__ float4 f32_smem[];
  for (int gi = 0; gi < kGemms; ++gi) {
    const F32Gemm q = a.g[gi];  // in registers: an indexed constant load would repeat in the loops
    const F32Op o = f32_op(a, gi);
    if (gi == kT || gi == kZ) {
      switch (q.tn) {
        case 32: f32_gemm<9, 32>(a, q, o, f32_smem); break;
        case 64: f32_gemm<9, 64>(a, q, o, f32_smem); break;
        case 128: f32_gemm<9, 128>(a, q, o, f32_smem); break;
        default: f32_gemm<9, 256>(a, q, o, f32_smem);
      }
    } else {
      f32_gemm<1, TN1>(a, q, o, f32_smem);
    }
    if (q.splits > 1) {
      sync_grid<kF32Threads>(a.bar);
      f32_split_sum(a, q, o);
    }
    if (gi + 1 < kGemms) sync_grid<kF32Threads>(a.bar);
  }
}

// One stage of a float32 GEMM's ring in float4 units: its A units and
// weights (kernels/c2f.py f32_stage_bytes mirrors it).
int f32_stage_units(int taps, int tn, int P) {
  const int tm = kF32Rows / tn, ck = taps == 1 ? kF32Ck1 : kF32Ck3;
  return ck / 4 * f32_a_units(taps, tm, P) + ck * taps * tn / 4;
}

// plan: the wrapper's (kernels/c2f.py C2fF32Plan.ints): cv1's TN and split,
// the 3x3s' TN, rows, columns and split, cv2's TN (cv1's) and split;
// checked here.
// scratch: B H W 4c floats for y1, t and z, then the split sums.
cudaError_t launch_f32(const void* const* p, void* y, void* scratch, long long scratch_elems,
                       void* bar, int B, int H, int W, int Cin, int c, int C2, const int* plan,
                       cudaStream_t stream) {
  if (!scratch || !bar || (Cin & 3) || (c & 15) || (C2 & 3)) return cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  if (npix > INT32_MAX / 4) return cudaErrorInvalidValue;
  F32Args a;
  const float* const* f = reinterpret_cast<const float* const*>(p);
  a.x = f[0];
  a.w1 = f[1];
  a.b1 = f[2];
  a.wm1 = f[3];
  a.bm1 = f[4];
  a.wm2 = f[5];
  a.bm2 = f[6];
  a.w2 = f[7];
  a.b2 = f[8];
  float* s = static_cast<float*>(scratch);
  a.y = static_cast<float*>(y);
  a.y1 = s;
  a.t = s + npix * 2 * c;
  a.z = s + npix * 3 * c;
  a.part = s + npix * 4 * c;
  a.bar = static_cast<unsigned*>(bar);
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.c = c;
  a.C2 = C2;
  a.npix = (int)npix;
  auto cdiv = [](long long x, long long d) { return (int)((x + d - 1) / d); };
  auto pow2 = [](int v, int lo) { return v >= lo && v <= 256 && (v & (v - 1)) == 0; };
  bool ok = true;
  auto one = [&](F32Gemm& g, int tn, int splits, int N, int K) {
    ok = ok && pow2(tn, 64);
    g.tn = ok ? tn : 64;
    g.splits = splits;
    g.R = g.Wt = g.P = g.nwt = g.nbands = 0;
    g.mtiles = cdiv(npix, kF32Rows / g.tn);
    g.ntiles = cdiv(N, g.tn);
    g.nchunks = cdiv(K, kF32Ck1);
  };
  auto three = [&](F32Gemm& g, int tn, int R, int Wt, int splits) {
    ok = ok && pow2(tn, 32) && R >= 1 && Wt >= 1 && (long long)R * (Wt + 2) <= kF32Rows / tn;
    g.tn = ok ? tn : 32;
    g.splits = splits;
    g.R = R;
    g.Wt = Wt;
    g.P = Wt + 2;
    g.nwt = cdiv(W, Wt);
    g.nbands = cdiv(H, R);
    g.mtiles = B * g.nbands * g.nwt;
    g.ntiles = cdiv(c, g.tn);
    g.nchunks = c / kF32Ck3;
  };
  one(a.g[kCv1], plan[0], plan[1], 2 * c, Cin);
  three(a.g[kT], plan[2], plan[3], plan[4], plan[5]);
  a.g[kZ] = a.g[kT];
  one(a.g[kCv2], plan[6], plan[7], C2, 3 * c);
  if (!ok) return cudaErrorInvalidValue;
  const int Ns[kGemms] = {2 * c, c, c, C2};
  long long need = npix * 4 * c;
  int units = 0, items = 0;
  for (int gi = 0; gi < kGemms; ++gi) {
    const F32Gemm& g = a.g[gi];
    const int per = (g.nchunks + g.splits - 1) / std::max(g.splits, 1);
    if (g.splits < 1 || g.splits > g.nchunks || (g.splits - 1) * per >= g.nchunks)
      return cudaErrorInvalidValue;  // no split without chunks
    if (g.splits > 1 && npix * Ns[gi] * g.splits >= INT32_MAX) return cudaErrorInvalidValue;
    if (g.splits > 1) need = std::max(need, npix * 4 * c + g.splits * npix * Ns[gi]);
    units = std::max(units, f32_stage_units(gi == kT || gi == kZ ? 9 : 1, g.tn, g.P));
    items = std::max(items, g.mtiles * g.ntiles * g.splits);
  }
  const int smem = 2 * units * 16;
  if (need > scratch_elems || smem > 232448 || a.g[kCv1].tn != a.g[kCv2].tn)
    return cudaErrorInvalidValue;
  auto kernel = a.g[kCv1].tn == 64    ? c2f_f32_kernel<64>
                : a.g[kCv1].tn == 128 ? c2f_f32_kernel<128>
                                      : c2f_f32_kernel<256>;
  cudaError_t e = allow_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kF32Threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one block an SM (the plan's cost model counts so)
  return launch_cooperative(kernel, std::min(items, sms), kF32Threads, smem, stream, a);
}


// ------------------------------------------- 16-bit: bfloat16 and float16

constexpr int kTcConsumers = 2;  // warpgroups that issue wgmma
constexpr int kTcThreads = 128 * (kTcConsumers + 1);
constexpr int kMinBStages = 4, kMaxBStages = 8;  // slots of the weight ring
constexpr int kMaxAStages = 6;                   // slots of A tiles (at least 2)
constexpr int kEpiBarrier = 2;                   // the consumers' (those with rows)

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
      if (gi + 1 < kGemms) sync_grid<kTcThreads>(o.bar);
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
      if (gi + 1 < kGemms) sync_grid<kTcThreads>(o.bar);
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
  // persistent: one block an SM
  return launch_cooperative(kernel, std::min(tiles, sms), kTcThreads, smem, stream, maps, g, out);
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
// cores: plan holds the 8 ints of kernels/c2f.py C2fF32Plan.ints; scratch
// holds B H W 4c floats and the split sums, scratch_elems of them), 1
// bfloat16 or 2 float16 (tensor cores: plan holds bk, bn, ms, rows, wt of
// kernels/c2f.py c2f_plan; scratch holds B H W 4c elements). bar: two
// unsigned ints, zero before the first launch and left so by each.
extern "C" int ys_c2f(const void* x, const void* w1, const void* b1, const void* wm1,
                      const void* bm1, const void* wm2, const void* bm2, const void* w2,
                      const void* b2, void* y, void* scratch, void* bar, int B, int H, int W,
                      int Cin, int c, int C2, int dtype, const int* plan,
                      long long scratch_elems, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  if (c % 4 || C2 % 4 || !plan) return cudaErrorInvalidValue;
  const void* p[9] = {x, w1, b1, wm1, bm1, wm2, bm2, w2, b2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(p, y, scratch, scratch_elems, bar, B, H, W, Cin, c, C2, plan, st);
  if (dtype == 1)
    return launch_tc_plan<bf16>(p, y, scratch, bar, B, H, W, Cin, c, C2, plan[0], plan[1],
                                plan[2], plan[3], plan[4], st);
  if (dtype == 2)
    return launch_tc_plan<f16>(p, y, scratch, bar, B, H, W, Cin, c, C2, plan[0], plan[1],
                               plan[2], plan[3], plan[4], st);
  return cudaErrorInvalidValue;
}
