// The 16-bit (bfloat16 and float16) kernels of the attention's backward on
// Hopper (csrc/attention_bwd.cu): one warp-specialised skeleton, a template
// on the element type T, the kernel kind (dQ, or dK and dV) and the head dim
// D (16, 32, 64, 128).
//
// Work. A unit is 128 rows of one (batch, head) sequence: query rows for
// dQ, key rows for dK / dV. The grid is persistent (one block an SM,
// kernels/attention.py attention_plan); block i takes units i, i + grid, ...
// Each block holds a producer warpgroup and two consumer warpgroups;
// consumer w owns rows 64 w .. 64 w + 63 of the unit (its "own" tiles: Q and
// g; K and V) and walks the other side of the sequence (the "stream": K and
// V; Q, g and the row statistics) tile by tile.
//
// Loads. One producer thread starts every load by TMA against mbarriers:
// the own tiles of a unit into one of two buffers (the next unit's own tiles
// load while this one computes), the stream through a ring of 2-8 stages
// (as many as the shared memory holds; the ring runs on into the next unit).
// Both consumer warpgroups read each stage, and release it once the wgmma
// that read it are done. Rows past N come from TMA's zero fill of the box,
// so no thread masks a load, and a sequence of any length streams through
// the same ring (at N = 400, D = 32 the ring holds the whole sequence).
// Tiles sit in shared memory as TMA writes them: rows of min(D, 64) elements
// under the swizzle of that width (32, 64 or 128 bytes); D = 128 is two such
// column halves. Every tile starts on a 1024-byte boundary, so the swizzle
// phase follows the address and each wgmma descriptor needs base offset 0.
//
// Products, all on wgmma (no mma.sync): a score tile (64 rows x KT) is a
// shared x shared product with both operands K-major (the D columns are the
// reduction); the products into 64 x D accumulators take A from registers
// (P or dS straight from the score accumulators, packed to T: the
// accumulator layout of m64nNk16 is the A-fragment layout of the next
// product) and B = a stream tile read MN-major (its rows are the reduction).
// Each register-A group is waited on right after its commit: a shared x
// shared wgmma started while it is in flight makes ptxas serialise every
// wgmma of the kernel (C7513).
//
// Stores. The outputs are rounded once to T, staged into the warpgroup's
// own tile (whose last reader has finished), and written by a TMA store that
// clips the rows past N; the own buffer is handed back once the store has
// read it.
#pragma once

#include <math.h>

#include <algorithm>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace ys {
namespace attn16 {

struct Strides {
  long long b, h, n;  // elements
};

constexpr int kOwnRows = 64;                       // rows of a consumer warpgroup
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

enum Kind : int { kDq = 1, kDkdv = 2 };

// The layout of one kernel kind at head dim D (kernels/attention.py
// attention_plan mirrors it): rows of a stream tile, f32 row vectors in a
// stage, the swizzle, and the shared memory of `stages` ring stages.
template <int KIND, int D>
struct Cfg {
  static constexpr int NC = 2;                          // consumer warpgroups
  static constexpr int UNIT = kOwnRows * NC;            // rows of a unit
  static constexpr int THREADS = 128 * (NC + 1);        // + the producer warpgroup
  static constexpr int OWN = 2;                         // own tensors a warpgroup
  static constexpr int KT = (KIND == kDkdv && D == 128) ? 32 : 64;
  static constexpr int VEC = KIND == kDkdv ? 2 : 0;
  static constexpr int W = D < 64 ? D : 64;  // elements in a row of one column half
  static constexpr int RB = W * 2;           // its bytes: 32, 64 or 128
  static constexpr int HALVES = D / W;
  static constexpr int SWZ = RB == 128 ? 1 : RB == 64 ? 2 : 3;  // descriptor layout type
  static constexpr uint32_t MASK = RB == 128 ? 0x70 : RB == 64 ? 0x30 : 0x10;
  static constexpr int OWN_TILE = kOwnRows * D * 2;
  static constexpr int OWN_BYTES = 2 * NC * OWN * OWN_TILE;  // two units' own tiles
  static constexpr int ST_TILE = KT * D * 2;
  static constexpr int STAGE = (2 * ST_TILE + VEC * KT * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGE_TX = 2 * ST_TILE + VEC * KT * 4;
  static constexpr int BARS = 8 * (4 * NC + 2 * kMaxStages);
  static constexpr int smem(int stages) { return 1024 + OWN_BYTES + stages * STAGE + BARS; }
};

struct Geo {
  int N, H, units, tps, nst, stages;
  float sl2;     // scale * log2(e): scores in log2 units
  float scale;
  float* lse;    // each row's log2-sum-exp, which the forward wrote
  const float* o32;  // each row's f32 output, which the forward wrote
  float* delta;  // D_i = g_i . o_i: dQ writes it, dK/dV reads it
  int np;        // row stride of lse and delta (N rounded up to 4)
};

// own: the own tensors (Q, g; K, V); st: the stream (K, V; Q, g); out: the
// outputs (dq; dk, dv); vec: the dK/dV kernel's lse and delta
struct Maps {
  CUtensorMap own[2], st[2], out[2], vec[2];
};

// D (64 x 32) = (scale_d ? D : 0) + A (64 x 16) B (16 x 32), both K-major in shared memory
#define YS_ATTN_SS32(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
               "}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                 "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
               : "l"(da), "l"(db), "r"(scale_d))

// D (64 x 64) = (scale_d ? D : 0) + A (64 x 16) B (16 x 64), both K-major in shared memory
#define YS_ATTN_SS64(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
               "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                 "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
                 "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
                 "+f"(d[30]), "+f"(d[31]) \
               : "l"(da), "l"(db), "r"(scale_d))

// D (64 x 16) += A (64 x 16, registers) B (16 x 16, MN-major in shared memory)
#define YS_ATTN_RS16(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
               "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
               "{%0, %1, %2, %3, %4, %5, %6, %7" \
               "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                 "+f"(d[6]), "+f"(d[7]) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// D (64 x 32) += A (64 x 16, registers) B (16 x 32, MN-major in shared memory)
#define YS_ATTN_RS32(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
               "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                 "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// D (64 x 64) += A (64 x 16, registers) B (16 x 64, MN-major in shared memory)
#define YS_ATTN_RS64(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
               "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                 "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
                 "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
                 "+f"(d[30]), "+f"(d[31]) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// D (64 x 128) += A (64 x 16, registers) B (16 x 128, MN-major in shared memory)
#define YS_ATTN_RS128(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
               "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
               "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
                 "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
                 "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
                 "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
                 "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
                 "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
                 "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
                 "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
                 "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
                 "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 32 || N == 64, "score tiles are 32 or 64 wide");
  if constexpr (std::is_same<T, bf16>::value) {
    if constexpr (N == 32) YS_ATTN_SS32("bf16"); else YS_ATTN_SS64("bf16");
  } else {
    if constexpr (N == 32) YS_ATTN_SS32("f16"); else YS_ATTN_SS64("f16");
  }
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, bf16>::value) {
    if constexpr (N == 16) YS_ATTN_RS16("bf16");
    else if constexpr (N == 32) YS_ATTN_RS32("bf16");
    else if constexpr (N == 64) YS_ATTN_RS64("bf16");
    else YS_ATTN_RS128("bf16");
  } else {
    if constexpr (N == 16) YS_ATTN_RS16("f16");
    else if constexpr (N == 32) YS_ATTN_RS32("f16");
    else if constexpr (N == 64) YS_ATTN_RS64("f16");
    else YS_ATTN_RS128("f16");
  }
}

// Keep the compiler from moving reads or writes of a wgmma's registers across
// the wgmma fence, commit and wait: every register of an accumulator or A
// fragment is fenced around them (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x on the special-function unit (MUFU): ~2 ulp, 0 for -inf.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void st_shared32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sync_warpgroup(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void tma_store4(const CUtensorMap* m, uint32_t src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Byte offset of element (r, c) in a tile of R rows as TMA writes it.
template <class C>
__device__ __forceinline__ uint32_t tile_off(int R, int r, int c) {
  const uint32_t off = (c / C::W) * R * C::RB + r * C::RB + (c % C::W) * 2;
  return off ^ ((off >> 3) & C::MASK);
}
// K-major operand: k16 step ks (elements 16 ks..) of a tile of R rows.
template <class C>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int R, int ks) {
  const int e = ks * 16;
  return smem_desc(tile + (e / C::W) * R * C::RB + (e % C::W) * 2, 16, 8 * C::RB, C::SWZ);
}
// MN-major operand: rows 16 ks.. of a tile of R rows are the reduction, its D
// columns the N dim (LBO: the next column half; SBO: the next 8 rows).
template <class C>
__device__ __forceinline__ uint64_t mndesc(uint32_t tile, int R, int ks) {
  return smem_desc(tile + ks * 16 * C::RB, R * C::RB, 8 * C::RB, C::SWZ);
}

// The A fragment of k16 step ks of a 64 x KT score accumulator, rounded to T.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* s) {
  a[0] = Half16<T>::pack(s[0], s[1]);
  a[1] = Half16<T>::pack(s[2], s[3]);
  a[2] = Half16<T>::pack(s[4], s[5]);
  a[3] = Half16<T>::pack(s[6], s[7]);
}

// Round a 64 x D accumulator (times mul0 on rows g, mul1 on rows g + 8) to
// T into the warpgroup's own tile at `tile`.
template <typename T, class C, int D>
__device__ __forceinline__ void stage_out(uint32_t tile, const float (&acc)[D / 2], float mul0,
                                          float mul1, int row0, int tg) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * tg;
    st_shared32(tile + tile_off<C>(kOwnRows, row0, c),
                Half16<T>::pack(acc[4 * n] * mul0, acc[4 * n + 1] * mul0));
    st_shared32(tile + tile_off<C>(kOwnRows, row0 + 8, c),
                Half16<T>::pack(acc[4 * n + 2] * mul1, acc[4 * n + 3] * mul1));
  }
}

// P = 2^(s sl2 - lse) of a 64 x KT tile whose rows are the query rows (the
// dQ kernel: lse and delta per row, l0 / l1 and d0 / d1 the thread's two
// rows) and dS = P (dP - delta), in place of s and dp; or, with COLS, whose
// columns are the query rows (the dK / dV kernel: lse and delta per column
// from the stage's vectors at vec). Columns at or past nvalid give P = dS =
// 0 where !FULL, and an n8 block wholly past them pays no exponential.
template <int KT, bool FULL, bool COLS>
__device__ __forceinline__ void bwd_tile(float (&s)[KT / 2], float (&dp)[KT / 2], float sl2,
                                         float l0, float l1, float d0, float d1, uint32_t vec,
                                         int nvalid, int tg) {
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    const int c = 8 * j + 2 * tg;
    if (!FULL && 8 * j >= nvalid) {
      s[4 * j] = s[4 * j + 1] = s[4 * j + 2] = s[4 * j + 3] = 0.f;
      dp[4 * j] = dp[4 * j + 1] = dp[4 * j + 2] = dp[4 * j + 3] = 0.f;
      continue;
    }
    float la0 = l0, la1 = l0, lb0 = l1, lb1 = l1;
    float da0 = d0, da1 = d0, db0 = d1, db1 = d1;
    if constexpr (COLS) {
      const float2 L = ld_shared_f2(vec + c * 4);
      const float2 Dl = ld_shared_f2(vec + KT * 4 + c * 4);
      la0 = lb0 = L.x;
      la1 = lb1 = L.y;
      da0 = db0 = Dl.x;
      da1 = db1 = Dl.y;
    }
    const float lv[4] = {la0, la1, lb0, lb1};
    const float dv[4] = {da0, da1, db0, db1};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = FULL || c + (e & 1) < nvalid;
      const float p = ok ? ex2(fmaf(s[4 * j + e], sl2, -lv[e])) : 0.f;
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - dv[e]);
    }
  }
}

// Two 16-bit values of a packed pair as floats (low half first).
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  if constexpr (std::is_same<T, bf16>::value) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  } else {
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  }
}
__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

template <typename T, int KIND, int D>
__global__ void __launch_bounds__(Cfg<KIND, D>::THREADS, 1)
attn16_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Geo g) {
  using C = Cfg<KIND, D>;
  constexpr int KT = C::KT;
  constexpr int NC = C::NC;
  extern __shared__ __align__(1024) uint8_t attn_smem[];
  const uint32_t base = (smem_u32(attn_smem) + 1023) & ~1023u;
  const uint32_t st_base = base + C::OWN_BYTES;
  const uint32_t bars = st_base + g.stages * C::STAGE;
  // own_full[2][NC], own_empty[2][NC], st_full[kMaxStages], st_empty[kMaxStages]
  auto own_full = [&](int buf, int w) { return bars + 8 * (buf * NC + w); };
  auto own_empty = [&](int buf, int w) { return bars + 8 * (2 * NC + buf * NC + w); };
  auto st_full = [&](int s) { return bars + 8 * (4 * NC + s); };
  auto st_empty = [&](int s) { return bars + 8 * (4 * NC + kMaxStages + s); };
  auto own_tile = [&](int buf, int w, int i) {
    return base + ((buf * NC + w) * C::OWN + i) * C::OWN_TILE;
  };
  auto stage = [&](int s) { return st_base + s * C::STAGE; };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2 * NC; ++i) {
      mbar_init(bars + 8 * i, 1);                       // own_full
      mbar_init(bars + 8 * (2 * NC + i), 1);            // own_empty: the storing thread
    }
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(st_full(s), 1);
      mbar_init(st_empty(s), 4 * NC);                   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * NC) {
    // ---- producer: one thread starts every TMA load
    setmaxnreg_dec<40>();
    if (tid == 128 * NC) {
      int si = 0, sph = 0;
      int cnt = 0;
      for (int u = blockIdx.x; u < g.units; u += gridDim.x, ++cnt) {
        const int seq = u / g.tps, tile = u - seq * g.tps;
        const int b = seq / g.H, h = seq - b * g.H;
        const int buf = cnt & 1, ph = (cnt >> 1) & 1;
        for (int w = 0; w < NC; ++w) {
          mbar_wait(own_empty(buf, w), ph ^ 1);
          mbar_expect(own_full(buf, w), C::OWN * C::OWN_TILE);
          const int r0 = tile * C::UNIT + w * kOwnRows;
          for (int i = 0; i < C::OWN; ++i)
            for (int hf = 0; hf < C::HALVES; ++hf)
              tma4(own_tile(buf, w, i) + hf * kOwnRows * C::RB, &maps.own[i], own_full(buf, w),
                   hf * C::W, r0, h, b);
        }
        for (int t = 0; t < g.nst; ++t) {
          mbar_wait(st_empty(si), sph ^ 1);
          mbar_expect(st_full(si), C::STAGE_TX);
          const uint32_t dst = stage(si);
          for (int i = 0; i < 2; ++i)
            for (int hf = 0; hf < C::HALVES; ++hf)
              tma4(dst + i * C::ST_TILE + hf * KT * C::RB, &maps.st[i], st_full(si), hf * C::W,
                   t * KT, h, b);
          for (int i = 0; i < C::VEC; ++i)
            tma2(dst + 2 * C::ST_TILE + i * KT * 4, &maps.vec[i], st_full(si), t * KT, seq);
          if (++si == g.stages) {
            si = 0;
            sph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers
    setmaxnreg_inc<232>();
    const int w = tid >> 7;             // this warpgroup
    const int wt = tid & 127;
    const int wi = wt >> 5;             // warp in the warpgroup: rows 16 wi..
    const int lane = tid & 31;
    const int gq = lane >> 2, tg = lane & 3;
    int si = 0, sph = 0;
    auto advance = [&]() {
      if (++si == g.stages) {
        si = 0;
        sph ^= 1;
      }
    };
    auto release = [&](int s) {
      if (lane == 0) mbar_arrive(st_empty(s));
    };
    int cnt = 0;
    for (int u = blockIdx.x; u < g.units; u += gridDim.x, ++cnt) {
      const int seq = u / g.tps, tile = u - seq * g.tps;
      const int b = seq / g.H, h = seq - b * g.H;
      const int buf = cnt & 1, ph = (cnt >> 1) & 1;
      const int r0 = tile * C::UNIT + w * kOwnRows;
      const int row0 = 16 * wi + gq;     // the thread's rows in the own tile: row0, row0 + 8
      const int ra = r0 + row0, rb = ra + 8;
      const bool live = r0 + 16 * wi < g.N;   // warp-uniform: a warp past N pays no exponential
      const uint32_t own0 = own_tile(buf, w, 0);
      const uint32_t own1 = own_tile(buf, w, 1);
      mbar_wait(own_full(buf, w), ph);

      if constexpr (KIND == kDq) {
        float la = 0.f, lb = 0.f;
        if (live) {
          const float* lp = g.lse + (long long)seq * g.np;
          if (ra < g.N) la = lp[ra];
          if (rb < g.N) lb = lp[rb];
        }
        // delta_i = g_i . o_i over the row's D columns (a quarter of them a
        // thread of the quad), from the g tile and the forward's f32 output
        float dl[2] = {0.f, 0.f};
        if (live) {
          const float* op = g.o32 + (long long)seq * g.N * D;
#pragma unroll
          for (int c = tg * (D / 4); c < (tg + 1) * (D / 4); c += 2) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = r ? rb : ra;
              if (row < g.N) {
                const float2 gv =
                    unpack2<T>(ld_shared_u32(own1 + tile_off<C>(kOwnRows, row0 + 8 * r, c)));
                const float2 ov = *reinterpret_cast<const float2*>(op + (long long)row * D + c);
                dl[r] = fmaf(gv.x, ov.x, fmaf(gv.y, ov.y, dl[r]));
              }
            }
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            dl[0] += __shfl_xor_sync(0xffffffffu, dl[0], off);
            dl[1] += __shfl_xor_sync(0xffffffffu, dl[1], off);
          }
        }
        // dS = P (dP - delta), dQ += dS K
        float dq[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
        for (int t = 0; t < g.nst; ++t) {
          mbar_wait(st_full(si), sph);
          const uint32_t kt = stage(si), vt = kt + C::ST_TILE;
          float s[KT / 2], dp[KT / 2];
          fence_regs(s);
          fence_regs(dp);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks)
            wgmma_ss<T, KT>(s, kdesc<C>(own0, kOwnRows, ks), kdesc<C>(kt, KT, ks), ks);
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks)
            wgmma_ss<T, KT>(dp, kdesc<C>(own1, kOwnRows, ks), kdesc<C>(vt, KT, ks), ks);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          fence_regs(dq);
          uint32_t da[KT / 16][4];
          if (live) {
            const int nvalid = min(KT, g.N - t * KT);
            if (nvalid == KT)
              bwd_tile<KT, true, false>(s, dp, g.sl2, la, lb, dl[0], dl[1], 0, nvalid, tg);
            else
              bwd_tile<KT, false, false>(s, dp, g.sl2, la, lb, dl[0], dl[1], 0, nvalid, tg);
#pragma unroll
            for (int ks = 0; ks < KT / 16; ++ks) pack_a<T>(da[ks], dp + 8 * ks);
          } else {
#pragma unroll
            for (int ks = 0; ks < KT / 16; ++ks) da[ks][0] = da[ks][1] = da[ks][2] = da[ks][3] = 0u;
          }
          fence_regs(da);
          fence_regs(dq);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KT / 16; ++ks) wgmma_rs<T, D>(dq, da[ks], mndesc<C>(kt, KT, ks));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
          release(si);
          advance();
        }
        if (live && tg == 0) {
          float* dp_ = g.delta + (long long)seq * g.np;
          if (ra < g.N) dp_[ra] = dl[0];
          if (rb < g.N) dp_[rb] = dl[1];
        }
        stage_out<T, C, D>(own0, dq, g.scale, g.scale, row0, tg);
      } else {
        // dK / dV: the own rows are keys, the stream the query tiles
        float dk[D / 2], dv[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
        for (int t = 0; t < g.nst; ++t) {
          mbar_wait(st_full(si), sph);
          const uint32_t qt = stage(si), gt = qt + C::ST_TILE, vec = qt + 2 * C::ST_TILE;
          float s[KT / 2], dp[KT / 2];
          fence_regs(s);
          fence_regs(dp);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks)
            wgmma_ss<T, KT>(s, kdesc<C>(own0, kOwnRows, ks), kdesc<C>(qt, KT, ks), ks);
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks)
            wgmma_ss<T, KT>(dp, kdesc<C>(own1, kOwnRows, ks), kdesc<C>(gt, KT, ks), ks);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          fence_regs(dk);
          fence_regs(dv);
          uint32_t pa[KT / 16][4], da[KT / 16][4];
          if (live) {
            const int nvalid = min(KT, g.N - t * KT);
            if (nvalid == KT)
              bwd_tile<KT, true, true>(s, dp, g.sl2, 0.f, 0.f, 0.f, 0.f, vec, nvalid, tg);
            else
              bwd_tile<KT, false, true>(s, dp, g.sl2, 0.f, 0.f, 0.f, 0.f, vec, nvalid, tg);
#pragma unroll
            for (int ks = 0; ks < KT / 16; ++ks) {
              pack_a<T>(pa[ks], s + 8 * ks);
              pack_a<T>(da[ks], dp + 8 * ks);
            }
          } else {
#pragma unroll
            for (int ks = 0; ks < KT / 16; ++ks) {
              pa[ks][0] = pa[ks][1] = pa[ks][2] = pa[ks][3] = 0u;
              da[ks][0] = da[ks][1] = da[ks][2] = da[ks][3] = 0u;
            }
          }
          fence_regs(pa);
          fence_regs(da);
          fence_regs(dk);
          fence_regs(dv);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KT / 16; ++ks) {
            wgmma_rs<T, D>(dv, pa[ks], mndesc<C>(gt, KT, ks));
            wgmma_rs<T, D>(dk, da[ks], mndesc<C>(qt, KT, ks));
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(dv);
          release(si);
          advance();
        }
        stage_out<T, C, D>(own0, dk, g.scale, g.scale, row0, tg);
        stage_out<T, C, D>(own1, dv, 1.f, 1.f, row0, tg);
      }

      // every thread's output is staged: one thread stores it by TMA, waits
      // until the store has read it, and hands the own buffer back
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      sync_warpgroup(1 + w);
      if (wt == 0) {
        for (int i = 0; i < (KIND == kDkdv ? 2 : 1); ++i)
          for (int hf = 0; hf < C::HALVES; ++hf)
            tma_store4(&maps.out[i], own_tile(buf, w, i) + hf * kOwnRows * C::RB, hf * C::W, r0,
                       h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(own_empty(buf, w));
      }
    }
    // the last stores have written device memory before the block exits
    if (wt == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// A TMA map of a (B, H, N, D) 16-bit view with element strides s: boxes of
// rows x min(D, 64) elements under the swizzle of that width.
template <typename T, int D>
inline int map4(CUtensorMap* m, const void* p, const Strides& s, int B, int H, int N, int rows) {
  constexpr int W = D < 64 ? D : 64;
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)N, (uint64_t)H, (uint64_t)B};
  const uint64_t str[3] = {(uint64_t)s.n, (uint64_t)s.h, (uint64_t)s.b};
  const uint32_t box[4] = {(uint32_t)W, (uint32_t)rows, 1, 1};
  const CUtensorMapSwizzle swz = W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(m, tma_type<T>(), 4, p, dims, str, box, swz);
}

// A TMA map of a float32 (S, np) row-vector array (N live columns), boxes of
// `cols` columns of one row.
inline int map_vec(CUtensorMap* m, const float* p, int S, int N, int np, int cols) {
  EncodeTiled enc = encoder();
  if (!enc) return kEncodeFailed;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)S};
  const cuuint64_t str[1] = {(cuuint64_t)np * 4};
  const cuuint32_t box[2] = {(cuuint32_t)cols, 1}, one[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, str,
                         box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// Launch one kernel kind. t: the (B, H, N, D) views q, k, v, g, dq, dk, dv
// in the order of `st` (the dQ kernel writes dq, the dK / dV kernel dk and
// dv). grid and stages come from kernels/attention.py attention_plan and are
// checked here.
template <typename T, int KIND, int D>
int launch_kind(const void* const* t, const Strides* st, int B, int H, int N, float scale,
                int grid, int stages, float* lse, const float* o32, float* delta, int np,
                cudaStream_t stream) {
  using C = Cfg<KIND, D>;
  Geo g;
  g.N = N;
  g.H = H;
  g.tps = (N + C::UNIT - 1) / C::UNIT;
  const long long units = (long long)B * H * g.tps;
  g.units = (int)units;
  g.nst = (N + C::KT - 1) / C::KT;
  g.stages = stages;
  g.sl2 = scale * kLog2e;
  g.scale = scale;
  g.lse = lse;
  g.o32 = o32;
  g.delta = delta;
  g.np = np;
  const int smem = C::smem(stages);
  if (units > INT32_MAX || grid < 1 || grid > units || stages < 2 || stages > kMaxStages ||
      smem > kMaxSmem || lse == nullptr || o32 == nullptr || delta == nullptr || np < N ||
      np % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  // a runtime call first: it makes the device's primary context current on
  // this thread (autograd's backward thread may have none), which
  // cuTensorMapEncodeTiled needs
  auto kernel = attn16_kernel<T, KIND, D>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  int err = 0;
  // the own and stream tensors of each kind, by index into t
  const int own[2] = {KIND == kDq ? 0 : 1, KIND == kDq ? 3 : 2};
  const int str[2] = {KIND == kDq ? 1 : 0, KIND == kDq ? 2 : 3};
  const int out0 = KIND == kDq ? 4 : 5;
  for (int i = 0; i < C::OWN && !err; ++i)
    err = map4<T, D>(&maps.own[i], t[own[i]], st[own[i]], B, H, N, kOwnRows);
  for (int i = 0; i < 2 && !err; ++i)
    err = map4<T, D>(&maps.st[i], t[str[i]], st[str[i]], B, H, N, C::KT);
  for (int i = 0; i < (KIND == kDkdv ? 2 : 1) && !err; ++i)
    err = map4<T, D>(&maps.out[i], t[out0 + i], st[out0 + i], B, H, N, kOwnRows);
  if (KIND == kDkdv && !err) err = map_vec(&maps.vec[0], lse, B * H, N, np, C::KT);
  if (KIND == kDkdv && !err) err = map_vec(&maps.vec[1], delta, B * H, N, np, C::KT);
  if (err) return err;
  kernel<<<grid, C::THREADS, smem, stream>>>(maps, g);
  return cudaGetLastError();
}

}  // namespace attn16
}  // namespace ys
