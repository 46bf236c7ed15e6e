// Shared helpers of the port's hand-written Hopper kernels: element types,
// conversions, the activation epilogue, and the tensor-core building blocks
// of the 16-bit routes (cp.async, ldmatrix, mma.sync; wgmma, mbarriers and
// TMA for the Hopper kernels). Every kernel takes float32, bfloat16 or
// float16 tensors and accumulates in float32.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ys {

enum Act : int { kIdentity = 0, kSilu = 1, kRelu = 2 };

using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(f16 v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch rounds
}
template <>
__device__ __forceinline__ f16 from_f<f16>(float v) {
  return __float2half_rn(v);  // round to nearest even (inf past 65504), as torch rounds
}

// Round a float32 value through T: what the plain version stores between
// two layers in the working type.
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kSilu) return silu(v);
  if (act == kRelu) return fmaxf(v, 0.f);
  return v;
}

// SiLU on the special-function unit (exp2 and reciprocal approximations, a
// few float32 ulp): the bfloat16 routes round it to 8 bits right after. The
// precise silu costs ~70 instructions, which made it the largest cost of the
// fused C2f block's epilogues at c = 32.
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// SiLU of a value that is rounded to 16 bits right after, in one MUFU
// operation: silu(v) = v/2 (1 + tanh(v/2)) through tanh.approx (relative
// error ~2^-11, so at most |v| 2^-12 off), against two for ex2 and rcp: the
// MUFU rate bounds the C2f kernel's epilogues at c = 32 and the bfloat16
// stem's.
__device__ __forceinline__ float silu16(float v) {
  const float h = 0.5f * v;
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(h));
  return fmaf(h, th, h);
}

__device__ __forceinline__ float apply_act_fast(float v, int act) {
  if (act == kSilu) return silu_fast(v);
  if (act == kRelu) return fmaxf(v, 0.f);
  return v;
}

// Four consecutive elements (16-byte aligned for float, 8 for 16-bit types).
__device__ __forceinline__ void load4(const float* p, float o[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float o[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}
__device__ __forceinline__ void load4(const f16* p, float o[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  o[0] = lo.x;
  o[1] = lo.y;
  o[2] = hi.x;
  o[3] = hi.y;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---- tensor-core building blocks (16-bit in, float32 sums) ------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy device -> shared; src_ok false zero-fills the
// 16 bytes (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool src_ok) {
  const int n = src_ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the row address of
// matrix l / 8, row l % 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The two 16-bit element types of the tensor-core routes. Both are 2 bytes,
// so every shared-memory layout, ldmatrix and wgmma descriptor is the same
// for both; they differ in the MMA instructions' type suffix and in the
// conversions. Half16<T>::mma: c += a (16x16, row) * b (16x8, col), T
// products, float32 sums; pack: two float32 values rounded to T, low half
// first; bits: the raw 16 bits.
template <typename T>
struct Half16;

template <>
struct Half16<bf16> {
  __device__ static __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  __device__ static __forceinline__ uint32_t bits(bf16 v) { return __bfloat16_as_ushort(v); }
};

template <>
struct Half16<f16> {
  __device__ static __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  __device__ static __forceinline__ uint32_t bits(f16 v) { return __half_as_ushort(v); }
};

// ---- Hopper building blocks: wgmma, mbarriers, TMA (the 16-bit conv3x3 and
// C2f kernels)

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
// offsets, base offset (the phase of the swizzle pattern at the start
// address), swizzle (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int swz,
                                              uint32_t base_offset = 0) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)(base_offset & 7) << 49) |
         ((uint64_t)swz << 62);
}
// The K-major A operand of BK channels a pixel row: 128-byte rows under the
// 128-byte swizzle (BK = 64) or 64-byte rows under the 64-byte swizzle (BK =
// 32), which XOR a row's 16-byte units with bits 7-9 (7-8) of its address;
// 8-row groups 8 rows apart. A tap starts its 64 rows at any pixel row of
// the tile, so the start is only row-aligned: the swizzle follows the
// absolute address (TMA writes it so, and wgmma reads it so with a base
// offset of 0 at every row start: conv3x3_desc_probe), so no base offset.
template <int BK>
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return smem_desc(addr, 16, 8 * BK * 2, BK == 64 ? 1 : 2);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of the given parity has completed. A wait of more
// than ~10 s (a lost TMA transaction or a miscounted barrier) traps, so a
// fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}
// TMA tensor loads into shared memory, completing on an mbarrier; the
// coordinates are signed, and elements outside the tensor read as zero.
__device__ __forceinline__ void tma2(uint32_t dst, const CUtensorMap* m, uint32_t bar, int c0,
                                     int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma3(uint32_t dst, const CUtensorMap* m, uint32_t bar, int c0,
                                     int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma4(uint32_t dst, const CUtensorMap* m, uint32_t bar, int c0,
                                     int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled of the CUDA driver API, found through the runtime's
// entry-point query so that the library links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

constexpr int kEncodeFailed = 10000;  // + the CUresult of a failed encode

// A tensor map over a tensor of `rank` dims (innermost first; strides in
// elements of dims 1..) of `elem`-byte elements (16-bit by default) with the
// given box and swizzle. 0 or an error.
inline int encode(CUtensorMap* m, CUtensorMapDataType type, int rank, const void* base,
                  const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                  CUtensorMapSwizzle swz, int elem = 2) {
  EncodeTiled enc = encoder();
  if (!enc) return kEncodeFailed;
  cuuint64_t d[5], s[4];
  cuuint32_t bx[5], one[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    one[i] = 1;
    if (i) s[i - 1] = strides[i - 1] * elem;
  }
  const CUresult r = enc(m, type, rank, const_cast<void*>(base), d, s, bx, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, bf16>::value    ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
         : std::is_same<T, f16>::value   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

}  // namespace ys
