// Shared helpers of the port's hand-written Hopper kernels: element types,
// conversions, the activation epilogue, and the tensor-core building blocks
// of the 16-bit routes (cp.async, ldmatrix, mma.sync). Every kernel takes
// float32, bfloat16 or float16 tensors and accumulates in float32.
#pragma once

#include <cstdint>

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

}  // namespace ys
