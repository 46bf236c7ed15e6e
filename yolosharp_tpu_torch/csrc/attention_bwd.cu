// The backward of the fused softmax attention for bfloat16 and float16: dq,
// dk and dv of o = softmax(q k^T * scale) v for the output gradient g. It
// replaces no Pallas kernel: the JAX package's backward (_pallas_attn_bwd,
// yolosharp_tpu/kernels/attention.py:100-113) is einsum code that XLA fuses
// on the TPU. It computes that math with f32 sums:
//   S = q k^T scale; P = softmax_row(S); dV = P^T g; dP = g V^T;
//   D_i = sum_j P_ij dP_ij; dS = P (dP - D); dQ = scale dS K; dK = scale dS^T Q,
// each gradient rounded once to its input's type. The float32 backward stays
// the plain kernels/attention.py attention_grads_plain.
//
// q, k, v, g, dq, dk, dv: (B, H, N, D) element-strided views (unit stride in
// D, 16-byte aligned rows) of one 16-bit type; D in {16, 32, 64, 128}; any N.
// lse, o32: each row's log2-sum-exp of the scaled scores and its float32
// output, which the forward (csrc/attention.cu) wrote under autograd: P =
// 2^(S scale log2(e) - lse) costs one exponential a score and no pass for
// the row maxima, and D_i = sum_j P_ij dP_ij = g_i . o_i costs no pass over
// the keys.
//
// Two launches of the skeleton in csrc/attention16.cuh, in order on the
// stream; no atomics, so two runs give the same bits:
// 1. attn16_kernel<T, kDq, D>: a unit is 128 query rows (64 a consumer
//    warpgroup), its own tiles Q and g. D_i = g_i . o_i in f32 from the g tile
//    and the forward's f32 output o32: not from the 16-bit o, whose rounding
//    of 2^-9 relative would land in every dS (dS = P (dP - D) cancels where
//    dP ~ D); o32 carries only the rounding of P to T in the forward's P V,
//    averaged over the row's keys. It streams K and V once: S = Q K^T and dP
//    = g V^T on wgmma, P and dS in f32, then dQ += dS K on wgmma (dS packed
//    to T from the accumulators as the A operand in registers, K read
//    MN-major). D goes to a f32 buffer of the wrapper.
// 2. attn16_kernel<T, kDkdv, D>: a unit is 128 key rows, its own tiles K and
//    V; the stream is Q and g with the rows' lse and D (TMA loads of the f32
//    buffers). Per stage S^T = K Q^T and dP^T = V g^T on wgmma (the score
//    tile transposed, so that P^T and dS^T come straight from the
//    accumulators as A operands), then dV += P^T g and dK += dS^T Q on wgmma
//    with g and Q read MN-major. At D = 128 its stage holds 32 query rows (the
//    four accumulators of 64 x 128 would not fit the registers otherwise).
// Every product is on wgmma; none needs mma.sync. P and dS are rounded to T
// as the A operands of the dV, dQ and dK products, which the f32 plain
// version does not do; the card tests and chip_smoke hold each gradient to
// 2.5 units of T's rounding of max|ref| against float64.
// What bounds it on an H100: q, k, v, g read once and dq, dk, dv written once,
// 7 S N D 2 bytes (46 MB, ~14 us at 3.35 TB/s, for a v12s b16 train step's
// layer 6: S = 256 sequences of N = 400, D = 32), and five products of 2 S N^2
// D flop (13 GFLOP); the two kernels compute S and dP twice and take two
// exponentials a score, and their two consumer warpgroups an SM wait on
// each wgmma group: latency, not the bytes, the tensor cores or the MUFU,
// sets their time (PERF.md). The wrapper
// allocates dq, dk, dv and the D buffer, so the backward captures in a CUDA
// graph.
#include "attention16.cuh"
#include "common.cuh"

using namespace ys;
using attn16::Strides;

namespace {

template <typename T, int D>
int launch(const void* const* t, const Strides* st, int B, int H, int N, float scale,
           const int* plan, float* lse, const float* o32, float* delta, int np,
           cudaStream_t stream) {
  const int e = attn16::launch_kind<T, attn16::kDq, D>(t, st, B, H, N, scale, plan[0], plan[1],
                                                       lse, o32, delta, np, stream);
  if (e) return e;
  return attn16::launch_kind<T, attn16::kDkdv, D>(t, st, B, H, N, scale, plan[2], plan[3], lse,
                                                  o32, delta, np, stream);
}

template <typename T>
int launch_t(const void* const* t, const Strides* st, int B, int H, int N, int D, float scale,
             const int* plan, float* lse, const float* o32, float* delta, int np,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(t, st, B, H, N, scale, plan, lse, o32, delta, np, s);
    case 32: return launch<T, 32>(t, st, B, H, N, scale, plan, lse, o32, delta, np, s);
    case 64: return launch<T, 64>(t, st, B, H, N, scale, plan, lse, o32, delta, np, s);
    case 128: return launch<T, 128>(t, st, B, H, N, scale, plan, lse, o32, delta, np, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the CUDA error of the launches (0 on success; 10000 + the CUresult
// of a failed TMA map encode). t: q, k, v, g, dq, dk, dv; strides: (batch,
// head, row) in elements for each, in that order. dtype: 1 bfloat16, 2
// float16. plan: grid and stages of the dQ kernel, then of the dK / dV kernel
// (kernels/attention.py attention_plan). lse: the forward's row statistics;
// delta: a f32 buffer of the same shape, written by the dQ kernel; both rows
// of np floats (np >= N, a multiple of 4), row s = b * H + h. o32: the
// forward's f32 output, a contiguous (B H, N, D) array.
extern "C" int ys_attention_bwd(const void* q, const void* k, const void* v, const void* g,
                                void* dq, void* dk, void* dv, int B, int H, int N, int D,
                                const long long* strides, float scale, int dtype,
                                const int* plan, float* lse, const float* o32, float* delta,
                                int np, void* stream) {
  if (B == 0 || H == 0 || N == 0) return 0;
  const void* t[7] = {q, k, v, g, dq, dk, dv};
  Strides st[7];
  for (int i = 0; i < 7; ++i) st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_t<bf16>(t, st, B, H, N, D, scale, plan, lse, o32, delta, np, s);
  if (dtype == 2) return launch_t<f16>(t, st, B, H, N, D, scale, plan, lse, o32, delta, np, s);
  return cudaErrorInvalidValue;
}
