// The float32 register tile that the CUDA-core kernels of conv3x3.cu
// (conv_f32_kernel) and c2f.cu (c2f_f32_kernel) share: a thread keeps an
// 8-pixel x 8-channel tile of float32 sums; its input is read from shared
// memory as float4 units of 4 channels of one pixel, its weights as two
// float4 of 4 output channels each (channels 4 cg.. and half + 4 cg.., so
// that the 8 threads of a shared-memory phase read 8 consecutive float4).
// Each float4 of input then feeds 4 x 8 FMAs and each weight float4 8 x 4.
// The order of the FMAs is fixed (input channel e = 0..3, then pixel i,
// then output channel j), so a result is the same bits from run to run.
#pragma once

namespace ys {

// a[j] += v * (wa, wb)[j]: one input value of one pixel into its 8 sums
__device__ __forceinline__ void fma8(float (&a)[8], const float4& wa, const float4& wb, float v) {
  a[0] = fmaf(v, wa.x, a[0]);
  a[1] = fmaf(v, wa.y, a[1]);
  a[2] = fmaf(v, wa.z, a[2]);
  a[3] = fmaf(v, wa.w, a[3]);
  a[4] = fmaf(v, wb.x, a[4]);
  a[5] = fmaf(v, wb.y, a[5]);
  a[6] = fmaf(v, wb.z, a[6]);
  a[7] = fmaf(v, wb.w, a[7]);
}

// One group of 4 input channels: acc[i][j] += px[i][e] w[e][j] for e = 0..3.
// wt points at this thread's weights of input channel 0 of the group (its
// first 4 output channels; the other 4 are HALF float4 on); input channel
// e's are LD float4 on.
template <int LD, int HALF>
__device__ __forceinline__ void fma_group(float (&acc)[8][8], const float4 (&px)[8],
                                          const float4* wt) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 wa = wt[e * LD], wb = wt[e * LD + HALF];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = e == 0 ? px[i].x : e == 1 ? px[i].y : e == 2 ? px[i].z : px[i].w;
      fma8(acc[i], wa, wb, v);
    }
  }
}

}  // namespace ys
