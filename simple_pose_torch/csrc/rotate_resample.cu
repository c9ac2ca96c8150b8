// Stage 2 of the two-stage affine crop, the rotation resample, for Hopper
// (sm_90a).
//
// Replaces simple_pose_tpu/ops/pallas_warp.py:45 (_stage2_kernel, launched by
// rotate_resample_pallas).  For sample b, crop pixel (y, x) and channel c:
//   (ux, uy) = R_b (x, y) + u0_b
//   out[b, y, x, c] = sum_h sum_w hat(h - uy) * bf16(hat(w - ux)) * I[b, c, h, w]
// with hat(s) = max(0, 1 - |s|).  Only the x-tap weights are rounded to
// bf16; the y-weights, the products and the sums are f32.  I is the
// channel-major bf16 stage-1 intermediate [B, C, in_h, in_w]; taps outside
// it read 0.  The output is [B, oh, ow, C], f32, or bf16 as the f32 result
// rounded once.
//
// hat() is nonzero at two taps per axis at most (floor(u) and floor(u) + 1),
// so the TPU's one-hot matmul over a row band reduces to a 4-tap gather: each
// row's two x-taps are summed in f32, then the two y-weighted rows.  Products
// of two bf16 values are exact in f32, and every nonzero sum has two terms, so
// this kernel, the plain PyTorch version and the Pallas kernel agree bit for
// bit in f32.  One ulp of ux can flip the bf16 rounding of an x-weight, so
// ux and uy are rounded exactly as the JAX package computes them: XLA
// contracts r00 * x + r01 * y into one fused multiply-add,
//   ux = fma(r00, x, r01 * y) + u0x,
// which is spelled out here with __fmaf_rn / __fmul_rn / __fadd_rn (nvcc's
// own contraction could fuse other pairs).  The y-weighted rows are
// multiplied and added with __fmul_rn / __fadd_rn, unfused, as in JAX.
//
// What bounds it on the card: bytes.  Per output element it does ~10 flops
// against one bf16 read of the rotated footprint of the intermediate (R has
// unit rows, so the footprint is about the crop's own area) and one write:
// at batch 128 and 256x192x3 that is ~38 MB read and 38 MB (bf16) or 75 MB
// (f32) written, ~22-34 us at 3.35 TB/s.
//
// Design: one thread per output pixel, all C channels, so a warp writes a
// contiguous run of the NHWC output (coalesced stores), and neighbouring
// threads read neighbouring taps of a rotated row, which L1 and L2 serve.
// blockIdx.y is the sample; every thread reads its sample's six scalars (a
// broadcast load: the TPU's scalar prefetch has no counterpart here).  No
// shared memory, no TMA: tiling the footprint through shared memory is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float hat(float tap, float u) {
  return fmaxf(0.0f, 1.0f - fabsf(tap - u));
}

// I[b, c, yi, xi] as f32, 0 outside the intermediate.
__device__ __forceinline__ float tap_value(const __nv_bfloat16* __restrict__ plane, int yi,
                                           int xi, int in_h, int in_w) {
  if (yi < 0 || yi >= in_h || xi < 0 || xi >= in_w) return 0.0f;
  return __bfloat162float(__ldg(plane + (size_t)yi * in_w + xi));
}

template <typename OutT>
__device__ __forceinline__ OutT store_cast(float v);
template <> __device__ __forceinline__ float store_cast<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
rotate_resample_kernel(const __nv_bfloat16* __restrict__ inter, const float* __restrict__ scalars,
                       OutT* __restrict__ out, int channels, int in_h, int in_w, int oh, int ow) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= oh * ow) return;
  const int y = p / ow;
  const int x = p - y * ow;

  const float* s = scalars + (size_t)b * 6;
  const float r00 = __ldg(s + 0), r01 = __ldg(s + 1), r10 = __ldg(s + 2), r11 = __ldg(s + 3);
  const float u0x = __ldg(s + 4), u0y = __ldg(s + 5);
  const float xf = (float)x, yf = (float)y;
  const float ux = __fadd_rn(__fmaf_rn(r00, xf, __fmul_rn(r01, yf)), u0x);
  const float uy = __fadd_rn(__fmaf_rn(r10, xf, __fmul_rn(r11, yf)), u0y);

  const float fx0 = floorf(ux), fy0 = floorf(uy);
  const int x0 = (int)fx0, y0 = (int)fy0;
  // x-tap weights rounded to bf16 (the Pallas kernel's bf16 one-hot matrix)
  const float wx0 = __bfloat162float(__float2bfloat16_rn(hat(fx0, ux)));
  const float wx1 = __bfloat162float(__float2bfloat16_rn(hat(fx0 + 1.0f, ux)));
  const float wy0 = hat(fy0, uy);
  const float wy1 = hat(fy0 + 1.0f, uy);

  OutT* o = out + ((size_t)b * oh * ow + p) * channels;
  for (int c = 0; c < channels; ++c) {
    const __nv_bfloat16* plane = inter + ((size_t)b * channels + c) * in_h * in_w;
    const float row0 = __fadd_rn(__fmul_rn(tap_value(plane, y0, x0, in_h, in_w), wx0),
                                 __fmul_rn(tap_value(plane, y0, x0 + 1, in_h, in_w), wx1));
    const float row1 = __fadd_rn(__fmul_rn(tap_value(plane, y0 + 1, x0, in_h, in_w), wx0),
                                 __fmul_rn(tap_value(plane, y0 + 1, x0 + 1, in_h, in_w), wx1));
    o[c] = store_cast<OutT>(__fadd_rn(__fmul_rn(wy0, row0), __fmul_rn(wy1, row1)));
  }
}

}  // namespace

extern "C" {

// inter: bf16 [batch, channels, in_h, in_w]; scalars: f32 [batch, 6] holding
// r00 r01 r10 r11 u0x u0y; out: [batch, oh, ow, channels], bf16 if out_bf16,
// else f32.  Launches on `stream` and returns cudaGetLastError() (0 on
// success).
int rotate_resample_forward(const void* inter, const void* scalars, void* out, int batch,
                            int channels, int in_h, int in_w, int oh, int ow, int out_bf16,
                            void* stream_) {
  if (batch <= 0 || batch > 65535 || channels <= 0 || oh <= 0 || ow <= 0 || in_h <= 0 ||
      in_w <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const dim3 grid((unsigned)((oh * ow + kThreads - 1) / kThreads), (unsigned)batch);
  const auto* in = static_cast<const __nv_bfloat16*>(inter);
  const auto* sc = static_cast<const float*>(scalars);
  if (out_bf16) {
    rotate_resample_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        in, sc, static_cast<__nv_bfloat16*>(out), channels, in_h, in_w, oh, ow);
  } else {
    rotate_resample_kernel<float><<<grid, kThreads, 0, stream>>>(
        in, sc, static_cast<float*>(out), channels, in_h, in_w, oh, ow);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
