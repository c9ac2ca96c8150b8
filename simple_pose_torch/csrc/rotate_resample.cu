// The rotated training crop for Hopper (sm_90a): the stage-2 rotation
// resample alone (rotate_resample_kernel), and the whole two-stage crop in one
// kernel (rotate_resample_crop_kernel).
//
// Both replace simple_pose_tpu/ops/pallas_warp.py:45 (_stage2_kernel, launched
// by rotate_resample_pallas inside affine_crop_pallas, :170).
//
// Stage 2.  For sample b, crop pixel (y, x) and channel c:
//   (ux, uy) = R_b (x, y) + u0_b
//   out[b, y, x, c] = sum_h sum_w hat(h - uy) * bf16(hat(w - ux)) * I[b, c, h, w]
// with hat(s) = max(0, 1 - |s|).  Only the x-tap weights are rounded to
// bf16; the y-weights, the products and the sums are f32.  I is the bf16
// stage-1 intermediate [inter, inter]; taps outside it read 0.  The output is
// [B, oh, ow, C], f32, or bf16 as the f32 result rounded once.
//
// hat() is nonzero at two taps per axis at most (floor(u) and floor(u) + 1),
// so the TPU's one-hot matmul over a row band reduces to a 4-tap gather: each
// row's two x-taps are summed in f32, then the two y-weighted rows.  Products
// of two bf16 values are exact in f32, and every nonzero sum has two terms, so
// these kernels, the plain PyTorch version and the Pallas kernel agree bit for
// bit in f32.  One ulp of ux can flip the bf16 rounding of an x-weight, so
// ux and uy are rounded exactly as the JAX package computes them: XLA
// contracts r00 * x + r01 * y into one fused multiply-add,
//   ux = fma(r00, x, r01 * y) + u0x,
// which is spelled out here with __fmaf_rn / __fmul_rn / __fadd_rn (nvcc's
// own contraction could fuse other pairs).  The y-weighted rows are
// multiplied and added with __fmul_rn / __fadd_rn, unfused, as in JAX.
//
// Stage 1 (ops/warp.py stage1_resample, the JAX package's two interpolation
// matmuls on bf16 operands).  Intermediate pixel (iy, ix), channel c, of the
// uint8 canvas G:
//   py = t1y + iy * d1, px = t1x + ix * d0      f32, multiply then add, unfused
//   wy = (bf16(1 - fy), bf16(fy)) at rows floor(py) + {0, 1}; wx likewise
//   tmp_k = bf16(wy0 * G[y0, x0 + k] + wy1 * G[y0 + 1, x0 + k])   rows first
//   I = bf16(wx0 * tmp_0 + wx1 * tmp_1)                             then columns
// with canvas taps outside the canvas contributing 0.  Every product is of
// two bf16 values, so exact in f32, and each sum has two terms: this is the
// matmuls' result whatever their summation order.  Columns first would round
// other sums and give other numbers.
//
// rotate_resample_kernel (stage 2 alone, the Pallas kernel's counterpart):
// one thread per output pixel, all C channels, reading the channel-major bf16
// intermediate [B, C, inter, inter] from device memory.  It is latency-bound at
// about a fifth of its bytes bound (PERF.md).
//
// rotate_resample_crop_kernel (the whole crop, what the training step runs):
// on the TPU gathers are near-serial, hence the MXU stage 1 and a stored
// intermediate; on this card a gather through L1 is cheap, so stage 1 is
// computed where stage 2 needs it and the intermediate never reaches device
// memory.  Its bytes bound: at batch 128 the taps touch about 135k canvas
// pixels per sample (52 MB of uint8) and the output is 38 MB in bf16, ~27 us
// at 3.35 TB/s.  Measured, bytes do not set its pace: switching the canvas
// loads off saves under 1% of its time, the stores 5%, and phase 1 (the
// stage-1 arithmetic) takes 75% of a block's (scripts/ablate_crop.py,
// PERF.md).
// Design, one block of threads per (sample, 32 x 32 output tile):
//   box      R has unit rows, so a tile's stage-2 taps span at most
//            hypot(32, 32) + 4 intermediate pixels per axis whatever the
//            rotation; the box is read off the tile's four corners with the
//            kernel's own u formula, padded by one tap for rounding, and
//            sized statically (kEdge, crop_box_edge() in
//            ops/rotate_resample.py).  Its cells outside [0, inter) hold 0,
//            so stage 2 reads it without bounds checks.
//   phase 0  the box's row and column stage-1 taps and weights, in shared
//            memory (one thread per row or column); a tap outside the canvas
//            gets weight 0 and an address inside it, so phase 1 does not
//            branch (0 * pixel adds an exact 0);
//   phase 1  the box's bf16 stage-1 values in shared memory, from the canvas
//            through __ldg / L1;
//   phase 2  each thread's output pixels from the box, staged NHWC in shared
//            memory;
//   phase 3  the tile's rows written with 16-byte stores where the rows are
//            16-byte aligned (a 32-pixel row is 192 contiguous bytes in bf16),
//            element by element elsewhere.
// No tensor cores: a 2-tap bilinear has no product worth an MMA.  A square
// tile recomputes fewer stage-1 values than 16 x 32 (the boxes of
// neighbouring tiles overlap): 14% faster, measured.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The whole-crop kernel's tile, box and channel limit.
constexpr int kCropThreads = 256;
constexpr int kTileH = 32;
constexpr int kTileW = 32;
constexpr int kMaxChannels = 4;
constexpr int ceil_sqrt(int n) {
  int r = 0;
  while (r * r < n) ++r;
  return r;
}
// ceil(hypot(kTileH, kTileW)) + 4, as crop_box_edge() computes it
constexpr int kEdge = ceil_sqrt(kTileH * kTileH + kTileW * kTileW) + 4;

__device__ __forceinline__ float hat(float tap, float u) {
  return fmaxf(0.0f, 1.0f - fabsf(tap - u));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The stage-2 taps of crop pixel (x, y): top-left tap and the four weights.
struct Stage2Taps {
  int x0, y0;
  float wx0, wx1, wy0, wy1;
};

__device__ __forceinline__ Stage2Taps stage2_taps(float r00, float r01, float r10, float r11,
                                                  float u0x, float u0y, int x, int y) {
  const float xf = (float)x, yf = (float)y;
  const float ux = __fadd_rn(__fmaf_rn(r00, xf, __fmul_rn(r01, yf)), u0x);
  const float uy = __fadd_rn(__fmaf_rn(r10, xf, __fmul_rn(r11, yf)), u0y);
  const float fx0 = floorf(ux), fy0 = floorf(uy);
  Stage2Taps t;
  t.x0 = (int)fx0;
  t.y0 = (int)fy0;
  // x-tap weights rounded to bf16 (the Pallas kernel's bf16 one-hot matrix)
  t.wx0 = bf16_round(hat(fx0, ux));
  t.wx1 = bf16_round(hat(fx0 + 1.0f, ux));
  t.wy0 = hat(fy0, uy);
  t.wy1 = hat(fy0 + 1.0f, uy);
  return t;
}

// The stage-2 sum of one channel from its four taps.
__device__ __forceinline__ float stage2_value(const Stage2Taps& t, float v00, float v01,
                                              float v10, float v11) {
  const float row0 = __fadd_rn(__fmul_rn(v00, t.wx0), __fmul_rn(v01, t.wx1));
  const float row1 = __fadd_rn(__fmul_rn(v10, t.wx0), __fmul_rn(v11, t.wx1));
  return __fadd_rn(__fmul_rn(t.wy0, row0), __fmul_rn(t.wy1, row1));
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
  const Stage2Taps t = stage2_taps(__ldg(s + 0), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3),
                                   __ldg(s + 4), __ldg(s + 5), x, y);
  OutT* o = out + ((size_t)b * oh * ow + p) * channels;
  for (int c = 0; c < channels; ++c) {
    const __nv_bfloat16* plane = inter + ((size_t)b * channels + c) * in_h * in_w;
    o[c] = store_cast<OutT>(stage2_value(
        t, tap_value(plane, t.y0, t.x0, in_h, in_w), tap_value(plane, t.y0, t.x0 + 1, in_h, in_w),
        tap_value(plane, t.y0 + 1, t.x0, in_h, in_w),
        tap_value(plane, t.y0 + 1, t.x0 + 1, in_h, in_w)));
  }
}

// The two stage-1 taps of one axis at intermediate index o: element offsets
// into the canvas and bf16-rounded weights.  p = start + o * step, unfused, as
// ops/warp.py _interp_matrix computes it.  A tap outside the canvas has weight
// 0 and offset 0: its product with any pixel is an exact 0, as the matmul's
// missing term is.
struct Stage1Taps {
  int off0, off1;
  float w0, w1;
};

__device__ __forceinline__ Stage1Taps stage1_taps(float start, float step, int o, int size,
                                                  int stride) {
  const float p = __fadd_rn(start, __fmul_rn((float)o, step));
  const float p0 = floorf(p);
  const float frac = __fsub_rn(p, p0);
  const int i0 = (int)fminf(fmaxf(p0, -2.0f), (float)size);  // no int overflow
  const bool in0 = i0 >= 0 && i0 < size, in1 = i0 + 1 >= 0 && i0 + 1 < size;
  Stage1Taps t;
  t.off0 = in0 ? i0 * stride : 0;
  t.off1 = in1 ? (i0 + 1) * stride : 0;
  t.w0 = in0 ? bf16_round(__fsub_rn(1.0f, frac)) : 0.0f;
  t.w1 = in1 ? bf16_round(frac) : 0.0f;
  return t;
}

// One bf16 stage-1 value (as f32) of channel c: rows first, then columns.
__device__ __forceinline__ float stage1_value(const uint8_t* __restrict__ img,
                                              const Stage1Taps& ty, const Stage1Taps& tx,
                                              int c) {
  float tmp[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint8_t* col = img + (k ? tx.off1 : tx.off0) + c;
    const float g0 = (float)__ldg(col + ty.off0), g1 = (float)__ldg(col + ty.off1);
    tmp[k] = bf16_round(__fadd_rn(__fmul_rn(ty.w0, g0), __fmul_rn(ty.w1, g1)));
  }
  return bf16_round(__fadd_rn(__fmul_rn(tx.w0, tmp[0]), __fmul_rn(tx.w1, tmp[1])));
}

// scalars per sample: d0 d1 t1x t1y r00 r01 r10 r11 u0x u0y
template <typename OutT>
__global__ void __launch_bounds__(kCropThreads)
rotate_resample_crop_kernel(const uint8_t* __restrict__ canvas, const float* __restrict__ scalars,
                            OutT* __restrict__ out, int channels, int in_h, int in_w, int inter,
                            int oh, int ow) {
  __shared__ __nv_bfloat16 box[kMaxChannels][kEdge][kEdge];
  __shared__ Stage1Taps row_taps[kEdge];
  __shared__ Stage1Taps col_taps[kEdge];
  __shared__ __align__(16) unsigned char stage_bytes[kTileH * kTileW * kMaxChannels * sizeof(OutT)];
  OutT* stage = reinterpret_cast<OutT*>(stage_bytes);

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int nty = min(kTileH, oh - ty0), ntx = min(kTileW, ow - tx0);
  const float* s = scalars + (size_t)b * 10;
  const float d0 = __ldg(s + 0), d1 = __ldg(s + 1), t1x = __ldg(s + 2), t1y = __ldg(s + 3);
  const float r00 = __ldg(s + 4), r01 = __ldg(s + 5), r10 = __ldg(s + 6), r11 = __ldg(s + 7);
  const float u0x = __ldg(s + 8), u0y = __ldg(s + 9);
  const uint8_t* img = canvas + (size_t)b * in_h * in_w * channels;
  const int row_stride = in_w * channels;

  // The footprint box: the taps of the tile's four corners and one tap of
  // padding for rounding; at most kEdge per axis (crop_box_edge()).
  int lo_x = INT_MAX, hi_x = INT_MIN, lo_y = INT_MAX, hi_y = INT_MIN;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Stage2Taps t = stage2_taps(r00, r01, r10, r11, u0x, u0y,
                                     tx0 + ((k & 1) ? ntx - 1 : 0), ty0 + ((k & 2) ? nty - 1 : 0));
    lo_x = min(lo_x, t.x0);
    hi_x = max(hi_x, t.x0);
    lo_y = min(lo_y, t.y0);
    hi_y = max(hi_y, t.y0);
  }
  const int bx0 = lo_x - 1, by0 = lo_y - 1;
  const int nbx = min(kEdge, hi_x + 2 - bx0 + 1), nby = min(kEdge, hi_y + 2 - by0 + 1);

  // phase 0: the box's stage-1 row and column taps
  for (int i = threadIdx.x; i < 2 * kEdge; i += kCropThreads) {
    if (i < kEdge) {
      if (i < nby) row_taps[i] = stage1_taps(t1y, d1, by0 + i, in_h, row_stride);
    } else if (i - kEdge < nbx) {
      col_taps[i - kEdge] = stage1_taps(t1x, d0, bx0 + i - kEdge, in_w, channels);
    }
  }
  __syncthreads();

  // phase 1: the box's stage-1 values, 0 outside the intermediate
  for (int i = threadIdx.x; i < nby * nbx; i += kCropThreads) {
    const int ly = i / nbx, lx = i - ly * nbx;
    const int iy = by0 + ly, ix = bx0 + lx;
    if (iy < 0 || iy >= inter || ix < 0 || ix >= inter) {
      for (int c = 0; c < channels; ++c) box[c][ly][lx] = __float2bfloat16_rn(0.0f);
      continue;
    }
    const Stage1Taps ty = row_taps[ly], tx = col_taps[lx];
    for (int c = 0; c < channels; ++c)
      box[c][ly][lx] = __float2bfloat16_rn(stage1_value(img, ty, tx, c));
  }
  __syncthreads();

  // phase 2: stage 2 from the box into the staged NHWC tile
  for (int p = threadIdx.x; p < kTileH * kTileW; p += kCropThreads) {
    const int ly = p / kTileW, lx = p - ly * kTileW;
    if (ly >= nty || lx >= ntx) continue;
    const Stage2Taps t = stage2_taps(r00, r01, r10, r11, u0x, u0y, tx0 + lx, ty0 + ly);
    // box cells of the taps; the clamps only keep a wild affine inside the
    // array (the box covers every tap: tests/test_torch_crop_kernel.py)
    const int by = min(max(t.y0 - by0, 0), kEdge - 2), bx = min(max(t.x0 - bx0, 0), kEdge - 2);
    for (int c = 0; c < channels; ++c) {
      const __nv_bfloat16(*plane)[kEdge] = box[c];
      stage[p * channels + c] = store_cast<OutT>(stage2_value(
          t, __bfloat162float(plane[by][bx]), __bfloat162float(plane[by][bx + 1]),
          __bfloat162float(plane[by + 1][bx]), __bfloat162float(plane[by + 1][bx + 1])));
    }
  }
  __syncthreads();

  // phase 3: the tile's rows to device memory
  const size_t out_row = (size_t)ow * channels;
  OutT* o = out + ((size_t)b * oh + ty0) * out_row + (size_t)tx0 * channels;
  const int len = ntx * channels, stage_row = kTileW * channels;
  constexpr int kVec = 16 / sizeof(OutT);
  if ((reinterpret_cast<uintptr_t>(o) & 15) == 0 && out_row % kVec == 0 && len % kVec == 0) {
    const int nv = len / kVec;
    for (int i = threadIdx.x; i < nty * nv; i += kCropThreads) {
      const int r = i / nv, v = i - r * nv;
      reinterpret_cast<uint4*>(o + r * out_row)[v] =
          reinterpret_cast<const uint4*>(stage + r * stage_row)[v];
    }
  } else {
    for (int i = threadIdx.x; i < nty * len; i += kCropThreads) {
      const int r = i / len, e = i - r * len;
      o[r * out_row + e] = stage[r * stage_row + e];
    }
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

// The whole two-stage crop.  canvas: uint8 [batch, in_h, in_w, channels];
// scalars: f32 [batch, 10] holding d0 d1 t1x t1y r00 r01 r10 r11 u0x u0y
// (ops/warp.py decompose_affine); inter: the stage-1 intermediate's edge;
// out: [batch, oh, ow, channels], bf16 if out_bf16, else f32.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int rotate_resample_crop_forward(const void* canvas, const void* scalars, void* out, int batch,
                                 int channels, int in_h, int in_w, int inter, int oh, int ow,
                                 int out_bf16, void* stream_) {
  if (batch <= 0 || batch > 65535 || channels <= 0 || channels > kMaxChannels || in_h <= 0 ||
      in_w <= 0 || inter <= 0 || oh <= 0 || ow <= 0 ||
      (long long)in_h * in_w * channels > INT_MAX || (oh + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const dim3 grid((unsigned)((ow + kTileW - 1) / kTileW), (unsigned)((oh + kTileH - 1) / kTileH),
                  (unsigned)batch);
  const auto* cv = static_cast<const uint8_t*>(canvas);
  const auto* sc = static_cast<const float*>(scalars);
  if (out_bf16) {
    rotate_resample_crop_kernel<__nv_bfloat16><<<grid, kCropThreads, 0, stream>>>(
        cv, sc, static_cast<__nv_bfloat16*>(out), channels, in_h, in_w, inter, oh, ow);
  } else {
    rotate_resample_crop_kernel<float><<<grid, kCropThreads, 0, stream>>>(
        cv, sc, static_cast<float*>(out), channels, in_h, in_w, inter, oh, ow);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
