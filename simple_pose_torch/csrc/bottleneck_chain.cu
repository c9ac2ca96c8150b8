// Eval-mode BN-folded Bottleneck block for Hopper (sm_90a), one launch per
// block of the layer1 chain.
//
// Replaces simple_pose_tpu/ops/pallas_bottleneck.py::_chain_kernel (math in
// _block_math).  Per block:
//   m1  = relu(x . w1 + b1)                      1x1, rounded to the compute type
//   m2  = relu(sum_taps pad0(m1) . w2[tap] + b2) 3x3 as 9 shifted products,
//                                                zero pad AFTER the relu
//   o   = m2 . w3 + b3                           1x1
//   o  *= sigmoid(fc2(relu(fc1(mean_hw(o)))))    optional SE gate
//   y   = relu(o + identity)    identity = x (f32) or x . wd + bd
// Matrix operands are rounded to the compute type (bf16 or f32); biases,
// accumulators, the SE mean and the sigmoid stay f32.  Products of two
// bf16 values are exact in f32, so f32 FMAs on rounded operands give what
// a bf16 matrix unit with f32 accumulation gives, up to the order of sums.
//
// What bounds it on the card: at the flagship layer1 shapes (64x48x64 in,
// 64x48x256 out, width 64) the chain is ~1.3 GFLOP per sample against
// ~2 MB of bf16 in and out, far above the H100's ~295 FLOP/byte ridge:
// it is bound by operations.  Two kernels, chosen by the compute type:
//   bf16: bottleneck_block_tc_kernel, all four products (conv1, the 3x3,
//         conv3, the projection) through one warp-level bf16 tensor-core
//         routine (mma.sync m16n8k16, f32 accumulate, ldmatrix operands);
//   f32:  bottleneck_block_kernel, f32 FMAs on the CUDA cores, since tensor
//         cores would round f32 operands (TF32 or bf16).
// With the products on tensor cores, what the design still moves (the f32
// pre/idn scratch of the SE pass, the f32 carry read twice, each band's
// halo rows) and its unoverlapped staging set the pace, not the products.
//
// Design.  The TPU kernel keeps a whole 64x48x256 sample in VMEM (~1.5 MB);
// a Hopper block has 227 KB of shared memory.  So each thread block owns one
// sample and a band of TH full-width rows:
//   A. m1 for the TH+2 halo rows goes to shared memory (rounded to the
//      compute type: f32 [channel][pixel] in the f32 kernel, bf16
//      [pixel][channel] in the bf16 kernel), with zero halo columns and zero
//      rows outside the image;
//   B. the 3x3 reads m1 from shared memory, one tap of w2 at a time;
//   C. conv3 and the identity (x re-read, or x . wd) per 64-channel chunk of
//      the output, f32 epilogue.
// Activations are NCHW, and a band of full-width rows is one contiguous
// span per channel, so every global load and store is coalesced.  The chain
// carries f32 between blocks; only the last block writes the input's type.
//
// SE needs the spatial mean over the whole sample before the residual add,
// so an SE block runs in two passes: pass 1 writes the pre-gate output, the
// identity and deterministic per-band channel sums (no atomics); then
// se_gate_kernel reduces the sums per sample and runs the two fcs and the
// sigmoid, and se_apply_kernel writes relu(o * g + identity).
//
// Register tiling of the f32 kernel: 256 threads = 8 warps.  Lane l of warp
// g computes pixels {l, l+32, ...} of the band and output channels
// 8g..8g+7, so the A operand is read conflict-free from shared memory and
// the B operand is a warp-wide broadcast.  The bf16 kernel's tiling is at
// bottleneck_block_tc_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNJ = 8;                   // output channels per thread
constexpr int kNTile = 8 * kNJ;          // output channels per pass (8 warps)
constexpr int kMaxHalo = 288;            // (TH + 2) * W  <= kMaxHalo
constexpr int kMaxBand = 192;            // TH * W        <= kMaxBand
constexpr int kPA = kMaxHalo / 32;       // halo pixels per lane
constexpr int kPC = kMaxBand / 32;       // band pixels per lane
constexpr int kKC = 16;                  // input-channel chunk of the x products
constexpr int kMaxWidth = 64;

// scratch floats beyond m1: max of phase A (x chunk + w1 chunk), phase B
// (one 3x3 tap), phase C (w3 chunk + x chunk + wd chunk)
constexpr int kWorkA = kKC * kMaxHalo + kKC * kNTile;
constexpr int kWorkB = kMaxWidth * kNTile;
constexpr int kWorkC = kMaxWidth * kNTile + kKC * kMaxBand + kKC * kNTile;
constexpr int kWork = kWorkA > kWorkC ? (kWorkA > kWorkB ? kWorkA : kWorkB)
                                      : (kWorkC > kWorkB ? kWorkC : kWorkB);

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value to the compute type, as a matrix operand is rounded.
template <typename TC> __device__ __forceinline__ float rnd(float v) {
  return to_f<TC>(from_f<TC>(v));
}

struct BlockArgs {
  const void* x;      // [B, Cin, H, W]   input type
  void* out;          // [B, Cout, H, W]  output type (no SE)
  float* pre;         // [B, Cout, H, W]  pre-gate output (SE pass 1)
  float* idn;         // [B, Cout, H, W]  identity (SE pass 1)
  float* partial;     // [B, bands, Cout] per-band channel sums (SE pass 1)
  const void* w1;     // [Cin, width]        compute type
  const float* b1;    // [width]
  const void* w2;     // [3, 3, width, width]
  const float* b2;
  const void* w3;     // [width, Cout]
  const float* b3;
  const void* wd;     // [Cin, Cout] or null
  const float* bd;
  int cin, width, cout, h, w, th, bands;
  int se;
};

template <typename TI, typename TC, typename TO>
__global__ void __launch_bounds__(kThreads, 2) bottleneck_block_kernel(BlockArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, grp = tid >> 5;
  const int band = blockIdx.x, b = blockIdx.y;
  const int H = a.h, W = a.w, HW = H * W, W2 = W + 2;
  const int h0 = band * a.th;
  const int th = min(a.th, H - h0);
  const int nhalo = (th + 2) * W, npix = th * W;
  const int m1_stride = (a.th + 2) * W2;
  const int band_stride = a.th * W;
  const int width = a.width, cin = a.cin, cout = a.cout;
  const int n_base = grp * kNJ;

  float* m1s = smem;                         // [width][m1_stride]
  float* work = smem + kMaxWidth * m1_stride;

  const TI* x = static_cast<const TI*>(a.x) + (size_t)b * cin * HW;
  const TC* w1 = static_cast<const TC*>(a.w1);
  const TC* w2 = static_cast<const TC*>(a.w2);
  const TC* w3 = static_cast<const TC*>(a.w3);
  const TC* wd = static_cast<const TC*>(a.wd);

  for (int i = tid; i < width * m1_stride; i += kThreads) m1s[i] = 0.f;

  // ---- A: m1 = relu(x . w1 + b1) on the halo rows h0-1 .. h0+th ----------
  {
    float* xs = work;                   // [kKC][kMaxHalo]
    float* ws = work + kKC * kMaxHalo;  // [kKC][kNTile]
    const int base = (h0 - 1) * W;      // linear offset of the first halo row
    float acc[kPA][kNJ];
#pragma unroll
    for (int i = 0; i < kPA; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < cin; k0 += kKC) {
      __syncthreads();
      for (int i = tid; i < kKC * kMaxHalo; i += kThreads) {
        const int kk = i / kMaxHalo, q = i % kMaxHalo, lin = base + q;
        float v = 0.f;
        if (k0 + kk < cin && q < nhalo && lin >= 0 && lin < HW)
          v = rnd<TC>(to_f<TI>(x[(size_t)(k0 + kk) * HW + lin]));
        xs[i] = v;
      }
      for (int i = tid; i < kKC * kNTile; i += kThreads) {
        const int kk = i / kNTile, n = i % kNTile;
        ws[i] = (k0 + kk < cin && n < width) ? to_f<TC>(w1[(size_t)(k0 + kk) * width + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKC; ++kk) {
        float av[kPA], bv[kNJ];
#pragma unroll
        for (int i = 0; i < kPA; ++i) av[i] = xs[kk * kMaxHalo + lane + 32 * i];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) bv[j] = ws[kk * kNTile + n_base + j];
#pragma unroll
        for (int i = 0; i < kPA; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPA; ++i) {
      const int q = lane + 32 * i, lin = base + q;
      if (q >= nhalo || lin < 0 || lin >= HW) continue;  // rows outside stay 0
      const int qr = q / W, qc = q % W;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int n = n_base + j;
        if (n < width)
          m1s[n * m1_stride + qr * W2 + qc + 1] = rnd<TC>(fmaxf(acc[i][j] + a.b1[n], 0.f));
      }
    }
  }

  // ---- B: m2 = relu(3x3(m1) + b2), one tap of w2 in shared memory at a time
  float acc[kPC][kNJ];
#pragma unroll
  for (int i = 0; i < kPC; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  {
    float* w2s = work;  // [width][kNTile]
    int off[kPC];
#pragma unroll
    for (int i = 0; i < kPC; ++i) {
      const int p = lane + 32 * i;
      off[i] = p < npix ? (p / W) * W2 + p % W : 0;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * W2 + tap % 3;
      __syncthreads();
      for (int i = tid; i < width * kNTile; i += kThreads) {
        const int k = i / kNTile, n = i % kNTile;
        w2s[i] = n < width ? to_f<TC>(w2[((size_t)tap * width + k) * width + n]) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < width; ++k) {
        float av[kPC], bv[kNJ];
#pragma unroll
        for (int i = 0; i < kPC; ++i) av[i] = m1s[k * m1_stride + off[i] + shift];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) bv[j] = w2s[k * kNTile + n_base + j];
#pragma unroll
        for (int i = 0; i < kPC; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  __syncthreads();  // every read of m1 is done: m2 overwrites it
  float* m2s = m1s;  // [width][band_stride]
#pragma unroll
  for (int i = 0; i < kPC; ++i) {
    const int p = lane + 32 * i;
    if (p >= npix) continue;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = n_base + j;
      if (n < width) m2s[n * band_stride + p] = rnd<TC>(fmaxf(acc[i][j] + a.b2[n], 0.f));
    }
  }

  // ---- C: o = m2 . w3 + b3, identity, epilogue; 64 output channels a pass
  float* w3s = work;                      // [width][kNTile]
  float* xs = work + kMaxWidth * kNTile;  // [kKC][kMaxBand]
  float* wds = xs + kKC * kMaxBand;       // [kKC][kNTile]
  const size_t band_off = (size_t)h0 * W;
  for (int n0 = 0; n0 < cout; n0 += kNTile) {
    __syncthreads();
    for (int i = tid; i < width * kNTile; i += kThreads) {
      const int k = i / kNTile, n = n0 + i % kNTile;
      w3s[i] = n < cout ? to_f<TC>(w3[(size_t)k * cout + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPC; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < width; ++k) {
      float av[kPC], bv[kNJ];
#pragma unroll
      for (int i = 0; i < kPC; ++i) av[i] = m2s[k * band_stride + min(lane + 32 * i, npix - 1)];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) bv[j] = w3s[k * kNTile + n_base + j];
#pragma unroll
      for (int i = 0; i < kPC; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = n0 + n_base + j;
      const float bias = n < cout ? a.b3[n] : 0.f;
#pragma unroll
      for (int i = 0; i < kPC; ++i) acc[i][j] += bias;
    }
    if (a.se) {
      // pre-gate output and this band's channel sums (lane order fixed by
      // the xor tree, so the sums are deterministic)
      float* pre = a.pre + (size_t)b * cout * HW + band_off;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int n = n0 + n_base + j;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kPC; ++i) {
          const int p = lane + 32 * i;
          if (p < npix) {
            s += acc[i][j];
            if (n < cout) pre[(size_t)n * HW + p] = acc[i][j];
          }
          acc[i][j] = 0.f;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0 && n < cout) a.partial[((size_t)b * a.bands + band) * cout + n] = s;
      }
    }
    if (wd != nullptr) {
      for (int k0 = 0; k0 < cin; k0 += kKC) {
        __syncthreads();
        for (int i = tid; i < kKC * kMaxBand; i += kThreads) {
          const int kk = i / kMaxBand, p = i % kMaxBand;
          xs[i] = (k0 + kk < cin && p < npix)
                      ? rnd<TC>(to_f<TI>(x[(size_t)(k0 + kk) * HW + band_off + p])) : 0.f;
        }
        for (int i = tid; i < kKC * kNTile; i += kThreads) {
          const int kk = i / kNTile, n = n0 + i % kNTile;
          wds[i] = (k0 + kk < cin && n < cout) ? to_f<TC>(wd[(size_t)(k0 + kk) * cout + n]) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kKC; ++kk) {
          float av[kPC], bv[kNJ];
#pragma unroll
          for (int i = 0; i < kPC; ++i) av[i] = xs[kk * kMaxBand + lane + 32 * i];
#pragma unroll
          for (int j = 0; j < kNJ; ++j) bv[j] = wds[kk * kNTile + n_base + j];
#pragma unroll
          for (int i = 0; i < kPC; ++i)
#pragma unroll
            for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int n = n0 + n_base + j;
        const float bias = n < cout ? a.bd[n] : 0.f;
#pragma unroll
        for (int i = 0; i < kPC; ++i) acc[i][j] += bias;
      }
    } else {
      // identity: the block's input itself, unrounded (cin == cout)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int n = n0 + n_base + j;
        if (n >= cout) continue;
#pragma unroll
        for (int i = 0; i < kPC; ++i) {
          const int p = lane + 32 * i;
          if (p < npix) acc[i][j] += to_f<TI>(x[(size_t)n * HW + band_off + p]);
        }
      }
    }
    float* idn = a.idn + (size_t)b * cout * HW + band_off;
    TO* out = static_cast<TO*>(a.out) + (size_t)b * cout * HW + band_off;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = n0 + n_base + j;
      if (n >= cout) continue;
#pragma unroll
      for (int i = 0; i < kPC; ++i) {
        const int p = lane + 32 * i;
        if (p >= npix) continue;
        if (a.se) idn[(size_t)n * HW + p] = acc[i][j];
        else out[(size_t)n * HW + p] = from_f<TO>(fmaxf(acc[i][j], 0.f));
      }
    }
  }
}

// ---- the tensor-core kernel (bf16 compute) ---------------------------------

constexpr int kP = kMaxWidth + 8;         // bf16 row pitch of the smem tiles (144 B)
constexpr int kMG = 4;                    // warps along M (pixels)
constexpr int kMT = kMaxBand / 16 / kMG;  // m16 tiles per warp (3)
constexpr int kNT = 4;                    // n8 tiles per warp: 32 channels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The one product routine: acc[i][j] += A(m-tile i) . B(n-tile j) over
// ksteps steps of k16.  a_addr[i] is this lane's ldmatrix row in m-tile i
// (row lane % 16 at k offset 8 * (lane / 16)), so the rows may be gathered
// from anywhere in shared memory; b_addr is this lane's row of the [n][k]
// weight tile for the warp's 32 channels.  m-tiles i >= mt are skipped.
__device__ __forceinline__ void warp_mma(float (&acc)[kMT][kNT][4], const uint32_t (&a_addr)[kMT],
                                         int mt, uint32_t b_addr, int ksteps) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t b01[4], b23[4];
    ldsm_x4(b01, b_addr + ks * 32);
    ldsm_x4(b23, b_addr + 16 * kP * 2 + ks * 32);
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (i < mt) {
        uint32_t a[4];
        ldsm_x4(a, a_addr[i] + ks * 32);
        mma_bf16(acc[i][0], a, b01[0], b01[1]);
        mma_bf16(acc[i][1], a, b01[2], b01[3]);
        mma_bf16(acc[i][2], a, b23[0], b23[1]);
        mma_bf16(acc[i][3], a, b23[2], b23[3]);
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[kMT][kNT][4]) {
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Staging loops issue kStageBatch items' global loads before their shared
// stores, so each thread keeps that many loads in flight.
constexpr int kStageBatch = 8;

// Stage rows 0 .. kMaxBand of x's channels k0 .. k0 + kpad, at linear pixel
// lin0 + row (zero outside the image, past `rows` and past cin), into xs
// [kMaxBand][kP] as bf16: two channels per item, so the global loads run
// along pixels and each shared store is one bf16 pair.
template <typename TI>
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, const TI* x, int HW, int lin0, int rows,
                                        int k0, int kpad, int cin) {
  const int total = kMaxBand * kpad / 2;
  for (int i0 = threadIdx.x; i0 < total; i0 += kStageBatch * kThreads) {
    float v[kStageBatch][2];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int c = k0 + 2 * (i / kMaxBand), r = i % kMaxBand, lin = lin0 + r;
      const bool ok = i < total && r < rows && lin >= 0 && lin < HW;
      v[u][0] = ok && c < cin ? to_f<TI>(x[(size_t)c * HW + lin]) : 0.f;
      v[u][1] = ok && c + 1 < cin ? to_f<TI>(x[(size_t)(c + 1) * HW + lin]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total)
        *reinterpret_cast<__nv_bfloat162*>(xs + (i % kMaxBand) * kP + 2 * (i / kMaxBand)) =
            __floats2bfloat162_rn(v[u][0], v[u][1]);
    }
  }
}

// Stage w[k0 + k][n0 + n] (global [K][N], row length ld) transposed into
// ws [kMaxWidth n][kP] for k < kpad, zero past K and N; two k per item.
__device__ __forceinline__ void stage_w(__nv_bfloat16* ws, const __nv_bfloat16* w, int ld, int k0,
                                        int kpad, int K, int n0, int N) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int total = kMaxWidth * kpad / 2;
  for (int i0 = threadIdx.x; i0 < total; i0 += kStageBatch * kThreads) {
    __nv_bfloat16 v[kStageBatch][2];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int k = k0 + 2 * (i / kMaxWidth), n = n0 + i % kMaxWidth;
      const bool ok = i < total && n < N;
      v[u][0] = ok && k < K ? w[(size_t)k * ld + n] : zero;
      v[u][1] = ok && k + 1 < K ? w[(size_t)(k + 1) * ld + n] : zero;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total)
        *reinterpret_cast<__nv_bfloat162*>(ws + (i % kMaxWidth) * kP + 2 * (i / kMaxWidth)) =
            __halves2bfloat162(v[u][0], v[u][1]);
    }
  }
}

// The bf16 block: the same three phases, bands and epilogue as
// bottleneck_block_kernel, with every product in warp_mma.  Shared memory
// holds activations as [pixel][channel] bf16 and weights as [n][k] bf16.
// Warp g owns m-tiles g/2, g/2 + 4, g/2 + 8 of up to 192 pixels and 32 of a
// pass's 64 channels; an f32 C fragment holds pixels lane/4 and lane/4 + 8
// for the channel pair 2 * (lane % 4) + {0, 1} of each n8 tile.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads, 2) bottleneck_block_tc_kernel(BlockArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  using bf16 = __nv_bfloat16;
  const int tid = threadIdx.x, lane = tid & 31, grp = tid >> 5;
  const int band = blockIdx.x, b = blockIdx.y;
  const int H = a.h, W = a.w, HW = H * W, W2 = W + 2;
  const int h0 = band * a.th;
  const int th = min(a.th, H - h0);
  const int nhalo = (th + 2) * W, npix = th * W;
  const int m1_stride = (a.th + 2) * W2;
  const int width = a.width, cin = a.cin, cout = a.cout;
  const int mg = grp >> 1, nw = 32 * (grp & 1);
  const int gid = lane >> 2, tig = lane & 3;
  const int mt = min(kMT, max(0, ((npix + 15) / 16 - mg + kMG - 1) / kMG));
  const int kw = (width + 15) / 16 * 16;  // K of the 3x3 and conv3, padded
  // this lane's ldmatrix rows: A at (m-tile row, k offset), B in [n][k]
  const int a_row = lane & 15, a_k = 8 * (lane >> 4);
  const uint32_t b_off = 2 * ((nw + 8 * (lane >> 4) + (lane & 7)) * kP + 8 * ((lane >> 3) & 1));

  bf16* m1s = reinterpret_cast<bf16*>(tc_smem);  // [m1_stride pixels][kP]
  bf16* work = m1s + (size_t)m1_stride * kP;

  const TI* x = static_cast<const TI*>(a.x) + (size_t)b * cin * HW;
  const bf16* w1 = static_cast<const bf16*>(a.w1);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  const bf16* w3 = static_cast<const bf16*>(a.w3);
  const bf16* wd = static_cast<const bf16*>(a.wd);

  for (int i = tid; i < m1_stride * kP / 8; i += kThreads)
    reinterpret_cast<uint4*>(m1s)[i] = make_uint4(0, 0, 0, 0);

  float acc[kMT][kNT][4];
  uint32_t a_addr[kMT];

  // ---- A: m1 = relu(x . w1 + b1) on the halo rows h0-1 .. h0+th, in rounds
  // of up to kMaxBand halo pixels
  {
    bf16* xs = work;                   // [kMaxBand][kP]
    bf16* ws = work + kMaxBand * kP;   // [kMaxWidth n][kP]
    const int base = (h0 - 1) * W;     // linear offset of the first halo row
    for (int r0 = 0; r0 < nhalo; r0 += kMaxBand) {
      const int rows = min(kMaxBand, nhalo - r0);
      const int rmt = min(kMT, max(0, ((rows + 15) / 16 - mg + kMG - 1) / kMG));
      zero_acc(acc);
      for (int k0 = 0; k0 < cin; k0 += kMaxWidth) {
        const int kpad = (min(kMaxWidth, cin - k0) + 15) / 16 * 16;
        __syncthreads();
        stage_x(xs, x, HW, base + r0, rows, k0, kpad, cin);
        stage_w(ws, w1, width, k0, kpad, cin, 0, width);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          a_addr[i] = smem_u32(xs + ((mg + kMG * i) * 16 + a_row) * kP + a_k);
        warp_mma(acc, a_addr, rmt, smem_u32(ws) + b_off, kpad / 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int n = nw + 8 * j + 2 * tig;
          const float b0 = n < width ? a.b1[n] : 0.f, b1 = n + 1 < width ? a.b1[n + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (mg + kMG * i) * 16 + gid + 8 * h, q = r0 + r, lin = base + q;
            if (r >= rows || lin < 0 || lin >= HW) continue;  // rows outside stay 0
            *reinterpret_cast<__nv_bfloat162*>(m1s + ((q / W) * W2 + q % W + 1) * kP + n) =
                __floats2bfloat162_rn(fmaxf(acc[i][j][2 * h] + b0, 0.f),
                                      fmaxf(acc[i][j][2 * h + 1] + b1, 0.f));
          }
        }
    }
  }

  // ---- B: m2 = relu(3x3(m1) + b2): 9 shifted products, the A rows of tap
  // (dy, dx) gathered from the halo at pixel + dy * W2 + dx
  zero_acc(acc);
  {
    bf16* w2s = work;  // [kMaxWidth n][kP]
    int row[kMT];      // this lane's A row (halo pixel) in m-tile i, tap (0, 0)
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int p = min((mg + kMG * i) * 16 + a_row, npix - 1);
      row[i] = (p / W) * W2 + p % W;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * W2 + tap % 3;
      __syncthreads();
      stage_w(w2s, w2 + (size_t)tap * width * width, width, 0, kw, width, 0, width);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kMT; ++i) a_addr[i] = smem_u32(m1s + (row[i] + shift) * kP + a_k);
      warp_mma(acc, a_addr, mt, smem_u32(w2s) + b_off, kw / 16);
    }
  }
  __syncthreads();  // every read of m1 is done: m2 overwrites it
  bf16* m2s = m1s;  // [band pixel][kP]
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = nw + 8 * j + 2 * tig;
      const float b0 = n < width ? a.b2[n] : 0.f, b1 = n + 1 < width ? a.b2[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mg + kMG * i) * 16 + gid + 8 * h;
        if (p < npix)
          *reinterpret_cast<__nv_bfloat162*>(m2s + p * kP + n) = __floats2bfloat162_rn(
              fmaxf(acc[i][j][2 * h] + b0, 0.f), fmaxf(acc[i][j][2 * h + 1] + b1, 0.f));
      }
    }

  // ---- C: o = m2 . w3 + b3, identity, epilogue; 64 output channels a pass
  bf16* w3s = work;                          // [kMaxWidth n][kP]
  bf16* xs = work + kMaxWidth * kP;          // [kMaxBand][kP]
  bf16* wds = xs + kMaxBand * kP;            // [kMaxWidth n][kP]
  float* red = reinterpret_cast<float*>(wds + kMaxWidth * kP);  // [kMG][kNTile]
  const size_t band_off = (size_t)h0 * W;
  // x's band for the projection is staged once when one 64-channel chunk
  // holds it (layer1's first block), else per pass and chunk
  const bool x_once = wd != nullptr && cin <= kMaxWidth;
  if (x_once) stage_x(xs, x, HW, (int)band_off, npix, 0, (cin + 15) / 16 * 16, cin);
  for (int n0 = 0; n0 < cout; n0 += kNTile) {
    __syncthreads();
    stage_w(w3s, w3, cout, 0, kw, width, n0, cout);
    __syncthreads();
    zero_acc(acc);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
      a_addr[i] = smem_u32(m2s + min((mg + kMG * i) * 16 + a_row, npix - 1) * kP + a_k);
    warp_mma(acc, a_addr, mt, smem_u32(w3s) + b_off, kw / 16);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + nw + 8 * j + 2 * tig + e;
        const float bias = n < cout ? a.b3[n] : 0.f;
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          acc[i][j][e] += bias;
          acc[i][j][2 + e] += bias;
        }
      }
    if (a.se) {
      // pre-gate output and this band's channel sums: per warp over its
      // pixels and the xor tree over lanes of one channel pair, then the 4
      // warps of a channel in a fixed order (deterministic, no atomics)
      float* pre = a.pre + (size_t)b * cout * HW + band_off;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nl = nw + 8 * j + 2 * tig + e, n = n0 + nl;
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int p = (mg + kMG * i) * 16 + gid + 8 * h;
              if (p < npix) {
                s += acc[i][j][2 * h + e];
                if (n < cout) pre[(size_t)n * HW + p] = acc[i][j][2 * h + e];
              }
              acc[i][j][2 * h + e] = 0.f;
            }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (gid == 0) red[mg * kNTile + nl] = s;
        }
      __syncthreads();
      if (tid < kNTile && n0 + tid < cout)
        a.partial[((size_t)b * a.bands + band) * cout + n0 + tid] =
            ((red[tid] + red[kNTile + tid]) + red[2 * kNTile + tid]) + red[3 * kNTile + tid];
    }
    if (wd != nullptr) {
      // identity = x . wd + bd, with x's band staged as bf16 per 64 channels
      for (int k0 = 0; k0 < cin; k0 += kMaxWidth) {
        const int kpad = (min(kMaxWidth, cin - k0) + 15) / 16 * 16;
        __syncthreads();
        if (!x_once) stage_x(xs, x, HW, (int)band_off, npix, k0, kpad, cin);
        stage_w(wds, wd, cout, k0, kpad, cin, n0, cout);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          a_addr[i] = smem_u32(xs + ((mg + kMG * i) * 16 + a_row) * kP + a_k);
        warp_mma(acc, a_addr, mt, smem_u32(wds) + b_off, kpad / 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + nw + 8 * j + 2 * tig + e;
          const float bias = n < cout ? a.bd[n] : 0.f;
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            acc[i][j][e] += bias;
            acc[i][j][2 + e] += bias;
          }
        }
    } else {
      // identity: the block's input itself, unrounded (cin == cout)
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = (mg + kMG * i) * 16 + gid + 8 * h;
            const int n = n0 + nw + 8 * j + 2 * tig;
            if (p >= npix) continue;
            if (n < cout) acc[i][j][2 * h] += to_f<TI>(x[(size_t)n * HW + band_off + p]);
            if (n + 1 < cout)
              acc[i][j][2 * h + 1] += to_f<TI>(x[(size_t)(n + 1) * HW + band_off + p]);
          }
    }
    float* idn = a.idn + (size_t)b * cout * HW + band_off;
    TO* out = static_cast<TO*>(a.out) + (size_t)b * cout * HW + band_off;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = (mg + kMG * i) * 16 + gid + 8 * h;
            const int n = n0 + nw + 8 * j + 2 * tig + e;
            if (p >= npix || n >= cout) continue;
            if (a.se) idn[(size_t)n * HW + p] = acc[i][j][2 * h + e];
            else out[(size_t)n * HW + p] = from_f<TO>(fmaxf(acc[i][j][2 * h + e], 0.f));
          }
  }
}

// One block per sample: v = mean_hw(o) from the band sums, then
// g = sigmoid(relu(v . sf1 + sb1) . sf2 + sb2); v and the hidden layer are
// rounded to the compute type as matrix operands.
template <typename TC>
__global__ void se_gate_kernel(const float* partial, int bands, int c, int hidden, int hw,
                               const void* sf1_, const float* sb1, const void* sf2_,
                               const float* sb2, float* gate) {
  extern __shared__ float s[];  // [c + hidden]
  const TC* sf1 = static_cast<const TC*>(sf1_);
  const TC* sf2 = static_cast<const TC*>(sf2_);
  const int b = blockIdx.x;
  float* v = s;
  float* g1 = s + c;
  for (int n = threadIdx.x; n < c; n += blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < bands; ++t) acc += partial[((size_t)b * bands + t) * c + n];
    v[n] = rnd<TC>(acc / (float)hw);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < hidden; n += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < c; ++k) acc = fmaf(v[k], to_f<TC>(sf1[(size_t)k * hidden + n]), acc);
    g1[n] = rnd<TC>(fmaxf(acc + sb1[n], 0.f));
  }
  __syncthreads();
  for (int n = threadIdx.x; n < c; n += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < hidden; ++k) acc = fmaf(g1[k], to_f<TC>(sf2[(size_t)k * c + n]), acc);
    gate[(size_t)b * c + n] = 1.f / (1.f + expf(-(acc + sb2[n])));
  }
}

template <typename TO>
__global__ void se_apply_kernel(const float* pre, const float* idn, const float* gate,
                                TO* out, size_t total, int hw) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = from_f<TO>(fmaxf(pre[i] * gate[i / hw] + idn[i], 0.f));
  }
}

size_t block_smem_bytes(int th, int w) {
  return sizeof(float) * ((size_t)kMaxWidth * (th + 2) * (w + 2) + kWork);
}

template <typename TI, typename TC, typename TO>
cudaError_t launch_block(const BlockArgs& a, int batch, cudaStream_t stream) {
  auto kernel = bottleneck_block_kernel<TI, TC, TO>;
  const size_t smem = block_smem_bytes(a.th, a.w);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.bands, batch), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// bf16 scratch beyond m1: phase A (x round + w1), phase C (w3 + x band + wd
// + the SE sums); phase B's one tap of w2 is smaller
constexpr int kTcWorkA = 2 * (kMaxBand + kMaxWidth) * kP;
constexpr int kTcWorkC = 2 * (2 * kMaxWidth + kMaxBand) * kP + 4 * kMG * kNTile;
constexpr int kTcWork = kTcWorkA > kTcWorkC ? kTcWorkA : kTcWorkC;

size_t tc_smem_bytes(int th, int w) {
  return sizeof(__nv_bfloat16) * (size_t)(th + 2) * (w + 2) * kP + kTcWork;
}

template <typename TI, typename TO>
cudaError_t launch_tc(const BlockArgs& a, int batch, cudaStream_t stream) {
  auto kernel = bottleneck_block_tc_kernel<TI, TO>;
  const size_t smem = tc_smem_bytes(a.th, a.w);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.bands, batch), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The compute type picks the kernel: bf16 runs on the tensor cores, f32 on
// the CUDA cores (tensor cores would round f32 operands).
template <typename TI>
cudaError_t launch_block_tc(const BlockArgs& a, int batch, bool c_bf16, bool out_bf16,
                            cudaStream_t s) {
  if (c_bf16)
    return out_bf16 ? launch_tc<TI, __nv_bfloat16>(a, batch, s) : launch_tc<TI, float>(a, batch, s);
  return out_bf16 ? launch_block<TI, float, __nv_bfloat16>(a, batch, s)
                  : launch_block<TI, float, float>(a, batch, s);
}

}  // namespace

extern "C" {

// Rows per band for a layer of width w: the largest TH with
// (TH + 2) * w <= 288 and TH * w <= 192, capped at h; 0 if w is too wide.
int bottleneck_band_rows(int h, int w) {
  int th = kMaxHalo / w - 2;
  if (kMaxBand / w < th) th = kMaxBand / w;
  if (th > h) th = h;
  return th > 0 ? th : 0;
}

// One folded Bottleneck block.  x: [B, Cin, H, W] (bf16 if x_bf16, else f32);
// out: [B, Cout, H, W] (bf16 if out_bf16, else f32).  Weights are in the
// compute type (bf16 if c_bf16, else f32), biases f32.  wd/bd and the SE
// arguments may be null.  For an SE block, pre and idn are f32 [B, Cout, H,
// W] scratch, partial is [B, bands, Cout] and gate [B, Cout].
// Returns cudaGetLastError() of the launches (0 on success).
int bottleneck_block_forward(const void* x, void* out, float* pre, float* idn, float* partial,
                             float* gate, const void* w1, const float* b1, const void* w2,
                             const float* b2, const void* w3, const float* b3, const void* wd,
                             const float* bd, const void* sf1, const float* sb1,
                             const void* sf2, const float* sb2, int batch, int cin, int width,
                             int cout, int se_hidden, int h, int w, int x_bf16, int c_bf16,
                             int out_bf16, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int th = bottleneck_band_rows(h, w);
  if (th == 0 || width > kMaxWidth || width <= 0) return (int)cudaErrorInvalidValue;
  const bool se = sf1 != nullptr;
  BlockArgs a{x, out, pre, idn, partial, w1, b1, w2, b2, w3, b3, wd, bd,
              cin, width, cout, h, w, th, (h + th - 1) / th, se ? 1 : 0};
  cudaError_t err = x_bf16 ? launch_block_tc<__nv_bfloat16>(a, batch, c_bf16, out_bf16, stream)
                           : launch_block_tc<float>(a, batch, c_bf16, out_bf16, stream);
  if (err != cudaSuccess || !se) return (int)err;

  const size_t gate_smem = sizeof(float) * (cout + se_hidden);
  if (c_bf16)
    se_gate_kernel<__nv_bfloat16><<<batch, 256, gate_smem, stream>>>(
        partial, a.bands, cout, se_hidden, h * w, sf1, sb1, sf2, sb2, gate);
  else
    se_gate_kernel<float><<<batch, 256, gate_smem, stream>>>(
        partial, a.bands, cout, se_hidden, h * w, sf1, sb1, sf2, sb2, gate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t total = (size_t)batch * cout * h * w;
  const int grid = (int)((total + 255) / 256 < 65535 * 8 ? (total + 255) / 256 : 65535 * 8);
  // gate is indexed by (b * cout + n) == element index / (h * w)
  if (out_bf16)
    se_apply_kernel<__nv_bfloat16><<<grid, 256, 0, stream>>>(
        pre, idn, gate, static_cast<__nv_bfloat16*>(out), total, h * w);
  else
    se_apply_kernel<float><<<grid, 256, 0, stream>>>(pre, idn, gate, static_cast<float*>(out),
                                                     total, h * w);
  return (int)cudaGetLastError();
}

}  // extern "C"
