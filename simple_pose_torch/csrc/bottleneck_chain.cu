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
// it is bound by operations (the wide ResNets' width 128: ~3.9 GFLOP per
// sample on the same bytes).  Two block kernels, chosen by the compute type:
//   bf16: hopper::bottleneck_block_wgmma_kernel, every product (conv1, the
//         3x3, conv3, the projection) on wgmma with the weights streamed by
//         TMA; one template on the width of its products, kN = 64 for
//         Bottleneck widths up to 64 (the flagship ResNet-50, HRNet,
//         ResNet-50-DUC) and kN = 128 for widths 65-128 (the wide ResNets),
//         one block of threads per SM; its section below says why;
//   f32:  bottleneck_block_kernel, f32 FMAs on the CUDA cores, since tensor
//         cores would round f32 operands (TF32 or bf16).
// With the products on wgmma, what the design still moves (the f32 carry
// read twice, each tile's halo, an SE block's input read once more by its
// sums pass) and the activations' global memory latency set the pace, not
// the products.
//
// Design.  The TPU kernel keeps a whole 64x48x256 sample in VMEM (~1.5 MB);
// a Hopper block has 227 KB of shared memory.  So each thread block owns one
// sample and a tile of TH rows by TW columns of it:
//   A. m1 on the tile's halo (the tile and a 1-pixel ring on all four sides,
//      (TH+2) x (TW+2)) goes to shared memory, rounded to the compute type
//      (f32 [channel][pixel] in the f32 kernel, bf16 [pixel][channel] in the
//      bf16 kernel); ring pixels outside the image stay zero;
//   B. the 3x3 reads m1 from shared memory, one tap of w2 at a time;
//   C. conv3 and the identity (x re-read, or x . wd) per pass of output
//      channels, f32 epilogue.
// The chain carries f32 between blocks; only the last block writes the
// input's type.  Activations are NCHW.
//
// Tiles.  Where a band of whole rows fits the limits below (TW = W), a tile
// spans the row, as up to W = 96 at width 64: its band and its halo rows are
// then one contiguous span per channel, so every global load and store is
// coalesced (the flagship's 64x48 map: bands of 4 rows, 16 per sample).
// Wider maps are cut into 2-D tiles of 32 columns (one warp's pixels per
// row; the bf16 kernel also 64), whose rows are spans of TW (+2) pixels.
// The wrapper (ops/bottleneck_chain.launch_plan) picks TH and TW;
// bottleneck_smem_bytes checks them against these limits and gives the
// shared memory they need.  A launch's grid is (tiles, batch).
//
// Width.  Every output channel of the 3x3 reads every m1 channel of the
// halo, and m2 overwrites m1 in place once the 3x3 is done, so one pass of
// the 3x3 covers all `width` output channels.  The f32 kernel's tile
// therefore shrinks as the width grows, with the same 8 warps and the same
// accumulator registers per thread (Cfg below): up to width 64, tiles of up
// to 192 pixels and passes of 64 channels; up to width 128, tiles of up to
// 96 pixels and passes of 128 channels.  The bf16 kernel keeps tiles of up
// to 192 pixels at both of its widths.
//
// SE needs the spatial mean of o over the whole sample before the residual
// add.  conv3 is linear, so mean_hw(o) = mean_hw(m2) . w3 + b3 (in exact
// arithmetic; only the order of the f32 sums differs), and an SE block runs
// in three launches:
//   1. the block kernel's sums pass (template flag kSums): phases A and B
//      only, then this tile's channel sums of m2 as conv3 reads it (rounded
//      to the compute type) into partial [B, tiles, width], in a fixed order
//      (no atomics); no conv3, no projection, no activation stores;
//   2. se_gate_kernel: per sample v = (sum of the tile sums / HW) . w3 + b3,
//      then the two fcs and the sigmoid into gate [B, Cout];
//   3. the block kernel's full pass, whose epilogue writes relu(o * g +
//      identity) straight into the block's output.
// So the pre-gate output and the identity never go through global memory;
// the price is conv1 and the 3x3 of an SE block run twice.
//
// Register tiling of the f32 kernel: 256 threads = 8 warps.  Lane l of warp
// g computes pixels {l, l+32, ...} of the tile and output channels
// kNJ*g .. kNJ*g + kNJ-1, so the A operand is read conflict-free from shared
// memory and the B operand is a warp-wide broadcast.  The bf16 kernel's
// tiling is at its section below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 16;               // input-channel chunk of the f32 kernel's x products
constexpr int kMaxSmem = 232448;      // one block's shared memory (227 KB)

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The tile limits and the shapes of the f32 kernel for Bottleneck widths up
// to kWMax (64 or 128).
template <int kWMax>
struct Cfg {
  static_assert(kWMax == 64 || kWMax == 128, "the kernel takes widths up to 64 or up to 128");
  static constexpr int kNTile = kWMax;                   // output channels per pass
  static constexpr int kBand = kWMax == 64 ? 192 : 96;   // TH * TW <= kBand
  static constexpr int kHalo = kWMax == 64 ? 288 : 192;  // (TH + 2) * TW <= kHalo
  static constexpr int kMinBlocks = kWMax == 64 ? 2 : 1;  // blocks per SM
  // kNJ output channels per thread, kPC tile pixels per lane, kPA halo
  // pixels per lane in each round of phase A, w2 and w3 in shared memory kKB
  // input channels at a time
  static constexpr int kNJ = kNTile / 8;
  static constexpr int kPC = kBand / 32;
  static constexpr int kPA = kWMax == 64 ? 9 : 3;
  static constexpr int kKB = kWMax == 64 ? 64 : 32;
  // scratch floats beyond m1: max of phase A (x chunk + w1 chunk), phase B
  // (a K chunk of one 3x3 tap), phase C (w3 chunk + x chunk + wd chunk)
  static constexpr int kWork = cmax(cmax(kKC * kPA * 32 + kKC * kNTile, kKB * kNTile),
                                    kKB * kNTile + kKC * kBand + kKC * kNTile);
};

template <int kWMax>
bool tile_fits(int th, int tw) {
  return th * tw <= Cfg<kWMax>::kBand && (th + 2) * tw <= Cfg<kWMax>::kHalo;
}

template <int kWMax>
size_t block_smem_bytes(int th, int tw) {
  return sizeof(float) * ((size_t)kWMax * (th + 2) * (tw + 2) + Cfg<kWMax>::kWork);
}

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
  void* out;          // [B, Cout, H, W]  output type (the full pass)
  float* partial;     // [B, tiles, width] per-tile channel sums of m2 (the sums pass)
  const float* gate;  // [B, Cout] the SE gate (an SE block's full pass), else null
  const void* w1;     // [Cin, width]        compute type
  const float* b1;    // [width]
  const void* w2;     // [3, 3, width, width]
  const float* b2;
  const void* w3;     // [width, Cout]
  const float* b3;
  const void* wd;     // [Cin, Cout] or null
  const float* bd;
  int cin, width, cout, h, w;
  int th, tw, tiles_w, tiles;  // tile rows and columns, tiles per row of tiles, tiles
};

// Pixels of a tile's band or halo, numbered row by row: pixel q lies at
// linear index lin(q) of the image.  kRows: the tile spans whole rows, so
// the pixels are one contiguous span (no division on the hot loops).
struct PixMap {
  int lin0, cols, w;  // pixel 0's linear index, pixels per row, the image's width
  template <bool kRows>
  __device__ __forceinline__ int lin(int q) const {
    return kRows ? lin0 + q : lin0 + (q / cols) * w + q % cols;
  }
};

// Tile t: rows h0 .. h0+th-1, columns w0 .. w0+tw-1 (ragged at the bottom
// and right edges).  m1 in shared memory has a.th + 2 rows of pitch
// a.tw + 2, row 0 at image row h0 - 1 and column 0 at image column w0 - 1;
// phase A computes the halo pixels inside the image.
struct Tile {
  int npix, tw, pitch;
  PixMap band, halo;
  int nhalo;    // halo pixels inside the image
  int halo_m1;  // m1 index of halo pixel 0
};

__device__ __forceinline__ Tile tile_of(const BlockArgs& a, int t) {
  const int h0 = (t / a.tiles_w) * a.th, w0 = (t % a.tiles_w) * a.tw;
  const int th = min(a.th, a.h - h0), tw = min(a.tw, a.w - w0);
  const int r0 = max(h0 - 1, 0), r1 = min(h0 + th + 1, a.h);
  const int c0 = max(w0 - 1, 0), c1 = min(w0 + tw + 1, a.w);
  Tile g;
  g.npix = th * tw;
  g.tw = tw;
  g.pitch = a.tw + 2;
  g.band = PixMap{h0 * a.w + w0, tw, a.w};
  g.halo = PixMap{r0 * a.w + c0, c1 - c0, a.w};
  g.nhalo = (r1 - r0) * (c1 - c0);
  g.halo_m1 = (r0 - h0 + 1) * g.pitch + (c0 - w0 + 1);
  return g;
}

// m1 index of halo pixel q, and of band pixel p's tap (0, 0)
__device__ __forceinline__ int halo_m1(const Tile& g, int q) {
  return g.halo_m1 + (q / g.halo.cols) * g.pitch + q % g.halo.cols;
}
__device__ __forceinline__ int band_m1(const Tile& g, int p) {
  return (p / g.tw) * g.pitch + p % g.tw;
}

// kGate: an SE block's full pass (o times a.gate before the identity; a
// block without SE runs an instance with no gate code).  kSums: the SE sums
// pass (phases A and B, then m2's channel sums).
template <int kWMax, bool kRows, typename TI, typename TC, typename TO, bool kGate, bool kSums>
__global__ void __launch_bounds__(kThreads, Cfg<kWMax>::kMinBlocks)
    bottleneck_block_kernel(BlockArgs a) {
  using C = Cfg<kWMax>;
  constexpr int kNJ = C::kNJ, kPC = C::kPC, kPA = C::kPA, kKB = C::kKB;
  constexpr int kNTile = C::kNTile, kBand = C::kBand, kRound = kPA * 32;
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, grp = tid >> 5;
  const int b = blockIdx.y;
  const Tile g = tile_of(a, blockIdx.x);
  const int HW = a.h * a.w, npix = g.npix;
  const int m1_stride = (a.th + 2) * g.pitch;
  const int band_stride = a.th * a.tw;
  const int width = a.width, cin = a.cin, cout = a.cout;
  const int n_base = grp * kNJ;

  float* m1s = smem;                     // [width][m1_stride]
  float* work = smem + kWMax * m1_stride;

  const TI* x = static_cast<const TI*>(a.x) + (size_t)b * cin * HW;
  const TC* w1 = static_cast<const TC*>(a.w1);
  const TC* w2 = static_cast<const TC*>(a.w2);
  const TC* w3 = static_cast<const TC*>(a.w3);
  const TC* wd = static_cast<const TC*>(a.wd);

  for (int i = tid; i < width * m1_stride; i += kThreads) m1s[i] = 0.f;

  // ---- A: m1 = relu(x . w1 + b1) on the halo, in rounds of kRound pixels
  {
    float* xs = work;                  // [kKC][kRound]
    float* ws = work + kKC * kRound;   // [kKC][kNTile]
    for (int r0 = 0; r0 < g.nhalo; r0 += kRound) {
      float acc[kPA][kNJ];
#pragma unroll
      for (int i = 0; i < kPA; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < cin; k0 += kKC) {
        __syncthreads();
        for (int i = tid; i < kKC * kRound; i += kThreads) {
          const int kk = i / kRound, q = r0 + i % kRound;
          float v = 0.f;
          if (k0 + kk < cin && q < g.nhalo)
            v = rnd<TC>(to_f<TI>(x[(size_t)(k0 + kk) * HW + g.halo.lin<kRows>(q)]));
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
          for (int i = 0; i < kPA; ++i) av[i] = xs[kk * kRound + lane + 32 * i];
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
        const int q = r0 + lane + 32 * i;
        if (q >= g.nhalo) continue;
        const int m = halo_m1(g, q);
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int n = n_base + j;
          if (n < width) m1s[n * m1_stride + m] = rnd<TC>(fmaxf(acc[i][j] + a.b1[n], 0.f));
        }
      }
    }
  }

  // ---- B: m2 = relu(3x3(m1) + b2), w2 in shared memory a tap and kKB
  // input channels at a time
  float acc[kPC][kNJ];
#pragma unroll
  for (int i = 0; i < kPC; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
  {
    float* w2s = work;  // [kKB][kNTile]
    int off[kPC];
#pragma unroll
    for (int i = 0; i < kPC; ++i) {
      const int p = lane + 32 * i;
      off[i] = p < npix ? band_m1(g, p) : 0;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * g.pitch + tap % 3;
      for (int k0 = 0; k0 < width; k0 += kKB) {
        const int kn = min(kKB, width - k0);
        __syncthreads();
        for (int i = tid; i < kn * kNTile; i += kThreads) {
          const int k = k0 + i / kNTile, n = i % kNTile;
          w2s[i] = n < width ? to_f<TC>(w2[((size_t)tap * width + k) * width + n]) : 0.f;
        }
        __syncthreads();
        for (int k = 0; k < kn; ++k) {
          float av[kPC], bv[kNJ];
#pragma unroll
          for (int i = 0; i < kPC; ++i) av[i] = m1s[(k0 + k) * m1_stride + off[i] + shift];
#pragma unroll
          for (int j = 0; j < kNJ; ++j) bv[j] = w2s[k * kNTile + n_base + j];
#pragma unroll
          for (int i = 0; i < kPC; ++i)
#pragma unroll
            for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
    }
  }
  if constexpr (kSums) {
    // the SE sums pass: this tile's channel sums of m2 as conv3 reads it
    // (lane order fixed by the xor tree, so the sums are deterministic)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = n_base + j;
      float s = 0.f;
      if (n < width) {
#pragma unroll
        for (int i = 0; i < kPC; ++i)
          if (lane + 32 * i < npix) s += rnd<TC>(fmaxf(acc[i][j] + a.b2[n], 0.f));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0 && n < width) a.partial[((size_t)b * a.tiles + blockIdx.x) * width + n] = s;
    }
    return;
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

  // ---- C: o = m2 . w3 + b3, identity, epilogue; kNTile output channels a pass
  float* w3s = work;                    // [kKB][kNTile]
  float* xs = work + kKB * kNTile;      // [kKC][kBand]
  float* wds = xs + kKC * kBand;        // [kKC][kNTile]
  TO* out = static_cast<TO*>(a.out) + (size_t)b * cout * HW;
  const float* gate = kGate ? a.gate + (size_t)b * cout : nullptr;
  for (int n0 = 0; n0 < cout; n0 += kNTile) {
#pragma unroll
    for (int i = 0; i < kPC; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < width; k0 += kKB) {
      const int kn = min(kKB, width - k0);
      __syncthreads();
      for (int i = tid; i < kn * kNTile; i += kThreads) {
        const int k = k0 + i / kNTile, n = n0 + i % kNTile;
        w3s[i] = n < cout ? to_f<TC>(w3[(size_t)k * cout + n]) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        float av[kPC], bv[kNJ];
#pragma unroll
        for (int i = 0; i < kPC; ++i)
          av[i] = m2s[(k0 + k) * band_stride + min(lane + 32 * i, npix - 1)];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) bv[j] = w3s[k * kNTile + n_base + j];
#pragma unroll
        for (int i = 0; i < kPC; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    // o = conv3 + b3, times the SE gate before the identity is added
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = n0 + n_base + j;
      const float bias = n < cout ? a.b3[n] : 0.f;
      if constexpr (kGate) {  // one loop: two ran the wide chain 3% slower
        const float gn = n < cout ? gate[n] : 0.f;
#pragma unroll
        for (int i = 0; i < kPC; ++i) acc[i][j] = (acc[i][j] + bias) * gn;
      } else {
#pragma unroll
        for (int i = 0; i < kPC; ++i) acc[i][j] += bias;
      }
    }
    if (wd != nullptr) {
      for (int k0 = 0; k0 < cin; k0 += kKC) {
        __syncthreads();
        for (int i = tid; i < kKC * kBand; i += kThreads) {
          const int kk = i / kBand, p = i % kBand;
          xs[i] = (k0 + kk < cin && p < npix)
                      ? rnd<TC>(to_f<TI>(x[(size_t)(k0 + kk) * HW + g.band.lin<kRows>(p)]))
                      : 0.f;
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
          for (int i = 0; i < kPC; ++i) av[i] = xs[kk * kBand + lane + 32 * i];
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
          if (p < npix) acc[i][j] += to_f<TI>(x[(size_t)n * HW + g.band.lin<kRows>(p)]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = n0 + n_base + j;
      if (n >= cout) continue;
#pragma unroll
      for (int i = 0; i < kPC; ++i) {
        const int p = lane + 32 * i;
        if (p >= npix) continue;
        out[(size_t)n * HW + g.band.lin<kRows>(p)] = from_f<TO>(fmaxf(acc[i][j], 0.f));
      }
    }
  }
}

// ---- the bf16 kernel (wgmma, every width) -----------------------------------
//
// One block of threads takes one tile of up to kBand = 192 pixels (4 whole
// rows of the 64x48 map: three 64-row wgmma tiles) with 4 warpgroups:
// warpgroups 0-2 compute, warpgroup w on tile pixels 64w .. 64w + 63 with its
// 64 x kN f32 sums in registers (kN / 2 per thread); warpgroup 3 is the
// producer, and hands its registers to the consumers (setmaxnreg).  kN is the
// width of every product: 64 at Bottleneck widths up to 64, 128 at widths
// 65-128; a narrower width reads as zeros past its end.  Every weight
// reaches shared memory as chunks of [K][kN channels] bf16 (K = 64 for w1
// and wd, kN for w2's taps and w3) in a ring of kStages stages: the
// producer's thread 0 waits until the stage is free (its `empty` mbarrier:
// every consumer warp arrives after its last wgmma on it), then asks TMA for
// the chunk's boxes of [K][64 channels] through the weight's tensor map,
// completing on the stage's `full` mbarrier.  TMA reads the folded weights
// as they are ([K][N], N contiguous) and writes them with the 128-byte
// swizzle, the MN-major layout that wgmma reads B in (`imm-trans-b`),
// out-of-range rows and columns as zeros.  So the weights of tap t + 1 are
// in flight while tap t is multiplied, and nothing transposes them.
//
// The chunks, in the order both sides walk them:
//   A. per round of up to kBand halo pixels, per 64 input channels: w1;
//   B. per 3x3 tap: w2[tap] (K = kN);
//   C. per pass of kN output channels: w3, then per 64 input channels wd
//      (none in the SE sums pass, which ends after B).
// Products: wgmma.mma_async m64nNk16 with N = kN (bf16 in, f32 sums), A from
// registers (ldmatrix from a [pixel][channel] bf16 tile, so the 3x3's A rows
// are the halo at pixel + shift), B from the stage by descriptor.
// Activations are staged by the consumers: x with 16-byte loads where its
// rows allow (whole rows, aligned), converted to bf16 in shared memory
// [pixel][64 channels].  Biases and the SE gate sit in shared memory, m1
// and m2 are stored with stmatrix, and half of the identity is loaded
// before conv3, so that its latency hides behind the product.  The
// numerics are those of the f32 kernel and the plain version: operands
// rounded to bf16 where the plain version rounds them, f32 sums, biases and
// carry, the zero pad after the relu, per-tile SE sums in a fixed order.
//
// Residency.  At kN = 128 every block of threads streams ~420 KB of weights
// per tile, and the ring (3 stages of 32 KB) and m1 (272 B a pixel) take
// ~213 KB: one block per SM.  At kN = 64 the products are a third of that,
// and the activations' global latency (staging x, the identity's loads, the
// epilogue's stores) sets the pace.  The 64 instance's shared memory (4
// stages of 8 KB, m1 at 144 B a pixel: ~107 KB for the 64x48 map's bands)
// would let two blocks of threads share an SM, but each would then have
// 32,768 registers, 64 a thread at launch: ptxas spills and serializes the
// wgmma, and there is no room to load the identity ahead; built so, it
// measured slower on the H100 (PERF.md).  So both instances run one block per
// SM, with the consumers at 160 registers holding the next x chunk and the
// identity while the products run.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

namespace hopper {

constexpr int kConsumers = 384;              // warpgroups 0-2
constexpr int kThreadsW = kConsumers + 128;  // and the producer warpgroup
constexpr int kWarpsC = kConsumers / 32;
constexpr int kBand = 192;                   // tile pixels: 3 x m64
constexpr int kStore = 320;                  // (th + 2) * (tw + 2): m1 on the tile and its ring
constexpr int kKX = 64;                      // x channels per chunk (phase A, the projection)
constexpr int kXP = kKX + 8;                 // x tile row pitch: 144 B
// registers per thread after setmaxnreg (launched at 65536 / 512 = 128): the
// producer gives up what the consumers' sums, A fragments and the loads held
// ahead need
constexpr int kProducerRegs = 32, kConsumerRegs = 160;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536, "one SM's registers");

// The instance whose products are kN channels wide.
template <int kN>
struct Shape {
  static_assert(kN == 64 || kN == 128, "products of 64 or 128 channels");
  static constexpr int kJ = kN / 8;                  // n8 blocks: 4 kJ sums a thread
  static constexpr int kP = kN + 8;                  // m1 / m2 row pitch: 144 or 272 B
  static constexpr int kBoxes = kN / 64;             // TMA boxes of 64 channels a chunk
  static constexpr int kStages = kN == 64 ? 4 : 3;
  static constexpr int kStageBytes = kBoxes * kN * 64 * 2;  // kBoxes boxes of [kN k][64 n]
  // the identity's fragment rows held in registers: at kN = 128 the first
  // row, loaded before conv3; at kN = 64 both, loaded during the pass before
  static constexpr int kIdnRows = kN == 64 ? 2 : 1;
  // shared memory after aligning to 1024 B (the swizzle's period):
  // [ring][x tile][SE sums][biases][mbarriers][m1 / m2]; the biases: b1, b2,
  // then b3, bd and the SE gate of the even passes of conv3, then of the
  // odd ones
  static constexpr int kXOff = kStages * kStageBytes;
  static constexpr int kRedOff = kXOff + kBand * kXP * 2;
  static constexpr int kBiasOff = kRedOff + kWarpsC * kN * 4;
  static constexpr int kBarOff = kBiasOff + 8 * kN * 4;
  static constexpr int kM1Off = kBarOff + 64;
  static_assert(2 * kStages * 8 <= 64, "the mbarriers");
};

bool tile_fits(int th, int tw) { return th * tw <= kBand && (th + 2) * (tw + 2) <= kStore; }

template <int kN>
size_t smem_bytes(int th, int tw) {
  return 1024 + Shape<kN>::kM1Off +
         sizeof(__nv_bfloat16) * (size_t)(th + 2) * (tw + 2) * Shape<kN>::kP;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete; trap after ~2^32
// cycles (a schedule that went wrong ends the launch with an error).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// The kBoxes boxes of a weight chunk (channels c_n + 64 h .. c_n + 64 h + 63
// into dst + h * box), completing on bar.
template <int kBoxes>
__device__ __forceinline__ void tma_chunk(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c_n, int c_k, int tap, uint32_t box) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  mbar_expect_tx(bar, kBoxes * box);
#pragma unroll
  for (int h = 0; h < kBoxes; ++h) {
    if (tap < 0)
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst + h * box),
          "l"(m), "r"(bar), "r"(c_n + 64 * h), "r"(c_k)
          : "memory");
    else
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst + h * box),
          "l"(m), "r"(bar), "r"(c_n + 64 * h), "r"(c_k), "r"(tap)
          : "memory");
  }
}

// wgmma descriptor of an MN-major B tile with the 128-byte swizzle: 8-row
// K groups 1024 B apart, 64-channel boxes `box` bytes apart.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t box) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(box >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Keeps the compiler from moving reads or writes of the sums across the
// asynchronous wgmma (its register operands are only ready after the wait).
template <int kA>
__device__ __forceinline__ void fence_acc(float (&d)[kA]) {
#pragma unroll
  for (int i = 0; i < kA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A . B over one k16 step: m64n64k16 (32 sums a thread) ...
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// ... and m64n128k16 (64 sums a thread)
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Cycle counters of scripts/profile_torch_k2.py --timers, which builds a
// copy of this file with K2_PHASE_TIMERS defined.  Per consumer warp: the
// cycles waiting for a chunk, in its products (ldmatrix, wgmma and their
// wait), staging x (with the barriers around it), storing m1 (with the
// zero fill), at the barriers after phases A and B, storing m2, in conv3's
// bias and the SE gate (in the sums pass: the sums, with their barrier),
// adding the identity (x, or the projection's bias), storing the output,
// and in all; per producer: waiting for a free stage, and in all.  Without
// the macro they compile to nothing.
enum { kTWait, kTMma, kTStage, kTEpiA, kTSync, kTEpiB, kTSe, kTIdn, kTOut, kTAll,
       kTProdWait, kTProdAll, kTimers };
#ifdef K2_PHASE_TIMERS
__device__ unsigned long long g_k2_cycles[kTimers];
#define K2_MARK(t) const long long t = clock64()
#define K2_ADD(k, t) (k2c[k] += clock64() - (t))
#define K2_FLUSH(k0, k1)                                                 \
  if ((threadIdx.x & 31) == 0)                                           \
    for (int k = k0; k < k1; ++k) atomicAdd(&g_k2_cycles[k], k2c[k])
#else
#define K2_MARK(t)
#define K2_ADD(k, t)
#define K2_FLUSH(k0, k1)
#endif
using Timers = unsigned long long[kTimers];

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// The ring as each side walks it: chunk i sits in stage i % kStages and
// fills for the (i / kStages)-th time.
template <int kN>
struct Ring {
  using S = Shape<kN>;
  uint32_t base, full, empty;  // stage 0, its full and empty mbarriers (8 B apart per stage)
  int i = 0;
  __device__ __forceinline__ int stage() const { return i % S::kStages; }
  __device__ __forceinline__ uint32_t parity() const { return (i / S::kStages) & 1; }
  __device__ __forceinline__ uint32_t full_bar() const { return full + 8 * stage(); }
  __device__ __forceinline__ uint32_t empty_bar() const { return empty + 8 * stage(); }
  __device__ __forceinline__ uint32_t data() const { return base + S::kStageBytes * stage(); }
};

// One chunk on the consumer side: wait for it, then (if this warpgroup has
// rows) acc += A . chunk over ksteps k16 steps, A's rows from this lane's
// ldmatrix address a_addr (k offset 0), then release the stage.
template <int kN>
__device__ __forceinline__ void consume(Ring<kN>& r, float (&acc)[kN / 2], bool active,
                                        uint32_t a_addr, int ksteps, uint32_t box, Timers& k2c) {
  K2_MARK(t0);
  mbar_wait(r.full_bar(), r.parity());
  K2_ADD(kTWait, t0);
  K2_MARK(t1);
  if (active) {
    uint32_t a[kN / 16][4];
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks)
      if (ks < ksteps) ldsm_x4(a[ks], a_addr + 32 * ks);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kN / 16; ++ks)
      if (ks < ksteps) wgmma(acc, a[ks], b_desc(r.data() + 2048 * ks, box));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
  }
  K2_ADD(kTMma, t1);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty_bar());
  ++r.i;
}

template <int kA>
__device__ __forceinline__ void zero(float (&acc)[kA]) {
#pragma unroll
  for (int i = 0; i < kA; ++i) acc[i] = 0.f;
}

// 16-byte loads of 8 pixels of one channel, as f32
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z,
  v[7] = hi.w;
}
__device__ __forceinline__ void load8(float (&v)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

// Pixels q0 .. q0 + kBand of map m (zero past `rows`), channels k0 .. k0 +
// 63 of x (zero past cin), for xs [kBand][kXP] as bf16, in two steps: load
// (into registers) and store.  An item is 8 pixels of a channel pair, two
// items a thread, both in registers at a time; neighbouring lanes
// take neighbouring pairs, so the shared stores fall in distinct banks.
// Where the 8 pixels are one aligned span (whole rows), each lane reads 32
// contiguous bytes of a channel (one sector) with 16-byte loads (one load
// for bf16 x).
template <bool kRows, typename TI>
struct XTile {
  static constexpr int kVec = 16 / sizeof(TI);  // pixels of one 16-byte load
  static_assert((kBand / 8) * (kKX / 2) == 2 * kConsumers, "two items per consumer thread");
  float v[2][2][8];

  __device__ __forceinline__ void load(const TI* x, int HW, const PixMap& m, int q0, int rows,
                                       int k0, int cin) {
    const bool vec = kRows && HW % kVec == 0 && (m.lin0 + q0) % kVec == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = threadIdx.x + u * kConsumers;
      const int p = 8 * (i / (kKX / 2)), c = k0 + 2 * (i % (kKX / 2));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool cok = c + e < cin;
        const TI* xc = x + (size_t)(cok ? c + e : 0) * HW;
        if (vec && cok && p + 8 <= rows) {
          load8(v[u][e], xc + m.lin0 + q0 + p);
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
            v[u][e][t] = cok && p + t < rows ? to_f<TI>(xc[m.lin<kRows>(q0 + p + t)]) : 0.f;
        }
      }
    }
  }

  __device__ __forceinline__ void store(__nv_bfloat16* xs) const {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = threadIdx.x + u * kConsumers;
      const int p = 8 * (i / (kKX / 2)), c = 2 * (i % (kKX / 2));
#pragma unroll
      for (int t = 0; t < 8; ++t)
        *reinterpret_cast<__nv_bfloat162*>(xs + (p + t) * kXP + c) =
            __floats2bfloat162_rn(v[u][0][t], v[u][1][t]);
    }
  }

  __device__ __forceinline__ void stage(__nv_bfloat16* xs, const TI* x, int HW, const PixMap& m,
                                        int q0, int rows, int k0, int cin) {
    load(x, HW, m, q0, rows, k0, cin);
    store(xs);
  }
};

// Store relu(acc + bias) as bf16 rows of 8 kJ channels with stmatrix (four
// 8x8 blocks an instruction, 16 bytes a row; a 4-byte store per fragment
// element was markedly slower).  Lane l gives the address of row l % 8
// of block l / 8, the blocks being (n8 block j, rows 0-7), (j, rows 8-15),
// (j + 1, 0-7) and (j + 1, 8-15) of this warp's 16 rows; row_addr is this
// lane's row at channel 0, or where `valid` is false a dummy slot.
template <int kJ>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[4 * kJ],
                                                const float (&bv)[2 * kJ], uint32_t row_addr,
                                                bool valid) {
  const uint32_t col = valid ? 16 * ((threadIdx.x & 31) >> 4) : 0;
#pragma unroll
  for (int j = 0; j < kJ; j += 2) {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int jj = j + (i >> 1), h = i & 1;
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          fmaxf(acc[4 * jj + 2 * h] + bv[2 * jj], 0.f),
          fmaxf(acc[4 * jj + 2 * h + 1] + bv[2 * jj + 1], 0.f));
      r[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     row_addr + (valid ? 16 * j : 0) + col),
                 "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
                 : "memory");
  }
}

// This thread's biases of the fragment's channels 8 j + 2 tig + e (bv[2 j +
// e]) from a slot of 8 kJ biases in shared memory.
template <int kJ>
__device__ __forceinline__ void load_bias(float (&bv)[2 * kJ], const float* slot, int tig) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[2 * j + e] = slot[8 * j + 2 * tig + e];
}

// Tensor maps: w1 [cin][width], w2 [9][width][width], w3 [width][cout],
// wd [cin][cout] (w3's map where there is no projection).  kSums: the SE
// sums pass (phases A and B, then m2's channel sums; w3 and wd unread).
template <int kN, bool kRows, typename TI, typename TO, bool kSums>
__global__ void __launch_bounds__(kThreadsW, 1)
    bottleneck_block_wgmma_kernel(BlockArgs a, const __grid_constant__ CUtensorMap tm_w1,
                                  const __grid_constant__ CUtensorMap tm_w2,
                                  const __grid_constant__ CUtensorMap tm_w3,
                                  const __grid_constant__ CUtensorMap tm_wd) {
  using bf16 = __nv_bfloat16;
  using S = Shape<kN>;
  constexpr int kJ = S::kJ, kP = S::kP;
  constexpr int kIdnRows = S::kIdnRows;
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  unsigned char* base = wgmma_smem + ((1024 - (smem_u32(wgmma_smem) & 1023)) & 1023);
  bf16* xs = reinterpret_cast<bf16*>(base + S::kXOff);
  float* red = reinterpret_cast<float*>(base + S::kRedOff);
  float* bias_s = reinterpret_cast<float*>(base + S::kBiasOff);
  bf16* m1s = reinterpret_cast<bf16*>(base + S::kM1Off);
  const uint32_t bars = smem_u32(base + S::kBarOff);
  Ring<kN> ring{smem_u32(base), bars, bars + 8 * S::kStages};

  const int tid = threadIdx.x;
  const Tile g = tile_of(a, blockIdx.x);
  const int width = a.width, cin = a.cin, cout = a.cout;
  const int rounds = (g.nhalo + kBand - 1) / kBand;
  const int kchunks = (cin + kKX - 1) / kKX, passes = kSums ? 0 : (cout + kN - 1) / kN;
  const bool proj = a.wd != nullptr, se = a.gate != nullptr;

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kWarpsC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  Timers k2c = {};
  K2_MARK(t_all);

  if (tid >= kConsumers) {
    // ---- the producer: thread 0 of warpgroup 3 walks the chunks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid != kConsumers) return;
    auto issue = [&](const CUtensorMap* map, int c_n, int c_k, int tap, uint32_t box) {
      K2_MARK(t0);
      mbar_wait(ring.empty_bar(), ring.parity() ^ 1);
      K2_ADD(kTProdWait, t0);
      tma_chunk<S::kBoxes>(ring.data(), map, ring.full_bar(), c_n, c_k, tap, box);
      ++ring.i;
    };
    for (int r = 0; r < rounds; ++r)
      for (int kc = 0; kc < kchunks; ++kc) issue(&tm_w1, 0, kKX * kc, -1, 64 * kKX * 2);
    for (int tap = 0; tap < 9; ++tap) issue(&tm_w2, 0, 0, tap, 64 * kN * 2);
    for (int np = 0; np < passes; ++np) {
      issue(&tm_w3, kN * np, 0, -1, 64 * kN * 2);
      if (proj)
        for (int kc = 0; kc < kchunks; ++kc) issue(&tm_wd, kN * np, kKX * kc, -1, 64 * kKX * 2);
    }
    K2_ADD(kTProdAll, t_all);
    K2_FLUSH(kTProdWait, kTimers);
    return;
  }

  // ---- the consumers: warpgroup wg, its warp wq (rows 16 wq .. 16 wq + 15
  // of the warpgroup's 64), fragment rows gid and gid + 8, channel pair tig
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int b = blockIdx.y, HW = a.h * a.w, npix = g.npix;
  const int lane = tid & 31, wg = tid >> 7, wq = (tid >> 5) & 3, gid = lane >> 2, tig = lane & 3;
  const int row0 = 64 * wg + 16 * wq;  // this warp's first row of the tile
  const int a_row = row0 + (lane & 15), a_k = 8 * (lane >> 4);
  const TI* x = static_cast<const TI*>(a.x) + (size_t)b * cin * HW;
  float acc[4 * kJ];

  {
    K2_MARK(t0);
    for (int i = tid; i < (a.th + 2) * g.pitch * kP / 8; i += kConsumers)
      reinterpret_cast<uint4*>(m1s)[i] = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < 2 * kN; i += kConsumers)  // b1 and b2, zero past the width
      bias_s[i] = i % kN < width ? (i < kN ? a.b1 : a.b2)[i % kN] : 0.f;
    K2_ADD(kTEpiA, t0);
  }

  // ---- A: m1 = relu(x . w1 + b1) on the halo, in rounds of up to kBand
  // pixels; each x chunk's loads fly while the chunk before it is multiplied
  XTile<kRows, TI> xt;
  const int steps = rounds * kchunks;
  xt.load(x, HW, g.halo, 0, min(kBand, g.nhalo), 0, cin);
  for (int it = 0; it < steps; ++it) {
    const int r = it / kchunks, kc = it % kchunks;
    const int q0 = kBand * r, rows = min(kBand, g.nhalo - q0);
    if (kc == 0) zero(acc);
    K2_MARK(t0);
    consumers_sync();  // every read of the previous x tile is done
    xt.store(xs);
    consumers_sync();
    if (it + 1 < steps) {
      const int q1 = kBand * ((it + 1) / kchunks);
      xt.load(x, HW, g.halo, q1, min(kBand, g.nhalo - q1), kKX * ((it + 1) % kchunks), cin);
    }
    K2_ADD(kTStage, t0);
    consume(ring, acc, 64 * wg < rows, smem_u32(xs + a_row * kXP + a_k), kKX / 16, 64 * kKX * 2,
            k2c);
    if (kc + 1 < kchunks) continue;
    K2_MARK(t_epi);
    float bv[2 * kJ];
    load_bias<kJ>(bv, bias_s, tig);
    {
      const int q = row0 + 8 * ((lane >> 3) & 1) + (lane & 7);
      const uint32_t row = q < rows ? smem_u32(m1s + halo_m1(g, q0 + q) * kP) : smem_u32(red);
      store_rows_bf16<kJ>(acc, bv, row, q < rows);
    }
    K2_ADD(kTEpiA, t_epi);
  }
  {
    K2_MARK(t0);
    consumers_sync();  // m1 is complete
    K2_ADD(kTSync, t0);
  }

  // ---- B: m2 = relu(3x3(m1) + b2): per tap, A rows are the halo at pixel + shift
  zero(acc);
  const bool x_once = proj && cin <= kKX;  // the projection's x tile is staged once
  {
    const uint32_t m1_row = smem_u32(m1s + band_m1(g, min(a_row, npix - 1)) * kP + a_k);
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * g.pitch + tap % 3;
      consume(ring, acc, 64 * wg < npix, m1_row + 2 * kP * shift, kN / 16, 64 * kN * 2, k2c);
    }
  }
  K2_MARK(t_sync);
  consumers_sync();  // every read of m1 is done: m2 overwrites it
  K2_ADD(kTSync, t_sync);
  if constexpr (kSums) {
    // ---- the SE sums pass: this tile's channel sums of m2 as conv3 reads
    // it (rounded to bf16), per warp over its 16 rows (the xor tree over the
    // lanes of one channel pair), then the 12 warps of a channel in a fixed
    // order (deterministic, no atomics)
    K2_MARK(t_sums);
    float bv[2 * kJ];
    load_bias<kJ>(bv, bias_s + kN, tig);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (row0 + gid + 8 * h < npix)
            s += __bfloat162float(
                __float2bfloat16(fmaxf(acc[4 * j + 2 * h + e] + bv[2 * j + e], 0.f)));
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (gid == 0) red[(tid >> 5) * kN + 8 * j + 2 * tig + e] = s;
      }
    consumers_sync();
    if (tid < width) {
      float s = red[tid];
#pragma unroll
      for (int w = 1; w < kWarpsC; ++w) s += red[w * kN + tid];
      a.partial[((size_t)b * a.tiles + blockIdx.x) * width + tid] = s;
    }
    K2_ADD(kTSe, t_sums);
    K2_ADD(kTAll, t_all);
    K2_FLUSH(kTWait, kTProdWait);
    return;
  }
  K2_MARK(t_m2);
  bf16* m2s = m1s;   // [tile pixel][kP]
  {
    float bv[2 * kJ];
    load_bias<kJ>(bv, bias_s + kN, tig);
    const int p = row0 + 8 * ((lane >> 3) & 1) + (lane & 7);
    store_rows_bf16<kJ>(acc, bv, p < npix ? smem_u32(m2s + p * kP) : smem_u32(red), p < npix);
  }
  __syncwarp();  // conv3 reads only this warp's own rows of m2
  K2_ADD(kTEpiB, t_m2);

  // ---- C: o = m2 . w3 + b3, the SE gate, identity, epilogue; kN output
  // channels a pass
  TO* out = static_cast<TO*>(a.out) + (size_t)b * cout * HW;
  const float* gate = se ? a.gate + (size_t)b * cout : nullptr;
  const bool active = 64 * wg < npix;
  const uint32_t xs_row = smem_u32(xs + a_row * kXP + a_k);
  if (x_once) {
    K2_MARK(t0);
    xt.stage(xs, x, HW, g.band, 0, npix, 0, cin);
    consumers_sync();
    K2_ADD(kTStage, t0);
  }
  // where there is no projection, the identity (the block's input itself,
  // unrounded: cin == cout) at this thread's first kIdnRows fragment rows of
  // the pass from output channel n0, into xv[4 j + 2 h + e] as acc holds it
  float xv[4 * kJ];
  auto load_identity = [&](int n0) {
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int h = 0; h < kIdnRows; ++h) {
        const int p = row0 + gid + 8 * h, lin = g.band.lin<kRows>(min(p, npix - 1));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + 2 * tig + e;
          xv[4 * j + 2 * h + e] = p < npix && n < cout ? to_f<TI>(x[(size_t)n * HW + lin]) : 0.f;
        }
      }
  };
  if (kIdnRows == 2 && !proj) load_identity(0);
  for (int np = 0; np < passes; ++np) {
    const int n0 = kN * np;
    // this pass's b3, bd and SE gate into their slots (the ones of pass np -
    // 2, whose readers all passed the barrier of pass np - 1), read after
    // conv3
    float* pass_bias = bias_s + kN * (2 + 3 * (np & 1));
    if (tid < 3 * kN) {
      const int k = tid / kN, n = n0 + tid % kN;
      const float* src = k == 0 ? a.b3 : k == 1 ? (proj ? a.bd : nullptr) : gate;
      pass_bias[tid] = n < cout && src != nullptr ? src[n] : 0.f;
    }
    // the identity's first row loaded before conv3, so that its latency
    // hides there
    if (kIdnRows == 1 && !proj) load_identity(n0);
    zero(acc);
    consume(ring, acc, active, smem_u32(m2s + min(a_row, npix - 1) * kP + a_k), kN / 16,
            64 * kN * 2, k2c);
    consumers_sync();  // the pass's biases are in place
    K2_MARK(t_se);
    {
      float bv[2 * kJ];
      load_bias<kJ>(bv, pass_bias, tig);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[4 * j + e] += bv[2 * j + e];
          acc[4 * j + 2 + e] += bv[2 * j + e];
        }
    }
    if (se) {
      // the SE gate, applied before the identity is added
      const float* gs = pass_bias + 2 * kN + 2 * tig;
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float gn = gs[8 * j + e];
          acc[4 * j + e] *= gn;
          acc[4 * j + 2 + e] *= gn;
        }
    }
    K2_ADD(kTSe, t_se);
    if (proj) {
      // identity = x . wd + bd, x's tile staged as bf16 per kKX channels
      for (int kc = 0; kc < kchunks; ++kc) {
        if (!x_once) {
          K2_MARK(t0);
          xt.load(x, HW, g.band, 0, npix, kKX * kc, cin);
          consumers_sync();
          xt.store(xs);
          consumers_sync();
          K2_ADD(kTStage, t0);
        }
        consume(ring, acc, active, xs_row, kKX / 16, 64 * kKX * 2, k2c);
      }
      K2_MARK(t0);
      float bv[2 * kJ];
      load_bias<kJ>(bv, pass_bias + kN, tig);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[4 * j + e] += bv[2 * j + e];
          acc[4 * j + 2 + e] += bv[2 * j + e];
        }
      K2_ADD(kTIdn, t0);
    } else {
      // the identity: the rows held in xv, the others loaded here; at kIdnRows
      // = 2 then the next pass's, in flight during this pass's stores and the
      // next conv3
      K2_MARK(t0);
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = row0 + gid + 8 * h, n = n0 + 8 * j + 2 * tig;
          if (h < kIdnRows) {
            acc[4 * j + 2 * h] += xv[4 * j + 2 * h];
            acc[4 * j + 2 * h + 1] += xv[4 * j + 2 * h + 1];
            continue;
          }
          if (p >= npix) continue;
          const int lin = g.band.lin<kRows>(p);
          if (n < cout) acc[4 * j + 2 * h] += to_f<TI>(x[(size_t)n * HW + lin]);
          if (n + 1 < cout) acc[4 * j + 2 * h + 1] += to_f<TI>(x[(size_t)(n + 1) * HW + lin]);
        }
      if (kIdnRows == 2 && np + 1 < passes) load_identity(n0 + kN);
      K2_ADD(kTIdn, t0);
    }
    K2_MARK(t_out);
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = row0 + gid + 8 * h, n = n0 + 8 * j + 2 * tig + e;
          if (p >= npix || n >= cout) continue;
          const size_t o = (size_t)n * HW + g.band.lin<kRows>(p);
          out[o] = from_f<TO>(fmaxf(acc[4 * j + 2 * h + e], 0.f));
        }
    K2_ADD(kTOut, t_out);
  }
  K2_ADD(kTAll, t_all);
  K2_FLUSH(kTWait, kTProdWait);
}

}  // namespace hopper

// The gate's products, one block of threads per sample: each column n of
// in [n_in] . w [n_in][n_out] is split over max(1, blockDim / n_out)
// threads, part p over a fixed span of the inputs, into red[p * n_out + n];
// parts_sum adds a column's parts in part order.  Many loads in flight:
// the gate is bound by the latency of its weight loads (SE's reduction
// ratio is 1, so fc1 and fc2 are Cout x Cout each), not by bytes or
// operations.
constexpr int kGateThreads = 1024;

template <typename TC>
__device__ __forceinline__ void gemv_parts(const float* in, int n_in, const TC* __restrict__ w,
                                           int n_out, float* red) {
  const int parts = max(1, (int)blockDim.x / n_out), span = (n_in + parts - 1) / parts;
  for (int i = threadIdx.x; i < parts * n_out; i += blockDim.x) {
    const int n = i % n_out, p = i / n_out, k1 = min(n_in, (p + 1) * span);
    float acc = 0.f;
#pragma unroll 16
    for (int k = p * span; k < k1; ++k)
      acc = fmaf(in[k], to_f<TC>(__ldg(&w[(size_t)k * n_out + n])), acc);
    red[i] = acc;
  }
  __syncthreads();
}

__device__ __forceinline__ float parts_sum(const float* red, int n, int n_out) {
  const int parts = max(1, (int)blockDim.x / n_out);
  float acc = red[n];
  for (int p = 1; p < parts; ++p) acc += red[p * n_out + n];
  return acc;
}

// One block per sample: the mean of m2 from the sums pass's tile sums
// (added in tile order), v = mean . w3 + b3 (= mean_hw(o): conv3 is
// linear), then g = sigmoid(relu(v . sf1 + sb1) . sf2 + sb2); v and the
// hidden layer are rounded to the compute type as matrix operands, the
// mean of m2 is not (the JAX kernel rounds none of it before the mean).
template <typename TC>
__global__ void __launch_bounds__(kGateThreads)
    se_gate_kernel(const float* partial, int tiles, int width, int c, int hidden, int hw,
                   const void* w3_, const float* b3, const void* sf1_, const float* sb1,
                   const void* sf2_, const float* sb2, float* gate) {
  extern __shared__ float s[];  // [width + c + hidden + max(blockDim, c, hidden)]
  const TC* w3 = static_cast<const TC*>(w3_);
  const TC* sf1 = static_cast<const TC*>(sf1_);
  const TC* sf2 = static_cast<const TC*>(sf2_);
  const int b = blockIdx.x;
  float* mean = s;
  float* v = s + width;
  float* g1 = v + c;
  float* red = g1 + hidden;
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < tiles; ++t) acc += partial[((size_t)b * tiles + t) * width + k];
    mean[k] = acc / (float)hw;
  }
  __syncthreads();
  gemv_parts(mean, width, w3, c, red);
  for (int n = threadIdx.x; n < c; n += blockDim.x) v[n] = rnd<TC>(parts_sum(red, n, c) + b3[n]);
  __syncthreads();
  gemv_parts(v, c, sf1, hidden, red);
  for (int n = threadIdx.x; n < hidden; n += blockDim.x)
    g1[n] = rnd<TC>(fmaxf(parts_sum(red, n, hidden) + sb1[n], 0.f));
  __syncthreads();
  gemv_parts(g1, hidden, sf2, c, red);
  for (int n = threadIdx.x; n < c; n += blockDim.x)
    gate[(size_t)b * c + n] = 1.f / (1.f + expf(-(parts_sum(red, n, c) + sb2[n])));
}

template <typename K>
cudaError_t launch(K kernel, const BlockArgs& a, int batch, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.tiles, batch), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver the process has loaded (no link
// against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A bf16 weight of `rank` dims (innermost first, the channels the products
// run along) as a tensor map with boxes of 64 channels by box_k rows and
// the 128-byte swizzle; rows and channels past the weight read as zeros.
bool weight_map(CUtensorMap* map, const void* w, int rank, const cuuint64_t* dims,
                cuuint32_t box_k) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(w) % 16 != 0 || dims[0] % 8 != 0) return false;
  const cuuint64_t strides[2] = {2 * dims[0], 2 * dims[0] * dims[1]};
  const cuuint32_t box[3] = {64, box_k, 1}, steps[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(w), dims, strides,
             box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The most dynamic shared memory for `kernel`.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int kN, bool kRows, typename TI, bool kSums>
cudaError_t launch_wgmma(const BlockArgs& a, int batch, bool out_bf16, cudaStream_t s) {
  const cuuint64_t width = a.width, cin = a.cin, cout = a.cout;
  const cuuint64_t d1[2] = {width, cin}, d2[3] = {width, width, 9}, d3[2] = {cout, width},
                   dd[2] = {cout, cin};
  CUtensorMap m1, m2, m3{}, md{};  // the sums pass reads neither w3 nor wd
  if (!weight_map(&m1, a.w1, 2, d1, hopper::kKX) || !weight_map(&m2, a.w2, 3, d2, kN))
    return cudaErrorInvalidValue;
  // the sums pass stores no output: its one instance has an f32 output type
  auto kernel = hopper::bottleneck_block_wgmma_kernel<kN, kRows, TI, float, kSums>;
  if constexpr (!kSums) {
    if (!weight_map(&m3, a.w3, 2, d3, kN) ||
        !weight_map(&md, a.wd ? a.wd : a.w3, 2, a.wd ? dd : d3, hopper::kKX))
      return cudaErrorInvalidValue;
    if (out_bf16)
      kernel = hopper::bottleneck_block_wgmma_kernel<kN, kRows, TI, __nv_bfloat16, false>;
  }
  const size_t smem = hopper::smem_bytes<kN>(a.th, a.tw);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.tiles, batch), hopper::kThreadsW, smem, s>>>(a, m1, m2, m3, md);
  return cudaGetLastError();
}

// f32 compute: the CUDA-core kernel for widths up to 64 or up to 128; an
// SE block's full pass (a.gate set) runs the instance with the gate.
template <int kWMax, bool kRows, typename TI, bool kSums>
cudaError_t launch_block(const BlockArgs& a, int batch, bool out_bf16, cudaStream_t s) {
  auto kernel = bottleneck_block_kernel<kWMax, kRows, TI, float, float, false, kSums>;
  if constexpr (!kSums) {
    if (a.gate != nullptr)
      kernel = out_bf16
                   ? bottleneck_block_kernel<kWMax, kRows, TI, float, __nv_bfloat16, true, false>
                   : bottleneck_block_kernel<kWMax, kRows, TI, float, float, true, false>;
    else if (out_bf16)
      kernel = bottleneck_block_kernel<kWMax, kRows, TI, float, __nv_bfloat16, false, false>;
  }
  return launch(kernel, a, batch, block_smem_bytes<kWMax>(a.th, a.tw), s);
}

// The compute type and the width pick the kernel: bf16 runs on wgmma
// (products 64 channels wide up to width 64, 128 above), f32 on the CUDA
// cores (tensor cores would round f32 operands); tiles of whole rows or
// 2-D tiles; kSums: the SE sums pass of that kernel (it writes no output,
// so its output type is f32).
template <typename TI, bool kSums>
cudaError_t launch_width(const BlockArgs& a, int batch, bool c_bf16, bool out_bf16,
                         cudaStream_t s) {
  const bool rows = a.tw == a.w;
  if (c_bf16) {
    if (a.width <= 64)
      return rows ? launch_wgmma<64, true, TI, kSums>(a, batch, out_bf16, s)
                  : launch_wgmma<64, false, TI, kSums>(a, batch, out_bf16, s);
    return rows ? launch_wgmma<128, true, TI, kSums>(a, batch, out_bf16, s)
                : launch_wgmma<128, false, TI, kSums>(a, batch, out_bf16, s);
  }
  if (a.width <= 64)
    return rows ? launch_block<64, true, TI, kSums>(a, batch, out_bf16, s)
                : launch_block<64, false, TI, kSums>(a, batch, out_bf16, s);
  return rows ? launch_block<128, true, TI, kSums>(a, batch, out_bf16, s)
              : launch_block<128, false, TI, kSums>(a, batch, out_bf16, s);
}

template <typename K>
int occupancy(K kernel, int threads, int smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return 0;
  return n;
}

template <int kWMax, bool kRows>
int blocks_per_sm(bool c_bf16, int smem) {
  if (c_bf16) {
    const auto kernel = hopper::bottleneck_block_wgmma_kernel<kWMax, kRows, float, float, false>;
    return allow_smem(kernel, smem) == cudaSuccess ? occupancy(kernel, hopper::kThreadsW, smem)
                                                   : 0;
  }
  const auto kernel = bottleneck_block_kernel<kWMax, kRows, float, float, float, false, false>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return 0;
  return occupancy(kernel, kThreads, smem);
}

}  // namespace

extern "C" {

// Shared memory bytes of one block of threads for tiles of th rows by tw
// columns at Bottleneck width `width` (bf16 compute if c_bf16, else f32);
// 0 if that tile or width is beyond the kernels' limits (width <= 128; in
// bf16 th * tw <= hopper::kBand and (th + 2) * (tw + 2) <= hopper::kStore;
// in f32 th * tw and (th + 2) * tw within Cfg's kBand and kHalo).
int bottleneck_smem_bytes(int th, int tw, int width, int c_bf16) {
  if (th < 1 || tw < 1 || width < 1 || width > 128) return 0;
  size_t bytes;
  if (c_bf16) {
    if (!hopper::tile_fits(th, tw)) return 0;
    bytes = width <= 64 ? hopper::smem_bytes<64>(th, tw) : hopper::smem_bytes<128>(th, tw);
  } else if (width <= 64) {
    if (!tile_fits<64>(th, tw)) return 0;
    bytes = block_smem_bytes<64>(th, tw);
  } else {
    if (!tile_fits<128>(th, tw)) return 0;
    bytes = block_smem_bytes<128>(th, tw);
  }
  return bytes <= (size_t)kMaxSmem ? (int)bytes : 0;
}

// Blocks of threads that fit on one SM (the occupancy calculator) for the
// block kernel a launch with these tiles runs (f32 x and output; rows: the
// tiles span whole rows); 0 if the tile is beyond the kernels' limits.
int bottleneck_blocks_per_sm(int th, int tw, int width, int c_bf16, int rows) {
  const int smem = bottleneck_smem_bytes(th, tw, width, c_bf16);
  if (smem == 0) return 0;
  if (width <= 64)
    return rows ? blocks_per_sm<64, true>(c_bf16, smem) : blocks_per_sm<64, false>(c_bf16, smem);
  return rows ? blocks_per_sm<128, true>(c_bf16, smem) : blocks_per_sm<128, false>(c_bf16, smem);
}

// One folded Bottleneck block.  x: [B, Cin, H, W] (bf16 if x_bf16, else f32);
// out: [B, Cout, H, W] (bf16 if out_bf16, else f32).  Weights are in the
// compute type (bf16 if c_bf16, else f32), biases f32.  wd/bd and the SE
// arguments may be null.  In bf16, width and Cout must be multiples of 8
// and the weights 16-byte aligned (the tensor maps' rows).
// Tiles of th x tw pixels (bottleneck_smem_bytes must take them); for an
// SE block, partial is f32 [B, tiles, width] scratch with tiles = ceil(h /
// th) * ceil(w / tw), and gate f32 [B, Cout]: the sums pass, se_gate_kernel
// and the full pass run in that order on `stream`.
// Returns cudaGetLastError() of the launches (0 on success).
int bottleneck_block_forward(const void* x, void* out, float* partial, float* gate,
                             const void* w1, const float* b1, const void* w2, const float* b2,
                             const void* w3, const float* b3, const void* wd, const float* bd,
                             const void* sf1, const float* sb1, const void* sf2,
                             const float* sb2, int batch, int cin, int width, int cout,
                             int se_hidden, int h, int w, int th, int tw, int x_bf16, int c_bf16,
                             int out_bf16, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (bottleneck_smem_bytes(th, tw, width, c_bf16) == 0 || th > h || tw > w)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (w + tw - 1) / tw;
  BlockArgs a{x,  out, partial, nullptr, w1, b1, w2, b2, w3, b3, wd, bd, cin, width, cout,
              h,  w,   th,      tw,      tiles_w, ((h + th - 1) / th) * tiles_w};
  cudaError_t err;
  if (sf1 != nullptr) {
    err = x_bf16 ? launch_width<__nv_bfloat16, true>(a, batch, c_bf16, false, stream)
                 : launch_width<float, true>(a, batch, c_bf16, false, stream);
    if (err != cudaSuccess) return (int)err;
    // within the 48 KB a launch may take without asking (6.6 KB at width 128)
    const size_t gate_smem =
        sizeof(float) * (width + cout + se_hidden + cmax(kGateThreads, cmax(cout, se_hidden)));
    if (gate_smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (c_bf16)
      se_gate_kernel<__nv_bfloat16><<<batch, kGateThreads, gate_smem, stream>>>(
          partial, a.tiles, width, cout, se_hidden, h * w, w3, b3, sf1, sb1, sf2, sb2, gate);
    else
      se_gate_kernel<float><<<batch, kGateThreads, gate_smem, stream>>>(
          partial, a.tiles, width, cout, se_hidden, h * w, w3, b3, sf1, sb1, sf2, sb2, gate);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a.gate = gate;
  }
  err = x_bf16 ? launch_width<__nv_bfloat16, false>(a, batch, c_bf16, out_bf16, stream)
               : launch_width<float, false>(a, batch, c_bf16, out_bf16, stream);
  return (int)err;
}

#ifdef K2_PHASE_TIMERS
// The cycle counters summed since the last call (then zeroed).
int k2_phase_cycles(unsigned long long* out) {
  static const unsigned long long zeros[hopper::kTimers] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(out, hopper::g_k2_cycles, sizeof(zeros));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(hopper::g_k2_cycles, zeros, sizeof(zeros));
  return (int)e;
}
#endif

}  // extern "C"
