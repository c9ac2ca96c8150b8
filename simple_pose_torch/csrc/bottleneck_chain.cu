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
// sample on the same bytes).  Two kernels, chosen by the compute type:
//   bf16: bottleneck_block_tc_kernel, all four products (conv1, the 3x3,
//         conv3, the projection) through one warp-level bf16 tensor-core
//         routine (mma.sync m16n8k16, f32 accumulate, ldmatrix operands);
//   f32:  bottleneck_block_kernel, f32 FMAs on the CUDA cores, since tensor
//         cores would round f32 operands (TF32 or bf16).
// With the products on tensor cores, what the design still moves (the f32
// pre/idn scratch of the SE pass, the f32 carry read twice, each tile's
// halo) and its unoverlapped staging set the pace, not the products.
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
// row), whose rows are spans of TW (+2) pixels.
// The wrapper (ops/bottleneck_chain.launch_plan) picks TH and TW;
// bottleneck_smem_bytes checks them against these limits and gives the
// shared memory they need.  A launch's grid is (tiles, batch).
//
// Width.  Every output channel of the 3x3 reads every m1 channel of the
// halo, and m2 overwrites m1 in place once the 3x3 is done, so one pass of
// the 3x3 covers all `width` output channels.  The tile therefore shrinks as
// the width grows, with the same 8 warps and the same accumulator registers
// per thread (Cfg below): up to width 64, tiles of up to 192 pixels and
// passes of 64 channels (the bf16 kernel's warps 4 along pixels x 2 along
// channels); up to width 128 (wide_resnet50_2 / 101_2), tiles of up to 96
// pixels and passes of 128 channels (2 x 4).  Taking m1 and w2 through in
// 64-channel chunks instead would keep the tile, but the 3x3's sums for
// all 128 channels would then live across the chunks: twice the
// accumulator registers, or m2 in a buffer of its own beside m1.  At width
// 128 a block takes ~150 KB (bf16), so one block runs per SM, against two
// at width 64.
//
// SE needs the spatial mean over the whole sample before the residual add,
// so an SE block runs in two passes: pass 1 writes the pre-gate output, the
// identity and deterministic per-tile channel sums (no atomics); then
// se_gate_kernel reduces the sums per sample and runs the two fcs and the
// sigmoid, and se_apply_kernel writes relu(o * g + identity).
//
// Register tiling of the f32 kernel: 256 threads = 8 warps.  Lane l of warp
// g computes pixels {l, l+32, ...} of the tile and output channels
// kNJ*g .. kNJ*g + kNJ-1, so the A operand is read conflict-free from shared
// memory and the B operand is a warp-wide broadcast.  The bf16 kernel's
// tiling is at bottleneck_block_tc_kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 16;               // input-channel chunk of the f32 kernel's x products
constexpr int kMaxSmem = 232448;      // one block's shared memory (227 KB)

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The tile limits and the two kernels' shapes for Bottleneck widths up to
// kWMax (64 or 128).
template <int kWMax>
struct Cfg {
  static_assert(kWMax == 64 || kWMax == 128, "the kernels take widths up to 64 or up to 128");
  static constexpr int kNTile = kWMax;                   // output channels per pass
  static constexpr int kBand = kWMax == 64 ? 192 : 96;   // TH * TW <= kBand
  static constexpr int kHalo = kWMax == 64 ? 288 : 192;  // (TH + 2) * TW <= kHalo
  static constexpr int kMinBlocks = kWMax == 64 ? 2 : 1;  // blocks per SM
  // f32 kernel: kNJ output channels per thread, kPC tile pixels per lane,
  // kPA halo pixels per lane in each round of phase A, w2 and w3 in shared
  // memory kKB input channels at a time
  static constexpr int kNJ = kNTile / 8;
  static constexpr int kPC = kBand / 32;
  static constexpr int kPA = kWMax == 64 ? 9 : 3;
  static constexpr int kKB = kWMax == 64 ? 64 : 32;
  // scratch floats beyond m1: max of phase A (x chunk + w1 chunk), phase B
  // (a K chunk of one 3x3 tap), phase C (w3 chunk + x chunk + wd chunk)
  static constexpr int kWork = cmax(cmax(kKC * kPA * 32 + kKC * kNTile, kKB * kNTile),
                                    kKB * kNTile + kKC * kBand + kKC * kNTile);
  // bf16 kernel: row pitch of the smem tiles (144 or 272 B, so the 8 rows of
  // an ldmatrix fall in distinct banks), warps along N (32 channels each)
  // and along M (pixels), m16 tiles per warp
  static constexpr int kP = kWMax + 8;
  static constexpr int kNG = kWMax / 32;
  static constexpr int kMG = 8 / kNG;
  static constexpr int kMT = 3;
  static_assert(kBand == 16 * kMT * kMG, "a tile is the warps' m16 tiles");
  // bf16 scratch beyond m1: phase A (x round + w1), phase C (w3 + x band +
  // wd + the SE sums); phase B's one tap of w2 is smaller
  static constexpr int kTcWork = cmax(2 * (kBand + kWMax) * kP,
                                      2 * (2 * kWMax + kBand) * kP + 4 * kMG * kNTile);
};

template <int kWMax>
bool tile_fits(int th, int tw) {
  return th * tw <= Cfg<kWMax>::kBand && (th + 2) * tw <= Cfg<kWMax>::kHalo;
}

template <int kWMax>
size_t block_smem_bytes(int th, int tw) {
  return sizeof(float) * ((size_t)kWMax * (th + 2) * (tw + 2) + Cfg<kWMax>::kWork);
}

template <int kWMax>
size_t tc_smem_bytes(int th, int tw) {
  return sizeof(__nv_bfloat16) * (size_t)(th + 2) * (tw + 2) * Cfg<kWMax>::kP +
         Cfg<kWMax>::kTcWork;
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
  void* out;          // [B, Cout, H, W]  output type (no SE)
  float* pre;         // [B, Cout, H, W]  pre-gate output (SE pass 1)
  float* idn;         // [B, Cout, H, W]  identity (SE pass 1)
  float* partial;     // [B, tiles, Cout] per-tile channel sums (SE pass 1)
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
  int se;
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

template <int kWMax, bool kRows, typename TI, typename TC, typename TO>
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
  float* pre = a.pre + (size_t)b * cout * HW;
  float* idn = a.idn + (size_t)b * cout * HW;
  TO* out = static_cast<TO*>(a.out) + (size_t)b * cout * HW;
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
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = n0 + n_base + j;
      const float bias = n < cout ? a.b3[n] : 0.f;
#pragma unroll
      for (int i = 0; i < kPC; ++i) acc[i][j] += bias;
    }
    if (a.se) {
      // pre-gate output and this tile's channel sums (lane order fixed by
      // the xor tree, so the sums are deterministic)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int n = n0 + n_base + j;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kPC; ++i) {
          const int p = lane + 32 * i;
          if (p < npix) {
            s += acc[i][j];
            if (n < cout) pre[(size_t)n * HW + g.band.lin<kRows>(p)] = acc[i][j];
          }
          acc[i][j] = 0.f;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0 && n < cout)
          a.partial[((size_t)b * a.tiles + blockIdx.x) * cout + n] = s;
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
        const size_t o = (size_t)n * HW + g.band.lin<kRows>(p);
        if (a.se) idn[o] = acc[i][j];
        else out[o] = from_f<TO>(fmaxf(acc[i][j], 0.f));
      }
    }
  }
}

// ---- the tensor-core kernel (bf16 compute) ---------------------------------

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

constexpr int kNT = 4;  // n8 tiles per warp: 32 channels

// The one product routine: acc[i][j] += A(m-tile i) . B(n-tile j) over
// ksteps steps of k16.  a_addr[i] is this lane's ldmatrix row in m-tile i
// (row lane % 16 at k offset 8 * (lane / 16)), so the rows may be gathered
// from anywhere in shared memory; b_addr is this lane's row of the [n][k]
// weight tile (row pitch kP) for the warp's 32 channels.  m-tiles i >= mt
// are skipped.
template <int kP, int kMT>
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

template <int kMT>
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

// Stage pixels q0 .. q0 + kMaxRows of the map m (zero past `rows` and past
// cin), x's channels k0 .. k0 + kpad, into xs [kMaxRows][kP] as bf16: two
// channels per item, so the global loads run along pixels and each shared
// store is one bf16 pair.
template <int kMaxRows, int kP, bool kRows, typename TI>
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, const TI* x, int HW, const PixMap& m,
                                        int q0, int rows, int k0, int kpad, int cin) {
  const int total = kMaxRows * kpad / 2;
  for (int i0 = threadIdx.x; i0 < total; i0 += kStageBatch * kThreads) {
    float v[kStageBatch][2];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int c = k0 + 2 * (i / kMaxRows), r = i % kMaxRows;
      const bool ok = i < total && r < rows;
      const int lin = ok ? m.lin<kRows>(q0 + r) : 0;
      v[u][0] = ok && c < cin ? to_f<TI>(x[(size_t)c * HW + lin]) : 0.f;
      v[u][1] = ok && c + 1 < cin ? to_f<TI>(x[(size_t)(c + 1) * HW + lin]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total)
        *reinterpret_cast<__nv_bfloat162*>(xs + (i % kMaxRows) * kP + 2 * (i / kMaxRows)) =
            __floats2bfloat162_rn(v[u][0], v[u][1]);
    }
  }
}

// Stage w[k0 + k][n0 + n] (global [K][N], row length ld) transposed into
// ws [kN n][kP] for k < kpad, zero past K and N; two k per item.
template <int kN, int kP>
__device__ __forceinline__ void stage_w(__nv_bfloat16* ws, const __nv_bfloat16* w, int ld, int k0,
                                        int kpad, int K, int n0, int N) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const int total = kN * kpad / 2;
  for (int i0 = threadIdx.x; i0 < total; i0 += kStageBatch * kThreads) {
    __nv_bfloat16 v[kStageBatch][2];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int k = k0 + 2 * (i / kN), n = n0 + i % kN;
      const bool ok = i < total && n < N;
      v[u][0] = ok && k < K ? w[(size_t)k * ld + n] : zero;
      v[u][1] = ok && k + 1 < K ? w[(size_t)(k + 1) * ld + n] : zero;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total)
        *reinterpret_cast<__nv_bfloat162*>(ws + (i % kN) * kP + 2 * (i / kN)) =
            __halves2bfloat162(v[u][0], v[u][1]);
    }
  }
}

// The bf16 block: the same three phases, tiles and epilogue as
// bottleneck_block_kernel, with every product in warp_mma.  Shared memory
// holds activations as [pixel][channel] bf16 and weights as [n][k] bf16.
// Warp g owns m-tiles g/kNG, g/kNG + kMG, g/kNG + 2kMG of up to kBand
// pixels and 32 of a pass's kNTile channels; an f32 C fragment holds pixels
// lane/4 and lane/4 + 8 for the channel pair 2 * (lane % 4) + {0, 1} of each
// n8 tile.
template <int kWMax, bool kRows, typename TI, typename TO>
__global__ void __launch_bounds__(kThreads, Cfg<kWMax>::kMinBlocks)
    bottleneck_block_tc_kernel(BlockArgs a) {
  using C = Cfg<kWMax>;
  constexpr int kP = C::kP, kMG = C::kMG, kMT = C::kMT, kBand = C::kBand, kNTile = C::kNTile;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  using bf16 = __nv_bfloat16;
  const int tid = threadIdx.x, lane = tid & 31, grp = tid >> 5;
  const int b = blockIdx.y;
  const Tile g = tile_of(a, blockIdx.x);
  const int HW = a.h * a.w, npix = g.npix;
  const int m1_stride = (a.th + 2) * g.pitch;
  const int width = a.width, cin = a.cin, cout = a.cout;
  const int mg = grp / C::kNG, nw = 32 * (grp % C::kNG);
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

  // ---- A: m1 = relu(x . w1 + b1) on the halo, in rounds of up to kBand
  // halo pixels
  {
    bf16* xs = work;                 // [kBand][kP]
    bf16* ws = work + kBand * kP;    // [kWMax n][kP]
    for (int r0 = 0; r0 < g.nhalo; r0 += kBand) {
      const int rows = min(kBand, g.nhalo - r0);
      const int rmt = min(kMT, max(0, ((rows + 15) / 16 - mg + kMG - 1) / kMG));
      zero_acc(acc);
      for (int k0 = 0; k0 < cin; k0 += kWMax) {
        const int kpad = (min(kWMax, cin - k0) + 15) / 16 * 16;
        __syncthreads();
        stage_x<kBand, kP, kRows>(xs, x, HW, g.halo, r0, rows, k0, kpad, cin);
        stage_w<kWMax, kP>(ws, w1, width, k0, kpad, cin, 0, width);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          a_addr[i] = smem_u32(xs + ((mg + kMG * i) * 16 + a_row) * kP + a_k);
        warp_mma<kP>(acc, a_addr, rmt, smem_u32(ws) + b_off, kpad / 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int n = nw + 8 * j + 2 * tig;
          const float b0 = n < width ? a.b1[n] : 0.f, b1 = n + 1 < width ? a.b1[n + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (mg + kMG * i) * 16 + gid + 8 * h;
            if (r >= rows) continue;
            *reinterpret_cast<__nv_bfloat162*>(m1s + halo_m1(g, r0 + r) * kP + n) =
                __floats2bfloat162_rn(fmaxf(acc[i][j][2 * h] + b0, 0.f),
                                      fmaxf(acc[i][j][2 * h + 1] + b1, 0.f));
          }
        }
    }
  }

  // ---- B: m2 = relu(3x3(m1) + b2): 9 shifted products, the A rows of tap
  // (dy, dx) gathered from the halo at pixel + dy * pitch + dx
  zero_acc(acc);
  {
    bf16* w2s = work;  // [kWMax n][kP]
    int row[kMT];      // this lane's A row (halo pixel) in m-tile i, tap (0, 0)
#pragma unroll
    for (int i = 0; i < kMT; ++i) row[i] = band_m1(g, min((mg + kMG * i) * 16 + a_row, npix - 1));
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * g.pitch + tap % 3;
      __syncthreads();
      stage_w<kWMax, kP>(w2s, w2 + (size_t)tap * width * width, width, 0, kw, width, 0, width);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kMT; ++i) a_addr[i] = smem_u32(m1s + (row[i] + shift) * kP + a_k);
      warp_mma<kP>(acc, a_addr, mt, smem_u32(w2s) + b_off, kw / 16);
    }
  }
  __syncthreads();  // every read of m1 is done: m2 overwrites it
  bf16* m2s = m1s;  // [tile pixel][kP]
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

  // ---- C: o = m2 . w3 + b3, identity, epilogue; kNTile output channels a pass
  bf16* w3s = work;                          // [kWMax n][kP]
  bf16* xs = work + kWMax * kP;              // [kBand][kP]
  bf16* wds = xs + kBand * kP;               // [kWMax n][kP]
  float* red = reinterpret_cast<float*>(wds + kWMax * kP);  // [kMG][kNTile]
  float* pre = a.pre + (size_t)b * cout * HW;
  float* idn = a.idn + (size_t)b * cout * HW;
  TO* out = static_cast<TO*>(a.out) + (size_t)b * cout * HW;
  // x's tile for the projection is staged once when one chunk of kWMax
  // channels holds it (layer1's first block), else per pass and chunk
  const bool x_once = wd != nullptr && cin <= kWMax;
  if (x_once)
    stage_x<kBand, kP, kRows>(xs, x, HW, g.band, 0, npix, 0, (cin + 15) / 16 * 16, cin);
  for (int n0 = 0; n0 < cout; n0 += kNTile) {
    __syncthreads();
    stage_w<kWMax, kP>(w3s, w3, cout, 0, kw, width, n0, cout);
    __syncthreads();
    zero_acc(acc);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
      a_addr[i] = smem_u32(m2s + min((mg + kMG * i) * 16 + a_row, npix - 1) * kP + a_k);
    warp_mma<kP>(acc, a_addr, mt, smem_u32(w3s) + b_off, kw / 16);
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
      // pre-gate output and this tile's channel sums: per warp over its
      // pixels and the xor tree over lanes of one channel pair, then the
      // kMG warps of a channel in a fixed order (deterministic, no atomics)
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
                if (n < cout) pre[(size_t)n * HW + g.band.lin<kRows>(p)] = acc[i][j][2 * h + e];
              }
              acc[i][j][2 * h + e] = 0.f;
            }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (gid == 0) red[mg * kNTile + nl] = s;
        }
      __syncthreads();
      if (tid < kNTile && n0 + tid < cout) {
        float s = red[tid];
#pragma unroll
        for (int m = 1; m < kMG; ++m) s += red[m * kNTile + tid];
        a.partial[((size_t)b * a.tiles + blockIdx.x) * cout + n0 + tid] = s;
      }
    }
    if (wd != nullptr) {
      // identity = x . wd + bd, with x's tile staged as bf16 per kWMax channels
      for (int k0 = 0; k0 < cin; k0 += kWMax) {
        const int kpad = (min(kWMax, cin - k0) + 15) / 16 * 16;
        __syncthreads();
        if (!x_once) stage_x<kBand, kP, kRows>(xs, x, HW, g.band, 0, npix, k0, kpad, cin);
        stage_w<kWMax, kP>(wds, wd, cout, k0, kpad, cin, n0, cout);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kMT; ++i)
          a_addr[i] = smem_u32(xs + ((mg + kMG * i) * 16 + a_row) * kP + a_k);
        warp_mma<kP>(acc, a_addr, mt, smem_u32(wds) + b_off, kpad / 16);
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
            const int lin = g.band.lin<kRows>(p);
            if (n < cout) acc[i][j][2 * h] += to_f<TI>(x[(size_t)n * HW + lin]);
            if (n + 1 < cout) acc[i][j][2 * h + 1] += to_f<TI>(x[(size_t)(n + 1) * HW + lin]);
          }
    }
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
            const size_t o = (size_t)n * HW + g.band.lin<kRows>(p);
            if (a.se) idn[o] = acc[i][j][2 * h + e];
            else out[o] = from_f<TO>(fmaxf(acc[i][j][2 * h + e], 0.f));
          }
  }
}

// One block per sample: v = mean_hw(o) from the tile sums, then
// g = sigmoid(relu(v . sf1 + sb1) . sf2 + sb2); v and the hidden layer are
// rounded to the compute type as matrix operands.
template <typename TC>
__global__ void se_gate_kernel(const float* partial, int tiles, int c, int hidden, int hw,
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
    for (int t = 0; t < tiles; ++t) acc += partial[((size_t)b * tiles + t) * c + n];
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

template <typename K>
cudaError_t launch(K kernel, const BlockArgs& a, int batch, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.tiles, batch), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The compute type picks the kernel: bf16 runs on the tensor cores, f32 on
// the CUDA cores (tensor cores would round f32 operands).
template <int kWMax, bool kRows, typename TI>
cudaError_t launch_block(const BlockArgs& a, int batch, bool c_bf16, bool out_bf16,
                         cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (c_bf16) {
    const size_t smem = tc_smem_bytes<kWMax>(a.th, a.tw);
    return out_bf16
               ? launch(bottleneck_block_tc_kernel<kWMax, kRows, TI, bf16>, a, batch, smem, s)
               : launch(bottleneck_block_tc_kernel<kWMax, kRows, TI, float>, a, batch, smem, s);
  }
  const size_t smem = block_smem_bytes<kWMax>(a.th, a.tw);
  return out_bf16
             ? launch(bottleneck_block_kernel<kWMax, kRows, TI, float, bf16>, a, batch, smem, s)
             : launch(bottleneck_block_kernel<kWMax, kRows, TI, float, float>, a, batch, smem, s);
}

// Widths up to 64 or up to 128; tiles of whole rows or 2-D tiles.
template <typename TI>
cudaError_t launch_width(const BlockArgs& a, int batch, bool c_bf16, bool out_bf16,
                         cudaStream_t s) {
  const bool rows = a.tw == a.w;
  if (a.width <= 64)
    return rows ? launch_block<64, true, TI>(a, batch, c_bf16, out_bf16, s)
                : launch_block<64, false, TI>(a, batch, c_bf16, out_bf16, s);
  return rows ? launch_block<128, true, TI>(a, batch, c_bf16, out_bf16, s)
              : launch_block<128, false, TI>(a, batch, c_bf16, out_bf16, s);
}

}  // namespace

extern "C" {

// Shared memory bytes of one block of threads for tiles of th rows by tw
// columns at Bottleneck width `width` (bf16 compute if c_bf16, else f32);
// 0 if that tile or width is beyond the kernels' limits (width <= 128;
// th * tw and (th + 2) * tw within Cfg's kBand and kHalo).
int bottleneck_smem_bytes(int th, int tw, int width, int c_bf16) {
  if (th < 1 || tw < 1 || width < 1 || width > 128) return 0;
  size_t bytes;
  if (width <= 64) {
    if (!tile_fits<64>(th, tw)) return 0;
    bytes = c_bf16 ? tc_smem_bytes<64>(th, tw) : block_smem_bytes<64>(th, tw);
  } else {
    if (!tile_fits<128>(th, tw)) return 0;
    bytes = c_bf16 ? tc_smem_bytes<128>(th, tw) : block_smem_bytes<128>(th, tw);
  }
  return bytes <= (size_t)kMaxSmem ? (int)bytes : 0;
}

// One folded Bottleneck block.  x: [B, Cin, H, W] (bf16 if x_bf16, else f32);
// out: [B, Cout, H, W] (bf16 if out_bf16, else f32).  Weights are in the
// compute type (bf16 if c_bf16, else f32), biases f32.  wd/bd and the SE
// arguments may be null.  Tiles of th x tw pixels (bottleneck_smem_bytes
// must take them); for an SE block, pre and idn are f32 [B, Cout, H, W]
// scratch, partial is [B, tiles, Cout] with tiles = ceil(h / th) *
// ceil(w / tw), and gate [B, Cout].
// Returns cudaGetLastError() of the launches (0 on success).
int bottleneck_block_forward(const void* x, void* out, float* pre, float* idn, float* partial,
                             float* gate, const void* w1, const float* b1, const void* w2,
                             const float* b2, const void* w3, const float* b3, const void* wd,
                             const float* bd, const void* sf1, const float* sb1,
                             const void* sf2, const float* sb2, int batch, int cin, int width,
                             int cout, int se_hidden, int h, int w, int th, int tw, int x_bf16,
                             int c_bf16, int out_bf16, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (bottleneck_smem_bytes(th, tw, width, c_bf16) == 0 || th > h || tw > w)
    return (int)cudaErrorInvalidValue;
  const bool se = sf1 != nullptr;
  const int tiles_w = (w + tw - 1) / tw;
  BlockArgs a{x,  out, pre, idn,  partial, w1, b1, w2, b2, w3, b3, wd, bd, cin, width, cout,
              h,  w,   th,  tw,   tiles_w, ((h + th - 1) / th) * tiles_w, se ? 1 : 0};
  cudaError_t err = x_bf16 ? launch_width<__nv_bfloat16>(a, batch, c_bf16, out_bf16, stream)
                           : launch_width<float>(a, batch, c_bf16, out_bf16, stream);
  if (err != cudaSuccess || !se) return (int)err;

  const size_t gate_smem = sizeof(float) * (cout + se_hidden);
  if (c_bf16)
    se_gate_kernel<__nv_bfloat16><<<batch, 256, gate_smem, stream>>>(
        partial, a.tiles, cout, se_hidden, h * w, sf1, sb1, sf2, sb2, gate);
  else
    se_gate_kernel<float><<<batch, 256, gate_smem, stream>>>(
        partial, a.tiles, cout, se_hidden, h * w, sf1, sb1, sf2, sb2, gate);
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
