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
// bf16 values are exact in f32, so a bf16 matrix unit with f32 sums gives
// what the plain version gives, up to the order of sums.
//
// What bounds it on the card: at the flagship layer1 shapes (64x48x64 in,
// 64x48x256 out, width 64) the chain is ~1.3 GFLOP per sample against
// ~2 MB of bf16 in and out, far above the H100's ~295 FLOP/byte ridge:
// it is bound by operations (the wide ResNets' width 128: ~3.9 GFLOP per
// sample on the same bytes).  One block kernel,
// hopper::bottleneck_block_wgmma_kernel, every product (conv1, the 3x3,
// conv3, the projection) on wgmma with the weights streamed by TMA; one
// template on the width of its products (kN = 64 for Bottleneck widths up
// to 64: the flagship ResNet-50, HRNet, ResNet-50-DUC; kN = 128 for widths
// 65-128: the wide ResNets) and on the compute type:
//   bf16: one wgmma m64nNk16 per k16 step, bf16 operands, f32 sums;
//   f32:  3xTF32, three wgmma m64nNk8 .tf32 per k8 step into one f32 sum,
//         a_lo.b_hi, a_hi.b_lo, then a_hi.b_hi, with hi = tf32(v) and lo =
//         tf32(v - hi) (cvt.rna): the dropped a_lo.b_lo and lo's own
//         rounding leave ~2^-22 of each product.  The tensor cores add
//         each wgmma's sum into the f32 accumulator rounding toward zero,
//         not to nearest, so the error is biased and grows with K: mean
//         error 1.8-4.7e-7 of max|out| at the layer1s (the 3x3 at width
//         128, K = 1152, the largest), ~10x what rounding to nearest
//         would give, max 2-6e-6 (scripts/k2_f32_error.py replays both
//         roundings; the kernel sits near the one toward zero), within
//         the f32 contract of 1e-4 max and 1e-6 mean.  Handing f32 bits
//         to the tensor cores as they are would drop their low 13 bits
//         (one TF32 product: ~3e-4 of the output, outside that contract).
//         Its operation bound is 3 tf32 products per f32 product at 495
//         TFLOP/s, ~165 TFLOP/s of f32 work (the CUDA cores: 67).
// With the products on wgmma, what the design still moves (the f32 carry
// read twice, each tile's halo, an SE block's input read once more by its
// sums pass) and the activations' global memory latency set the pace of
// bf16; f32's products are ~6x as long, and take a larger share.
//
// Design.  The TPU kernel keeps a whole 64x48x256 sample in VMEM (~1.5 MB);
// a Hopper block has 227 KB of shared memory.  So each thread block owns one
// sample and a tile of TH rows by TW columns of it:
//   A. m1 on the tile's halo (the tile and a 1-pixel ring on all four sides,
//      (TH+2) x (TW+2)) goes to shared memory [pixel][channel] in the
//      compute type; ring pixels outside the image stay zero;
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
// Wider maps are cut into 2-D tiles of 32 or 64 columns (f32 at width 128:
// also 16), whose rows are spans of TW (+2) pixels.  The wrapper
// (ops/bottleneck_chain.launch_plan) picks TH and TW; bottleneck_smem_bytes
// checks them against these limits and gives the shared memory they need.
// A launch's grid is (tiles, batch).
//
// Width.  Every output channel of the 3x3 reads every m1 channel of the
// halo, and m2 overwrites m1 in place once the 3x3 is done, so one pass of
// the 3x3 covers all `width` output channels.  m1 in f32 at width 128 is
// 544 B a pixel: that instance takes tiles of up to 128 pixels (two
// consumer warpgroups) with m1 in up to 180 pixels (8 x 16 tiles at 64x48);
// the others take up to 192 pixels (three) in up to 320.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;      // one block's shared memory (227 KB)

constexpr int cmax(int a, int b) { return a > b ? a : b; }

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

// ---- the block kernel (wgmma, both compute types, every width) -------------
//
// One block of threads takes one tile of up to kBand pixels with kWG + 1
// warpgroups: warpgroups 0 .. kWG - 1 compute, warpgroup w on tile pixels
// 64w .. 64w + 63 with its 64 x kN f32 sums in registers (kN / 2 per
// thread); warpgroup kWG is the producer, and hands its registers to the
// consumers (setmaxnreg).  kWG = 3 (kBand = 192: 4 whole rows of the 64x48
// map) but for f32 at kN = 128, whose m1 takes 544 B a pixel: kWG = 2
// (kBand = 128: 8 x 16 tiles of the 64x48 map).  kN is the width of every
// product: 64 at Bottleneck widths up to 64, 128 at widths 65-128; a
// narrower width reads as zeros past its end.  Every weight reaches shared
// memory as chunks in a ring of kStages stages: the producer's thread 0
// waits until the stage is free (its `empty` mbarrier: every consumer warp
// arrives after its last wgmma on it), then asks TMA for the chunk's boxes
// through the weight's tensor map, completing on the stage's `full`
// mbarrier; out-of-range rows and columns read as zeros.  So the weights of
// tap t + 1 are in flight while tap t is multiplied.
//   bf16: chunks of [K][kN channels] (K = 64 for w1 and wd, kN for w2's
//         taps and w3) in boxes of [K][64 channels]: TMA reads the folded
//         weights as they are ([K][N], N contiguous) and writes them with
//         the 128-byte swizzle, the MN-major layout that wgmma reads B in
//         (`imm-trans-b`), so nothing transposes them;
//   f32:  tf32 wgmma reads B only K-major, so the wrapper packs each weight
//         once (ops/bottleneck_chain.pack_tf32): split into tf32 hi and
//         lo, transposed to [N][K] (K contiguous, each k8 group in the order
//         0, 2, 4, 6, 1, 3, 5, 7, so that one 8-byte load gives a thread
//         the two k of its A fragment).  A chunk is K = 32 (128 B of f32: a
//         swizzled row) of hi and of lo, two boxes of [kN][32].
//
// The chunks, in the order both sides walk them (f32: each cut in K = 32):
//   A. per round of up to kBand halo pixels, per kKX input channels: w1;
//   B. per 3x3 tap: w2[tap] (K = kN);
//   C. per pass of kN output channels: w3, then per kKX input channels wd
//      (none in the SE sums pass, which ends after B).
// Products: wgmma.mma_async with N = kN and f32 sums, A from registers, B
// from the stage by descriptor.  bf16: m64nNk16, A by ldmatrix from a
// [pixel][channel] bf16 tile.  f32: m64nNk8 .tf32 three times per k8 step
// (a_lo . b_hi, a_hi . b_lo, a_hi . b_hi), A by 8-byte loads from a
// [pixel][channel] f32 tile, split into hi and lo in registers.  The 3x3's
// A rows are the halo at pixel + shift.  Activations are staged by the
// consumers: x with 16-byte loads where its rows allow (whole rows,
// aligned), in the compute type in shared memory [pixel][kKX channels].
// Biases and the SE gate sit in shared memory, m1 and m2 are stored with
// stmatrix (bf16) or 8-byte stores (f32), and part of the identity is
// loaded before conv3, so that its latency hides behind the product.  The
// numerics are those of the plain version: operands rounded to bf16 where
// the plain version rounds them (f32: nothing but the products rounded),
// f32 sums, biases and carry, the zero pad after the relu, per-tile SE sums
// in a fixed order.  Row pitches of m1, m2 and the x tile are 8 elements
// past their channels: ldmatrix rows and f32 fragment loads and stores hit
// distinct banks.
//
// Residency: one block of threads per SM for every instance.  At kN = 128
// every block of threads streams ~420 KB of bf16 weights per tile, and the
// ring (3 stages of 32 KB) and m1 (272 B a pixel) take ~213 KB.  At kN =
// 64 the products are a third of that, and the activations' global latency
// (staging x, the identity's loads, the epilogue's stores) sets the pace.
// The bf16 64 instance's shared memory (4 stages of 8 KB, m1 at 144 B a
// pixel: ~107 KB for the 64x48 map's bands) would let two blocks of
// threads share an SM, but each would then have 32,768 registers, 64 a
// thread at launch: ptxas spills and serializes the wgmma, and there is no
// room to load the identity ahead; built so, it measured slower on the
// H100 (PERF.md).  The f32 instances take 213-226 KB (rings of 4 x 16 KB
// or 3 x 32 KB, m1 in f32).  The consumers run at 160 registers (232 where
// kWG = 2), holding the next x chunk and the identity while the products
// run.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

namespace hopper {

// The instance whose products are kN channels wide in compute type TC_
// (__nv_bfloat16, or float: 3xTF32).
template <int kN_, typename TC_>
struct Shape {
  static constexpr int kN = kN_;
  using TC = TC_;
  static_assert(kN == 64 || kN == 128, "products of 64 or 128 channels");
  static constexpr bool kF32 = sizeof(TC) == 4;
  static constexpr int kES = sizeof(TC);              // bytes of an element of m1, m2, x
  static constexpr int kWG = kF32 && kN == 128 ? 2 : 3;  // consumer warpgroups
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
  static constexpr int kWarpsC = kConsumers / 32;
  static constexpr int kBand = 64 * kWG;              // tile pixels: kWG x m64
  // (th + 2) * (tw + 2): m1 on the tile and its ring
  static constexpr int kStore = kF32 && kN == 128 ? 180 : 320;
  static constexpr int kKX = kF32 && kN == 128 ? 32 : 64;  // x channels per staged chunk
  static constexpr int kXP = kKX + 8;                 // x tile row pitch
  static constexpr int kJ = kN / 8;                   // n8 blocks: 4 kJ sums a thread
  static constexpr int kP = kN + 8;                   // m1 / m2 row pitch
  static constexpr int kStages = kN == 64 ? 4 : 3;
  // bf16: kN / 64 boxes of [K = kN][64 n] (w1 and wd: K = 64); f32: the hi
  // and the lo box of [kN n][32 k], kBox bytes each
  static constexpr int kBox = kN * 32 * 4;
  static constexpr int kStageBytes = kF32 ? 2 * kBox : (kN / 64) * kN * 64 * 2;
  // the identity's fragment rows held in registers: at kN = 128 the first
  // row, loaded before conv3; at kN = 64 both, loaded during the pass before
  static constexpr int kIdnRows = kN == 64 ? 2 : 1;
  // registers per thread after setmaxnreg (launched at 65536 / kThreads,
  // rounded down to 8: 128 or 168): the producer gives up what the
  // consumers' sums, A fragments and the loads held ahead need
  static constexpr int kProducerRegs = kWG == 3 ? 32 : 40;
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : 232;
  static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536, "one SM's registers");
  // shared memory after aligning to 1024 B (the swizzle's period):
  // [ring][x tile][SE sums][biases][mbarriers][m1 / m2]; the biases: b1, b2,
  // then b3, bd and the SE gate of the even passes of conv3, then of the
  // odd ones
  static constexpr int kXOff = kStages * kStageBytes;
  static constexpr int kRedOff = kXOff + kBand * kXP * kES;
  static constexpr int kBiasOff = kRedOff + kWarpsC * kN * 4;
  static constexpr int kBarOff = kBiasOff + 8 * kN * 4;
  static constexpr int kM1Off = kBarOff + 64;
  static_assert(2 * kStages * 8 <= 64, "the mbarriers");
};

template <class S>
bool tile_fits(int th, int tw) {
  return th * tw <= S::kBand && (th + 2) * (tw + 2) <= S::kStore;
}

template <class S>
size_t smem_bytes(int th, int tw) {
  return 1024 + S::kM1Off + (size_t)S::kES * (th + 2) * (tw + 2) * S::kP;
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

// f32: the hi and the lo box of a weight chunk (planes z and z + 1 of the
// packed weight, its rows c_n .. c_n + kN - 1, K from c_k: [kN][32] f32
// each) into dst and dst + box, completing on bar.
__device__ __forceinline__ void tma_split_chunk(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                                int c_n, int c_k, int z, uint32_t box) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  mbar_expect_tx(bar, 2 * box);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst + h * box),
        "l"(m), "r"(bar), "r"(c_k), "r"(c_n), "r"(z + h)
        : "memory");
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

// f32 (3xTF32).  wgmma descriptor of a K-major B tile with the 128-byte
// swizzle: rows of 32 f32 of K (128 B), 8-row groups 1024 B apart (the
// leading byte offset is unused); k8 step s of a row starts 32 s B in.
__device__ __forceinline__ uint64_t k_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// v = hi + lo + r, hi and lo tf32 (cvt.rna: nearest, ties away from zero;
// hi's low 13 bits cleared, as lo = v - hi needs them), |r| <= 2^-22 |v|
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(v));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(v - __uint_as_float(h)));
  hi = h, lo = l;
}

__device__ __forceinline__ float2 lds64(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

// d += A . B over one k8 step in tf32: m64n64k8 (32 sums a thread) and
// m64n128k8 (64); A's fragment: a[0] (row gid, k tig), a[1] (gid + 8, tig),
// a[2] (gid, tig + 4), a[3] (gid + 8, tig + 4) of the warp's 16 rows
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
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

template <class S>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(S::kConsumers) : "memory");
}

// The ring as each side walks it: chunk i sits in stage i % kStages and
// fills for the (i / kStages)-th time.
template <class S>
struct Ring {
  uint32_t base, full, empty;  // stage 0, its full and empty mbarriers (8 B apart per stage)
  int i = 0;
  __device__ __forceinline__ int stage() const { return i % S::kStages; }
  __device__ __forceinline__ uint32_t parity() const { return (i / S::kStages) & 1; }
  __device__ __forceinline__ uint32_t full_bar() const { return full + 8 * stage(); }
  __device__ __forceinline__ uint32_t empty_bar() const { return empty + 8 * stage(); }
  __device__ __forceinline__ uint32_t data() const { return base + S::kStageBytes * stage(); }
};

// One bf16 chunk on the consumer side: wait for it, then (if this
// warpgroup has rows) acc += A . chunk over ksteps k16 steps, A's rows from
// this lane's ldmatrix address a_addr (k offset 0), then release the stage.
template <class S, int kN = S::kN>
__device__ __forceinline__ void consume(Ring<S>& r, float (&acc)[kN / 2], bool active,
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

// One f32 chunk (K = 32) on the consumer side: wait for it, then (if this
// warpgroup has rows) acc += A . chunk in 3xTF32 over its 4 k8 steps, per
// step a_lo . b_hi, a_hi . b_lo, then a_hi . b_hi (the small terms first),
// then release the stage.  A: this thread's fragment rows gid and gid + 8
// at lo_addr and hi_addr (f32, channel 2 tig of the chunk); the packed
// k8 groups of B hold channels 0, 2, 4, 6, 1, 3, 5, 7, so the 8-byte load
// of channels 2 tig and 2 tig + 1 gives fragment columns tig and tig + 4.
template <class S, int kN = S::kN>
__device__ __forceinline__ void consume_tf32(Ring<S>& r, float (&acc)[kN / 2], bool active,
                                             uint32_t lo_addr, uint32_t hi_addr, Timers& k2c) {
  K2_MARK(t0);
  mbar_wait(r.full_bar(), r.parity());
  K2_ADD(kTWait, t0);
  K2_MARK(t1);
  if (active) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float2 u = lds64(lo_addr + 32 * s), v = lds64(hi_addr + 32 * s);
      split_tf32(u.x, ah[s][0], al[s][0]);
      split_tf32(v.x, ah[s][1], al[s][1]);
      split_tf32(u.y, ah[s][2], al[s][2]);
      split_tf32(v.y, ah[s][3], al[s][3]);
    }
    const uint32_t b_hi = r.data(), b_lo = b_hi + S::kBox;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_tf32(acc, al[s], k_desc(b_hi + 32 * s));
      wgmma_tf32(acc, ah[s], k_desc(b_lo + 32 * s));
      wgmma_tf32(acc, ah[s], k_desc(b_hi + 32 * s));
    }
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
// kKX - 1 of x (zero past cin), for xs [kBand][kXP] in the compute type, in
// two steps: load (into registers) and store.  An item is 8 pixels of a
// channel pair, kItems items a thread (2, or 1 where kWG = 2), all in
// registers at a time; neighbouring lanes take neighbouring pairs, so the
// shared stores fall in distinct banks.  Where the 8 pixels are one
// aligned span (whole rows), each lane reads 32 contiguous bytes of a
// channel (one sector) with 16-byte loads (one load for bf16 x).
template <class S, bool kRows, typename TI>
struct XTile {
  using TC = typename S::TC;
  static constexpr int kBand = S::kBand, kKX = S::kKX, kXP = S::kXP, kConsumers = S::kConsumers;
  static constexpr int kVec = 16 / sizeof(TI);  // pixels of one 16-byte load
  static constexpr int kItems = (kBand / 8) * (kKX / 2) / kConsumers;
  static_assert(kItems * kConsumers == (kBand / 8) * (kKX / 2), "whole items a consumer thread");
  float v[kItems][2][8];

  __device__ __forceinline__ void load(const TI* x, int HW, const PixMap& m, int q0, int rows,
                                       int k0, int cin) {
    const bool vec = kRows && HW % kVec == 0 && (m.lin0 + q0) % kVec == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
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

  __device__ __forceinline__ void store(TC* xs) const {
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int i = threadIdx.x + u * kConsumers;
      const int p = 8 * (i / (kKX / 2)), c = 2 * (i % (kKX / 2));
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if constexpr (S::kF32)
          *reinterpret_cast<float2*>(xs + (p + t) * kXP + c) = make_float2(v[u][0][t], v[u][1][t]);
        else
          *reinterpret_cast<__nv_bfloat162*>(xs + (p + t) * kXP + c) =
              __floats2bfloat162_rn(v[u][0][t], v[u][1][t]);
      }
    }
  }

  __device__ __forceinline__ void stage(TC* xs, const TI* x, int HW, const PixMap& m,
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

// Store relu(acc + bias) of this thread's fragment row gid + 8 h as f32,
// 8-byte stores of channels 8 j + 2 tig and + 1; row_addr: the row at
// channel 2 tig.
template <int kJ>
__device__ __forceinline__ void store_row_f32(const float (&acc)[4 * kJ], const float (&bv)[2 * kJ],
                                              int h, uint32_t row_addr) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(row_addr + 32 * j),
                 "f"(fmaxf(acc[4 * j + 2 * h] + bv[2 * j], 0.f)),
                 "f"(fmaxf(acc[4 * j + 2 * h + 1] + bv[2 * j + 1], 0.f))
                 : "memory");
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

// Tensor maps, bf16: w1 [cin][width], w2 [9][width][width], w3
// [width][cout], wd [cin][cout] (w3's map where there is no projection);
// f32: the packed w1 [2][width][cin], w2 [9 * 2][width][width], w3
// [2][cout][width], wd [2][cout][cin] (K padded to 8).  kSums: the SE sums
// pass (phases A and B, then m2's channel sums; w3 and wd unread).
template <int kN, typename TC, bool kRows, typename TI, typename TO, bool kSums>
__global__ void __launch_bounds__(Shape<kN, TC>::kThreads, 1)
    bottleneck_block_wgmma_kernel(BlockArgs a, const __grid_constant__ CUtensorMap tm_w1,
                                  const __grid_constant__ CUtensorMap tm_w2,
                                  const __grid_constant__ CUtensorMap tm_w3,
                                  const __grid_constant__ CUtensorMap tm_wd) {
  using S = Shape<kN, TC>;
  constexpr bool kF32 = S::kF32;
  constexpr int kJ = S::kJ, kP = S::kP, kXP = S::kXP, kKX = S::kKX, kBand = S::kBand;
  constexpr int kConsumers = S::kConsumers, kIdnRows = S::kIdnRows;
  extern __shared__ __align__(1024) unsigned char wgmma_smem[];
  unsigned char* base = wgmma_smem + ((1024 - (smem_u32(wgmma_smem) & 1023)) & 1023);
  TC* xs = reinterpret_cast<TC*>(base + S::kXOff);
  float* red = reinterpret_cast<float*>(base + S::kRedOff);
  float* bias_s = reinterpret_cast<float*>(base + S::kBiasOff);
  TC* m1s = reinterpret_cast<TC*>(base + S::kM1Off);
  const uint32_t bars = smem_u32(base + S::kBarOff);
  Ring<S> ring{smem_u32(base), bars, bars + 8 * S::kStages};

  const int tid = threadIdx.x;
  const Tile g = tile_of(a, blockIdx.x);
  const int width = a.width, cin = a.cin, cout = a.cout;
  const int rounds = (g.nhalo + kBand - 1) / kBand;
  const int kchunks = (cin + kKX - 1) / kKX, passes = kSums ? 0 : (cout + kN - 1) / kN;
  const bool proj = a.wd != nullptr, se = a.gate != nullptr;

  if (tid == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, S::kWarpsC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  Timers k2c = {};
  K2_MARK(t_all);

  if (tid >= kConsumers) {
    // ---- the producer: thread 0 of warpgroup kWG walks the chunks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(S::kProducerRegs));
    if (tid != kConsumers) return;
    if constexpr (kF32) {
      // chunks of K = 32 (z: the plane of hi; lo is z + 1)
      auto issue = [&](const CUtensorMap* map, int c_n, int c_k, int z) {
        K2_MARK(t0);
        mbar_wait(ring.empty_bar(), ring.parity() ^ 1);
        K2_ADD(kTProdWait, t0);
        tma_split_chunk(ring.data(), map, ring.full_bar(), c_n, c_k, z, S::kBox);
        ++ring.i;
      };
      for (int r = 0; r < rounds; ++r)
        for (int k = 0; k < kKX * kchunks; k += 32) issue(&tm_w1, 0, k, 0);
      for (int tap = 0; tap < 9; ++tap)
        for (int k = 0; k < kN; k += 32) issue(&tm_w2, 0, k, 2 * tap);
      for (int np = 0; np < passes; ++np) {
        for (int k = 0; k < kN; k += 32) issue(&tm_w3, kN * np, k, 0);
        if (proj)
          for (int k = 0; k < kKX * kchunks; k += 32) issue(&tm_wd, kN * np, k, 0);
      }
    } else {
      auto issue = [&](const CUtensorMap* map, int c_n, int c_k, int tap, uint32_t box) {
        K2_MARK(t0);
        mbar_wait(ring.empty_bar(), ring.parity() ^ 1);
        K2_ADD(kTProdWait, t0);
        tma_chunk<kN / 64>(ring.data(), map, ring.full_bar(), c_n, c_k, tap, box);
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
    }
    K2_ADD(kTProdAll, t_all);
    K2_FLUSH(kTProdWait, kTimers);
    return;
  }

  // ---- the consumers: warpgroup wg, its warp wq (rows 16 wq .. 16 wq + 15
  // of the warpgroup's 64), fragment rows gid and gid + 8, channel pair tig
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(S::kConsumerRegs));
  const int b = blockIdx.y, HW = a.h * a.w, npix = g.npix;
  const int lane = tid & 31, wg = tid >> 7, wq = (tid >> 5) & 3, gid = lane >> 2, tig = lane & 3;
  const int row0 = 64 * wg + 16 * wq;  // this warp's first row of the tile
  // A's row and channel: bf16, this lane's ldmatrix row; f32, this thread's
  // first fragment row (the second is a_row + 8) and its channel pair
  const int a_row = kF32 ? row0 + gid : row0 + (lane & 15);
  const int a_k = kF32 ? 2 * tig : 8 * (lane >> 4);
  const TI* x = static_cast<const TI*>(a.x) + (size_t)b * cin * HW;
  float acc[4 * kJ];
  // f32: acc += A . the next kext / 32 chunks, A's fragment rows (a_row and
  // a_row + 8) at lo and hi, at channel a_k of the first chunk
  auto products_f32 = [&](bool active, uint32_t lo, uint32_t hi, int kext) {
    for (int k = 0; k < kext; k += 32) consume_tf32(ring, acc, active, lo + 4 * k, hi + 4 * k, k2c);
  };

  {
    K2_MARK(t0);
    for (int i = tid; i < (a.th + 2) * g.pitch * (kP * S::kES / 16); i += kConsumers)
      reinterpret_cast<uint4*>(m1s)[i] = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < 2 * kN; i += kConsumers)  // b1 and b2, zero past the width
      bias_s[i] = i % kN < width ? (i < kN ? a.b1 : a.b2)[i % kN] : 0.f;
    K2_ADD(kTEpiA, t0);
  }

  // ---- A: m1 = relu(x . w1 + b1) on the halo, in rounds of up to kBand
  // pixels; each x chunk's loads fly while the chunk before it is multiplied
  XTile<S, kRows, TI> xt;
  const int steps = rounds * kchunks;
  xt.load(x, HW, g.halo, 0, min(kBand, g.nhalo), 0, cin);
  for (int it = 0; it < steps; ++it) {
    const int r = it / kchunks, kc = it % kchunks;
    const int q0 = kBand * r, rows = min(kBand, g.nhalo - q0);
    if (kc == 0) zero(acc);
    K2_MARK(t0);
    consumers_sync<S>();  // every read of the previous x tile is done
    xt.store(xs);
    consumers_sync<S>();
    if (it + 1 < steps) {
      const int q1 = kBand * ((it + 1) / kchunks);
      xt.load(x, HW, g.halo, q1, min(kBand, g.nhalo - q1), kKX * ((it + 1) % kchunks), cin);
    }
    K2_ADD(kTStage, t0);
    const uint32_t xs_a = smem_u32(xs + a_row * kXP + a_k);
    if constexpr (kF32)
      products_f32(64 * wg < rows, xs_a, xs_a + 8 * kXP * 4, kKX);
    else
      consume(ring, acc, 64 * wg < rows, xs_a, kKX / 16, 64 * kKX * 2, k2c);
    if (kc + 1 < kchunks) continue;
    K2_MARK(t_epi);
    float bv[2 * kJ];
    load_bias<kJ>(bv, bias_s, tig);
    if constexpr (kF32) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = a_row + 8 * h;
        if (q < rows) store_row_f32<kJ>(acc, bv, h, smem_u32(m1s + halo_m1(g, q0 + q) * kP + a_k));
      }
    } else {
      const int q = row0 + 8 * ((lane >> 3) & 1) + (lane & 7);
      const uint32_t row = q < rows ? smem_u32(m1s + halo_m1(g, q0 + q) * kP) : smem_u32(red);
      store_rows_bf16<kJ>(acc, bv, row, q < rows);
    }
    K2_ADD(kTEpiA, t_epi);
  }
  {
    K2_MARK(t0);
    consumers_sync<S>();  // m1 is complete
    K2_ADD(kTSync, t0);
  }

  // ---- B: m2 = relu(3x3(m1) + b2): per tap, A rows are the halo at pixel + shift
  zero(acc);
  const bool x_once = proj && cin <= kKX;  // the projection's x tile is staged once
  if constexpr (kF32) {
    const uint32_t lo = smem_u32(m1s + band_m1(g, min(a_row, npix - 1)) * kP + a_k);
    const uint32_t hi = smem_u32(m1s + band_m1(g, min(a_row + 8, npix - 1)) * kP + a_k);
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = 4 * kP * ((tap / 3) * g.pitch + tap % 3);
      products_f32(64 * wg < npix, lo + shift, hi + shift, kN);
    }
  } else {
    const uint32_t m1_row = smem_u32(m1s + band_m1(g, min(a_row, npix - 1)) * kP + a_k);
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * g.pitch + tap % 3;
      consume(ring, acc, 64 * wg < npix, m1_row + 2 * kP * shift, kN / 16, 64 * kN * 2, k2c);
    }
  }
  K2_MARK(t_sync);
  consumers_sync<S>();  // every read of m1 is done: m2 overwrites it
  K2_ADD(kTSync, t_sync);
  if constexpr (kSums) {
    // ---- the SE sums pass: this tile's channel sums of m2 as conv3 reads
    // it (rounded to the compute type), per warp over its 16 rows (the xor
    // tree over the lanes of one channel pair), then the warps of a channel
    // in a fixed order (deterministic, no atomics)
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
            s += rnd<TC>(fmaxf(acc[4 * j + 2 * h + e] + bv[2 * j + e], 0.f));
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (gid == 0) red[(tid >> 5) * kN + 8 * j + 2 * tig + e] = s;
      }
    consumers_sync<S>();
    if (tid < width) {
      float s = red[tid];
#pragma unroll
      for (int w = 1; w < S::kWarpsC; ++w) s += red[w * kN + tid];
      a.partial[((size_t)b * a.tiles + blockIdx.x) * width + tid] = s;
    }
    K2_ADD(kTSe, t_sums);
    K2_ADD(kTAll, t_all);
    K2_FLUSH(kTWait, kTProdWait);
    return;
  }
  K2_MARK(t_m2);
  TC* m2s = m1s;   // [tile pixel][kP]
  {
    float bv[2 * kJ];
    load_bias<kJ>(bv, bias_s + kN, tig);
    if constexpr (kF32) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (a_row + 8 * h < npix)
          store_row_f32<kJ>(acc, bv, h, smem_u32(m2s + (a_row + 8 * h) * kP + a_k));
    } else {
      const int p = row0 + 8 * ((lane >> 3) & 1) + (lane & 7);
      store_rows_bf16<kJ>(acc, bv, p < npix ? smem_u32(m2s + p * kP) : smem_u32(red), p < npix);
    }
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
    consumers_sync<S>();
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
    for (int i = tid; i < 3 * kN; i += kConsumers) {
      const int k = i / kN, n = n0 + i % kN;
      const float* src = k == 0 ? a.b3 : k == 1 ? (proj ? a.bd : nullptr) : gate;
      pass_bias[i] = n < cout && src != nullptr ? src[n] : 0.f;
    }
    // the identity's first row loaded before conv3, so that its latency
    // hides there
    if (kIdnRows == 1 && !proj) load_identity(n0);
    zero(acc);
    if constexpr (kF32)
      products_f32(active, smem_u32(m2s + min(a_row, npix - 1) * kP + a_k),
                   smem_u32(m2s + min(a_row + 8, npix - 1) * kP + a_k), kN);
    else
      consume(ring, acc, active, smem_u32(m2s + min(a_row, npix - 1) * kP + a_k), kN / 16,
              64 * kN * 2, k2c);
    consumers_sync<S>();  // the pass's biases are in place
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
      // identity = x . wd + bd, x's tile staged in the compute type per kKX
      // channels
      for (int kc = 0; kc < kchunks; ++kc) {
        if (!x_once) {
          K2_MARK(t0);
          xt.load(x, HW, g.band, 0, npix, kKX * kc, cin);
          consumers_sync<S>();
          xt.store(xs);
          consumers_sync<S>();
          K2_ADD(kTStage, t0);
        }
        if constexpr (kF32)
          products_f32(active, xs_row, xs_row + 8 * kXP * 4, kKX);
        else
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

// A packed f32 weight [planes][N][K] (ops/bottleneck_chain.pack_tf32; K
// innermost, a multiple of 8) as a tensor map with boxes of 32 K by box_n
// rows of one plane and the 128-byte swizzle; rows past N read as zeros.
bool split_map(CUtensorMap* map, const void* w, const cuuint64_t* dims, cuuint32_t box_n) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(w) % 16 != 0 || dims[0] % 8 != 0) return false;
  const cuuint64_t strides[2] = {4 * dims[0], 4 * dims[0] * dims[1]};
  const cuuint32_t box[3] = {32, box_n, 1}, steps[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(w), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The f32 instances' packed weights (ops/bottleneck_chain.pack_tf32), null
// in bf16: w1 [2][width][cin8], w2 [18][width][width8], w3 [2][cout][width8],
// wd [2][cout][cin8] or null (cin8, width8: cin and width padded to 8).
struct Packed {
  const void *w1, *w2, *w3, *wd;
};

constexpr cuuint64_t pad8(int v) { return (cuuint64_t)((v + 7) / 8 * 8); }

// The most dynamic shared memory for `kernel`.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int kN, typename TC, bool kRows, typename TI, bool kSums>
cudaError_t launch_wgmma(const BlockArgs& a, const Packed& p, int batch, bool out_bf16,
                         cudaStream_t s) {
  using S = hopper::Shape<kN, TC>;
  const cuuint64_t width = a.width, cin = a.cin, cout = a.cout;
  CUtensorMap m1, m2, m3{}, md{};  // the sums pass reads neither w3 nor wd
  if constexpr (S::kF32) {
    const cuuint64_t d1[3] = {pad8(a.cin), width, 2}, d2[3] = {pad8(a.width), width, 18},
                     d3[3] = {pad8(a.width), cout, 2}, dd[3] = {pad8(a.cin), cout, 2};
    if (!split_map(&m1, p.w1, d1, kN) || !split_map(&m2, p.w2, d2, kN)) return cudaErrorInvalidValue;
    if (!kSums && (!split_map(&m3, p.w3, d3, kN) ||
                   !split_map(&md, p.wd ? p.wd : p.w3, p.wd ? dd : d3, kN)))
      return cudaErrorInvalidValue;
  } else {
    const cuuint64_t d1[2] = {width, cin}, d2[3] = {width, width, 9}, d3[2] = {cout, width},
                     dd[2] = {cout, cin};
    if (!weight_map(&m1, a.w1, 2, d1, S::kKX) || !weight_map(&m2, a.w2, 3, d2, kN))
      return cudaErrorInvalidValue;
    if (!kSums && (!weight_map(&m3, a.w3, 2, d3, kN) ||
                   !weight_map(&md, a.wd ? a.wd : a.w3, 2, a.wd ? dd : d3, S::kKX)))
      return cudaErrorInvalidValue;
  }
  // the sums pass stores no output, and f32 compute writes f32: their one
  // instance has an f32 output type
  auto kernel = hopper::bottleneck_block_wgmma_kernel<kN, TC, kRows, TI, float, kSums>;
  if constexpr (!kSums && !S::kF32) {
    if (out_bf16)
      kernel = hopper::bottleneck_block_wgmma_kernel<kN, TC, kRows, TI, __nv_bfloat16, false>;
  }
  const size_t smem = hopper::smem_bytes<S>(a.th, a.tw);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.tiles, batch), S::kThreads, smem, s>>>(a, m1, m2, m3, md);
  return cudaGetLastError();
}

// The compute type and the width pick the instance: products 64 channels
// wide up to width 64, 128 above; bf16 or f32 (3xTF32; f32 x and output
// only); tiles of whole rows or 2-D tiles; kSums: the SE sums pass (it
// writes no output, so its output type is f32).
template <typename TC, typename TI, bool kSums>
cudaError_t launch_typed(const BlockArgs& a, const Packed& p, int batch, bool out_bf16,
                         cudaStream_t s) {
  const bool rows = a.tw == a.w;
  if (a.width <= 64)
    return rows ? launch_wgmma<64, TC, true, TI, kSums>(a, p, batch, out_bf16, s)
                : launch_wgmma<64, TC, false, TI, kSums>(a, p, batch, out_bf16, s);
  return rows ? launch_wgmma<128, TC, true, TI, kSums>(a, p, batch, out_bf16, s)
              : launch_wgmma<128, TC, false, TI, kSums>(a, p, batch, out_bf16, s);
}

template <bool kSums>
cudaError_t launch_block(const BlockArgs& a, const Packed& p, int batch, bool x_bf16,
                         bool c_bf16, bool out_bf16, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (c_bf16)
    return x_bf16 ? launch_typed<bf16, bf16, kSums>(a, p, batch, out_bf16, s)
                  : launch_typed<bf16, float, kSums>(a, p, batch, out_bf16, s);
  return launch_typed<float, float, kSums>(a, p, batch, false, s);
}

template <typename K>
int occupancy(K kernel, int threads, int smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess)
    return 0;
  return n;
}

template <int kN, typename TC, bool kRows>
int blocks_per_sm(int smem) {
  const auto kernel = hopper::bottleneck_block_wgmma_kernel<kN, TC, kRows, float, float, false>;
  return allow_smem(kernel, smem) == cudaSuccess
             ? occupancy(kernel, hopper::Shape<kN, TC>::kThreads, smem)
             : 0;
}

// The shared memory of the instance S for th x tw tiles, 0 beyond its limits.
template <class S>
size_t fit_bytes(int th, int tw) {
  return hopper::tile_fits<S>(th, tw) ? hopper::smem_bytes<S>(th, tw) : 0;
}

}  // namespace

extern "C" {

// Shared memory bytes of one block of threads for tiles of th rows by tw
// columns at Bottleneck width `width` (bf16 compute if c_bf16, else f32);
// 0 if that tile or width is beyond the kernel's limits (width <= 128;
// th * tw <= Shape::kBand and (th + 2) * (tw + 2) <= Shape::kStore of the
// instance: 192 and 320, but 128 and 180 for f32 at widths 65-128).
int bottleneck_smem_bytes(int th, int tw, int width, int c_bf16) {
  using bf16 = __nv_bfloat16;
  using hopper::Shape;
  if (th < 1 || tw < 1 || width < 1 || width > 128) return 0;
  const size_t bytes = width <= 64 ? (c_bf16 ? fit_bytes<Shape<64, bf16>>(th, tw)
                                             : fit_bytes<Shape<64, float>>(th, tw))
                                   : (c_bf16 ? fit_bytes<Shape<128, bf16>>(th, tw)
                                             : fit_bytes<Shape<128, float>>(th, tw));
  return bytes <= (size_t)kMaxSmem ? (int)bytes : 0;
}

// Blocks of threads that fit on one SM (the occupancy calculator) for the
// instance a launch with these tiles runs (f32 x and output; rows: the
// tiles span whole rows); 0 if the tile is beyond the kernel's limits.
int bottleneck_blocks_per_sm(int th, int tw, int width, int c_bf16, int rows) {
  using bf16 = __nv_bfloat16;
  const int smem = bottleneck_smem_bytes(th, tw, width, c_bf16);
  if (smem == 0) return 0;
  if (width <= 64) {
    if (c_bf16) return rows ? blocks_per_sm<64, bf16, true>(smem) : blocks_per_sm<64, bf16, false>(smem);
    return rows ? blocks_per_sm<64, float, true>(smem) : blocks_per_sm<64, float, false>(smem);
  }
  if (c_bf16) return rows ? blocks_per_sm<128, bf16, true>(smem) : blocks_per_sm<128, bf16, false>(smem);
  return rows ? blocks_per_sm<128, float, true>(smem) : blocks_per_sm<128, float, false>(smem);
}

// One folded Bottleneck block.  x: [B, Cin, H, W] (bf16 if x_bf16, else f32);
// out: [B, Cout, H, W] (bf16 if out_bf16, else f32); f32 compute takes f32
// x and writes f32 out only.  Weights are in the compute type (bf16 if
// c_bf16, else f32), biases f32.  wd/bd and the SE
// arguments may be null.  In bf16, width and Cout must be multiples of 8
// and the weights 16-byte aligned (the tensor maps' rows).  In f32 the
// products read w1p, w2p, w3p and wdp (Packed; wdp null without wd,
// 16-byte aligned) and se_gate_kernel reads w3.
// Tiles of th x tw pixels (bottleneck_smem_bytes must take them); for an
// SE block, partial is f32 [B, tiles, width] scratch with tiles = ceil(h /
// th) * ceil(w / tw), and gate f32 [B, Cout]: the sums pass, se_gate_kernel
// and the full pass run in that order on `stream`.
// Returns cudaGetLastError() of the launches (0 on success).
int bottleneck_block_forward(const void* x, void* out, float* partial, float* gate,
                             const void* w1, const float* b1, const void* w2, const float* b2,
                             const void* w3, const float* b3, const void* wd, const float* bd,
                             const void* sf1, const float* sb1, const void* sf2,
                             const float* sb2, const void* w1p, const void* w2p,
                             const void* w3p, const void* wdp, int batch, int cin, int width,
                             int cout, int se_hidden, int h, int w, int th, int tw, int x_bf16,
                             int c_bf16, int out_bf16, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (bottleneck_smem_bytes(th, tw, width, c_bf16) == 0 || th > h || tw > w)
    return (int)cudaErrorInvalidValue;
  if (!c_bf16 && (x_bf16 || out_bf16 || w1p == nullptr || w2p == nullptr || w3p == nullptr ||
                  (wd && !wdp)))
    return (int)cudaErrorInvalidValue;
  const Packed p{w1p, w2p, w3p, wdp};
  const int tiles_w = (w + tw - 1) / tw;
  BlockArgs a{x,  out, partial, nullptr, w1, b1, w2, b2, w3, b3, wd, bd, cin, width, cout,
              h,  w,   th,      tw,      tiles_w, ((h + th - 1) / th) * tiles_w};
  cudaError_t err;
  if (sf1 != nullptr) {
    err = launch_block<true>(a, p, batch, x_bf16, c_bf16, false, stream);
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
  return (int)launch_block<false>(a, p, batch, x_bf16, c_bf16, out_bf16, stream);
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
