// jpeg_canvas: threaded JPEG -> RGB canvas batch decoder with libjpeg's
// integer arithmetic, for a host without libjpeg.
//
// The same C API and result as native/canvas_loader.cc: each image (RGB)
// pasted at the origin of a zeroed [n, canvas, canvas, 3] uint8 slot,
// cropped to the canvas.  The pixels equal libjpeg-turbo 2.1's default
// decompression bit for bit, because each stage repeats its arithmetic:
//   * the marker reader (jdmarker.c): SOF0/1/2/9/10, DHT, DAC, DQT, DRI,
//     APP0/APP14, and the skipping of bytes between markers; a file that
//     ends early reads as followed by EOI markers (jdatasrc.c).  A DHT,
//     DAC or DQT segment whose tables do not use up its length fails
//     (JERR_BAD_LENGTH), a DQT of any nonzero precision holds 16-bit
//     entries, an APPn or COM length below 2 skips nothing, and a scan may
//     not take a component twice;
//   * the standard Huffman tables (jstdhuff.c, T.81 Annex K.3): once the
//     markers up to the first SOS are read, each DC and AC slot 0 and 1
//     that no DHT has defined gets its standard table, in sequential
//     Huffman frames only (jdhuff.c), so that Motion-JPEG frames, which
//     leave their tables out, decode;
//   * every scan decodes into a whole-image coefficient buffer, so that
//     sequential files of several scans decode as single-scan ones do; a
//     single-component scan covers the component's own ceil(width / 8) x
//     ceil(height / 8) blocks, not the interleaved MCU grid (jdinput.c);
//   * Huffman decoding of sequential (jdhuff.c) and progressive (jdphuff.c)
//     scans: DC first and refine, AC first with end-of-band runs, AC refine;
//   * arithmetic decoding (jdarith.c): the Qe state machine, DC and AC
//     statistics conditioned by DAC, sequential and all four progressive
//     scan types;
//   * entropy data that runs out: once a Huffman scan needs a bit past the
//     data (the file ends or a marker comes), the MCU is finished with zero
//     bits and no further MCU of that restart interval is decoded, so the
//     rest of the image stays at its coefficients so far (mid-gray in a
//     sequential file); restart markers resynchronise as
//     jpeg_resync_to_restart does.  An arithmetic scan decodes zero bytes
//     past the data, as jdarith.c does;
//   * progressive scans checked as libjpeg checks them: a bad Ss/Se/Ah/Al
//     fails; an AC scan before the DC scan or a coefficient refined out of
//     order (which libjpeg only warns about) decodes; a scan checks only the
//     Huffman table it decodes with (the DC table of a DC first scan, none
//     in a DC refinement, the AC table of an AC scan), a sequential scan
//     both;
//   * block smoothing of a progressive file whose low coefficients are not
//     fully refined (jdcoefct.c smoothing_ok and decompress_smooth_data: the
//     5x5 DC window, the 10-coefficient form while no AC coefficient of the
//     component is known and the 6-coefficient one after, and each iMCU
//     row's coefficient precision taken from the last scan that reached it);
//   * dequantization and the "islow" integer IDCT as libjpeg-turbo's x86-64
//     SIMD code computes it (jidctint.c's 13-bit constants and 2 pass-1
//     bits in 16-bit lanes: equal to jidctint.c wherever values stay in
//     range, and to the reference build on the wild coefficients of
//     damaged files too);
//   * "fancy" triangle upsampling of h2v1, h1v2 and h2v2 chroma, with edge
//     rows replicated at the downsampled height (jdsample.c, jdmainct.c),
//     and box upsampling where the downsampled width is <= 2;
//   * YCbCr -> RGB with jdcolor.c's 16-bit fixed-point tables; grayscale is
//     replicated to RGB.
// What libjpeg refuses fails to decode (height and width 0): 12-bit and
// lossless frames, CMYK and other colour spaces without an RGB conversion,
// sampling factors that do not divide the largest one, a scan whose
// Huffman table is in no slot (progressive and arithmetic frames get no
// standard tables, and no frame gets them in slots 2 and 3).  A decode is
// libjpeg's pixels or a failure, never other pixels.
//
// C API (ctypes-friendly):
//   void* cl_create(int num_threads);
//   void  cl_destroy(void* pool);
//   int   cl_load_batch(void* pool, const char** paths, int n, int canvas,
//                       unsigned char* out,   // [n, canvas, canvas, 3], zeroed
//                       int* heights, int* widths);  // decoded dims (0 on failure)
//   Returns the number of decoded images.
//
// Build: g++ -O2 -fPIC -std=c++17 -shared jpeg_canvas.cc -o libjpeg_canvas.so -lpthread

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

using u8 = unsigned char;

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jaricom.c jpeg_aritab, the standard's Table D.2: Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 bin.
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// The tables of ITU-T T.81 Annex K.3 (K.3-K.6), as libjpeg writes them
// unoptimized and as jstdhuff.c holds them: class (0 DC, 1 AC), slot, the
// number of codes of each length 1-16, the symbols.
struct StdHuffman {
  int tc, th;
  u8 bits[16];
  u8 vals[162];
};
const StdHuffman kStdHuffman[4] = {
    // DC luminance (K.3)
    {0, 0, {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
     {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b}},
    // AC luminance (K.5)
    {1, 0, {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
     {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
      0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
      0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
      0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
      0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
      0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
      0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
      0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
      0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
      0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
      0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
      0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
      0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
      0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}},
    // DC chrominance (K.4)
    {0, 1, {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
     {0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b}},
    // AC chrominance (K.6)
    {1, 1, {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119},
     {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
      0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
      0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
      0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
      0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
      0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
      0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
      0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
      0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
      0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
      0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
      0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
      0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
      0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}},
};

struct Huffman {
  // defined: by a DHT segment or as a standard table; usable: also its codes
  // fitting their lengths; dc_usable: also its symbols all DC categories
  // 0-15.  libjpeg checks both only when a scan takes the table
  // (jpeg_make_d_derived_tbl).
  bool defined = false, usable = false, dc_usable = false;
  int maxcode[18];
  int valoffset[18];
  u8 values[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;  // coefficient buffer size in blocks (MCU-padded)
  int wb = 0, hb = 0;  // width_in_blocks, height_in_blocks (jdinput.c)
  int dw = 0, dh = 0;  // downsampled width and height (jdinput.c)
  std::vector<u8> plane;     // bw*8 x bh*8 samples
  std::vector<int16_t> coef;  // bw x bh blocks of 64 coefficients, natural order
  // the quantization table latched at the component's first scan
  uint16_t q[64] = {};
  bool latched = false;
  // libjpeg's coef_bits (the Al each coefficient was last coded with; -1
  // before its first scan) and, for coefficients 1-9, their values before
  // the component's last scan (jdphuff.c keeps them for block smoothing)
  int bits[64];
  int prev_bits[10] = {};
};

struct Jpeg {
  const u8* data = nullptr;
  size_t size = 0, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, restart = 0;
  int mcux = 0, mcuy = 0;  // the interleaved MCU grid; mcuy is total_iMCU_rows
  bool progressive = false, arith = false, multiscan = false;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  u8 dc_L[16], dc_U[16], ac_K[16];  // DAC conditioning
  Component comp[3];
  int scans = 0;          // input_scan_number
  int last_good_row = 0;  // jdcoefct.c last_good_iMCU_row
  // entropy decoder state
  int unread = 0;  // the marker code the entropy decoder ran into, if any
  bool insufficient = false;
  int next_restart = 0;
  uint64_t acc = 0;  // jdhuff.c bit buffer, left-aligned
  int nbits = 0;
  int64_t c = 0, a = 0;  // jdarith.c C and A registers
  int ct = 0;
  u8 dc_stats[16][64], ac_stats[16][256], fixed_bin[4];
};

bool read_file(const char* path, std::vector<u8>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bool ok = std::fseek(f, 0, SEEK_END) == 0;
  const long size = ok ? std::ftell(f) : -1;
  ok = ok && size > 0 && std::fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize(static_cast<size_t>(size));
    ok = std::fread(buf->data(), 1, buf->size(), f) == buf->size();
  }
  std::fclose(f);
  return ok;
}

inline int be16(const u8* p) { return (p[0] << 8) | p[1]; }

// The byte at p: the file's, then the fake EOI markers that jdatasrc.c's
// fill_input_buffer inserts once the file has ended.
inline int byte_at(const Jpeg& j, size_t p) {
  return p < j.size ? j.data[p] : ((p - j.size) & 1) ? 0xD9 : 0xFF;
}

bool build_huffman(Huffman* t, const u8* bits, const u8* vals, int count) {
  // jdhuff.c jpeg_make_d_derived_tbl: canonical codes by length
  t->dc_usable = false;
  std::memcpy(t->values, vals, count);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      t->valoffset[l] = k - code;
      code += bits[l - 1];
      k += bits[l - 1];
      t->maxcode[l] = code - 1;
    } else {
      t->maxcode[l] = -1;
    }
    if (code > (1 << l)) return false;
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;  // sentinel: ends a corrupt code
  t->dc_usable = std::all_of(vals, vals + count, [](u8 v) { return v <= 15; });
  return true;
}

// jstdhuff.c std_huff_tables, which jinit_huff_decoder calls once the
// markers up to the first SOS are read: each DC and AC slot 0 and 1 that no
// DHT has defined gets its standard table (Motion-JPEG frames leave them out).
void std_huff_tables(Jpeg* j) {
  for (const StdHuffman& s : kStdHuffman) {
    Huffman* t = s.tc ? &j->ac[s.th] : &j->dc[s.th];
    if (t->defined) continue;
    int count = 0;
    for (u8 b : s.bits) count += b;
    t->defined = true;
    t->usable = build_huffman(t, s.bits, s.vals, count);
  }
}

// jdmarker.c next_marker: skips to the next marker from j->pos and returns
// its code, with j->pos just past it.
int next_marker(Jpeg* j) {
  for (;;) {
    int c = byte_at(*j, j->pos++);
    while (c != 0xFF) c = byte_at(*j, j->pos++);
    do c = byte_at(*j, j->pos++);
    while (c == 0xFF);
    if (c != 0) return c;
  }
}

// jdmarker.c jpeg_resync_to_restart, for a marker that is not the expected
// RSTn: discard it, scan on to the next marker, or leave it for the marker
// reader (the rest of the scan then decodes no data).
void resync_to_restart(Jpeg* j, int desired) {
  int marker = j->unread;
  for (;;) {
    int action;
    if (marker < 0xC0) {
      action = 2;
    } else if (marker < 0xD0 || marker > 0xD7) {
      action = 3;
    } else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7)) {
      action = 3;
    } else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7)) {
      action = 2;
    } else {
      action = 1;
    }
    if (action == 1) {
      j->unread = 0;
      return;
    }
    if (action == 3) return;
    marker = j->unread = next_marker(j);
  }
}

// jdmarker.c read_restart_marker
void read_restart_marker(Jpeg* j) {
  if (j->unread == 0) j->unread = next_marker(j);
  if (j->unread == 0xD0 + j->next_restart) {
    j->unread = 0;
  } else {
    resync_to_restart(j, j->next_restart);
  }
  j->next_restart = (j->next_restart + 1) & 7;
}

// -- Huffman entropy decoding (jdhuff.c, jdphuff.c) ---------------------------

// jpeg_fill_bit_buffer: reads bytes up to the next marker, which it leaves
// in j->unread.
void fill(Jpeg* j) {
  while (j->unread == 0 && j->nbits <= 56) {
    int c = byte_at(*j, j->pos++);
    if (c == 0xFF) {
      do c = byte_at(*j, j->pos++);
      while (c == 0xFF);
      if (c == 0) {
        c = 0xFF;
      } else {
        j->unread = c;
        break;
      }
    }
    j->acc |= static_cast<uint64_t>(c) << (56 - j->nbits);
    j->nbits += 8;
  }
}

// n bits in the buffer; past the data they are zeros and the scan is short
// of data from here on (insufficient_data).
inline void need(Jpeg* j, int n) {
  if (j->nbits >= n) return;
  fill(j);
  if (j->nbits < n) {
    j->insufficient = true;
    j->nbits = 57;  // the zeros below the real bits
  }
}

inline int get_bits(Jpeg* j, int n) {
  if (n == 0) return 0;
  need(j, n);
  const int v = static_cast<int>(j->acc >> (64 - n));
  j->acc <<= n;
  j->nbits -= n;
  return v;
}

// jpeg_huff_decode: a code of up to 16 bits; a corrupt one takes 17 bits and
// decodes as 0, as libjpeg does after its warning.
int decode_symbol(Jpeg* j, const Huffman& t) {
  if (j->nbits < 17) fill(j);
  int code = 0;
  for (int l = 1; l <= 17; ++l) {
    if (j->nbits == 0) need(j, 1);
    code = (code << 1) | static_cast<int>(j->acc >> 63);
    j->acc <<= 1;
    --j->nbits;
    if (code <= t.maxcode[l]) return l > 16 ? 0 : t.values[(code + t.valoffset[l]) & 0xFF];
  }
  return 0;
}

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

// -- arithmetic entropy decoding (jdarith.c) -----------------------------------

// get_byte of the C register: zeros once a marker has been met
int arith_byte(Jpeg* j) {
  if (j->unread) return 0;
  int data = byte_at(*j, j->pos++);
  if (data == 0xFF) {
    do data = byte_at(*j, j->pos++);
    while (data == 0xFF);
    if (data == 0) {
      data = 0xFF;
    } else {
      j->unread = data;
      data = 0;
    }
  }
  return data;
}

// arith_decode: one binary decision with the statistics bin *st
int arith_decode(Jpeg* j, u8* st) {
  while (j->a < 0x8000) {  // renormalization and data input (D.2.6)
    if (--j->ct < 0) {
      j->c = (j->c << 8) | arith_byte(j);
      if ((j->ct += 8) < 0) {
        if (++j->ct == 0) j->a = 0x8000;  // two initial bytes read
      }
    }
    j->a <<= 1;
  }
  int sv = *st;
  int64_t qe = kAritab[sv & 0x7F];
  const int nl = static_cast<int>(qe & 0xFF);
  qe >>= 8;
  const int nm = static_cast<int>(qe & 0xFF);
  qe >>= 8;
  int64_t temp = j->a - qe;
  j->a = temp;
  temp <<= j->ct;
  if (j->c >= temp) {
    j->c -= temp;
    if (j->a < qe) {  // conditional LPS exchange
      j->a = qe;
      *st = static_cast<u8>((sv & 0x80) ^ nm);
    } else {
      j->a = qe;
      *st = static_cast<u8>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (j->a < 0x8000) {
    if (j->a < qe) {  // conditional MPS exchange
      *st = static_cast<u8>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = static_cast<u8>((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

// A DC difference (F.19-F.24): updates the DC context and returns the
// difference, or sets ct = -1 on a magnitude overflow.
int arith_dc_diff(Jpeg* j, int tbl, int* context) {
  u8* st = j->dc_stats[tbl] + *context;
  if (arith_decode(j, st) == 0) {
    *context = 0;
    return 0;
  }
  const int sign = arith_decode(j, st + 1);
  st += 2 + sign;
  int m = arith_decode(j, st);
  if (m != 0) {
    st = j->dc_stats[tbl] + 20;
    while (arith_decode(j, st)) {
      if ((m <<= 1) == 0x8000) {
        j->ct = -1;
        return 0;
      }
      st += 1;
    }
  }
  if (m < static_cast<int>((1L << j->dc_L[tbl]) >> 1)) {
    *context = 0;
  } else if (m > static_cast<int>((1L << j->dc_U[tbl]) >> 1)) {
    *context = 12 + sign * 4;
  } else {
    *context = 4 + sign * 4;
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(j, st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

// AC coefficients ss..se of one block (F.20, decode_mcu_AC_first and the
// AC part of the sequential decode_mcu); a spectral or magnitude overflow
// sets ct = -1 and stops the scan's decoding.
void arith_ac(Jpeg* j, int tbl, int ss, int se, int al, int16_t* block) {
  for (int k = ss; k <= se; ++k) {
    u8* st = j->ac_stats[tbl] + 3 * (k - 1);
    if (arith_decode(j, st)) break;  // EOB
    while (arith_decode(j, st + 1) == 0) {
      st += 3;
      if (++k > se) {
        j->ct = -1;
        return;
      }
    }
    const int sign = arith_decode(j, j->fixed_bin);
    st += 2;
    int m = arith_decode(j, st);
    if (m != 0) {
      if (arith_decode(j, st)) {
        m <<= 1;
        st = j->ac_stats[tbl] + (k <= j->ac_K[tbl] ? 189 : 217);
        while (arith_decode(j, st)) {
          if ((m <<= 1) == 0x8000) {
            j->ct = -1;
            return;
          }
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(j, st)) v |= m;
    v += 1;
    if (sign) v = -v;
    block[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
  }
}

// decode_mcu_AC_refine for one block
void arith_ac_refine(Jpeg* j, int tbl, int ss, int se, int al, int16_t* block) {
  const int p1 = 1 << al, m1 = static_cast<int>(~0u << al);
  int kex = se;
  for (; kex > 0; --kex)
    if (block[kNatural[kex]]) break;
  for (int k = ss; k <= se; ++k) {
    u8* st = j->ac_stats[tbl] + 3 * (k - 1);
    if (k > kex && arith_decode(j, st)) break;  // EOB
    for (;;) {
      int16_t* coef = block + kNatural[k];
      if (*coef) {
        if (arith_decode(j, st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
        break;
      }
      if (arith_decode(j, st + 1)) {
        *coef = static_cast<int16_t>(arith_decode(j, j->fixed_bin) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) {
        j->ct = -1;
        return;
      }
    }
  }
}

// -- the islow IDCT as libjpeg-turbo's x86-64 SIMD computes it ---------------
//
// jsimd_idct_islow_avx2 (and its SSE2 twin) is jidctint.c's algorithm in
// 16-bit lanes: the dequantized coefficients, in0 +- in4 and the odd part's
// z3 = in7 + in3 and z4 = in5 + in1 wrap to 16 bits, each pass's outputs
// saturate to 16 bits, the samples saturate to [-128, 127] before +128, and
// a block whose rows 1-7 are all zero takes pass 1 as (in0 << 2) wrapped.
// For every block whose values stay in range this equals jidctint.c; it
// differs, as the reference build does, on the wild coefficients that a
// damaged or cut file can decode into.

inline int32_t wrap16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }

inline int32_t sat16(int32_t x) { return x < -32768 ? -32768 : x > 32767 ? 32767 : x; }

// One 1-D pass over in[0], in[stride], ..., in[7 * stride].  Every sum
// fits 32 bits: the inputs are 16-bit and the largest output before the
// shift is below 1.7e9.
template <int kStride, int kShift>
inline void idct_pass(const int32_t* in, int32_t* out) {
  constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                    F2053 = 16819, F2562 = 20995, F3072 = 25172;
  const int32_t i0 = in[0], i1 = in[kStride], i2 = in[2 * kStride], i3 = in[3 * kStride],
                i4 = in[4 * kStride], i5 = in[5 * kStride], i6 = in[6 * kStride],
                i7 = in[7 * kStride];
  const int32_t tmp3 = i2 * (F0541 + F0765) + i6 * F0541;
  const int32_t tmp2 = i2 * F0541 + i6 * (F0541 - F1847);
  const int32_t tmp0 = wrap16(i0 + i4) * 8192, tmp1 = wrap16(i0 - i4) * 8192;
  const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int32_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
  const int32_t z3p = z3 * (F1175 - F1961) + z4 * F1175;
  const int32_t z4p = z3 * F1175 + z4 * (F1175 - F0390);
  const int32_t o0 = i7 * (F0298 - F0899) + i1 * -F0899 + z3p;
  const int32_t o1 = i5 * (F2053 - F2562) + i3 * -F2562 + z4p;
  const int32_t o2 = i5 * -F2562 + i3 * (F3072 - F2562) + z3p;
  const int32_t o3 = i7 * -F0899 + i1 * (F1501 - F0899) + z4p;
  constexpr int32_t round = 1 << (kShift - 1);
  auto d = [](int32_t v) { return sat16((v + round) >> kShift); };
  out[0] = d(tmp10 + o3);
  out[7 * kStride] = d(tmp10 - o3);
  out[kStride] = d(tmp11 + o2);
  out[6 * kStride] = d(tmp11 - o2);
  out[2 * kStride] = d(tmp12 + o1);
  out[5 * kStride] = d(tmp12 - o1);
  out[3 * kStride] = d(tmp13 + o0);
  out[4 * kStride] = d(tmp13 - o0);
}

void idct_islow(const int16_t* coef, const uint16_t* q, u8* out, int stride) {
  constexpr int kPass1 = 2, kConst = 13;
  int32_t in[64], ws[64], px[64];
  bool ac_rows_zero = true;
  for (int i = 0; i < 64; ++i) {
    in[i] = wrap16(static_cast<int32_t>(coef[i]) * q[i]);
    if (i >= 8 && coef[i] != 0) ac_rows_zero = false;
  }
  if (ac_rows_zero) {
    for (int c = 0; c < 8; ++c)
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = wrap16(in[c] * 4);
  } else {
    for (int c = 0; c < 8; ++c) idct_pass<8, kConst - kPass1>(in + c, ws + c);
  }
  for (int r = 0; r < 8; ++r) idct_pass<1, kConst + kPass1 + 3>(ws + 8 * r, px + 8 * r);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) {
      const int32_t v = px[8 * r + c];
      out[r * stride + c] = static_cast<u8>((v < -128 ? -128 : v > 127 ? 127 : v) + 128);
    }
}

// The frame's geometry (jdinput.c initial_setup): the interleaved MCU grid,
// each component's MCU-padded block grid, its blocks and its downsampled
// size, and the zeroed coefficient buffers.
bool setup_frame(Jpeg* j) {
  for (int c = 0; c < j->ncomp; ++c) {
    j->hmax = std::max(j->hmax, j->comp[c].h);
    j->vmax = std::max(j->vmax, j->comp[c].v);
  }
  for (int c = 0; c < j->ncomp; ++c) {  // jdsample.c: no fractional factors
    if (j->hmax % j->comp[c].h || j->vmax % j->comp[c].v) return false;
  }
  j->mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
  j->mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
  for (int c = 0; c < j->ncomp; ++c) {
    Component& k = j->comp[c];
    k.bw = j->mcux * k.h;
    k.bh = j->mcuy * k.v;
    k.wb = (j->width * k.h + 8 * j->hmax - 1) / (8 * j->hmax);
    k.hb = (j->height * k.v + 8 * j->vmax - 1) / (8 * j->vmax);
    k.dw = (j->width * k.h + j->hmax - 1) / j->hmax;
    k.dh = (j->height * k.v + j->vmax - 1) / j->vmax;
    k.plane.assign(static_cast<size_t>(k.bw) * 8 * k.bh * 8, 0);
    k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
    std::fill(k.bits, k.bits + 64, -1);
  }
  return true;
}

// One scan's setup and entropy decoder state (start_pass of jdhuff.c,
// jdphuff.c or jdarith.c), checked as libjpeg checks it.
struct Scan {
  int cs[3] = {0, 0, 0};  // frame component of each scan component
  int ns = 0, ss = 0, se = 0, ah = 0, al = 0;
  int pred[3] = {0, 0, 0};        // last DC value per scan component
  int dc_context[3] = {0, 0, 0};  // arithmetic DC conditioning
  unsigned eobrun = 0;
};

bool start_scan(Jpeg* j, Scan* s) {
  if (s->ns > 1) {  // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
    int blocks = 0;
    for (int i = 0; i < s->ns; ++i) blocks += j->comp[s->cs[i]].h * j->comp[s->cs[i]].v;
    if (blocks > 10) return false;
  }
  for (int i = 0; i < s->ns; ++i) {  // jdinput.c latch_quant_tables
    Component& k = j->comp[s->cs[i]];
    if (!k.latched) {
      if (!j->qt_defined[k.tq]) return false;
      std::memcpy(k.q, j->qt[k.tq], sizeof(k.q));
      k.latched = true;
    }
  }
  const bool dc = s->ss == 0;
  if (j->progressive) {
    if (dc ? s->se != 0 : (s->se < s->ss || s->se > 63 || s->ns != 1)) return false;
    if ((s->ah != 0 && s->al != s->ah - 1) || s->al > 13) return false;
    // progression status; an AC scan before the DC scan or a refinement out
    // of order is only a warning
    for (int i = 0; i < s->ns; ++i) {
      Component& k = j->comp[s->cs[i]];
      for (int c = 1; c <= 9; ++c) k.prev_bits[c] = j->scans > 1 ? k.bits[c] : 0;
      for (int c = s->ss; c <= s->se; ++c) k.bits[c] = s->al;
    }
  }
  // the tables the scan takes, as jdhuff.c and jdphuff.c check them: a
  // sequential scan both, a progressive one only the table it decodes with
  // (none in a DC refinement); a missing or corrupt table fails (dc_usable
  // implies usable)
  for (int i = 0; i < s->ns; ++i) {
    const Component& k = j->comp[s->cs[i]];
    if (j->arith) {
      if (k.td > 15 || k.ta > 15) return false;
    } else if (!j->progressive) {
      if (k.td > 3 || k.ta > 3 || !j->dc[k.td].dc_usable || !j->ac[k.ta].usable) return false;
    } else if (dc ? s->ah == 0 && (k.td > 3 || !j->dc[k.td].dc_usable)
                  : k.ta > 3 || !j->ac[k.ta].usable) {
      return false;
    }
  }
  j->insufficient = false;
  j->next_restart = 0;
  j->acc = 0;
  j->nbits = 0;
  if (j->arith) {
    for (int i = 0; i < s->ns; ++i) {
      const Component& k = j->comp[s->cs[i]];
      if (!j->progressive || (dc && s->ah == 0)) std::memset(j->dc_stats[k.td], 0, 64);
      if (!j->progressive || !dc) std::memset(j->ac_stats[k.ta], 0, 256);
    }
    j->c = 0;
    j->a = 0;
    j->ct = -16;
  }
  return true;
}

// process_restart of the scan's entropy decoder
void restart(Jpeg* j, Scan* s) {
  j->acc = 0;  // the Huffman bit buffer's rest is discarded
  j->nbits = 0;
  read_restart_marker(j);
  const bool dc_reset = !j->progressive || (s->ss == 0 && s->ah == 0);
  for (int i = 0; i < s->ns; ++i) {
    if (j->arith) {
      const Component& k = j->comp[s->cs[i]];
      if (dc_reset) std::memset(j->dc_stats[k.td], 0, 64);
      if (!j->progressive || s->ss) std::memset(j->ac_stats[k.ta], 0, 256);
    }
    s->pred[i] = 0;
    s->dc_context[i] = 0;
  }
  s->eobrun = 0;
  if (j->arith) {
    j->c = 0;
    j->a = 0;
    j->ct = -16;
  } else if (j->unread == 0) {
    j->insufficient = false;  // unless the restart left us at a marker
  }
}

// jdhuff.c decode_mcu for one block of a sequential scan
void huff_block(Jpeg* j, const Component& k, int* pred, int16_t* block) {
  int s = decode_symbol(j, j->dc[k.td]);
  if (s) s = extend(get_bits(j, s), s);
  *pred += s;
  block[0] = static_cast<int16_t>(*pred);
  const Huffman& ac = j->ac[k.ta];
  for (int i = 1; i < 64; ++i) {
    const int rs = decode_symbol(j, ac);
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      i += r;
      block[kNatural[i]] = static_cast<int16_t>(extend(get_bits(j, s), s));
    } else {
      if (r != 15) break;
      i += 15;
    }
  }
}

// decode_mcu_AC_first for one block
void ac_first(Jpeg* j, const Huffman& t, Scan* st, int16_t* block) {
  if (st->eobrun > 0) {
    --st->eobrun;
    return;
  }
  for (int k = st->ss; k <= st->se; ++k) {
    const int rs = decode_symbol(j, t);
    int r = rs >> 4;
    const int s = rs & 15;
    if (s) {
      k += r;
      block[kNatural[k]] =
          static_cast<int16_t>(static_cast<unsigned>(extend(get_bits(j, s), s)) << st->al);
    } else if (r == 15) {  // ZRL
      k += 15;
    } else {  // EOBr: a run of 2^r + r appended bits blocks, this one included
      st->eobrun = 1u << r;
      if (r) st->eobrun += get_bits(j, r);
      --st->eobrun;
      break;
    }
  }
}

// One correction bit for an already-nonzero coefficient.
inline void refine(Jpeg* j, int16_t* coef, int p1, int m1) {
  if (get_bits(j, 1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
}

// decode_mcu_AC_refine for one block
void ac_refine(Jpeg* j, const Huffman& t, Scan* st, int16_t* block) {
  const int p1 = 1 << st->al, m1 = static_cast<int>(~0u << st->al);
  int k = st->ss;
  if (st->eobrun == 0) {
    for (; k <= st->se; ++k) {
      const int rs = decode_symbol(j, t);
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {  // a newly nonzero coefficient (its size should be 1)
        s = get_bits(j, 1) ? p1 : m1;
      } else if (r != 15) {
        st->eobrun = 1u << r;
        if (r) st->eobrun += get_bits(j, r);
        break;  // the rest of the block is the EOB run's
      }
      do {  // pass over r zero coefficients, refining the nonzero ones
        int16_t* coef = block + kNatural[k];
        if (*coef != 0) {
          refine(j, coef, p1, m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= st->se);
      if (s) block[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (st->eobrun > 0) {
    for (; k <= st->se; ++k) {
      int16_t* coef = block + kNatural[k];
      if (*coef != 0) refine(j, coef, p1, m1);
    }
    --st->eobrun;
  }
}

// One block of the scan: Huffman or arithmetic, sequential or one of the
// four progressive kinds.
void decode_block(Jpeg* j, Scan* s, int i, int16_t* block) {
  const Component& k = j->comp[s->cs[i]];
  const bool dc = s->ss == 0;
  if (j->arith) {
    if (!j->progressive) {
      const int diff = arith_dc_diff(j, k.td, &s->dc_context[i]);
      if (j->ct == -1) return;
      s->pred[i] = (s->pred[i] + diff) & 0xffff;
      block[0] = static_cast<int16_t>(s->pred[i]);
      arith_ac(j, k.ta, 1, 63, 0, block);
    } else if (dc && s->ah == 0) {
      const int diff = arith_dc_diff(j, k.td, &s->dc_context[i]);
      if (j->ct == -1) return;
      s->pred[i] = (s->pred[i] + diff) & 0xffff;
      block[0] = static_cast<int16_t>(static_cast<unsigned>(s->pred[i]) << s->al);
    } else if (dc) {
      if (arith_decode(j, j->fixed_bin)) block[0] = static_cast<int16_t>(block[0] | (1 << s->al));
    } else if (s->ah == 0) {
      arith_ac(j, k.ta, s->ss, s->se, s->al, block);
    } else {
      arith_ac_refine(j, k.ta, s->ss, s->se, s->al, block);
    }
    return;
  }
  if (!j->progressive) {
    huff_block(j, k, &s->pred[i], block);
  } else if (dc && s->ah == 0) {
    int d = decode_symbol(j, j->dc[k.td]);
    if (d) d = extend(get_bits(j, d), d);
    s->pred[i] += d;
    block[0] = static_cast<int16_t>(static_cast<unsigned>(s->pred[i]) << s->al);
  } else if (dc) {
    if (get_bits(j, 1)) block[0] = static_cast<int16_t>(block[0] | (1 << s->al));
  } else if (s->ah == 0) {
    ac_first(j, j->ac[k.ta], s, block);
  } else {
    ac_refine(j, j->ac[k.ta], s, block);
  }
}

// One scan into the coefficient buffers (jdcoefct.c consume_data).  A
// Huffman scan that has run out of data leaves the rest of its restart
// interval as it was; an arithmetic one after a decoding error likewise.
bool decode_scan(Jpeg* j, Scan* s) {
  if (!start_scan(j, s)) return false;
  // a one-component scan is non-interleaved: one block per MCU over the
  // component's own blocks, v block rows per iMCU row
  const Component& k0 = j->comp[s->cs[0]];
  const bool single = s->ns == 1;
  const int mcux = single ? k0.wb : j->mcux, mcuy = single ? k0.hb : j->mcuy;
  const int rows_per_imcu = single ? k0.v : 1;
  int left = j->restart;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (!j->insufficient) j->last_good_row = my / rows_per_imcu;
      if (j->restart) {
        if (left == 0) {
          restart(j, s);
          left = j->restart;
        }
        --left;
      }
      if (j->arith ? j->ct == -1 : j->insufficient) continue;
      for (int i = 0; i < s->ns; ++i) {
        Component& k = j->comp[s->cs[i]];
        const int bh = single ? 1 : k.v, bwd = single ? 1 : k.h;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bwd; ++bx) {
            const size_t x = static_cast<size_t>(mx) * bwd + bx;
            const size_t y = static_cast<size_t>(my) * bh + by;
            decode_block(j, s, i, k.coef.data() + (y * k.bw + x) * 64);
            if (j->arith && j->ct == -1) break;
          }
          if (j->arith && j->ct == -1) break;
        }
        if (j->arith && j->ct == -1) break;
      }
    }
  }
  return true;
}

// -- upsampling (jdsample.c) and colour conversion (jdcolor.c) ----------------

// A component upsampled by (hf, vf) to rows of width dw*hf, with the rows
// above and below replicated at the component's downsampled edge.  As
// jinit_upsampler picks: fancy h2v1 and h2v2 where dw > 2, fancy h1v2,
// and box replication (int_upsample) for every other factor.
std::vector<u8> upsample(const Component& k, int hf, int vf, int out_w, int out_h) {
  std::vector<u8> out(static_cast<size_t>(out_w) * out_h);
  const int stride = k.bw * 8;
  auto row = [&](int y) {
    y = y < 0 ? 0 : (y >= k.dh ? k.dh - 1 : y);
    return k.plane.data() + static_cast<size_t>(y) * stride;
  };
  const bool fancy = (hf == 2 && vf <= 2 && k.dw > 2) || (hf == 1 && vf == 2);
  std::vector<u8> line(static_cast<size_t>(hf) * k.dw);
  for (int oy = 0; oy < out_h; ++oy) {
    const int iy = oy / vf;
    const u8* in0 = row(iy);
    u8* o = line.data();
    if (hf == 1 && vf == 1) {
      std::memcpy(o, in0, k.dw);
    } else if (!fancy) {  // box: h2v1_upsample, h2v2_upsample, int_upsample
      for (int x = 0; x < hf * k.dw; ++x) o[x] = in0[x / hf];
    } else if (vf == 1) {  // h2v1_fancy_upsample
      int v = in0[0];
      o[0] = static_cast<u8>(v);
      o[1] = static_cast<u8>((v * 3 + in0[1] + 2) >> 2);
      for (int x = 1; x < k.dw - 1; ++x) {
        v = in0[x] * 3;
        o[2 * x] = static_cast<u8>((v + in0[x - 1] + 1) >> 2);
        o[2 * x + 1] = static_cast<u8>((v + in0[x + 1] + 2) >> 2);
      }
      const int last = k.dw - 1;
      v = in0[last];
      o[2 * last] = static_cast<u8>((v * 3 + in0[last - 1] + 1) >> 2);
      o[2 * last + 1] = static_cast<u8>(v);
    } else {
      const bool above = (oy & 1) == 0;
      const u8* in1 = row(above ? iy - 1 : iy + 1);
      if (hf == 1) {  // h1v2_fancy_upsample
        const int bias = above ? 1 : 2;
        for (int x = 0; x < k.dw; ++x) o[x] = static_cast<u8>((in0[x] * 3 + in1[x] + bias) >> 2);
      } else {  // h2v2_fancy_upsample
        int thiscol = in0[0] * 3 + in1[0];
        int nextcol = in0[1] * 3 + in1[1];
        o[0] = static_cast<u8>((thiscol * 4 + 8) >> 4);
        o[1] = static_cast<u8>((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        int x = 1;
        for (; x < k.dw - 1; ++x) {
          nextcol = in0[x + 1] * 3 + in1[x + 1];
          o[2 * x] = static_cast<u8>((thiscol * 3 + lastcol + 8) >> 4);
          o[2 * x + 1] = static_cast<u8>((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        o[2 * x] = static_cast<u8>((thiscol * 3 + lastcol + 8) >> 4);
        o[2 * x + 1] = static_cast<u8>((thiscol * 4 + 7) >> 4);
      }
    }
    std::memcpy(out.data() + static_cast<size_t>(oy) * out_w, o, out_w);
  }
  return out;
}

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (int64_t(1) << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

const ColorTables& color_tables() {
  static const ColorTables t;
  return t;
}

inline u8 clamp255(int v) { return static_cast<u8>(v < 0 ? 0 : v > 255 ? 255 : v); }

// -- block smoothing (jdcoefct.c) ----------------------------------------------

// Natural-order positions of the DC and the first 9 AC coefficients
const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// smoothing_ok: whether libjpeg smooths the blocks, with the coefficient
// precisions it latches: latch[c][0..9] now, prev[c][0..9] before each
// component's last scan (-1 when the file had one scan).
bool smoothing_ok(const Jpeg& j, int latch[3][10], int prev[3][10]) {
  if (!j.progressive) return false;
  bool useful = false;
  for (int c = 0; c < j.ncomp; ++c) {
    const Component& k = j.comp[c];
    if (!k.latched) return false;
    for (int i = 0; i < 10; ++i)
      if (k.q[kQPos[i]] == 0) return false;
    if (k.bits[0] < 0) return false;
    latch[c][0] = k.bits[0];
    for (int i = 1; i < 10; ++i) {
      prev[c][i] = j.scans > 1 ? k.prev_bits[i] : -1;
      latch[c][i] = k.bits[i];
      if (k.bits[i] != 0) useful = true;
    }
  }
  return useful;
}

// The estimate of one AC coefficient from num, as decompress_smooth_data
// rounds and clamps it.
inline int16_t smooth_pred(int64_t num, int64_t q, int al) {
  int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
  if (al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
  return static_cast<int16_t>(num >= 0 ? pred : -pred);
}

// decompress_smooth_data for one component: each block's unknown low AC
// coefficients (and, while no AC coefficient is known, its DC) estimated
// from the DC values of the 5x5 blocks around it, then the IDCT.
void smooth_component(const Jpeg& j, Component& k, const int* latch, const int* prev) {
  const int total = j.mcuy, last_row = total - 1, last_col = k.wb - 1;
  const int stride = k.bw * 8;
  int16_t ws[64];
  for (int row = 0; row < total; ++row) {
    int block_rows = k.v;
    if (row == last_row) {
      block_rows = k.hb % k.v;
      if (block_rows == 0) block_rows = k.v;
    }
    // an iMCU row the last scan did not reach keeps the scan before's precision
    const int* bits = row > j.last_good_row ? prev : latch;
    bool change_dc = true;
    for (int i = 1; i <= 9; ++i) change_dc = change_dc && bits[i] == -1;
    int64_t Q[10];
    for (int i = 0; i < 10; ++i) Q[i] = k.q[kQPos[i]];
    const int64_t Q00 = Q[0];
    for (int br = 0; br < block_rows; ++br) {
      // the neighbouring block rows, as libjpeg-turbo 2.1 picks them: a row
      // of an iMCU row before (after) is replicated from the nearer one at
      // the image's first two (last two) iMCU rows
      const int by = row * k.v + br;
      auto blocks = [&](int y) { return k.coef.data() + static_cast<size_t>(y) * k.bw * 64; };
      const int16_t* cur = blocks(by);
      const int16_t* prv = br > 0 || row > 0 ? blocks(by - 1) : cur;
      const int16_t* pp = br > 1 || row > 1 ? blocks(by - 2) : prv;
      const int16_t* nxt = br < block_rows - 1 || row < last_row ? blocks(by + 1) : cur;
      const int16_t* nn = br < block_rows - 2 || row < last_row - 1 ? blocks(by + 2) : nxt;
      int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13, DC14,
          DC15, DC16, DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
      DC01 = DC02 = DC03 = DC04 = DC05 = pp[0];
      DC06 = DC07 = DC08 = DC09 = DC10 = prv[0];
      DC11 = DC12 = DC13 = DC14 = DC15 = cur[0];
      DC16 = DC17 = DC18 = DC19 = DC20 = nxt[0];
      DC21 = DC22 = DC23 = DC24 = DC25 = nn[0];
      for (int bx = 0; bx <= last_col; ++bx) {
        std::memcpy(ws, cur + static_cast<size_t>(bx) * 64, sizeof(ws));
        if (bx == 0 && bx < last_col) {
          DC04 = pp[64];
          DC09 = prv[64];
          DC14 = cur[64];
          DC19 = nxt[64];
          DC24 = nn[64];
        }
        if (bx + 1 < last_col) {
          const size_t o = static_cast<size_t>(bx + 2) * 64;
          DC05 = pp[o];
          DC10 = prv[o];
          DC15 = cur[o];
          DC20 = nxt[o];
          DC25 = nn[o];
        }
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
          const int64_t num =
              Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                  3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                  3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                  DC24 + DC25)
                               : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = smooth_pred(num, Q[1], al);
        }
        if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
          const int64_t num =
              Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                  13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 -
                                  38 * DC18 - 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                                  3 * DC24 + DC25)
                               : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = smooth_pred(num, Q[2], al);
        }
        if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
          const int64_t num =
              Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                  5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                               : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = smooth_pred(num, Q[3], al);
        }
        if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
          const int64_t num =
              Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 +
                                  DC21 - DC25)
                               : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                  DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = smooth_pred(num, Q[4], al);
        }
        if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
          const int64_t num =
              Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                  7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                               : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = smooth_pred(num, Q[5], al);
        }
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0) {  // AC03
            ws[3] = smooth_pred(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q[6], al);
          }
          if ((al = bits[7]) != 0 && ws[10] == 0) {  // AC12
            ws[10] = smooth_pred(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q[7], al);
          }
          if ((al = bits[8]) != 0 && ws[17] == 0) {  // AC21
            ws[17] = smooth_pred(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q[8], al);
          }
          if ((al = bits[9]) != 0 && ws[24] == 0) {  // AC30
            ws[24] = smooth_pred(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q[9], al);
          }
          const int64_t num =
              Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                     42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                     42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                     6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
          ws[0] = smooth_pred(num, Q00, 0);
        }
        idct_islow(ws, k.q, k.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
        DC01 = DC02;
        DC02 = DC03;
        DC03 = DC04;
        DC04 = DC05;
        DC06 = DC07;
        DC07 = DC08;
        DC08 = DC09;
        DC09 = DC10;
        DC11 = DC12;
        DC12 = DC13;
        DC13 = DC14;
        DC14 = DC15;
        DC16 = DC17;
        DC17 = DC18;
        DC18 = DC19;
        DC19 = DC20;
        DC21 = DC22;
        DC22 = DC23;
        DC23 = DC24;
        DC24 = DC25;
      }
    }
  }
}

// The IDCT of every coefficient block into the component planes, through
// the block smoothing where libjpeg applies it.
void output_planes(Jpeg* j) {
  int latch[3][10], prev[3][10];
  const bool smooth = smoothing_ok(*j, latch, prev);
  for (int c = 0; c < j->ncomp; ++c) {
    Component& k = j->comp[c];
    if (smooth) {
      smooth_component(*j, k, latch[c], prev[c]);
      continue;
    }
    const uint16_t* q = k.latched ? k.q : j->qt[k.tq];  // a component of no scan is all zero
    const int stride = k.bw * 8;
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(k.coef.data() + (static_cast<size_t>(by) * k.bw + bx) * 64, q,
                   k.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
  }
}

// -- the marker reader (jdmarker.c read_markers) ---------------------------------

bool read_sof(Jpeg* j, const u8* d, int marker, size_t seg, int len) {
  j->progressive = marker == 0xC2 || marker == 0xCA;
  j->arith = marker >= 0xC9;
  if (d[seg] != 8) return false;  // an 8-bit build: 12-bit frames fail
  j->height = be16(d + seg + 1);
  j->width = be16(d + seg + 3);
  j->ncomp = d[seg + 5];
  if (j->width <= 0 || j->height <= 0 || j->width > 65500 || j->height > 65500 ||
      len != 8 + 3 * j->ncomp || (j->ncomp != 1 && j->ncomp != 3))
    return false;  // no RGB conversion of 2- or 4-component (CMYK) frames
  for (int c = 0; c < j->ncomp; ++c) {
    Component& k = j->comp[c];
    k.id = d[seg + 6 + 3 * c];
    k.h = d[seg + 7 + 3 * c] >> 4;
    k.v = d[seg + 7 + 3 * c] & 15;
    k.tq = d[seg + 8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return false;
  }
  return true;
}

// jdmarker.c get_sos: the scan's components (each an id of the frame, not
// taken twice) and its Ss, Se, Ah and Al.
bool read_sos(Jpeg* j, const u8* d, size_t seg, int len, Scan* s) {
  s->ns = d[seg];
  if (s->ns < 1 || s->ns > 4 || len != 6 + 2 * s->ns) return false;
  if (s->ns > j->ncomp) return false;
  bool taken[3] = {false, false, false};
  for (int i = 0; i < s->ns; ++i) {
    const int id = d[seg + 1 + 2 * i], t = d[seg + 2 + 2 * i];
    int c = 0;
    while (c < j->ncomp && (j->comp[c].id != id || taken[c])) ++c;
    if (c == j->ncomp) return false;
    taken[i] = true;  // libjpeg marks the scan slot, not the component
    for (int p = 0; p < i; ++p)
      if (s->cs[p] == c) return false;  // but refuses a component taken twice
    s->cs[i] = c;
    j->comp[c].td = t >> 4;
    j->comp[c].ta = t & 15;
  }
  const size_t p = seg + 1 + 2 * s->ns;
  s->ss = d[p];
  s->se = d[p + 1];
  s->ah = d[p + 2] >> 4;
  s->al = d[p + 2] & 15;
  return true;
}

// Reads the file's markers and decodes each scan into the coefficient
// buffers, up to EOI or the end of the file.
bool read_file_scans(Jpeg* j) {
  if (j->size < 4 || j->data[0] != 0xFF || j->data[1] != 0xD8) return false;
  j->pos = 2;
  for (int t = 0; t < 16; ++t) {
    j->dc_L[t] = 0;
    j->dc_U[t] = 1;
    j->ac_K[t] = 5;
  }
  j->fixed_bin[0] = 113;
  bool have_sof = false;
  for (;;) {
    int marker = j->unread;
    j->unread = 0;
    if (marker == 0) marker = next_marker(j);
    if (marker == 0xD9) return j->scans > 0;  // EOI
    if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;  // RSTn, TEM
    // the segment, from its length bytes on; one cut by the end of the file
    // goes on with the fake EOI markers, as libjpeg reads it
    const int len = (byte_at(*j, j->pos) << 8) | byte_at(*j, j->pos + 1);
    if (len < 2) {  // fails where the length is checked; skipped segments skip nothing
      if (marker != 0xDC && marker != 0xFE && (marker < 0xE0 || marker > 0xEF)) return false;
      j->pos += 2;
      continue;
    }
    std::vector<u8> copy;
    const u8* d = j->data + j->pos;
    if (j->pos + len > j->size) {
      copy.resize(len);
      for (int i = 0; i < len; ++i) copy[i] = static_cast<u8>(byte_at(*j, j->pos + i));
      d = copy.data();
    }
    j->pos += len;
    const size_t seg = 2, end = len;
    if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2 || marker == 0xC9 || marker == 0xCA) {
      if (have_sof || !read_sof(j, d, marker, seg, len)) return false;
      have_sof = true;
    } else if (marker >= 0xC3 && marker <= 0xCF && marker != 0xC4 && marker != 0xCC) {
      return false;  // lossless, hierarchical and JPG frames
    } else if (marker == 0xDB) {  // DQT
      size_t q = seg;
      while (q < end) {
        const int pq = d[q] >> 4, tq = d[q] & 15;
        const size_t bytes = 1 + (pq ? 128 : 64);  // 16-bit entries for any nonzero Pq
        if (tq > 3 || q + bytes > end) return false;  // JERR_BAD_LENGTH
        for (int i = 0; i < 64; ++i) {
          const int v = pq ? be16(d + q + 1 + 2 * i) : d[q + 1 + i];
          j->qt[tq][kNatural[i]] = static_cast<uint16_t>(v);
        }
        j->qt_defined[tq] = true;
        q += bytes;
      }
    } else if (marker == 0xC4) {  // DHT
      size_t q = seg;
      while (q + 17 <= end) {
        const int tc = d[q] >> 4, th = d[q] & 15;
        int count = 0;
        for (int i = 0; i < 16; ++i) count += d[q + 1 + i];
        if (tc > 1 || th > 3 || count > 256 || q + 17 + count > end) return false;
        Huffman* t = tc ? &j->ac[th] : &j->dc[th];
        t->defined = true;
        t->usable = build_huffman(t, d + q + 1, d + q + 17, count);
        q += 17 + count;
      }
      if (q != end) return false;  // tables that leave bytes over: JERR_BAD_LENGTH
    } else if (marker == 0xCC) {  // DAC
      if ((end - seg) % 2) return false;  // JERR_BAD_LENGTH
      for (size_t q = seg; q < end; q += 2) {
        const int index = d[q], val = d[q + 1];
        if (index >= 32) return false;
        if (index >= 16) {
          j->ac_K[index - 16] = static_cast<u8>(val);
        } else {
          j->dc_L[index] = static_cast<u8>(val & 15);
          j->dc_U[index] = static_cast<u8>(val >> 4);
          if (j->dc_L[index] > j->dc_U[index]) return false;
        }
      }
    } else if (marker == 0xDD) {  // DRI
      if (len != 4) return false;
      j->restart = be16(d + seg);
    } else if (marker == 0xE0) {  // APP0: JFIF implies YCbCr
      if (len >= 16 && std::memcmp(d + seg, "JFIF\0", 5) == 0) j->jfif = true;
    } else if (marker == 0xEE) {  // APP14 (Adobe): the colour transform
      if (len >= 14 && std::memcmp(d + seg, "Adobe", 5) == 0) {
        j->adobe = true;
        j->adobe_transform = d[seg + 11];
      }
    } else if (marker == 0xDA) {  // SOS
      Scan s;
      if (!have_sof || !read_sos(j, d, seg, len, &s)) return false;
      if (j->scans == 0) {
        if (!setup_frame(j)) return false;
        if (!j->progressive && !j->arith) std_huff_tables(j);
        j->multiscan = j->progressive || s.ns < j->ncomp;
      } else if (!j->multiscan) {
        return false;  // a second scan of a single-scan file: JERR_EOI_EXPECTED
      }
      ++j->scans;
      if (!decode_scan(j, &s)) return false;
    } else if (marker != 0xDC && marker != 0xFE && (marker < 0xE0 || marker > 0xEF)) {
      return false;  // an unknown marker (DNL, COM and APPn are skipped)
    }
  }
}

bool decode_into_canvas(const char* path, int canvas, u8* slot, int* h, int* w) {
  *h = *w = 0;
  std::vector<u8> file;
  if (!read_file(path, &file)) return false;
  Jpeg j;
  j.data = file.data();
  j.size = file.size();
  if (!read_file_scans(&j)) return false;
  output_planes(&j);
  const int copy_w = j.width < canvas ? j.width : canvas;
  const int copy_h = j.height < canvas ? j.height : canvas;
  std::vector<std::vector<u8>> planes(j.ncomp);
  for (int c = 0; c < j.ncomp; ++c) {
    const Component& k = j.comp[c];
    const int hf = j.hmax / k.h, vf = j.vmax / k.v;
    planes[c] = upsample(k, hf, vf, k.dw * hf, std::min(k.dh * vf, j.height));
  }
  const ColorTables& t = color_tables();
  // jdapimin.c default_decompress_parms: JFIF means YCbCr, else Adobe's
  // transform, else the component ids
  const bool rgb = j.ncomp == 3 && !j.jfif &&
                   (j.adobe ? j.adobe_transform == 0
                            : j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B');
  for (int y = 0; y < copy_h; ++y) {
    u8* o = slot + static_cast<size_t>(y) * canvas * 3;
    const u8* p0 = planes[0].data() + static_cast<size_t>(y) * (j.comp[0].dw * (j.hmax / j.comp[0].h));
    if (j.ncomp == 1) {
      for (int x = 0; x < copy_w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = p0[x];
      continue;
    }
    const u8* p1 = planes[1].data() + static_cast<size_t>(y) * (j.comp[1].dw * (j.hmax / j.comp[1].h));
    const u8* p2 = planes[2].data() + static_cast<size_t>(y) * (j.comp[2].dw * (j.hmax / j.comp[2].h));
    for (int x = 0; x < copy_w; ++x) {
      if (rgb) {
        o[3 * x] = p0[x];
        o[3 * x + 1] = p1[x];
        o[3 * x + 2] = p2[x];
        continue;
      }
      const int yy = p0[x], cb = p1[x], cr = p2[x];
      o[3 * x] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
  *h = j.height;
  *w = j.width;
  return true;
}

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void submit(std::function<void()> task) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      tasks_.push(std::move(task));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* cl_create(int num_threads) { return new ThreadPool(num_threads < 1 ? 1 : num_threads); }

void cl_destroy(void* pool) { delete static_cast<ThreadPool*>(pool); }

int cl_load_batch(void* pool_ptr, const char** paths, int n, int canvas, unsigned char* out,
                  int* heights, int* widths) {
  ThreadPool* pool = static_cast<ThreadPool*>(pool_ptr);
  const size_t slot_bytes = static_cast<size_t>(canvas) * canvas * 3;
  std::atomic<int> ok_count{0};
  std::atomic<int> done{0};
  std::mutex done_mu;
  std::condition_variable done_cv;
  for (int i = 0; i < n; ++i) {
    pool->submit([&, i] {
      int h = 0, w = 0;
      if (decode_into_canvas(paths[i], canvas, out + slot_bytes * i, &h, &w)) ok_count.fetch_add(1);
      heights[i] = h;
      widths[i] = w;
      if (done.fetch_add(1) + 1 == n) {
        std::lock_guard<std::mutex> lock(done_mu);
        done_cv.notify_all();
      }
    });
  }
  std::unique_lock<std::mutex> lock(done_mu);
  done_cv.wait(lock, [&] { return done.load() == n; });
  return ok_count.load();
}

}  // extern "C"
