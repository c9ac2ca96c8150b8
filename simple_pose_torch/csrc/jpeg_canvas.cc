// jpeg_canvas: threaded sequential and progressive JPEG -> RGB canvas batch
// decoder with libjpeg's integer arithmetic, for a host without libjpeg.
//
// The same C API and result as native/canvas_loader.cc: each image (RGB)
// pasted at the origin of a zeroed [n, canvas, canvas, 3] uint8 slot,
// cropped to the canvas.  The pixels equal libjpeg(-turbo)'s default
// decompression bit for bit, because each stage repeats its arithmetic:
//   * Huffman decode of a sequential (SOF0/SOF1) 8-bit interleaved scan,
//     restart intervals included (jdhuff.c);
//   * Huffman decode of a progressive (SOF2) file's scans into a whole-image
//     coefficient buffer (jdphuff.c): DC first and refine, AC first with
//     end-of-band runs and AC refine, each scan's Ss, Se, Ah and Al checked
//     as libjpeg checks them; a single-component scan covers the
//     component's own ceil(width / 8) x ceil(height / 8) blocks, not the
//     interleaved MCU grid (jdinput.c per_scan_setup);
//   * dequantization and the "islow" integer IDCT (jidctint.c: 13-bit
//     constants, 2 pass-1 bits, the range-limit table's wrap, jdmaster.c);
//   * "fancy" triangle upsampling of h2v1, h1v2 and h2v2 chroma, with edge
//     rows replicated at the downsampled height (jdsample.c, jdmainct.c),
//     and box upsampling where the downsampled width is <= 2;
//   * YCbCr -> RGB with jdcolor.c's 16-bit fixed-point tables; grayscale is
//     replicated to RGB.
// libjpeg smooths a progressive file's blocks (jdcoefct.c
// decompress_smooth_data) when its low coefficients are not fully refined
// (smoothing_ok); a complete file from libjpeg's default progression ends
// fully refined.  This decoder does not smooth: a file on which either
// libjpeg's 6- or 10-coefficient smoothing_ok test holds fails to decode,
// as do files whose scans break libjpeg's progression rules (which libjpeg
// only warns about) or whose entropy data runs into a marker.
// Arithmetic-coded, 12-bit, lossless, multi-scan sequential, CMYK and other
// sampling layouts fail to decode (height and width 0).
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

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  u8 values[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;  // plane size in blocks (MCU-padded)
  int wb = 0, hb = 0;  // width_in_blocks, height_in_blocks (jdinput.c)
  int dw = 0, dh = 0;  // downsampled width and height (jdinput.c)
  std::vector<u8> plane;  // bw*8 x bh*8 samples
  // progressive only: bw x bh blocks of 64 coefficients in natural order,
  // the quantization table latched at the component's first scan, and
  // libjpeg's coef_bits (the Al each coefficient was last coded with; -1
  // before its first scan)
  std::vector<int16_t> coef;
  uint16_t q[64] = {};
  bool latched = false;
  int bits[64] = {};
};

struct Jpeg {
  const u8* data = nullptr;
  size_t size = 0, pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, restart = 0;
  int mcux = 0, mcuy = 0;  // the interleaved MCU grid
  bool progressive = false;
  bool adobe = false, adobe_rgb = false;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];
  // entropy decoder state
  uint64_t acc = 0;
  int nbits = 0;
  bool hit_marker = false;
  int fake_bits = 0;  // zero bits fed past a marker, at the end of acc
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

int u16(const Jpeg& j, size_t p) { return (j.data[p] << 8) | j.data[p + 1]; }

bool build_huffman(Huffman* t, const u8* bits, const u8* vals, int count) {
  // jdhuff.c jpeg_make_d_derived_tbl: canonical codes by length
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
  t->defined = true;
  return true;
}

bool setup_frame(Jpeg* j);
bool decode_progressive_scan(Jpeg* j, const int* cs, int ns, int ss, int se, int ah, int al);

// The position of the next marker at or after j->pos that is not a restart
// marker, skipping the bytes between (jdmarker.c next_marker).
size_t next_marker(const Jpeg& j) {
  size_t p = j.pos;
  while (p + 1 < j.size) {
    const int next = j.data[p + 1];
    if (j.data[p] == 0xFF && next != 0x00 && next != 0xFF) {
      if (next < 0xD0 || next > 0xD7) return p;
      p += 2;
    } else {
      ++p;
    }
  }
  return j.size;
}

// Reads markers up to the first scan of a sequential file (j->pos is then
// its entropy data), or decodes every scan of a progressive one up to EOI.
bool parse_headers(Jpeg* j) {
  if (j->size < 4 || j->data[0] != 0xFF || j->data[1] != 0xD8) return false;
  size_t p = 2;
  bool have_sof = false;
  int scans = 0;
  while (p + 2 <= j->size) {
    if (j->data[p] != 0xFF) return false;
    const int marker = j->data[p + 1];
    if (marker == 0xFF) {  // fill byte
      ++p;
      continue;
    }
    if (marker == 0xD9) return j->progressive && scans > 0;  // EOI
    if (p + 4 > j->size) return false;
    const int len = u16(*j, p + 2);
    const size_t seg = p + 4, end = p + 2 + len;
    if (len < 2 || end > j->size) return false;
    if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {  // sequential / progressive, Huffman
      if (have_sof || len < 8 || j->data[seg] != 8) return false;
      j->progressive = marker == 0xC2;
      j->height = u16(*j, seg + 1);
      j->width = u16(*j, seg + 3);
      j->ncomp = j->data[seg + 5];
      if (j->width <= 0 || j->height <= 0 || (j->ncomp != 1 && j->ncomp != 3) ||
          len < 8 + 3 * j->ncomp)
        return false;
      for (int c = 0; c < j->ncomp; ++c) {
        Component& k = j->comp[c];
        k.id = j->data[seg + 6 + 3 * c];
        k.h = j->data[seg + 7 + 3 * c] >> 4;
        k.v = j->data[seg + 7 + 3 * c] & 15;
        k.tq = j->data[seg + 8 + 3 * c];
        if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return false;
      }
      have_sof = true;
    } else if ((marker >= 0xC3 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
                marker != 0xCC)) {
      return false;  // lossless or arithmetic coding
    } else if (marker == 0xDB) {  // DQT
      size_t q = seg;
      while (q < end) {
        const int pq = j->data[q] >> 4, tq = j->data[q] & 15;
        if (tq > 3 || q + 1 + 64 * (pq + 1) > end) return false;
        for (int i = 0; i < 64; ++i) {
          const int v = pq ? u16(*j, q + 1 + 2 * i) : j->data[q + 1 + i];
          j->qt[tq][kNatural[i]] = static_cast<uint16_t>(v);
        }
        j->qt_defined[tq] = true;
        q += 1 + 64 * (pq + 1);
      }
    } else if (marker == 0xC4) {  // DHT
      size_t q = seg;
      while (q + 17 <= end) {
        const int tc = j->data[q] >> 4, th = j->data[q] & 15;
        int count = 0;
        for (int i = 0; i < 16; ++i) count += j->data[q + 1 + i];
        if (tc > 1 || th > 3 || count > 256 || q + 17 + count > end) return false;
        Huffman* t = tc ? &j->ac[th] : &j->dc[th];
        if (!build_huffman(t, j->data + q + 1, j->data + q + 17, count)) return false;
        q += 17 + count;
      }
    } else if (marker == 0xDD) {  // DRI
      if (len < 4) return false;
      j->restart = u16(*j, seg);
    } else if (marker == 0xEE) {  // APP14 (Adobe): transform 0 means RGB
      if (len >= 14 && std::memcmp(j->data + seg, "Adobe", 5) == 0) {
        j->adobe = true;
        j->adobe_rgb = j->data[seg + 11] == 0;
      }
    } else if (marker == 0xDA && j->progressive) {  // SOS of one progressive scan
      const int ns = j->data[seg];
      if (ns < 1 || ns > j->ncomp || len != 6 + 2 * ns) return false;
      if (scans++ == 0 && !setup_frame(j)) return false;
      int cs[3];
      for (int i = 0; i < ns; ++i) {  // jdmarker.c get_sos: ids of the frame, no repeats
        const int id = j->data[seg + 1 + 2 * i], t = j->data[seg + 2 + 2 * i];
        int c = 0;
        while (c < j->ncomp && j->comp[c].id != id) ++c;
        if (c == j->ncomp) return false;
        for (int prev = 0; prev < i; ++prev)
          if (cs[prev] == c) return false;
        cs[i] = c;
        j->comp[c].td = t >> 4;
        j->comp[c].ta = t & 15;
        if (j->comp[c].td > 3 || j->comp[c].ta > 3) return false;
      }
      const size_t s = seg + 1 + 2 * ns;
      j->pos = end;
      if (!decode_progressive_scan(j, cs, ns, j->data[s], j->data[s + 1], j->data[s + 2] >> 4,
                                   j->data[s + 2] & 15))
        return false;
      p = next_marker(*j);
      continue;
    } else if (marker == 0xDA) {  // SOS: one interleaved scan of every component
      if (!have_sof) return false;
      const int ns = j->data[seg];
      if (ns != j->ncomp || len < 6 + 2 * ns) return false;
      for (int i = 0; i < ns; ++i) {
        const int id = j->data[seg + 1 + 2 * i], t = j->data[seg + 2 + 2 * i];
        if (j->comp[i].id != id) return false;
        j->comp[i].td = t >> 4;
        j->comp[i].ta = t & 15;
        if (j->comp[i].td > 3 || j->comp[i].ta > 3 || !j->dc[j->comp[i].td].defined ||
            !j->ac[j->comp[i].ta].defined || !j->qt_defined[j->comp[i].tq])
          return false;
      }
      j->pos = end;
      return true;
    }
    p = end;
  }
  return false;
}

// -- entropy decoding (jdhuff.c) --------------------------------------------

void fill(Jpeg* j) {
  while (j->nbits <= 56) {
    int byte = 0;
    bool real = false;
    if (!j->hit_marker && j->pos < j->size) {
      real = true;
      byte = j->data[j->pos];
      if (byte == 0xFF) {
        const int next = j->pos + 1 < j->size ? j->data[j->pos + 1] : 0xD9;
        if (next == 0x00) {
          j->pos += 2;
        } else {  // a marker: feed zeros from here on, as libjpeg does
          j->hit_marker = true;
          real = false;
          byte = 0;
        }
      } else {
        ++j->pos;
      }
    }
    if (!real) j->fake_bits += 8;
    j->acc |= static_cast<uint64_t>(byte) << (56 - j->nbits);
    j->nbits += 8;
  }
}

int get_bits(Jpeg* j, int n) {
  if (n == 0) return 0;
  if (j->nbits < n) fill(j);
  const int v = static_cast<int>(j->acc >> (64 - n));
  j->acc <<= n;
  j->nbits -= n;
  return v;
}

int decode_symbol(Jpeg* j, const Huffman& t) {
  if (j->nbits < 16) fill(j);
  int code = 0, l = 1;
  for (; l <= 16; ++l) {
    code = (code << 1) | static_cast<int>((j->acc >> 63) & 1);
    j->acc <<= 1;
    --j->nbits;
    if (code <= t.maxcode[l]) break;
  }
  if (l > 16) return 0;  // corrupt data: libjpeg warns and decodes zeros
  return t.values[(code + t.valoffset[l]) & 0xFF];
}

int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

// Whether the decode has taken bits past the end of the entropy data.
bool overrun(const Jpeg& j) { return j.nbits < j.fake_bits; }

bool restart_marker(Jpeg* j) {
  j->acc = 0;
  j->nbits = 0;
  j->hit_marker = false;
  j->fake_bits = 0;
  while (j->pos + 1 < j->size && j->data[j->pos] == 0xFF && j->data[j->pos + 1] == 0xFF) ++j->pos;
  if (j->pos + 1 < j->size && j->data[j->pos] == 0xFF && j->data[j->pos + 1] >= 0xD0 &&
      j->data[j->pos + 1] <= 0xD7) {
    j->pos += 2;
    return true;
  }
  return false;
}

// -- the islow IDCT (jidctint.c) and the range limit (jdmaster.c) -----------

inline u8 range_limit_idct(int64_t x) {
  const int m = static_cast<int>(x & 1023);
  return static_cast<u8>(m < 128 ? m + 128 : m < 512 ? 255 : m < 896 ? 0 : m - 896);
}

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

void idct_islow(const int16_t* coef, const uint16_t* q, u8* out, int stride) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                    F2053 = 16819, F2562 = 20995, F3072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    auto dq = [&](int r) { return int64_t(in[8 * r]) * qt[8 * r]; };
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConst);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConst);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConst - kPass1;
    ws[c + 8 * 0] = static_cast<int>(descale(tmp10 + tmp3, s));
    ws[c + 8 * 7] = static_cast<int>(descale(tmp10 - tmp3, s));
    ws[c + 8 * 1] = static_cast<int>(descale(tmp11 + tmp2, s));
    ws[c + 8 * 6] = static_cast<int>(descale(tmp11 - tmp2, s));
    ws[c + 8 * 2] = static_cast<int>(descale(tmp12 + tmp1, s));
    ws[c + 8 * 5] = static_cast<int>(descale(tmp12 - tmp1, s));
    ws[c + 8 * 3] = static_cast<int>(descale(tmp13 + tmp0, s));
    ws[c + 8 * 4] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    u8* o = out + r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConst);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConst);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConst + kPass1 + 3;
    o[0] = range_limit_idct(descale(tmp10 + tmp3, s));
    o[7] = range_limit_idct(descale(tmp10 - tmp3, s));
    o[1] = range_limit_idct(descale(tmp11 + tmp2, s));
    o[6] = range_limit_idct(descale(tmp11 - tmp2, s));
    o[2] = range_limit_idct(descale(tmp12 + tmp1, s));
    o[5] = range_limit_idct(descale(tmp12 - tmp1, s));
    o[3] = range_limit_idct(descale(tmp13 + tmp0, s));
    o[4] = range_limit_idct(descale(tmp13 - tmp0, s));
  }
}

// The frame's geometry (jdinput.c initial_setup): the interleaved MCU grid,
// each component's MCU-padded block grid, its blocks and its downsampled
// size.  A one-component frame is always non-interleaved: one block per MCU.
bool setup_frame(Jpeg* j) {
  if (j->ncomp == 1) {
    Component& k = j->comp[0];
    k.h = k.v = 1;
    j->hmax = j->vmax = 1;
  } else {
    for (int c = 0; c < j->ncomp; ++c) {
      j->hmax = std::max(j->hmax, j->comp[c].h);
      j->vmax = std::max(j->vmax, j->comp[c].v);
    }
    for (int c = 0; c < j->ncomp; ++c) {
      if (j->hmax % j->comp[c].h || j->vmax % j->comp[c].v) return false;
    }
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
    if (j->progressive) {
      k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
      std::fill(k.bits, k.bits + 64, -1);
    }
  }
  return true;
}

bool decode_scan(Jpeg* j) {
  if (!setup_frame(j)) return false;
  const int mcux = j->mcux, mcuy = j->mcuy;
  int pred[3] = {0, 0, 0};
  int16_t block[64];
  int left = j->restart;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (j->restart) {
        if (left == 0) {
          if (!restart_marker(j)) return false;
          pred[0] = pred[1] = pred[2] = 0;
          left = j->restart;
        }
        --left;
      }
      for (int c = 0; c < j->ncomp; ++c) {
        Component& k = j->comp[c];
        const Huffman& dc = j->dc[k.td];
        const Huffman& ac = j->ac[k.ta];
        for (int by = 0; by < k.v; ++by) {
          for (int bx = 0; bx < k.h; ++bx) {
            std::memset(block, 0, sizeof(block));
            int s = decode_symbol(j, dc);
            if (s) s = extend(get_bits(j, s), s);
            pred[c] += s;
            block[0] = static_cast<int16_t>(pred[c]);
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
            const int stride = k.bw * 8;
            const size_t x0 = static_cast<size_t>(mx * k.h + bx) * 8;
            const size_t y0 = static_cast<size_t>(my * k.v + by) * 8;
            idct_islow(block, j->qt[k.tq], k.plane.data() + y0 * stride + x0, stride);
          }
        }
      }
    }
  }
  return true;
}

// -- progressive scans (jdphuff.c) -------------------------------------------

struct ScanState {
  int ss = 0, se = 0, al = 0;
  int pred[3] = {0, 0, 0};  // per scan component
  unsigned eobrun = 0;
};

// decode_mcu_DC_first for one block; fails on a DC category libjpeg's
// table builder refuses (> 15)
bool dc_first(Jpeg* j, const Huffman& t, int* pred, int al, int16_t* block) {
  int s = decode_symbol(j, t);
  if (s > 15) return false;
  if (s) s = extend(get_bits(j, s), s);
  *pred += s;
  block[0] = static_cast<int16_t>(static_cast<unsigned>(*pred) << al);
  return true;
}

// decode_mcu_AC_first for one block
void ac_first(Jpeg* j, const Huffman& t, ScanState* st, int16_t* block) {
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
void ac_refine(Jpeg* j, const Huffman& t, ScanState* st, int16_t* block) {
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

// One progressive scan into the coefficient buffers.  Its parameters are
// checked as jdphuff.c start_pass_phuff_decoder checks them; what libjpeg
// only warns about (a coefficient refined out of order, AC before DC) fails
// here.
bool decode_progressive_scan(Jpeg* j, const int* cs, int ns, int ss, int se, int ah, int al) {
  const bool dc = ss == 0;
  if (dc ? se != 0 : (ss > se || se > 63 || ns != 1)) return false;
  if ((ah != 0 && al != ah - 1) || al > 13) return false;
  int blocks = 0;
  for (int i = 0; i < ns; ++i) {
    Component& k = j->comp[cs[i]];
    blocks += k.h * k.v;
    if (dc ? (ah == 0 && !j->dc[k.td].defined) : !j->ac[k.ta].defined) return false;
    if (!dc && k.bits[0] < 0) return false;
    for (int c = ss; c <= se; ++c) {
      if (ah != (k.bits[c] < 0 ? 0 : k.bits[c])) return false;
      k.bits[c] = al;
    }
    if (!k.latched) {  // jdinput.c latch_quant_tables
      if (!j->qt_defined[k.tq]) return false;
      std::memcpy(k.q, j->qt[k.tq], sizeof(k.q));
      k.latched = true;
    }
  }
  if (ns > 1 && blocks > 10) return false;  // D_MAX_BLOCKS_IN_MCU
  j->acc = 0;
  j->nbits = 0;
  j->hit_marker = false;
  j->fake_bits = 0;
  ScanState st;
  st.ss = ss;
  st.se = se;
  st.al = al;
  // a one-component scan is non-interleaved: one block per MCU over the
  // component's own blocks
  const int mcux = ns == 1 ? j->comp[cs[0]].wb : j->mcux;
  const int mcuy = ns == 1 ? j->comp[cs[0]].hb : j->mcuy;
  int left = j->restart;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (j->restart) {
        if (left == 0) {
          if (overrun(*j) || !restart_marker(j)) return false;
          st.pred[0] = st.pred[1] = st.pred[2] = 0;
          st.eobrun = 0;
          left = j->restart;
        }
        --left;
      }
      for (int i = 0; i < ns; ++i) {
        Component& k = j->comp[cs[i]];
        const int bh = ns == 1 ? 1 : k.v, bwd = ns == 1 ? 1 : k.h;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bwd; ++bx) {
            const size_t x = static_cast<size_t>(mx) * bwd + bx, y = static_cast<size_t>(my) * bh + by;
            int16_t* block = k.coef.data() + (y * k.bw + x) * 64;
            if (dc && ah == 0) {
              if (!dc_first(j, j->dc[k.td], &st.pred[i], al, block)) return false;
            } else if (dc) {
              if (get_bits(j, 1)) block[0] = static_cast<int16_t>(block[0] | (1 << al));
            } else if (ah == 0) {
              ac_first(j, j->ac[k.ta], &st, block);
            } else {
              ac_refine(j, j->ac[k.ta], &st, block);
            }
          }
        }
      }
    }
  }
  return !overrun(*j);
}

// jdcoefct.c smoothing_ok with libjpeg's first ``n`` coefficients (6 before
// libjpeg-turbo 2.1, 10 since): whether libjpeg would smooth the blocks.
bool smoothing_ok(const Jpeg& j, int n) {
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (int c = 0; c < j.ncomp; ++c) {
    const Component& k = j.comp[c];
    if (!k.latched) return false;
    for (int i = 0; i < n; ++i)
      if (k.q[kPos[i]] == 0) return false;
    if (k.bits[0] < 0) return false;
    for (int i = 1; i < n; ++i)
      if (k.bits[i] != 0) useful = true;
  }
  return useful;
}

// The islow IDCT of every coefficient block into the component planes.
bool finish_progressive(Jpeg* j) {
  if (smoothing_ok(*j, 6) || smoothing_ok(*j, 10)) return false;
  for (int c = 0; c < j->ncomp; ++c) {
    Component& k = j->comp[c];
    const uint16_t* q = k.latched ? k.q : j->qt[k.tq];  // a component of no scan is all zero
    const int stride = k.bw * 8;
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(k.coef.data() + (static_cast<size_t>(by) * k.bw + bx) * 64, q,
                   k.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8, stride);
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

bool decode_into_canvas(const char* path, int canvas, u8* slot, int* h, int* w) {
  *h = *w = 0;
  std::vector<u8> file;
  if (!read_file(path, &file)) return false;
  Jpeg j;
  j.data = file.data();
  j.size = file.size();
  if (!parse_headers(&j) || !(j.progressive ? finish_progressive(&j) : decode_scan(&j)))
    return false;
  const int copy_w = j.width < canvas ? j.width : canvas;
  const int copy_h = j.height < canvas ? j.height : canvas;
  std::vector<std::vector<u8>> planes(j.ncomp);
  for (int c = 0; c < j.ncomp; ++c) {
    const Component& k = j.comp[c];
    const int hf = j.hmax / k.h, vf = j.vmax / k.v;
    planes[c] = upsample(k, hf, vf, k.dw * hf, std::min(k.dh * vf, j.height));
  }
  const ColorTables& t = color_tables();
  const bool rgb = j.ncomp == 3 && ((j.adobe && j.adobe_rgb) ||
                                    (!j.adobe && j.comp[0].id == 'R' && j.comp[1].id == 'G' &&
                                     j.comp[2].id == 'B'));
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
