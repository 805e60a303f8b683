// Image decoding and resampling for the file-backed dataset readers: the
// PNG row filters, a baseline JPEG decoder and encoder and Pillow's two
// resamplers.
//
// Built with g++ at first use and bound with ctypes
// (`simplerecon_tpu_torch/data/codec.py`); ctypes releases the GIL, so the
// loader's threads decode in parallel.
//
// PNG: Python inflates the IDAT stream with zlib; `png_unfilter` undoes the
// five row filters (None, Sub, Up, Average, Paeth) in place.
//
// JPEG: 8-bit baseline or extended sequential Huffman, 1 or 3 components,
// sampling 4:4:4, 4:2:2 or 4:2:0, restart intervals, interleaved or
// single-component scans. It reproduces libjpeg-turbo's default decode,
// which Pillow runs: the `islow` integer IDCT (jidctint.c: CONST_BITS 13,
// PASS1_BITS 2, the post-IDCT range limit), fancy upsampling (jdsample.c:
// the h2v1 and h2v2 triangle filters with their alternating rounding
// biases, the first and last chroma row repeated as context) and the
// fixed-point YCbCr -> RGB tables (jdcolor.c, SCALEBITS 16).
//
// JPEG encoding: baseline, 4:2:0, as libjpeg-turbo's defaults write it
// (see the encoder's section).
//
// Resize: Pillow's BILINEAR (the filter's support widened by the scale
// when shrinking, horizontal pass first, coefficients in fixed point with
// 22 fractional bits, each pass rounded to 8 bits) and NEAREST (the
// affine scale with positions stepped from half a pixel by in / out).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ----------------------------------------------------------------------
// PNG
// ----------------------------------------------------------------------

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// ----------------------------------------------------------------------
// JPEG
// ----------------------------------------------------------------------

enum JpegError {
  JPEG_OK = 0,
  JPEG_NOT_JPEG = 1,
  JPEG_PROGRESSIVE = 2,
  JPEG_ARITHMETIC = 3,
  JPEG_LOSSLESS = 4,
  JPEG_PRECISION = 5,
  JPEG_SAMPLING = 6,
  JPEG_COMPONENTS = 7,
  JPEG_CORRUPT = 8,
  JPEG_CAPACITY = 9,
};

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for a corrupt run past the end (as libjpeg does)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t lookup_len[512];   // 9-bit lookahead: code length, 0 if longer
  uint8_t lookup_val[512];
  int32_t maxcode[18];       // largest code of each length, -1 if none
  int32_t valoffset[17];     // value index of a code = code + valoffset
  uint8_t values[256];
};

bool build_huffman(Huffman& h, const uint8_t counts[16],
                   const uint8_t* values, int nvalues) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  if (p != nvalues || p > 256) return false;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) return false;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      h.valoffset[l] = p - huffcode[p];
      p += counts[l - 1];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.maxcode[17] = 0x7fffffff;
  std::memcpy(h.values, values, nvalues);
  std::memset(h.lookup_len, 0, sizeof(h.lookup_len));
  p = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      int lookbits = huffcode[p] << (9 - l);
      for (int ctr = 1 << (9 - l); ctr > 0; --ctr, ++lookbits) {
        h.lookup_len[lookbits] = (uint8_t)l;
        h.lookup_val[lookbits] = values[p];
      }
    }
  }
  h.defined = true;
  return true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;              // tables of the current scan
  int blocks_w = 0, blocks_h = 0;  // the padded block grid
  int width = 0, height = 0;       // downsampled size (libjpeg's)
  int pred = 0;
  std::vector<int16_t> coef;       // 64 per block, natural order
};

// Entropy-coded data: bytes with 0xFF00 stuffing, a marker ends it and
// zeros are supplied past it (libjpeg's behaviour on a short segment).
struct BitReader {
  const uint8_t* data;
  size_t len, pos;
  uint64_t buf = 0;
  int bits = 0;
  bool hit_marker = false;

  void fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      if (!hit_marker && pos < len) {
        byte = data[pos];
        if (byte == 0xFF) {
          uint8_t next = pos + 1 < len ? data[pos + 1] : 0;
          if (next == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= (uint64_t)byte << (56 - bits);
      bits += 8;
    }
  }
  inline uint32_t peek(int n) {
    if (bits < n) fill();
    return (uint32_t)(buf >> (64 - n));
  }
  inline void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  inline uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  // drops the bits of the current byte and any buffered bytes, and moves
  // past the restart marker that must come next
  bool restart(int expected) {
    // the interval's padding bits go; `fill` stops at a marker, so every
    // byte before it has been read, unless the interval ends early
    buf = 0;
    bits = 0;
    if (!hit_marker) {
      while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00
                                && data[pos + 1] != 0xFF))
        ++pos;
    }
    while (pos < len && data[pos] == 0xFF && pos + 1 < len
           && data[pos + 1] == 0xFF)
      ++pos;
    if (pos + 1 >= len) return false;
    int marker = data[pos + 1];
    if (marker != 0xD0 + expected) return false;
    pos += 2;
    hit_marker = false;
    return true;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

inline int decode_huff(BitReader& br, const Huffman& h) {
  uint32_t look = br.peek(9);
  int l = h.lookup_len[look];
  if (l) {
    br.skip(l);
    return h.lookup_val[look];
  }
  uint32_t code16 = br.peek(16);
  for (l = 10; l <= 16; ++l) {
    int32_t code = (int32_t)(code16 >> (16 - l));
    if (code <= h.maxcode[l]) {
      br.skip(l);
      int idx = code + h.valoffset[l];
      if (idx < 0 || idx > 255) return 0;
      return h.values[idx];
    }
  }
  br.skip(16);  // corrupt: libjpeg returns 0 and goes on
  return 0;
}

bool decode_block(BitReader& br, Component& c, const Huffman& dc,
                  const Huffman& ac, int16_t* block) {
  int s = decode_huff(br, dc);
  if (s > 16) return false;
  int diff = s ? extend((int)br.get(s), s) : 0;
  c.pred += diff;
  block[0] = (int16_t)c.pred;
  for (int k = 1; k < 64; ++k) {
    int rs = decode_huff(br, ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      int v = extend((int)br.get(s), s);
      block[kNaturalOrder[k]] = (int16_t)v;
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return true;
}

// jidctint.c: jpeg_idct_islow
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

struct RangeLimit {
  // libjpeg's sample_range_limit table (jdmaster.c), indexed from -256
  uint8_t table[5 * 256 + 128];
  const uint8_t* simple;  // simple[x] = clamp(x, 0, 255) for x in [-256, 767]
  const uint8_t* idct;    // idct[x & 1023]: the post-IDCT limit
  RangeLimit() {
    uint8_t* t = table + 256;
    std::memset(t - 256, 0, 256);
    for (int i = 0; i <= 255; ++i) t[i] = (uint8_t)i;
    uint8_t* u = t + 128;
    for (int i = 128; i < 512; ++i) u[i] = 255;
    std::memset(u + 512, 0, 512 - 128);
    std::memcpy(u + 1024 - 128, t, 128);
    simple = t;
    idct = u;
  }
};

const RangeLimit& range_limit() {
  static const RangeLimit r;
  return r;
}

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int stride) {
  const uint8_t* limit = range_limit().idct;
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* in = coef + col;
    const uint16_t* q = quant + col;
    int* w = ws + col;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0
        && in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dcval = (int)((int)in[0] * (int)q[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dcval;
      continue;
    }
    int64_t z2 = (int)in[16] * (int)q[16];
    int64_t z3 = (int)in[48] * (int)q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int)in[0] * (int)q[0];
    z3 = (int)in[32] * (int)q[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int)in[56] * (int)q[56];
    tmp1 = (int)in[40] * (int)q[40];
    tmp2 = (int)in[24] * (int)q[24];
    tmp3 = (int)in[8] * (int)q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    w[0] = (int)descale(tmp10 + tmp3, n);
    w[56] = (int)descale(tmp10 - tmp3, n);
    w[8] = (int)descale(tmp11 + tmp2, n);
    w[48] = (int)descale(tmp11 - tmp2, n);
    w[16] = (int)descale(tmp12 + tmp1, n);
    w[40] = (int)descale(tmp12 - tmp1, n);
    w[24] = (int)descale(tmp13 + tmp0, n);
    w[32] = (int)descale(tmp13 - tmp0, n);
  }
  const int n = CONST_BITS + PASS1_BITS + 3;
  for (int row = 0; row < 8; ++row) {
    const int* w = ws + 8 * row;
    uint8_t* o = out + (size_t)row * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0
        && w[6] == 0 && w[7] == 0) {
      uint8_t v = limit[(int)descale((int64_t)w[0], PASS1_BITS + 3) & 1023];
      for (int i = 0; i < 8; ++i) o[i] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = limit[(int)descale(tmp10 + tmp3, n) & 1023];
    o[7] = limit[(int)descale(tmp10 - tmp3, n) & 1023];
    o[1] = limit[(int)descale(tmp11 + tmp2, n) & 1023];
    o[6] = limit[(int)descale(tmp11 - tmp2, n) & 1023];
    o[2] = limit[(int)descale(tmp12 + tmp1, n) & 1023];
    o[5] = limit[(int)descale(tmp12 - tmp1, n) & 1023];
    o[3] = limit[(int)descale(tmp13 + tmp0, n) & 1023];
    o[4] = limit[(int)descale(tmp13 - tmp0, n) & 1023];
  }
}

// jdsample.c's fancy upsamplers on one component plane of `dw` x `dh`
// samples (row stride `stride`) into `2 dw` columns.
void upsample_h2v1(const uint8_t* in, int stride, int dw, int dh,
                   uint8_t* out, int ostride) {
  for (int y = 0; y < dh; ++y) {
    const uint8_t* p = in + (size_t)y * stride;
    uint8_t* o = out + (size_t)y * ostride;
    if (dw <= 2) {  // libjpeg replicates when there are 2 or fewer samples
      for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = p[x];
      continue;
    }
    int v = p[0];
    *o++ = (uint8_t)v;
    *o++ = (uint8_t)((v * 3 + p[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      v = p[x] * 3;
      *o++ = (uint8_t)((v + p[x - 1] + 1) >> 2);
      *o++ = (uint8_t)((v + p[x + 1] + 2) >> 2);
    }
    v = p[dw - 1];
    *o++ = (uint8_t)((v * 3 + p[dw - 2] + 1) >> 2);
    *o++ = (uint8_t)v;
  }
}

// `2 dh` output rows; the first and last rows serve as their own context
void upsample_h2v2(const uint8_t* in, int stride, int dw, int dh,
                   uint8_t* out, int ostride) {
  for (int y = 0; y < dh; ++y) {
    for (int v = 0; v < 2; ++v) {
      const uint8_t* p0 = in + (size_t)y * stride;
      int y1 = v == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < dh ? y + 1 : dh - 1);
      const uint8_t* p1 = in + (size_t)y1 * stride;
      uint8_t* o = out + (size_t)(2 * y + v) * ostride;
      if (dw <= 2) {
        for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = p0[x];
        continue;
      }
      int thiscol = p0[0] * 3 + p1[0];
      int nextcol = p0[1] * 3 + p1[1];
      *o++ = (uint8_t)((thiscol * 4 + 8) >> 4);
      *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 2; x < dw; ++x) {
        nextcol = p0[x] * 3 + p1[x];
        *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
        *o++ = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      *o++ = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      *o++ = (uint8_t)((thiscol * 4 + 7) >> 4);
    }
  }
}

struct Jpeg {
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool adobe = false, jfif = false;
  int adobe_transform = -1;
  bool frame_seen = false;
  Component comp[3];
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

int parse_frame(Jpeg& j, const uint8_t* p, int len) {
  if (len < 6) return JPEG_CORRUPT;
  if (p[0] != 8) return JPEG_PRECISION;
  j.height = be16(p + 1);
  j.width = be16(p + 3);
  j.ncomp = p[5];
  if (j.ncomp != 1 && j.ncomp != 3) return JPEG_COMPONENTS;
  if (len < 6 + 3 * j.ncomp || j.width <= 0 || j.height <= 0)
    return JPEG_CORRUPT;
  for (int i = 0; i < j.ncomp; ++i) {
    Component& c = j.comp[i];
    c.id = p[6 + 3 * i];
    c.h = p[7 + 3 * i] >> 4;
    c.v = p[7 + 3 * i] & 15;
    c.tq = p[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      return JPEG_CORRUPT;
  }
  j.hmax = j.vmax = 1;
  for (int i = 0; i < j.ncomp; ++i) {
    if (j.comp[i].h > j.hmax) j.hmax = j.comp[i].h;
    if (j.comp[i].v > j.vmax) j.vmax = j.comp[i].v;
  }
  if (j.ncomp == 1) {
    j.comp[0].h = j.comp[0].v = j.hmax = j.vmax = 1;
  } else {
    // 4:4:4, 4:2:2 (2x1 luma) or 4:2:0 (2x2 luma) with 1x1 chroma
    for (int i = 1; i < 3; ++i)
      if (j.comp[i].h != 1 || j.comp[i].v != 1) return JPEG_SAMPLING;
    int h = j.comp[0].h, v = j.comp[0].v;
    if (!((h == 1 && v == 1) || (h == 2 && v == 1) || (h == 2 && v == 2)))
      return JPEG_SAMPLING;
  }
  j.mcus_x = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcus_y = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int i = 0; i < j.ncomp; ++i) {
    Component& c = j.comp[i];
    c.blocks_w = j.mcus_x * c.h;
    c.blocks_h = j.mcus_y * c.v;
    c.width = (j.width * c.h + j.hmax - 1) / j.hmax;
    c.height = (j.height * c.v + j.vmax - 1) / j.vmax;
  }
  j.frame_seen = true;
  return JPEG_OK;
}

int parse_dht(Jpeg& j, const uint8_t* p, int len) {
  int pos = 0;
  while (pos < len) {
    if (pos + 17 > len) return JPEG_CORRUPT;
    int tc = p[pos] >> 4, th = p[pos] & 15;
    if (tc > 1 || th > 3) return JPEG_CORRUPT;
    uint8_t counts[16];
    int total = 0;
    for (int i = 0; i < 16; ++i) total += counts[i] = p[pos + 1 + i];
    if (total > 256 || pos + 17 + total > len) return JPEG_CORRUPT;
    Huffman& h = tc == 0 ? j.dc[th] : j.ac[th];
    if (!build_huffman(h, counts, p + pos + 17, total)) return JPEG_CORRUPT;
    pos += 17 + total;
  }
  return JPEG_OK;
}

int parse_dqt(Jpeg& j, const uint8_t* p, int len) {
  int pos = 0;
  while (pos < len) {
    int pq = p[pos] >> 4, tq = p[pos] & 15;
    if (tq > 3 || pq > 1) return JPEG_CORRUPT;
    int size = pq ? 128 : 64;
    if (pos + 1 + size > len) return JPEG_CORRUPT;
    for (int k = 0; k < 64; ++k) {
      int v = pq ? be16(p + pos + 1 + 2 * k) : p[pos + 1 + k];
      j.quant[tq][kNaturalOrder[k]] = (uint16_t)v;
    }
    j.quant_defined[tq] = true;
    pos += 1 + size;
  }
  return JPEG_OK;
}

// one scan; returns the position just after its entropy-coded data
int decode_scan(Jpeg& j, const uint8_t* data, size_t len, size_t& pos,
                const uint8_t* p, int seglen) {
  if (!j.frame_seen || seglen < 1) return JPEG_CORRUPT;
  int ns = p[0];
  if (ns < 1 || ns > j.ncomp || seglen < 1 + 2 * ns + 3) return JPEG_CORRUPT;
  Component* sc[3];
  for (int i = 0; i < ns; ++i) {
    int id = p[1 + 2 * i], tables = p[2 + 2 * i];
    Component* c = nullptr;
    for (int k = 0; k < j.ncomp; ++k)
      if (j.comp[k].id == id) c = &j.comp[k];
    if (!c) return JPEG_CORRUPT;
    c->td = tables >> 4;
    c->ta = tables & 15;
    if (c->td > 3 || c->ta > 3 || !j.dc[c->td].defined
        || !j.ac[c->ta].defined)
      return JPEG_CORRUPT;
    c->pred = 0;
    if (c->coef.empty())
      c->coef.assign((size_t)c->blocks_w * c->blocks_h * 64, 0);
    sc[i] = c;
  }
  int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], ahal = p[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahal != 0) return JPEG_PROGRESSIVE;

  BitReader br{data, len, pos};
  int units_x, units_y;
  if (ns == 1) {
    units_x = (sc[0]->width + 7) / 8;
    units_y = (sc[0]->height + 7) / 8;
  } else {
    units_x = j.mcus_x;
    units_y = j.mcus_y;
  }
  int64_t total = (int64_t)units_x * units_y;
  int restarts = 0, todo = j.restart_interval;
  for (int64_t m = 0; m < total; ++m) {
    if (j.restart_interval && todo == 0) {
      if (!br.restart(restarts & 7)) return JPEG_CORRUPT;
      ++restarts;
      todo = j.restart_interval;
      for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
    }
    int ux = (int)(m % units_x), uy = (int)(m / units_x);
    if (ns == 1) {
      Component* c = sc[0];
      int16_t* block = c->coef.data()
                       + ((size_t)uy * c->blocks_w + ux) * 64;
      if (!decode_block(br, *c, j.dc[c->td], j.ac[c->ta], block))
        return JPEG_CORRUPT;
    } else {
      for (int i = 0; i < ns; ++i) {
        Component* c = sc[i];
        for (int by = 0; by < c->v; ++by)
          for (int bx = 0; bx < c->h; ++bx) {
            size_t row = (size_t)uy * c->v + by, col = (size_t)ux * c->h + bx;
            int16_t* block = c->coef.data() + (row * c->blocks_w + col) * 64;
            if (!decode_block(br, *c, j.dc[c->td], j.ac[c->ta], block))
              return JPEG_CORRUPT;
          }
      }
    }
    if (j.restart_interval) --todo;
  }
  // the next marker
  size_t q = br.pos;
  while (q + 1 < len && !(data[q] == 0xFF && data[q + 1] != 0x00
                          && data[q + 1] != 0xFF && !(data[q + 1] >= 0xD0
                          && data[q + 1] <= 0xD7)))
    ++q;
  pos = q;
  return JPEG_OK;
}

int jpeg_parse(Jpeg& j, const uint8_t* data, size_t len, bool decode) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return JPEG_NOT_JPEG;
  size_t pos = 2;
  bool scanned = false;
  while (pos < len) {
    if (data[pos] != 0xFF) {
      ++pos;
      continue;
    }
    while (pos < len && data[pos] == 0xFF) ++pos;
    if (pos >= len) break;
    int marker = data[pos++];
    if (marker == 0xD9) break;                       // EOI
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (pos + 2 > len) return JPEG_CORRUPT;
    int seglen = be16(data + pos) - 2;
    if (seglen < 0 || pos + 2 + seglen > len) return JPEG_CORRUPT;
    const uint8_t* p = data + pos + 2;
    size_t next = pos + 2 + seglen;
    int err = JPEG_OK;
    switch (marker) {
      case 0xC0:
      case 0xC1:
        if (j.frame_seen) return JPEG_CORRUPT;
        err = parse_frame(j, p, seglen);
        if (err == JPEG_OK && !decode) return JPEG_OK;
        break;
      case 0xC2:
      case 0xC6:
      case 0xCA:
      case 0xCE:
        return JPEG_PROGRESSIVE;
      case 0xC3:
      case 0xC5:
      case 0xC7:
      case 0xCB:
      case 0xCD:
      case 0xCF:
        return JPEG_LOSSLESS;
      case 0xC9:
      case 0xCC:
        return JPEG_ARITHMETIC;
      case 0xC4:
        err = parse_dht(j, p, seglen);
        break;
      case 0xDB:
        err = parse_dqt(j, p, seglen);
        break;
      case 0xDD:
        if (seglen < 2) return JPEG_CORRUPT;
        j.restart_interval = be16(p);
        break;
      case 0xDA:
        pos = next;
        err = decode_scan(j, data, len, pos, p, seglen);
        if (err) return err;
        scanned = true;
        continue;
      case 0xE0:
        if (seglen >= 5 && std::memcmp(p, "JFIF", 5) == 0) j.jfif = true;
        break;
      case 0xEE:
        if (seglen >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
          j.adobe = true;
          j.adobe_transform = p[11];
        }
        break;
      case 0xDC:  // DNL
        return JPEG_CORRUPT;
      default:    // APPn, COM and others: skipped
        break;
    }
    if (err) return err;
    pos = next;
  }
  if (!j.frame_seen) return JPEG_CORRUPT;
  if (decode && !scanned) return JPEG_CORRUPT;
  return JPEG_OK;
}

// libjpeg's default_decompress_parms: is a 3-component image YCbCr?
bool is_ycbcr(const Jpeg& j) {
  if (j.jfif) return true;
  if (j.adobe) return j.adobe_transform != 0;
  int c0 = j.comp[0].id, c1 = j.comp[1].id, c2 = j.comp[2].id;
  if (c0 == 1 && c1 == 2 && c2 == 3) return true;
  if (c0 == 82 && c1 == 71 && c2 == 66) return false;
  return true;
}

// jdcolor.c: build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << SCALEBITS) + 0.5); };
    for (int i = 0, x = -128; i <= 255; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + ONE_HALF;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables t;
  return t;
}

int jpeg_render(Jpeg& j, uint8_t* out) {
  const int W = j.width, H = j.height;
  std::vector<uint8_t> planes[3];
  int pstride[3];
  for (int i = 0; i < j.ncomp; ++i) {
    Component& c = j.comp[i];
    if (!j.quant_defined[c.tq]) return JPEG_CORRUPT;
    if (c.coef.empty()) c.coef.assign((size_t)c.blocks_w * c.blocks_h * 64, 0);
    int pw = c.blocks_w * 8, ph = c.blocks_h * 8;
    pstride[i] = pw;
    planes[i].assign((size_t)pw * ph, 0);
    for (int by = 0; by < c.blocks_h; ++by)
      for (int bx = 0; bx < c.blocks_w; ++bx)
        idct_islow(c.coef.data() + ((size_t)by * c.blocks_w + bx) * 64,
                   j.quant[c.tq],
                   planes[i].data() + (size_t)by * 8 * pw + bx * 8, pw);
  }
  if (j.ncomp == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(out + (size_t)y * W, planes[0].data() + (size_t)y * pstride[0],
                  W);
    return JPEG_OK;
  }
  // chroma to full size
  const uint8_t* full[3];
  int fstride[3];
  std::vector<uint8_t> up[3];
  for (int i = 0; i < 3; ++i) {
    Component& c = j.comp[i];
    int sh = j.hmax / c.h, sv = j.vmax / c.v;
    if (sh == 1 && sv == 1) {
      full[i] = planes[i].data();
      fstride[i] = pstride[i];
      continue;
    }
    int ow = c.width * 2, oh = sv == 2 ? c.height * 2 : c.height;
    up[i].assign((size_t)ow * oh, 0);
    if (sv == 1)
      upsample_h2v1(planes[i].data(), pstride[i], c.width, c.height,
                    up[i].data(), ow);
    else
      upsample_h2v2(planes[i].data(), pstride[i], c.width, c.height,
                    up[i].data(), ow);
    full[i] = up[i].data();
    fstride[i] = ow;
  }
  if (!is_ycbcr(j)) {
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x)
        for (int i = 0; i < 3; ++i)
          out[((size_t)y * W + x) * 3 + i] = full[i][(size_t)y * fstride[i] + x];
    return JPEG_OK;
  }
  const YccTables& t = ycc_tables();
  const uint8_t* limit = range_limit().simple;
  for (int y = 0; y < H; ++y) {
    const uint8_t* py = full[0] + (size_t)y * fstride[0];
    const uint8_t* pb = full[1] + (size_t)y * fstride[1];
    const uint8_t* pr = full[2] + (size_t)y * fstride[2];
    uint8_t* o = out + (size_t)y * W * 3;
    for (int x = 0; x < W; ++x) {
      int yy = py[x], cb = pb[x], cr = pr[x];
      o[3 * x + 0] = limit[yy + t.cr_r[cr]];
      o[3 * x + 1] = limit[yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)];
      o[3 * x + 2] = limit[yy + t.cb_b[cb]];
    }
  }
  return JPEG_OK;
}

// ----------------------------------------------------------------------
// JPEG encoder
// ----------------------------------------------------------------------

// Baseline JPEG as libjpeg-turbo's defaults write it, which is what
// Pillow's `Image.save(path)` runs: JFIF, RGB -> YCbCr by jccolor.c's
// fixed-point tables, 4:2:0 by jcsample.c's h2v2 box filter (rounding
// biases 1, 2 alternating along a row), the image padded to whole MCUs by
// repeating its last column and row (jcsample.c, jcprepct.c) and blocks
// wholly outside it coded as their neighbour's DC (jccoefct.c), the
// `islow` forward DCT (jfdctint.c), quantisation by the IJG tables scaled
// to a quality (jcparam.c) with rounding to nearest, and the standard
// Huffman tables of the JPEG specification's annex K.

const uint8_t kStdLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// annex K.3: code counts by length (1..16), then the values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0,
                                 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0,
                                   0, 0, 0};
const uint8_t kDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0,
                                 1, 0x7d};
const uint8_t kAcLumaValues[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
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
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1,
                                   2, 0x77};
const uint8_t kAcChromaValues[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
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
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jcparam.c: jpeg_quality_scaling and jpeg_add_quant_table, baseline
void scaled_quant(const uint8_t* basic, int quality, uint16_t* out) {
  quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    int v = (basic[i] * scale + 50) / 100;
    out[i] = (uint16_t)(v < 1 ? 1 : (v > 255 ? 255 : v));
  }
}

struct HuffCodes {
  uint16_t code[256];
  uint8_t size[256];
};

// jchuff.c: jpeg_make_c_derived_tbl
HuffCodes make_codes(const uint8_t bits[16], const uint8_t* values) {
  HuffCodes h{};
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i, ++k) {
      h.code[values[k]] = (uint16_t)code++;
      h.size[values[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
  return h;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t byte = (uint8_t)(acc >> (nbits - 8));
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0);     // stuffing
      nbits -= 8;
    }
    acc &= (1u << nbits) - 1;
  }
  void flush() {                             // pad with 1 bits
    if (nbits > 0) put(0x7F, 8 - nbits);
  }
};

// jfdctint.c: jpeg_fdct_islow, output scaled up by 8
void fdct_islow(int32_t* data) {
  int32_t* p = data;
  for (int r = 0; r < 8; ++r, p += 8) {
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865,
                            CONST_BITS - PASS1_BITS);
    p[6] = (int32_t)descale(z1 - tmp12 * FIX_1_847759065,
                            CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = (int32_t)descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = (int32_t)descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = (int32_t)descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = (int32_t)descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  p = data;
  for (int c = 0; c < 8; ++c, ++p) {
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = (int32_t)descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865,
                             CONST_BITS + PASS1_BITS);
    p[48] = (int32_t)descale(z1 - tmp12 * FIX_1_847759065,
                             CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = (int32_t)descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = (int32_t)descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = (int32_t)descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = (int32_t)descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// One plane padded to whole blocks: `w` x `h` samples, row-major.
struct Plane {
  int w, h;
  std::vector<uint8_t> px;
};

// The quantised coefficients (natural order) of the 8x8 block at (bx, by)
// of `p`: the DCT of the samples less 128, each divided by 8 q with
// rounding to nearest (jcdctmgr.c: quantize).
void forward_block(const Plane& p, int bx, int by, const uint16_t* quant,
                   int16_t* out) {
  int32_t d[64];
  for (int y = 0; y < 8; ++y) {
    const uint8_t* row = &p.px[(size_t)(by * 8 + y) * p.w + bx * 8];
    for (int x = 0; x < 8; ++x) d[y * 8 + x] = (int32_t)row[x] - 128;
  }
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) {
    int32_t q = (int32_t)quant[i] << 3, v = d[i];
    out[i] = (int16_t)(v < 0 ? -((-v + (q >> 1)) / q) : (v + (q >> 1)) / q);
  }
}

void encode_block(BitWriter& bw, const int16_t* block, int& last_dc,
                  const HuffCodes& dc, const HuffCodes& ac) {
  auto magnitude = [](int v) {
    int n = 0;
    for (int a = v < 0 ? -v : v; a; a >>= 1) ++n;
    return n;
  };
  int diff = block[0] - last_dc;
  last_dc = block[0];
  int n = magnitude(diff);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = block[kNaturalOrder[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) bw.put(ac.code[0xF0], ac.size[0xF0]);
    n = magnitude(v);
    int sym = (run << 4) | n;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put((uint32_t)(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t bits[16],
             const uint8_t* values) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  o.insert(o.end(), {0xFF, 0xC4});
  put16(o, 2 + 1 + 16 + n);
  o.push_back((uint8_t)cls_id);
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), values, values + n);
}

std::vector<uint8_t> encode_jpeg_rgb(const uint8_t* rgb, int h, int w,
                                     int quality) {
  // jccolor.c: rgb_ycc_convert, SCALEBITS 16
  auto fix = [](double x) { return (int32_t)(x * 65536 + 0.5); };
  const int32_t half = 1 << 15, cbcr = 128 << 16;
  const int mcus_x = (w + 15) / 16, mcus_y = (h + 15) / 16;
  const int luma_bw = (w + 7) / 8, luma_bh = (h + 7) / 8;
  const int h2 = h + (h & 1);                // rows padded to even
  Plane ys{luma_bw * 8, luma_bh * 8, {}}, cb{mcus_x * 8, mcus_y * 8, {}},
      cr{mcus_x * 8, mcus_y * 8, {}};
  ys.px.resize((size_t)ys.w * ys.h);
  cb.px.resize((size_t)cb.w * cb.h);
  cr.px.resize((size_t)cr.w * cr.h);
  // the colour-converted rows, the last column repeated to the chroma
  // MCU width (jcsample.c: expand_right_edge)
  const int wide = mcus_x * 16;
  std::vector<uint8_t> yrow(wide), cbrows(2 * (size_t)wide),
      crrows(2 * (size_t)wide);
  auto convert = [&](int y, uint8_t* yo, uint8_t* bo, uint8_t* ro) {
    const uint8_t* in = rgb + (size_t)y * w * 3;
    for (int x = 0; x < w; ++x) {
      int32_t r = in[3 * x], g = in[3 * x + 1], b = in[3 * x + 2];
      yo[x] = (uint8_t)((fix(0.29900) * r + fix(0.58700) * g +
                         fix(0.11400) * b + half) >> 16);
      bo[x] = (uint8_t)((-fix(0.16874) * r - fix(0.33126) * g +
                         fix(0.5) * b + cbcr + half - 1) >> 16);
      ro[x] = (uint8_t)((fix(0.5) * r - fix(0.41869) * g -
                         fix(0.08131) * b + cbcr + half - 1) >> 16);
    }
    for (int x = w; x < wide; ++x) {
      yo[x] = yo[w - 1];
      bo[x] = bo[w - 1];
      ro[x] = ro[w - 1];
    }
  };
  for (int y = 0; y < h2; y += 2) {
    for (int k = 0; k < 2; ++k) {
      int src = y + k < h ? y + k : h - 1;   // jcprepct.c: last row again
      convert(src, yrow.data(), &cbrows[(size_t)k * wide],
              &crrows[(size_t)k * wide]);
      if (y + k < ys.h)
        std::memcpy(&ys.px[(size_t)(y + k) * ys.w], yrow.data(), ys.w);
    }
    // jcsample.c: h2v2_downsample
    uint8_t* bo = &cb.px[(size_t)(y / 2) * cb.w];
    uint8_t* ro = &cr.px[(size_t)(y / 2) * cr.w];
    int bias = 1;
    for (int x = 0; x < cb.w; ++x) {
      const uint8_t *b0 = &cbrows[2 * x], *b1 = &cbrows[wide + 2 * x];
      const uint8_t *r0 = &crrows[2 * x], *r1 = &crrows[wide + 2 * x];
      bo[x] = (uint8_t)((b0[0] + b0[1] + b1[0] + b1[1] + bias) >> 2);
      ro[x] = (uint8_t)((r0[0] + r0[1] + r1[0] + r1[1] + bias) >> 2);
      bias ^= 3;
    }
  }
  // the last rows repeated to whole blocks (jcprepct.c: expand_bottom_edge)
  for (int y = h2; y < ys.h; ++y)
    std::memcpy(&ys.px[(size_t)y * ys.w], &ys.px[(size_t)(h2 - 1) * ys.w],
                ys.w);
  for (Plane* c : {&cb, &cr})
    for (int y = h2 / 2; y < c->h; ++y)
      std::memcpy(&c->px[(size_t)y * c->w],
                  &c->px[(size_t)(h2 / 2 - 1) * c->w], c->w);

  uint16_t qy[64], qc[64];
  scaled_quant(kStdLumaQuant, quality, qy);
  scaled_quant(kStdChromaQuant, quality, qc);
  std::vector<uint8_t> out;
  out.reserve((size_t)w * h / 2 + 1024);
  out.insert(out.end(), {0xFF, 0xD8,                           // SOI
                         0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0,  // APP0
                         1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < 2; ++t) {                                // DQT
    const uint16_t* q = t ? qc : qy;
    out.insert(out.end(), {0xFF, 0xDB, 0, 67, (uint8_t)t});
    for (int k = 0; k < 64; ++k) out.push_back((uint8_t)q[kNaturalOrder[k]]);
  }
  out.insert(out.end(), {0xFF, 0xC0, 0, 17, 8});               // SOF0
  put16(out, h);
  put16(out, w);
  out.insert(out.end(), {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  put_dht(out, 0x00, kDcLumaBits, kDcValues);
  put_dht(out, 0x10, kAcLumaBits, kAcLumaValues);
  put_dht(out, 0x01, kDcChromaBits, kDcValues);
  put_dht(out, 0x11, kAcChromaBits, kAcChromaValues);
  out.insert(out.end(), {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11,
                         0, 63, 0});                            // SOS

  const HuffCodes dcy = make_codes(kDcLumaBits, kDcValues),
                  acy = make_codes(kAcLumaBits, kAcLumaValues),
                  dcc = make_codes(kDcChromaBits, kDcValues),
                  acc = make_codes(kAcChromaBits, kAcChromaValues);
  BitWriter bw(out);
  int dc_y = 0, dc_cb = 0, dc_cr = 0;
  int16_t blocks[4][64], chroma[64];
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      for (int k = 0; k < 4; ++k) {
        int bx = 2 * mx + (k & 1), by = 2 * my + (k >> 1);
        if (by >= luma_bh) {         // a dummy row: the previous block's DC
          std::memset(blocks[k], 0, sizeof(blocks[k]));
          blocks[k][0] = blocks[(k >> 1) * 2 - 1][0];
        } else if (bx >= luma_bw) {  // a dummy column: its left block's DC
          std::memset(blocks[k], 0, sizeof(blocks[k]));
          blocks[k][0] = blocks[k - 1][0];
        } else {
          forward_block(ys, bx, by, qy, blocks[k]);
        }
        encode_block(bw, blocks[k], dc_y, dcy, acy);
      }
      forward_block(cb, mx, my, qc, chroma);
      encode_block(bw, chroma, dc_cb, dcc, acc);
      forward_block(cr, mx, my, qc, chroma);
      encode_block(bw, chroma, dc_cr, dcc, acc);
    }
  }
  bw.flush();
  out.insert(out.end(), {0xFF, 0xD9});                         // EOI
  return out;
}

// ----------------------------------------------------------------------
// Pillow's resamplers (libImaging/Resample.c, Geometry.c)
// ----------------------------------------------------------------------

constexpr int PRECISION_BITS = 32 - 8 - 2;

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// precompute_coeffs with the bilinear filter, then normalize_coeffs_8bpc
int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
  float in0 = 0.0f, in1 = (float)in_size;
  double scale = (double)(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  int ksize = (int)std::ceil(support) * 2 + 1;
  std::vector<double> pre((size_t)out_size * ksize, 0.0);
  bounds.assign((size_t)out_size * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[(size_t)xx * ksize];
    int x = 0;
    for (; x < xmax; ++x) {
      double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    for (; x < ksize; ++x) k[x] = 0;
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  kk.assign(pre.size(), 0);
  for (size_t i = 0; i < pre.size(); ++i)
    kk[i] = pre[i] < 0 ? (int32_t)(-0.5 + pre[i] * (1 << PRECISION_BITS))
                       : (int32_t)(0.5 + pre[i] * (1 << PRECISION_BITS));
  return ksize;
}

inline uint8_t clip8(int in) {
  int v = in >> PRECISION_BITS;
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// Undoes the PNG row filters of `height` rows of `row_bytes` bytes, each
// after its filter byte, `bpp` bytes a pixel (at least 1); writes the
// rows without their filter bytes to `out`. Returns 0, or the 1-based
// row of an unknown filter type.
int png_unfilter(const uint8_t* raw, int64_t raw_len, int height,
                 int row_bytes, int bpp, uint8_t* out) {
  if (raw_len < (int64_t)height * (row_bytes + 1)) return -1;
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* in = raw + (size_t)y * (row_bytes + 1);
    int filter = in[0];
    ++in;
    uint8_t* o = out + (size_t)y * row_bytes;
    switch (filter) {
      case 0:
        std::memcpy(o, in, row_bytes);
        break;
      case 1:
        for (int i = 0; i < row_bytes; ++i)
          o[i] = (uint8_t)(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < row_bytes; ++i)
          o[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0;
          o[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          o[i] = (uint8_t)(in[i] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
    prev = o;
  }
  return 0;
}

// Reads a JPEG's size: `whc` gets width, height and channels. Returns 0
// or an error code (codec.py names them).
int jpeg_info(const uint8_t* data, int64_t len, int* whc) {
  Jpeg j;
  int err = jpeg_parse(j, data, (size_t)len, false);
  if (err) return err;
  whc[0] = j.width;
  whc[1] = j.height;
  whc[2] = j.ncomp;
  return 0;
}

// Decodes a JPEG into `out` (height x width x channels uint8, `capacity`
// bytes). Returns 0 or an error code.
int jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out,
                int64_t capacity) {
  Jpeg j;
  int err = jpeg_parse(j, data, (size_t)len, true);
  if (err) return err;
  if ((int64_t)j.width * j.height * j.ncomp > capacity) return JPEG_CAPACITY;
  return jpeg_render(j, out);
}

// Encodes an (h, w, 3) RGB image as a baseline JPEG of `quality` (1-100)
// into `out` (`capacity` bytes). Returns the file's length, or -1 when it
// does not fit.
int64_t jpeg_encode(const uint8_t* rgb, int h, int w, int quality,
                    uint8_t* out, int64_t capacity) {
  std::vector<uint8_t> file = encode_jpeg_rgb(rgb, h, w, quality);
  if ((int64_t)file.size() > capacity) return -1;
  std::memcpy(out, file.data(), file.size());
  return (int64_t)file.size();
}

// Pillow's BILINEAR resize of an 8-bit (in_h, in_w, channels) image to
// (out_h, out_w): a horizontal pass when the width changes, then a
// vertical pass when the height does.
void resize_bilinear_u8(const uint8_t* in, int in_h, int in_w, int channels,
                        uint8_t* out, int out_h, int out_w) {
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  bool need_h = out_w != in_w, need_v = out_h != in_h;
  int ksh = precompute_coeffs(in_w, out_w, bh, kh);
  int ksv = precompute_coeffs(in_h, out_h, bv, kv);
  int ybox_first = bv[0];
  int ybox_last = bv[out_h * 2 - 2] + bv[out_h * 2 - 1];
  const uint8_t* src = in;
  int src_h = in_h, src_w = in_w;
  std::vector<uint8_t> tmp;
  if (need_h) {
    for (int i = 0; i < out_h; ++i) bv[i * 2] -= ybox_first;
    int th = ybox_last - ybox_first;
    tmp.assign((size_t)th * out_w * channels, 0);
    for (int yy = 0; yy < th; ++yy) {
      const uint8_t* row = in + (size_t)(yy + ybox_first) * in_w * channels;
      uint8_t* o = tmp.data() + (size_t)yy * out_w * channels;
      for (int xx = 0; xx < out_w; ++xx) {
        int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int32_t* k = &kh[(size_t)xx * ksh];
        for (int ch = 0; ch < channels; ++ch) {
          int ss = 1 << (PRECISION_BITS - 1);
          for (int x = 0; x < xmax; ++x)
            ss += row[(x + xmin) * channels + ch] * k[x];
          o[xx * channels + ch] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    src_h = th;
    src_w = out_w;
  }
  if (need_v) {
    for (int yy = 0; yy < out_h; ++yy) {
      const int32_t* k = &kv[(size_t)yy * ksv];
      int ymin = bv[yy * 2], ymax = bv[yy * 2 + 1];
      uint8_t* o = out + (size_t)yy * src_w * channels;
      for (int xx = 0; xx < src_w * channels; ++xx) {
        int ss = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; ++y)
          ss += src[(size_t)(y + ymin) * src_w * channels + xx] * k[y];
        o[xx] = clip8(ss);
      }
    }
  } else {
    std::memcpy(out, src, (size_t)src_h * src_w * channels);
  }
}

// Pillow's NEAREST resize of (in_h, in_w) pixels of `pixel_bytes` bytes
// each. 8-bit images go through ImagingScaleAffine, which steps the source
// position from half a pixel by in / out (`stepped` 1); 16-bit ones
// through the generic affine transform, floor((x + 0.5) * in / out).
void resize_nearest(const uint8_t* in, int in_h, int in_w, int pixel_bytes,
                    uint8_t* out, int out_h, int out_w, int stepped) {
  double ax = (double)in_w / out_w, ay = (double)in_h / out_h;
  auto coord = [](double v, int size) {
    int i = v < 0.0 ? -1 : (int)v;
    return i < 0 ? 0 : (i >= size ? size - 1 : i);
  };
  std::vector<int> xin(out_w);
  double xo = ax * 0.5;
  for (int x = 0; x < out_w; ++x) {
    xin[x] = coord(stepped ? xo : ax * (x + 0.5), in_w);
    xo += ax;
  }
  double yo = ay * 0.5;
  for (int y = 0; y < out_h; ++y) {
    int yi = coord(stepped ? yo : ay * (y + 0.5), in_h);
    const uint8_t* row = in + (size_t)yi * in_w * pixel_bytes;
    uint8_t* o = out + (size_t)y * out_w * pixel_bytes;
    for (int x = 0; x < out_w; ++x)
      std::memcpy(o + (size_t)x * pixel_bytes,
                  row + (size_t)xin[x] * pixel_bytes, pixel_bytes);
    yo += ay;
  }
}

}  // extern "C"
