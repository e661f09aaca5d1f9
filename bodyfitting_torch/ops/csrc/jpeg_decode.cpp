// JPEG decoding (host C++): the pixels libjpeg-turbo's defaults give, as
// cv2.imread returns them.
//
// Scope: Huffman-coded 8-bit baseline and extended sequential (SOF0, SOF1)
// and progressive (SOF2) images of 1 or 3 components, with sampling
// factors of 1 or 2 in each direction, restart intervals, APPn and COM
// segments skipped.  Everything else is refused with a message: arithmetic
// coding, 12-bit samples, lossless and hierarchical frames, 2 or 4
// components (CMYK, YCCK), and a truncated or corrupt stream (libjpeg-turbo
// warns, pads the missing data and returns an image; this decoder does not
// guess).
//
// Bit-exactness follows libjpeg-turbo's default decompression path:
//   * jidctint.c's JDCT_ISLOW integer IDCT (CONST_BITS 13, PASS1_BITS 2)
//     and its range-limit table;
//   * jdsample.c's "fancy" triangle upsampling: h2v1 and h2v2 when the
//     component is wider than 2 samples (box replication otherwise), h1v2
//     always, each with libjpeg's rounding biases and the image edges
//     replicated (jdmainct.c's context rows);
//   * jdcolor.c's fixed-point YCbCr -> RGB tables, SCALEBITS 16;
//   * jdapimin.c's colour-space guess from the JFIF / Adobe markers and the
//     component ids.
// A complete progressive image has every coefficient refined, so libjpeg's
// block smoothing does not run; an image that leaves any of the first 10
// coefficients unrefined is refused.
//
// Built at first use by bodyfitting_torch/ops/kernels/_build.py with the
// system C++ compiler; io/jpeg.py calls it through ctypes.

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

// zig-zag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int maxcode[18];     // largest code of each length, -1 when none
  int valptr[17];      // index into vals of the first code of each length
  int mincode[17];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | value, 0 if longer
};

// jdhuff.c jpeg_make_d_derived_tbl: canonical codes, none of them all ones,
// DC symbols at most 15.
void build_huffman(Huffman* h, const uint8_t counts[16], const uint8_t* vals,
                   int nvals, bool is_dc) {
  memcpy(h->vals, vals, nvals);
  for (int i = 0; i < nvals; ++i)
    if (is_dc && vals[i] > 15) fail("corrupt Huffman table");
  int maxlen = 0;
  for (int l = 1; l <= 16; ++l)
    if (counts[l - 1]) maxlen = l;
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    h->valptr[l] = k;
    h->mincode[l] = code;
    code += counts[l - 1];
    k += counts[l - 1];
    h->maxcode[l] = counts[l - 1] ? code - 1 : -1;
    if (l <= maxlen && code >= (1 << l)) fail("corrupt Huffman table");
    code <<= 1;
  }
  h->maxcode[17] = 0x7fffffff;
  memset(h->look, 0, sizeof(h->look));
  k = 0;
  code = 0;
  for (int l = 1; l <= 9; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
      int lo = code << (9 - l), n = 1 << (9 - l);
      for (int j = 0; j < n; ++j)
        h->look[lo + j] = (uint16_t)((l << 8) | vals[k]);
    }
    code <<= 1;
  }
  h->defined = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled width and height (samples)
  int bw = 0, bh = 0;        // blocks a row and rows of blocks, MCU-padded
  bool latched = false;      // quantisation table copied at its first scan
  int16_t qt[64];            // natural order; libjpeg's ISLOW_MULT_TYPE
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int coef_bits[64];         // zig-zag k: the Al last coded, -1 never
  bool seen = false;
};

struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t acc = 0;
  int bits = 0;
  bool at_marker = false;
  int64_t real = 0, used = 0;  // real bits read from the stream, consumed

  void reset(size_t p) {
    pos = p;
    acc = 0;
    bits = 0;
    at_marker = false;
    real = used = 0;
  }
  void fill() {
    while (bits <= 56) {
      uint64_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;  // fill bytes
          if (q < n && d[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;  // a marker (or the end): pad with zeros
            pos = q - 1;
            b = 0;
          }
        } else {
          ++pos;
        }
        if (!at_marker) real += 8;
      } else {
        at_marker = true;
      }
      acc |= b << (56 - bits);
      bits += 8;
    }
  }
  inline uint32_t peek(int k) {
    if (bits < k) fill();
    return (uint32_t)(acc >> (64 - k));
  }
  inline void skip(int k) {
    acc <<= k;
    bits -= k;
    used += k;
  }
  inline uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  inline int bit() { return (int)get(1); }
  bool overrun() const { return used > real; }
};

inline int extend(uint32_t v, int s) {
  return (s && v < (1u << (s - 1))) ? (int)v - (1 << s) + 1 : (int)v;
}

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  void run();

  int width = 0, height = 0, ncomp = 0;
  std::vector<uint8_t> out;  // height x width x (1 or 3), RGB order

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;

  // frame
  bool have_frame_ = false, progressive_ = false;
  int max_h_ = 1, max_v_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  Component comp_[3];
  int16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;

  // scan
  int scomp_[3], ns_ = 0, ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int dc_tbl_[3], ac_tbl_[3];
  int pred_[3];
  int eobrun_ = 0;
  BitReader br_;

  uint8_t byte() {
    if (pos_ >= n_) fail("truncated file (no EOI marker)");
    return d_[pos_++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker();
  void read_sof(int marker, int len);
  void read_dqt(int len);
  void read_dht(int len);
  void read_sos(int len);
  void read_app(int marker, int len);
  void decode_scan();
  int decode_huff(const Huffman& h);
  void decode_block(int ci, int16_t* blk);
  void restart(int* expected_rst);
  void finish();
};

int Decoder::next_marker() {
  // skip to the next 0xFF; several 0xFF are fill bytes
  while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
  while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
  if (pos_ >= n_) fail("truncated file (no EOI marker)");
  return d_[pos_++];
}

void Decoder::read_app(int marker, int len) {
  const uint8_t* p = d_ + pos_;
  if (marker == 0xE0 && len >= 14 && memcmp(p, "JFIF\0", 5) == 0)
    saw_jfif_ = true;
  if (marker == 0xEE && len >= 12 && memcmp(p, "Adobe", 5) == 0) {
    saw_adobe_ = true;
    adobe_transform_ = p[11];
  }
}

void Decoder::read_sof(int marker, int len) {
  if (have_frame_) fail("more than one frame header");
  if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
    fail("lossless JPEG is not supported");
  if (marker >= 0xC9)
    fail("arithmetic-coded JPEG is not supported");
  if (marker >= 0xC5) fail("hierarchical JPEG is not supported");
  progressive_ = marker == 0xC2;
  int precision = byte();
  if (precision != 8)
    fail(std::to_string(precision) + "-bit JPEG is not supported (8-bit only)");
  height = u16();
  width = u16();
  ncomp = byte();
  if (height == 0) fail("a DNL-defined height is not supported");
  if (width == 0) fail("zero image width");
  if (ncomp == 4) fail("CMYK/YCCK JPEG is not supported");
  if (ncomp != 1 && ncomp != 3)
    fail(std::to_string(ncomp) + "-component JPEG is not supported");
  if (len != 8 + 3 * ncomp) fail("corrupt frame header");
  for (int c = 0; c < ncomp; ++c) {
    Component& k = comp_[c];
    k.id = byte();
    int hv = byte();
    k.h = hv >> 4;
    k.v = hv & 15;
    k.tq = byte();
    if (k.h < 1 || k.h > 2 || k.v < 1 || k.v > 2)
      fail("sampling factors above 2 are not supported");
    if (k.tq > 3) fail("corrupt frame header");
    max_h_ = std::max(max_h_, k.h);
    max_v_ = std::max(max_v_, k.v);
  }
  if (ncomp == 1) {  // one component: an MCU is one block
    comp_[0].h = comp_[0].v = max_h_ = max_v_ = 1;
  }
  mcus_x_ = (width + 8 * max_h_ - 1) / (8 * max_h_);
  mcus_y_ = (height + 8 * max_v_ - 1) / (8 * max_v_);
  for (int c = 0; c < ncomp; ++c) {
    Component& k = comp_[c];
    k.dw = (int)(((int64_t)width * k.h + max_h_ - 1) / max_h_);
    k.dh = (int)(((int64_t)height * k.v + max_v_ - 1) / max_v_);
    k.bw = mcus_x_ * k.h;
    k.bh = mcus_y_ * k.v;
    k.coef.assign((size_t)k.bw * k.bh * 64, 0);
    for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
  }
  have_frame_ = true;
}

void Decoder::read_dqt(int len) {
  size_t end = pos_ + len - 2;
  while (pos_ < end) {
    int pq_tq = byte();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3 || pq > 1) fail("corrupt quantisation table");
    for (int k = 0; k < 64; ++k)
      qt_[tq][kNatural[k]] = (int16_t)(pq ? u16() : byte());
    qt_defined_[tq] = true;
  }
  if (pos_ != end) fail("corrupt quantisation table");
}

void Decoder::read_dht(int len) {
  size_t end = pos_ + len - 2;
  while (pos_ < end) {
    int tc_th = byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) fail("corrupt Huffman table");
    uint8_t counts[16];
    int total = 0;
    for (int i = 0; i < 16; ++i) total += counts[i] = byte();
    if (total > 256 || pos_ + total > end) fail("corrupt Huffman table");
    build_huffman(tc ? &ac_[th] : &dc_[th], counts, d_ + pos_, total,
                  tc == 0);
    pos_ += total;
  }
  if (pos_ != end) fail("corrupt Huffman table");
}

void Decoder::read_sos(int len) {
  if (!have_frame_) fail("scan before the frame header");
  ns_ = byte();
  if (ns_ < 1 || ns_ > ncomp || len != 6 + 2 * ns_) fail("corrupt scan header");
  for (int i = 0; i < ns_; ++i) {
    int id = byte(), t = byte();
    int c = 0;
    while (c < ncomp && comp_[c].id != id) ++c;
    if (c == ncomp) fail("scan names an unknown component");
    for (int j = 0; j < i; ++j)
      if (scomp_[j] == c) fail("corrupt scan header");
    scomp_[i] = c;
    dc_tbl_[i] = t >> 4;
    ac_tbl_[i] = t & 15;
    if (dc_tbl_[i] > 3 || ac_tbl_[i] > 3) fail("corrupt scan header");
  }
  ss_ = byte();
  se_ = byte();
  int a = byte();
  ah_ = a >> 4;
  al_ = a & 15;
  if (progressive_) {
    if (ss_ > se_ || se_ > 63 || (ss_ == 0 && se_ != 0) ||
        (ss_ > 0 && ns_ != 1) || al_ > 13 || (ah_ && ah_ != al_ + 1))
      fail("corrupt progressive scan parameters");
  } else if (ss_ != 0 || se_ != 63 || ah_ != 0 || al_ != 0) {
    fail("corrupt sequential scan parameters");
  }
  for (int i = 0; i < ns_; ++i) {
    Component& k = comp_[scomp_[i]];
    if (!k.latched) {
      if (!qt_defined_[k.tq]) fail("missing quantisation table");
      memcpy(k.qt, qt_[k.tq], sizeof(k.qt));
      k.latched = true;
    }
    k.seen = true;
    bool need_dc = ss_ == 0 && ah_ == 0;
    bool need_ac = se_ > 0 && (!progressive_ || ss_ > 0);
    if ((need_dc && !dc_[dc_tbl_[i]].defined) ||
        (need_ac && !ac_[ac_tbl_[i]].defined))
      fail("missing Huffman table");
    // the progressive bookkeeping of libjpeg's coef_bits
    for (int kk = ss_; kk <= se_; ++kk) {
      if (progressive_) {
        if (k.coef_bits[kk] != (ah_ ? ah_ : -1))
          fail("corrupt progressive scan sequence");
      }
      k.coef_bits[kk] = al_;
    }
  }
  decode_scan();
}

int Decoder::decode_huff(const Huffman& h) {
  uint32_t p = br_.peek(16);
  uint16_t e = h.look[p >> 7];
  if (e) {
    br_.skip(e >> 8);
    return e & 0xFF;
  }
  int l = 10;
  int code = (int)(p >> (16 - l));
  while (code > h.maxcode[l]) {
    ++l;
    if (l > 16) fail("corrupt data (bad Huffman code)");
    code = (int)(p >> (16 - l));
  }
  br_.skip(l);
  int idx = h.valptr[l] + code - h.mincode[l];
  if (idx < 0 || idx > 255) fail("corrupt data (bad Huffman code)");
  return h.vals[idx];
}

// One block of the current scan for scan component i.
void Decoder::decode_block(int i, int16_t* blk) {
  if (!progressive_) {
    int s = decode_huff(dc_[dc_tbl_[i]]);
    if (s > 16) fail("corrupt data");
    pred_[i] += extend(br_.get(s), s);
    blk[0] = (int16_t)pred_[i];
    const Huffman& ac = ac_[ac_tbl_[i]];
    for (int k = 1; k < 64; ++k) {
      int rs = decode_huff(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt data (coefficient index past 63)");
        blk[kNatural[k]] = (int16_t)extend(br_.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return;
  }
  if (ss_ == 0) {  // DC scans
    if (ah_ == 0) {
      int s = decode_huff(dc_[dc_tbl_[i]]);
      if (s > 16) fail("corrupt data");
      pred_[i] += extend(br_.get(s), s);
      blk[0] = (int16_t)(pred_[i] * (1 << al_));
    } else if (br_.bit()) {
      blk[0] = (int16_t)(blk[0] | (1 << al_));
    }
    return;
  }
  const Huffman& ac = ac_[ac_tbl_[i]];
  if (ah_ == 0) {  // AC first pass
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    for (int k = ss_; k <= se_; ++k) {
      int rs = decode_huff(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt data (coefficient index past 63)");
        blk[kNatural[k]] = (int16_t)(extend(br_.get(s), s) * (1 << al_));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = (1 << r) - 1;
        if (r) eobrun_ += (int)br_.get(r);
        break;
      }
    }
    return;
  }
  // AC refinement (jdphuff.c decode_mcu_AC_refine)
  const int p1 = 1 << al_, m1 = -1 * (1 << al_);
  int k = ss_;
  if (eobrun_ == 0) {
    for (; k <= se_; ++k) {
      int rs = decode_huff(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) fail("corrupt data (refinement value)");
        s = br_.bit() ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += (int)br_.get(r);
        break;
      }
      do {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) {
          if (br_.bit() && (*c & p1) == 0)
            *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
        } else {
          if (--r < 0) break;
        }
        ++k;
      } while (k <= se_);
      if (s) {
        if (k > 63) fail("corrupt data (coefficient index past 63)");
        blk[kNatural[k]] = (int16_t)s;
      }
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t* c = blk + kNatural[k];
      if (*c != 0 && br_.bit() && (*c & p1) == 0)
        *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
    }
    --eobrun_;
  }
}

void Decoder::restart(int* expected_rst) {
  if (br_.overrun()) fail("truncated or corrupt data in a restart interval");
  pos_ = br_.pos;
  int m = next_marker();
  if (m != 0xD0 + *expected_rst)
    fail("corrupt data (missing restart marker)");
  *expected_rst = (*expected_rst + 1) & 7;
  br_.reset(pos_);
  for (int i = 0; i < ns_; ++i) pred_[i] = 0;
  eobrun_ = 0;
}

void Decoder::decode_scan() {
  br_.d = d_;
  br_.n = n_;
  br_.reset(pos_);
  for (int i = 0; i < ns_; ++i) pred_[i] = 0;
  eobrun_ = 0;
  int expected_rst = 0;
  long mcu = 0;
  if (ns_ == 1) {  // non-interleaved: one block an MCU
    Component& k = comp_[scomp_[0]];
    int nbx = (k.dw + 7) / 8, nby = (k.dh + 7) / 8;
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx) {
        if (restart_interval_ && mcu && mcu % restart_interval_ == 0)
          restart(&expected_rst);
        decode_block(0, &k.coef[((size_t)by * k.bw + bx) * 64]);
        ++mcu;
      }
  } else {
    for (int my = 0; my < mcus_y_; ++my)
      for (int mx = 0; mx < mcus_x_; ++mx) {
        if (restart_interval_ && mcu && mcu % restart_interval_ == 0)
          restart(&expected_rst);
        for (int i = 0; i < ns_; ++i) {
          Component& k = comp_[scomp_[i]];
          for (int v = 0; v < k.v; ++v)
            for (int h = 0; h < k.h; ++h) {
              size_t b = (size_t)(my * k.v + v) * k.bw + mx * k.h + h;
              decode_block(i, &k.coef[b * 64]);
            }
        }
        ++mcu;
      }
  }
  if (br_.overrun()) fail("truncated or corrupt data");
  pos_ = br_.pos;
}

// ---------------------------------------------------------------------------
// Reconstruction: IDCT, upsampling, colour conversion
// ---------------------------------------------------------------------------

inline uint8_t range_limit_idct(int x) {
  // jdmaster.c prepare_range_limit_table, post-IDCT part: x & 1023
  int v = x & 1023;
  if (v < 128) return (uint8_t)(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return (uint8_t)(v - 896);
}

const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// One 1-D pass of jidctint.c's jpeg_idct_islow on x[0..7] (a column of
// dequantised coefficients, or a row of the workspace): o[k] before the
// pass's descale.
inline void islow_1d(const int64_t x[8], int64_t o[8]) {
  // even part: the rotator is sqrt(2) * c(-6)
  int64_t z1 = (x[2] + x[6]) * FIX_0_541196100;
  int64_t tmp2 = z1 + x[6] * -FIX_1_847759065;
  int64_t tmp3 = z1 + x[2] * FIX_0_765366865;
  int64_t tmp0 = (x[0] + x[4]) * (1 << CONST_BITS);
  int64_t tmp1 = (x[0] - x[4]) * (1 << CONST_BITS);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  // odd part: x[7], x[5], x[3], x[1]
  tmp0 = x[7];
  tmp1 = x[5];
  tmp2 = x[3];
  tmp3 = x[1];
  z1 = tmp0 + tmp3;
  int64_t z2 = tmp1 + tmp2, z3 = tmp0 + tmp2, z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 = tmp0 * FIX_0_298631336;
  tmp1 = tmp1 * FIX_2_053119869;
  tmp2 = tmp2 * FIX_3_072711026;
  tmp3 = tmp3 * FIX_1_501321110;
  z1 = z1 * -FIX_0_899976223;
  z2 = z2 * -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  o[0] = tmp10 + tmp3;
  o[7] = tmp10 - tmp3;
  o[1] = tmp11 + tmp2;
  o[6] = tmp11 - tmp2;
  o[2] = tmp12 + tmp1;
  o[5] = tmp12 - tmp1;
  o[3] = tmp13 + tmp0;
  o[4] = tmp13 - tmp0;
}

// jidctint.c jpeg_idct_islow for one block into out (stride bytes a row):
// columns into the workspace, scaled by 2^PASS1_BITS, then rows; a column
// or row whose AC terms are all zero takes the shortcut libjpeg takes (it
// gives the same values).
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  int64_t x[8], o[8];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    bool ac = false;
    for (int r = 0; r < 8; ++r) {
      x[r] = (int64_t)((int)ip[8 * r] * (int)qp[8 * r]);
      ac |= r > 0 && ip[8 * r] != 0;
    }
    if (!ac) {
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = (int)x[0] * (1 << PASS1_BITS);
      continue;
    }
    islow_1d(x, o);
    for (int r = 0; r < 8; ++r)
      ws[8 * r + c] = (int)descale(o[r], CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    bool ac = false;
    for (int i = 0; i < 8; ++i) {
      x[i] = wp[i];
      ac |= i > 0 && wp[i] != 0;
    }
    if (!ac) {
      uint8_t dc = range_limit_idct((int)descale(x[0], PASS1_BITS + 3));
      for (int i = 0; i < 8; ++i) op[i] = dc;
      continue;
    }
    islow_1d(x, o);
    for (int i = 0; i < 8; ++i)
      op[i] = range_limit_idct(
          (int)descale(o[i], CONST_BITS + PASS1_BITS + 3));
  }
}

// The component's samples upsampled to width x height (jdsample.c).
std::vector<uint8_t> upsample(const uint8_t* p, int stride, int dw, int dh,
                              int rx, int ry, int width, int height) {
  std::vector<uint8_t> u((size_t)width * height);
  if (rx == 1 && ry == 1) {
    for (int y = 0; y < height; ++y)
      memcpy(&u[(size_t)y * width], p + (size_t)y * stride, width);
  } else if (ry == 1) {  // h2v1
    for (int y = 0; y < height; ++y) {
      const uint8_t* row = p + (size_t)y * stride;
      uint8_t* o = &u[(size_t)y * width];
      for (int x = 0; x < width; ++x) {
        int i = x >> 1;
        if (dw <= 2) {
          o[x] = row[i];
        } else if (x & 1) {
          o[x] = (uint8_t)((3 * row[i] + row[std::min(i + 1, dw - 1)] + 2) >> 2);
        } else {
          o[x] = (uint8_t)((3 * row[i] + row[std::max(i - 1, 0)] + 1) >> 2);
        }
      }
    }
  } else if (rx == 1) {  // h1v2: always fancy
    for (int y = 0; y < height; ++y) {
      int i = y >> 1;
      int nb = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* r0 = p + (size_t)i * stride;
      const uint8_t* r1 = p + (size_t)nb * stride;
      uint8_t* o = &u[(size_t)y * width];
      for (int x = 0; x < width; ++x)
        o[x] = (uint8_t)((3 * r0[x] + r1[x] + bias) >> 2);
    }
  } else {  // h2v2
    std::vector<int> cs(dw);
    for (int y = 0; y < height; ++y) {
      int i = y >> 1;
      uint8_t* o = &u[(size_t)y * width];
      const uint8_t* r0 = p + (size_t)i * stride;
      if (dw <= 2) {
        for (int x = 0; x < width; ++x) o[x] = r0[x >> 1];
        continue;
      }
      int nb = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      const uint8_t* r1 = p + (size_t)nb * stride;
      for (int j = 0; j < dw; ++j) cs[j] = 3 * r0[j] + r1[j];
      for (int x = 0; x < width; ++x) {
        int j = x >> 1;
        if (x & 1)
          o[x] = (uint8_t)((3 * cs[j] + cs[std::min(j + 1, dw - 1)] + 7) >> 4);
        else
          o[x] = (uint8_t)((3 * cs[j] + cs[std::max(j - 1, 0)] + 8) >> 4);
      }
    }
  }
  return u;
}

void Decoder::finish() {
  for (int c = 0; c < ncomp; ++c)
    if (!comp_[c].seen) fail("a component has no scan");
  if (progressive_) {
    for (int c = 0; c < ncomp; ++c)
      for (int k = 0; k < 10; ++k)
        if (comp_[c].coef_bits[k] != 0)
          fail("incomplete progressive image (coefficients left unrefined)");
  }
  std::vector<uint8_t> planes[3];
  for (int c = 0; c < ncomp; ++c) {
    Component& k = comp_[c];
    int stride = k.bw * 8;
    std::vector<uint8_t> plane((size_t)stride * k.bh * 8);
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], k.qt,
                   &plane[(size_t)by * 8 * stride + bx * 8], stride);
    planes[c] = upsample(plane.data(), stride, k.dw, k.dh, max_h_ / k.h,
                         max_v_ / k.v, width, height);
  }
  size_t npx = (size_t)width * height;
  if (ncomp == 1) {
    out = std::move(planes[0]);
    return;
  }
  out.resize(npx * 3);
  bool rgb = false;
  if (saw_jfif_) {
    rgb = false;
  } else if (saw_adobe_) {
    rgb = adobe_transform_ == 0;
  } else {
    rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
  }
  if (rgb) {
    for (size_t i = 0; i < npx; ++i)
      for (int c = 0; c < 3; ++c) out[3 * i + c] = planes[c][i];
    return;
  }
  // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
  const int SCALEBITS = 16;
  const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
  auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
    cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + ONE_HALF;
  }
  auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
  const uint8_t *Y = planes[0].data(), *Cb = planes[1].data(),
                *Cr = planes[2].data();
  for (size_t i = 0; i < npx; ++i) {
    int y = Y[i], cb = Cb[i], cr = Cr[i];
    out[3 * i + 0] = clamp(y + cr_r[cr]);
    out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
    out[3 * i + 2] = clamp(y + cb_b[cb]);
  }
}

void Decoder::run() {
  if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file");
  pos_ = 2;
  bool seen_scan = false;
  while (true) {
    int m = next_marker();
    if (m == 0xD9) break;                           // EOI
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // RSTn, TEM
    if (m == 0xD8) fail("corrupt data (a second SOI marker)");
    int len = u16();
    if (len < 2 || pos_ + len - 2 > n_) fail("truncated file (a marker segment)");
    size_t end = pos_ + len - 2;
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      read_sof(m, len);
    } else if (m == 0xC4) {
      read_dht(len);
    } else if (m == 0xCC) {
      fail("arithmetic-coded JPEG is not supported");
    } else if (m == 0xDB) {
      read_dqt(len);
    } else if (m == 0xDD) {
      if (len != 4) fail("corrupt restart interval");
      restart_interval_ = u16();
    } else if (m == 0xDA) {
      read_sos(len);
      seen_scan = true;
      continue;  // decode_scan left pos_ after the entropy-coded data
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
      read_app(m, len);
    } else if (m == 0xDC) {
      fail("a DNL marker is not supported");
    } else {
      fail("unsupported JPEG marker");
    }
    pos_ = end;
  }
  if (!have_frame_ || !seen_scan) fail("no image data");
  finish();
}

}  // namespace

extern "C" {

// Decode the JPEG in data[0:n].  On success returns 0 and sets *out to a
// malloc'd buffer of height x width x channels bytes (channels 1: grey, 3:
// RGB), released with jpeg_free.  On failure returns 1 and writes a message
// into err (errlen bytes).
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t** out, int* width,
                int* height, int* channels, char* err, int errlen) {
  *out = nullptr;
  try {
    Decoder dec(data, (size_t)n);
    dec.run();
    *out = (uint8_t*)malloc(dec.out.size());
    if (!*out) fail("out of memory");
    memcpy(*out, dec.out.data(), dec.out.size());
    *width = dec.width;
    *height = dec.height;
    *channels = dec.ncomp == 1 ? 1 : 3;
    return 0;
  } catch (const Error& e) {
    snprintf(err, errlen, "%s", e.msg.c_str());
  } catch (const std::bad_alloc&) {
    snprintf(err, errlen, "out of memory");
  }
  return 1;
}

void jpeg_free(uint8_t* p) { free(p); }

}  // extern "C"
