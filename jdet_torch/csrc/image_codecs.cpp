// Host-side image codecs for the data path: a JPEG decoder that gives the
// pixels of libjpeg-turbo (cv2.imread's JPEG path), the inner loops of
// the TIFF reader (LZW and PackBits), and cv2 5.0's float32 warpAffine
// (INTER_LINEAR, BORDER_CONSTANT) for YOLO's random affine
// (`jdet_torch/data/yolo.py::warp_affine`, whose numpy form it equals).
//
// `jdet_torch/data/jpeg.py` and `jdet_torch/data/tiff.py` build this file
// with `g++ -O3 -shared -fPIC` at first use into `build/` (keyed by a hash
// of the source), as `ops/polygon_native.py` builds `polygon.cpp`, and
// bind the extern "C" functions with ctypes.
//
// The JPEG decoder covers baseline and extended sequential (SOF0/SOF1) and
// progressive (SOF2) Huffman scans, restart intervals, 1 or 3 components
// with integral sampling ratios, and 8-bit samples. It computes what
// libjpeg-turbo computes with its defaults (JDCT_ISLOW, fancy upsampling):
// the integer slow IDCT of jidctint.c with its range limit, the fancy
// upsamplers of jdsample.c (h2v1, h1v2, h2v2 with their rounding biases,
// edge rows and columns replicated; plain replication for ratios other
// than 2 and for h2 components at most 2 samples wide) and the fixed-point
// YCbCr->RGB tables of jdcolor.c. Every other stream (arithmetic coding,
// 12-bit, lossless, hierarchical, CMYK/YCCK, a corrupt or truncated stream)
// is refused with an error message: libjpeg would warn and fill the rest
// of the image with grey, this decoder never returns such pixels.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, errlen, "%s", msg.c_str());
  }
}

// zigzag position -> natural (row-major) position of a coefficient
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  // canonical code tables, as jdhuff.c's jpeg_make_d_derived_tbl
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 when longer than 9 bits
  uint16_t look[512];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals) {
  h.defined = true;
  std::memcpy(h.vals, vals, nvals);
  std::memset(h.look, 0, sizeof(h.look));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    int n = counts[len - 1];
    if (n) {
      h.valoffset[len] = k - code;
      for (int i = 0; i < n; ++i, ++k, ++code) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j) {
            h.look[(code << shift) | j] = (uint16_t)((len << 8) | vals[k]);
          }
        }
      }
      h.maxcode[len] = code - 1;
    } else {
      h.maxcode[len] = -1;
    }
    if (code > (1 << len)) fail("corrupt JPEG: bad Huffman table");
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;  // sentinel
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled size in samples
  int bw = 0, bh = 0;        // allocated size in blocks (MCU-padded)
  int wblocks = 0, hblocks = 0;  // blocks that hold image samples
  std::vector<int16_t> coef;     // bw * bh * 64
  bool quant_latched = false;
  uint16_t quant[64];            // natural order
  int dc_pred = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t n, size_t pos) : data_(data), n_(n), pos_(pos) {}

  size_t pos() const { return pos_; }

  // drop everything buffered: the reader then stands at the marker that
  // ends the segment, or before padding bytes
  void reset() {
    buf_ = 0;
    cnt_ = 0;
    fake_ = 0;
  }

  void fill() {
    while (cnt_ <= 56) {
      uint64_t byte = 0;
      if (!marker_ahead()) {
        byte = data_[pos_++];
        if (byte == 0xFF) ++pos_;  // the stuffed 0x00
      } else {
        fake_ += 8;
      }
      buf_ |= byte << (56 - cnt_);
      cnt_ += 8;
    }
  }

  int peek(int n) {
    if (cnt_ < n) fill();
    return (int)(buf_ >> (64 - n));
  }

  void skip(int n) {
    buf_ <<= n;
    cnt_ -= n;
  }

  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }

  int bit() { return get(1); }

  // bits taken beyond the end of the entropy-coded segment
  bool overrun() const { return fake_ > cnt_; }

  bool marker_ahead() const {
    if (pos_ >= n_) return true;
    if (data_[pos_] != 0xFF) return false;
    if (pos_ + 1 >= n_) return true;
    return data_[pos_ + 1] != 0x00;
  }

  // move to the next marker, skipping any bytes before it
  void seek_marker() {
    while (pos_ < n_) {
      if (data_[pos_] == 0xFF && pos_ + 1 < n_ && data_[pos_ + 1] != 0x00 &&
          data_[pos_ + 1] != 0xFF) {
        return;
      }
      if (data_[pos_] == 0xFF && pos_ + 1 < n_ && data_[pos_ + 1] == 0x00) {
        pos_ += 2;
      } else {
        ++pos_;
      }
    }
  }

  void set_pos(size_t p) { pos_ = p; }

 private:
  const uint8_t* data_;
  size_t n_;
  size_t pos_;
  uint64_t buf_ = 0;
  int cnt_ = 0;
  int fake_ = 0;
};

inline int decode_huff(BitReader& br, const Huffman& h) {
  int look = br.peek(9);
  uint16_t e = h.look[look];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  int code = br.peek(16);
  for (int len = 10; len <= 16; ++len) {
    int c = code >> (16 - len);
    if (c <= h.maxcode[len]) {
      br.skip(len);
      return h.vals[c + h.valoffset[len]];
    }
  }
  fail("corrupt JPEG: bad Huffman code");
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---------------------------------------------------------------------------
// jidctint.c: the integer slow IDCT with its range limit

const int CONST_BITS = 13;
const int PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446;
const int64_t FIX_0_390180644 = 3196;
const int64_t FIX_0_541196100 = 4433;
const int64_t FIX_0_765366865 = 6270;
const int64_t FIX_0_899976223 = 7373;
const int64_t FIX_1_175875602 = 9633;
const int64_t FIX_1_501321110 = 12299;
const int64_t FIX_1_847759065 = 15137;
const int64_t FIX_1_961570560 = 16069;
const int64_t FIX_2_053119869 = 16819;
const int64_t FIX_2_562915447 = 20995;
const int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// the post-IDCT range limit of jdmaster.c, indexed by (x & 1023)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      t[i] = i < 128 ? (uint8_t)(i + 128) : i < 512 ? 255 : i < 896 ? 0 : (uint8_t)(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (int)(ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
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
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = kRange.t[(int)descale(wp[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
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
    op[0] = kRange.t[(int)descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kRange.t[(int)descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kRange.t[(int)descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kRange.t[(int)descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kRange.t[(int)descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kRange.t[(int)descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kRange.t[(int)descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kRange.t[(int)descale(tmp13 - tmp0, sh) & 1023];
  }
}

// ---------------------------------------------------------------------------
// jdcolor.c: the YCbCr -> RGB tables

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto FIX = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------------------

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* data, size_t n) : d_(data), n_(n) {}

  void read_header() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file");
    pos_ = 2;
    while (!frame_) {
      int m = next_marker();
      if (m == 0xD9) fail("corrupt JPEG: no frame before EOI");
      handle_marker(m);
    }
  }

  void decode(uint8_t* out) {
    allocate();
    bool any_scan = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        read_scan();
        any_scan = true;
      } else {
        handle_marker(m);
      }
    }
    if (!any_scan) fail("corrupt JPEG: no scan");
    output(out);
  }

  int width = 0, height = 0, ncomp = 0;

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool frame_ = false, progressive_ = false;
  bool adobe_ = false, jfif_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  int hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0;  // MCUs per row / column of an interleaved scan
  Component comp_[4];
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  int eobrun_ = 0;

  int u8() {
    if (pos_ >= n_) fail("truncated JPEG");
    return d_[pos_++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // skip anything up to the next 0xFF, then fill bytes
    while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
    while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
    if (pos_ >= n_) fail("truncated JPEG: no EOI marker");
    return d_[pos_++];
  }

  void handle_marker(int m) {
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_frame(m == 0xC2);
    } else if (m == 0xC3 || (m >= 0xC5 && m <= 0xC7)) {
      fail("lossless or hierarchical JPEG is not supported");
    } else if (m >= 0xC9 && m <= 0xCF) {
      fail("arithmetic-coded JPEG is not supported");
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      int len = u16();
      if (len != 4) fail("corrupt JPEG: bad DRI length");
      restart_interval_ = u16();
    } else if (m == 0xDC) {
      fail("JPEG DNL markers are not supported");
    } else if (m == 0xDA) {
      fail("corrupt JPEG: scan before frame");
    } else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      fail("corrupt JPEG: unexpected marker");
    } else {
      // APPn, COM and the rest: skip, noting JFIF and Adobe
      size_t start = pos_;
      int len = u16();
      if (len < 2 || start + len > n_) fail("truncated JPEG segment");
      if (m == 0xE0 && len >= 7 && std::memcmp(d_ + start + 2, "JFIF\0", 5) == 0) jfif_ = true;
      if (m == 0xEE && len >= 14 && std::memcmp(d_ + start + 2, "Adobe", 5) == 0) {
        adobe_ = true;
        adobe_transform_ = d_[start + 13];
      }
      pos_ = start + len;
    }
  }

  void read_frame(bool progressive) {
    if (frame_) fail("corrupt JPEG: two frames");
    size_t start = pos_;
    int len = u16();
    int prec = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (prec != 8) fail("JPEG with " + std::to_string(prec) + "-bit samples is not supported");
    if (height == 0) fail("JPEG with a DNL-defined height is not supported");
    if (width == 0) fail("corrupt JPEG: zero width");
    if (ncomp == 4) fail("CMYK/YCCK JPEG is not supported");
    if (ncomp != 1 && ncomp != 3) fail("JPEG with " + std::to_string(ncomp) + " components is not supported");
    if (len != 8 + 3 * ncomp) fail("corrupt JPEG: bad SOF length");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp_[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("corrupt JPEG: bad component");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    pos_ = start + len;
    for (int i = 0; i < ncomp; ++i) {
      if (hmax_ % comp_[i].h || vmax_ % comp_[i].v) fail("JPEG with fractional sampling is not supported");
    }
    progressive_ = progressive;
    frame_ = true;
  }

  void read_dht() {
    size_t start = pos_;
    int len = u16();
    size_t end = start + len;
    if (end > n_) fail("truncated JPEG: DHT");
    while (pos_ < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad DHT");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        counts[i] = (uint8_t)u8();
        total += counts[i];
      }
      if (total > 256 || pos_ + total > end) fail("corrupt JPEG: bad DHT");
      build_huffman(tc ? ac_[th] : dc_[th], counts, d_ + pos_, total);
      pos_ += total;
    }
    pos_ = end;
  }

  void read_dqt() {
    size_t start = pos_;
    int len = u16();
    size_t end = start + len;
    if (end > n_) fail("truncated JPEG: DQT");
    while (pos_ < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("corrupt JPEG: bad DQT");
      for (int i = 0; i < 64; ++i) qt_[tq][kNatural[i]] = (uint16_t)(pq ? u16() : u8());
      qt_defined_[tq] = true;
    }
    pos_ = end;
  }

  void allocate() {
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp_[i];
      c.dw = (int)(((int64_t)width * c.h + hmax_ - 1) / hmax_);
      c.dh = (int)(((int64_t)height * c.v + vmax_ - 1) / vmax_);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
  }

  void read_scan() {
    size_t start = pos_;
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) fail("corrupt JPEG: bad SOS");
    Component* sc[4];
    int td[4], ta[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8();
      int t = u8();
      sc[i] = nullptr;
      for (int j = 0; j < ncomp; ++j) {
        if (comp_[j].id == id) sc[i] = &comp_[j];
      }
      if (!sc[i]) fail("corrupt JPEG: scan names an unknown component");
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) fail("corrupt JPEG: bad SOS table");
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    pos_ = start + len;
    if (!progressive_) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) fail("corrupt JPEG: bad sequential scan");
    } else {
      if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13 ||
          (ah && ah != al + 1)) {
        fail("corrupt JPEG: bad progression parameters");
      }
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!c.quant_latched) {
        if (!qt_defined_[c.tq]) fail("corrupt JPEG: undefined quantization table");
        std::memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
        c.quant_latched = true;
      }
      bool need_dc = ss == 0 && ah == 0;
      bool need_ac = se > 0;
      if (need_dc && !dc_[td[i]].defined) fail("corrupt JPEG: undefined Huffman table");
      if (need_ac && !ac_[ta[i]].defined) fail("corrupt JPEG: undefined Huffman table");
      c.dc_pred = 0;
    }
    eobrun_ = 0;

    BitReader br(d_, n_, pos_);
    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = sc[0]->wblocks;
      mcus_y = sc[0]->hblocks;
    } else {
      mcus_x = mcux_;
      mcus_y = mcuy_;
    }
    int64_t total = (int64_t)mcus_x * mcus_y;
    int restarts_to_go = restart_interval_;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval_ && restarts_to_go == 0) {
        // RSTn: realign, check the marker, reset the predictions
        br.reset();
        br.seek_marker();
        size_t p = br.pos();
        if (p + 1 >= n_ || d_[p + 1] != 0xD0 + next_rst) fail("corrupt JPEG: missing restart marker");
        br.set_pos(p + 2);
        next_rst = (next_rst + 1) & 7;
        restarts_to_go = restart_interval_;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        eobrun_ = 0;
      }
      int mx = (int)(m % mcus_x), my = (int)(m / mcus_x);
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
        for (int y = 0; y < bh; ++y) {
          for (int x = 0; x < bw; ++x) {
            int bx = mx * bw + x, by = my * bh + y;
            int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
            const Huffman& dct = dc_[td[i]];
            const Huffman& act = ac_[ta[i]];
            if (!progressive_) {
              decode_baseline(br, blk, c, dct, act);
            } else if (ss == 0) {
              if (ah == 0) {
                int s = decode_huff(br, dct);
                int diff = 0;
                if (s) {
                  if (s > 11) fail("corrupt JPEG: bad DC value");
                  diff = extend(br.get(s), s);
                }
                c.dc_pred += diff;
                blk[0] = (int16_t)(c.dc_pred * (1 << al));
              } else if (br.bit()) {
                blk[0] |= (int16_t)(1 << al);
              }
            } else if (ah == 0) {
              decode_ac_first(br, blk, act, ss, se, al);
            } else {
              decode_ac_refine(br, blk, act, ss, se, al);
            }
          }
        }
      }
      if (br.overrun()) fail("truncated or corrupt JPEG scan");
      if (restart_interval_) --restarts_to_go;
    }
    br.reset();
    br.seek_marker();
    pos_ = br.pos();
  }

  void decode_baseline(BitReader& br, int16_t* blk, Component& c, const Huffman& dct,
                       const Huffman& act) {
    int s = decode_huff(br, dct);
    int diff = 0;
    if (s) {
      if (s > 11) fail("corrupt JPEG: bad DC value");
      diff = extend(br.get(s), s);
    }
    c.dc_pred += diff;
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; ++k) {
      int rs = decode_huff(br, act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt JPEG: coefficient index out of range");
        blk[kNatural[k]] = (int16_t)extend(br.get(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_ac_first(BitReader& br, int16_t* blk, const Huffman& act, int ss, int se, int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = decode_huff(br, act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) fail("corrupt JPEG: coefficient index out of range");
        blk[kNatural[k]] = (int16_t)(extend(br.get(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += br.get(r);
        --eobrun_;
        break;
      }
    }
  }

  void decode_ac_refine(BitReader& br, int16_t* blk, const Huffman& act, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun_ == 0) {
      for (; k <= se; ++k) {
        int rs = decode_huff(br, act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt JPEG: bad refinement value");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) fail("corrupt JPEG: coefficient index out of range");
          blk[kNatural[k]] = (int16_t)s;
        }
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0) {
          *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        }
      }
      --eobrun_;
    }
  }

  // one component's samples (dw x dh), inverse-transformed
  std::vector<uint8_t> plane(const Component& c) {
    int pw = c.bw * 8, ph = c.bh * 8;
    std::vector<uint8_t> buf((size_t)pw * ph);
    for (int by = 0; by < c.hblocks; ++by) {
      for (int bx = 0; bx < c.wblocks; ++bx) {
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                   &buf[(size_t)by * 8 * pw + bx * 8], pw);
      }
    }
    std::vector<uint8_t> out((size_t)c.dw * c.dh);
    for (int y = 0; y < c.dh; ++y) std::memcpy(&out[(size_t)y * c.dw], &buf[(size_t)y * pw], c.dw);
    return out;
  }

  // jdsample.c: the component upsampled to width x height
  std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& in) {
    int hr = hmax_ / c.h, vr = vmax_ / c.v;
    int dw = c.dw, dh = c.dh;
    std::vector<uint8_t> out((size_t)width * height);
    auto at = [&](int y, int x) -> int {
      y = std::min(std::max(y, 0), dh - 1);
      x = std::min(std::max(x, 0), dw - 1);
      return in[(size_t)y * dw + x];
    };
    if (hr == 1 && vr == 1) {
      return in;
    }
    if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < height; ++y) {
        for (int x = 0; x < width; ++x) {
          int j = x >> 1;
          int v = at(y, j) * 3;
          out[(size_t)y * width + x] =
              (uint8_t)((x & 1) ? (v + at(y, j + 1) + 2) >> 2 : (v + at(y, j - 1) + 1) >> 2);
        }
      }
      return out;
    }
    if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < height; ++y) {
        int i = y >> 1, nb = (y & 1) ? i + 1 : i - 1, bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; ++x) {
          out[(size_t)y * width + x] = (uint8_t)((at(i, x) * 3 + at(nb, x) + bias) >> 2);
        }
      }
      return out;
    }
    if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      std::vector<int> colsum(dw + 2);
      for (int y = 0; y < height; ++y) {
        int i = y >> 1, nb = (y & 1) ? i + 1 : i - 1;
        for (int j = -1; j <= dw; ++j) colsum[j + 1] = at(i, j) * 3 + at(nb, j);
        for (int x = 0; x < width; ++x) {
          int j = (x >> 1) + 1;
          int t = colsum[j] * 3;
          out[(size_t)y * width + x] =
              (uint8_t)((x & 1) ? (t + colsum[j + 1] + 7) >> 4 : (t + colsum[j - 1] + 8) >> 4);
        }
      }
      return out;
    }
    // int_upsample (and h2v1 / h2v2 on components at most 2 samples wide):
    // each sample replicated hr x vr times
    for (int y = 0; y < height; ++y) {
      for (int x = 0; x < width; ++x) out[(size_t)y * width + x] = (uint8_t)at(y / vr, x / hr);
    }
    return out;
  }

  void output(uint8_t* out) {
    for (int i = 0; i < ncomp; ++i) {
      if (!comp_[i].quant_latched) fail("corrupt JPEG: a component has no scan");
    }
    size_t npix = (size_t)width * height;
    if (ncomp == 1) {
      std::vector<uint8_t> y = upsample(comp_[0], plane(comp_[0]));
      for (size_t p = 0; p < npix; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = y[p];
      return;
    }
    std::vector<uint8_t> ch[3];
    for (int i = 0; i < 3; ++i) ch[i] = upsample(comp_[i], plane(comp_[i]));
    // jdapimin.c's default_decompress_parms: JFIF or Adobe transform 1 means
    // YCbCr, Adobe transform 0 and component ids 'R', 'G', 'B' mean RGB
    bool rgb = false;
    if (!jfif_) {
      if (adobe_) {
        rgb = adobe_transform_ == 0;
      } else {
        rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
      }
    }
    if (rgb) {
      for (size_t p = 0; p < npix; ++p) {
        out[3 * p] = ch[0][p];
        out[3 * p + 1] = ch[1][p];
        out[3 * p + 2] = ch[2][p];
      }
      return;
    }
    for (size_t p = 0; p < npix; ++p) {
      int y = ch[0][p], cb = ch[1][p], cr = ch[2][p];
      out[3 * p] = clamp255(y + kYcc.cr_r[cr]);
      out[3 * p + 1] = clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      out[3 * p + 2] = clamp255(y + kYcc.cb_b[cb]);
    }
  }
};

// ---------------------------------------------------------------------------
// TIFF: LZW (tif_lzw.c's MSB-first codes with early change) and PackBits

int64_t lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  const int CLEAR = 256, EOI = 257;
  std::vector<int32_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    suffix[i] = first[i] = (uint8_t)i;
    length[i] = 1;
  }
  int64_t o = 0, bitpos = 0, nbits_total = n * 8;
  int width = 9, next = 258, prev = -1;
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) fail("old-style LZW TIFF is not supported");
  for (;;) {
    if (bitpos + width > nbits_total) break;  // ran out without EOI: as libtiff
    int64_t byte = bitpos >> 3;
    uint32_t window = (uint32_t)in[byte] << 16;
    if (byte + 1 < n) window |= (uint32_t)in[byte + 1] << 8;
    if (byte + 2 < n) window |= in[byte + 2];
    int code = (int)((window >> (24 - width - (bitpos & 7))) & ((1u << width) - 1));
    bitpos += width;
    if (code == EOI) break;
    if (code == CLEAR) {
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    int entry;
    if (prev < 0) {
      if (code > 255) fail("corrupt LZW data");
      entry = code;
    } else if (code < next) {
      entry = code;
      if (next < 4096) {
        prefix[next] = prev;
        suffix[next] = first[code];
        first[next] = first[prev];
        length[next] = length[prev] + 1;
        ++next;
      }
    } else if (code == next && next < 4096) {
      prefix[next] = prev;
      suffix[next] = first[prev];
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      entry = next++;
    } else {
      fail("corrupt LZW data");
    }
    int len = length[entry];
    if (o + len > cap) fail("LZW data longer than the strip");
    int e = entry;
    for (int i = len - 1; i >= 0; --i) {
      out[o + i] = suffix[e];
      e = prefix[e];
    }
    o += len;
    prev = entry;
    if (next + 1 >= (1 << width) && width < 12) ++width;
  }
  return o;
}

int64_t packbits_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n && o < cap) {
    int c = (int8_t)in[i++];
    if (c >= 0) {
      int64_t len = c + 1;
      if (i + len > n || o + len > cap) fail("corrupt PackBits data");
      std::memcpy(out + o, in + i, len);
      i += len;
      o += len;
    } else if (c != -128) {
      int64_t len = 1 - c;
      if (i >= n || o + len > cap) fail("corrupt PackBits data");
      std::memset(out + o, in[i++], len);
      o += len;
    }
  }
  return o;
}

}  // namespace

extern "C" {

// (width, height, components) of a JPEG stream; 0 on success
int jpeg_probe(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    JpegDecoder dec(data, (size_t)n);
    dec.read_header();
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.ncomp;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  }
}

// decode into out (height x width x 3 RGB); 0 on success
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err, int errlen) {
  try {
    JpegDecoder dec(data, (size_t)n);
    dec.read_header();
    dec.decode(out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return 1;
  }
}

// bytes written to out, or -1 with err set
int64_t tiff_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap, char* err,
                        int errlen) {
  try {
    return lzw_decode(in, n, out, cap);
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

int64_t tiff_packbits_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap, char* err,
                             int errlen) {
  try {
    return packbits_decode(in, n, out, cap);
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

// a * b + c rounded once to float: the product of two floats is exact in
// a double (the numpy form computes the same)
static inline float fma_once(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
}

// dst (h, w, C) from src (H, W, C), float32, through the inverted affine map
// m (6 floats, rounded from cv2's float64 inverse): the source coordinates
// of a row's first w / 16 * 16 pixels as cv2's vector code takes them,
// fma(m0, x, m1 * y + m2), the rest as its scalar tail does,
// fma(x, m0, m1 * y) + m2; neighbours outside the image read `fill`; three
// fused lerps.
void warp_affine_f32(const float* src, int64_t H, int64_t W, int64_t C, float* dst,
                     int64_t h, int64_t w, const float* m, float fill) {
  const int64_t nvec = w / 16 * 16;
  for (int64_t y = 0; y < h; ++y) {
    const float fy = static_cast<float>(y);
    const float bx = m[1] * fy + m[2], by = m[4] * fy + m[5];
    const float tx = m[1] * fy, ty = m[4] * fy;
    for (int64_t x = 0; x < w; ++x) {
      const float fx = static_cast<float>(x);
      float sx, sy;
      if (x < nvec) {
        sx = fma_once(m[0], fx, bx);
        sy = fma_once(m[3], fx, by);
      } else {
        sx = fma_once(fx, m[0], tx) + m[2];
        sy = fma_once(fx, m[3], ty) + m[5];
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      const float a = sx - flx, b = sy - fly;
      const int64_t ix = static_cast<int64_t>(std::min(std::max(flx, -2.0f), W + 1.0f));
      const int64_t iy = static_cast<int64_t>(std::min(std::max(fly, -2.0f), H + 1.0f));
      const bool x0 = ix >= 0 && ix < W, x1 = ix + 1 >= 0 && ix + 1 < W;
      const bool y0 = iy >= 0 && iy < H, y1 = iy + 1 >= 0 && iy + 1 < H;
      float* out = dst + (y * w + x) * C;
      for (int64_t c = 0; c < C; ++c) {
        const float p00 = (y0 && x0) ? src[(iy * W + ix) * C + c] : fill;
        const float p01 = (y0 && x1) ? src[(iy * W + ix + 1) * C + c] : fill;
        const float p10 = (y1 && x0) ? src[((iy + 1) * W + ix) * C + c] : fill;
        const float p11 = (y1 && x1) ? src[((iy + 1) * W + ix + 1) * C + c] : fill;
        const float v0 = fma_once(a, p01 - p00, p00);
        const float v1 = fma_once(a, p11 - p10, p10);
        out[c] = fma_once(b, v1 - v0, v0);
      }
    }
  }
}

}  // extern "C"
