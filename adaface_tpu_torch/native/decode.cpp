// JPEG, BMP and GIF decoding for the host data path (C ABI, loaded with
// ctypes).
//
// The pixels are those Pillow gives for `Image.open(path)` on a build with
// libjpeg-turbo at its defaults: the integer ISLOW IDCT (jidctint.c),
// "fancy" triangle upsampling of subsampled chroma (jdsample.c), and
// libjpeg's fixed-point YCbCr -> RGB tables (jdcolor.c), bit for bit.
//
// JPEG: 8-bit Huffman-coded sequential (SOF0, SOF1) and progressive (SOF2)
// with spectral selection and successive approximation, restart intervals,
// one component (grey), three (YCbCr or RGB) or four (CMYK or YCCK, given
// as Pillow's convert("RGB") gives them), sampling factors 1 to 4 in either
// direction at integral ratios (libjpeg-turbo's upsampler for each: "fancy"
// at 2x1, 1x2 and 2x2, replication otherwise). BMP: see `Bmp`. Anything
// else (arithmetic, 12-bit, lossless and hierarchical JPEGs among it) is
// refused with a message naming what was found; nothing is passed on
// silently.
//
// Two calls: `image_info` parses the headers into the output's shape, then
// `image_decode` fills a caller-owned [H, W, C] uint8 buffer (C = 1 for a
// grey JPEG, else 3). Both return 0, or 1 with a message in `err`. GIF has
// its own pair, `gif_info` and `gif_decode`, for its frames (see `Gif`).

#include <algorithm>
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

// the zigzag position -> natural (row-major) index (jpeg_natural_order),
// padded with 63s so that a corrupt run past the end writes harmlessly
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int maxcode[18] = {};
  int valptr[17] = {};
  int mincode[17] = {};
  uint8_t look_len[512] = {};  // 9-bit lookahead: code length, 0 = longer
  uint8_t look_sym[512] = {};

  void build(const uint8_t* counts, const uint8_t* symbols, int n) {
    std::memcpy(vals, symbols, n);
    std::memset(look_len, 0, sizeof(look_len));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (len <= 9) {
          const int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = (uint8_t)len;
            look_sym[(code << shift) | j] = vals[k];
          }
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      if (code > (1 << len)) fail("JPEG: bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;  // blocks across and down, padded to whole MCUs
  int dw = 0, dh = 0;  // samples across and down (downsampled_width/height)
  bool latched = false;
  uint16_t q[64] = {};
  int pred = 0;
  std::vector<int16_t> coef;  // [bh][bw][64], natural order
};

class Jpeg {
 public:
  Jpeg(const uint8_t* data, size_t n) : p_(data), n_(n) {}

  // Parse up to the frame header: the image's size and components.
  void info(int* w, int* h, int* c) {
    parse(false);
    *w = width_;
    *h = height_;
    *c = ncomp_ == 1 ? 1 : 3;
  }

  void decode(uint8_t* out) {
    parse(true);
    for (int ci = 0; ci < ncomp_; ++ci) idct_component(ci);
    write_pixels(out);
  }

 private:
  const uint8_t* p_;
  size_t n_, pos_ = 0;
  uint16_t qt_[4][64] = {};
  bool qdefined_[4] = {};
  Huffman dc_[4], ac_[4];
  int width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool progressive_ = false, frame_ = false, saw_jfif_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  Component comp_[4];
  std::vector<std::vector<uint8_t>> planes_;  // IDCT output per component

  // entropy-coded segment reader
  uint32_t bits_ = 0;
  int nbits_ = 0;
  bool at_marker_ = false;
  int eobrun_ = 0;

  uint8_t byte() {
    if (pos_ >= n_) fail("JPEG: file ends inside a header");
    return p_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {
    // skip to 0xFF, then past fill bytes
    while (pos_ < n_ && p_[pos_] != 0xFF) ++pos_;
    while (pos_ < n_ && p_[pos_] == 0xFF) ++pos_;
    if (pos_ >= n_) fail("JPEG: no EOI marker");
    return p_[pos_++];
  }

  void parse(bool decode) {
    pos_ = 0;
    if (n_ < 4 || p_[0] != 0xFF || p_[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      const int len = word();
      if (len < 2 || pos_ + len - 2 > n_) fail("JPEG: bad marker length");
      const size_t end = pos_ + len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          read_frame(m);
          if (!decode) return;
          break;
        case 0xC3: fail("JPEG: lossless (SOF3) coding is not supported");
        case 0xC5: case 0xC6: case 0xC7:
          fail("JPEG: hierarchical (SOF5-7) coding is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail("JPEG: arithmetic coding is not supported");
        case 0xCC: fail("JPEG: arithmetic coding (DAC marker) is not supported");
        case 0xC4: read_dht(end); break;
        case 0xDB: read_dqt(end); break;
        case 0xDD: restart_interval_ = word(); break;
        case 0xDA:
          if (!frame_) fail("JPEG: scan before frame header");
          read_scan();
          continue;  // read_scan leaves pos_ at the next marker
        case 0xDC: fail("JPEG: DNL marker (height defined after the scan) is not supported");
        case 0xE0:
          if (len >= 7 && std::memcmp(p_ + pos_, "JFIF\0", 5) == 0) saw_jfif_ = true;
          break;
        case 0xEE:
          if (len >= 14 && std::memcmp(p_ + pos_, "Adobe", 5) == 0)
            adobe_transform_ = p_[pos_ + 11];
          break;
        default: break;  // APPn, COM and the rest: skipped
      }
      pos_ = end;
    }
    if (!frame_) fail("JPEG: no frame header");
  }

  void read_frame(int m) {
    if (frame_) fail("JPEG: more than one frame");
    frame_ = true;
    progressive_ = m == 0xC2;
    const int precision = byte();
    if (precision != 8) fail("JPEG: " + std::to_string(precision) + "-bit samples are not supported");
    height_ = word();
    width_ = word();
    ncomp_ = byte();
    if (height_ == 0) fail("JPEG: height 0 (defined by a DNL marker) is not supported");
    if (width_ == 0) fail("JPEG: width 0");
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4)
      fail("JPEG: " + std::to_string(ncomp_) + " components are not supported (Pillow opens 1, "
           "3 and 4)");
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte() & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("JPEG: bad sampling factors");
    }
    if (ncomp_ == 1) comp_[0].h = comp_[0].v = 1;  // one component: one block an MCU
    hmax_ = vmax_ = 1;
    for (int i = 0; i < ncomp_; ++i) {
      hmax_ = std::max(hmax_, comp_[i].h);
      vmax_ = std::max(vmax_, comp_[i].v);
    }
    std::string factors;
    for (int i = 0; i < ncomp_; ++i)
      factors += (i ? "," : "") + std::to_string(comp_[i].h) + "x" + std::to_string(comp_[i].v);
    for (int i = 0; i < ncomp_; ++i) {
      if (hmax_ % comp_[i].h || vmax_ % comp_[i].v)
        fail("JPEG: sampling factors " + factors + " are not integral ratios (libjpeg refuses "
             "them)");
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      c.dw = (int)(((long long)width_ * c.h + hmax_ - 1) / hmax_);
      c.dh = (int)(((long long)height_ * c.v + vmax_ - 1) / vmax_);
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
    }
    if ((long long)width_ * height_ > (1LL << 28)) fail("JPEG: image too large");
  }

  void read_dht(size_t end) {
    while (pos_ < end) {
      const int tc = byte();
      const int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) fail("JPEG: bad Huffman table id");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = byte();
      if (total > 256 || pos_ + total > end) fail("JPEG: bad Huffman table");
      uint8_t symbols[256];
      for (int i = 0; i < total; ++i) symbols[i] = byte();
      (cls ? ac_ : dc_)[id].build(counts, symbols, total);
    }
  }

  void read_dqt(size_t end) {
    while (pos_ < end) {
      const int pq = byte();
      const int id = pq & 15, prec = pq >> 4;
      if (id > 3 || prec > 1) fail("JPEG: bad quantization table");
      for (int k = 0; k < 64; ++k) qt_[id][kNatural[k]] = (uint16_t)(prec ? word() : byte());
      qdefined_[id] = true;
    }
  }

  // -------------------------------------------------------- entropy decoding
  void fill() {
    while (nbits_ <= 24) {
      uint32_t b = 0;
      if (!at_marker_ && pos_ < n_) {
        b = p_[pos_++];
        if (b == 0xFF) {
          const uint8_t next = pos_ < n_ ? p_[pos_] : 0xD9;
          if (next == 0) {
            ++pos_;
          } else {  // a marker: feed zeros from here on, as libjpeg does
            --pos_;
            at_marker_ = true;
            b = 0;
          }
        }
      } else {
        at_marker_ = true;
      }
      bits_ |= b << (24 - nbits_);
      nbits_ += 8;
    }
  }
  int get_bits(int n) {
    if (n == 0) return 0;
    if (n > 16) fail("JPEG: bad Huffman symbol (a value of " + std::to_string(n) + " bits)");
    if (nbits_ < n) fill();
    const int v = (int)(bits_ >> (32 - n));
    bits_ <<= n;
    nbits_ -= n;
    return v;
  }
  int get_bit() { return get_bits(1); }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  int decode_symbol(const Huffman& t) {
    if (nbits_ < 16) fill();
    const int look = (int)(bits_ >> 23);
    if (int len = t.look_len[look]) {
      bits_ <<= len;
      nbits_ -= len;
      return t.look_sym[look];
    }
    const uint32_t code16 = bits_ >> 16;
    for (int len = 10; len <= 16; ++len) {
      const int code = (int)(code16 >> (16 - len));
      if (code <= t.maxcode[len]) {
        bits_ <<= len;
        nbits_ -= len;
        return t.vals[(t.valptr[len] + code - t.mincode[len]) & 255];
      }
    }
    // a corrupt code: libjpeg warns and takes 0
    bits_ <<= 16;
    nbits_ -= 16;
    return 0;
  }

  void reset_reader() {
    bits_ = 0;
    nbits_ = 0;
    at_marker_ = false;
  }

  void restart() {
    reset_reader();
    // find the RSTn marker and step past it
    while (pos_ + 1 < n_ && !(p_[pos_] == 0xFF && p_[pos_ + 1] >= 0xD0 && p_[pos_ + 1] <= 0xD7)) {
      if (p_[pos_] == 0xFF && p_[pos_ + 1] != 0 && p_[pos_ + 1] != 0xFF) break;  // another marker
      ++pos_;
    }
    if (pos_ + 1 < n_ && p_[pos_] == 0xFF && p_[pos_ + 1] >= 0xD0 && p_[pos_ + 1] <= 0xD7)
      pos_ += 2;
    for (int i = 0; i < ncomp_; ++i) comp_[i].pred = 0;
    eobrun_ = 0;
  }

  struct Scan {
    int n = 0, comps[4] = {};
    int ss = 0, se = 63, ah = 0, al = 0;
  };

  void read_scan() {
    Scan s;
    s.n = byte();
    if (s.n < 1 || s.n > ncomp_ || s.n > 4) fail("JPEG: bad scan header");
    for (int i = 0; i < s.n; ++i) {
      const int id = byte(), tables = byte();
      int ci = -1;
      for (int k = 0; k < ncomp_; ++k)
        if (comp_[k].id == id) ci = k;
      if (ci < 0) fail("JPEG: scan names an unknown component");
      s.comps[i] = ci;
      comp_[ci].dc_tbl = tables >> 4;
      comp_[ci].ac_tbl = tables & 15;
      if (comp_[ci].dc_tbl > 3 || comp_[ci].ac_tbl > 3) fail("JPEG: bad table id in scan");
    }
    if (s.n > 1) {  // libjpeg's limit on an interleaved scan's MCU
      int blocks = 0;
      for (int i = 0; i < s.n; ++i) blocks += comp_[s.comps[i]].h * comp_[s.comps[i]].v;
      if (blocks > 10)
        fail("JPEG: " + std::to_string(blocks) + " blocks in an MCU (libjpeg takes at most 10)");
    }
    s.ss = byte();
    s.se = byte();
    const int a = byte();
    s.ah = a >> 4;
    s.al = a & 15;
    if (progressive_) {
      if (s.ss > s.se || s.se > 63 || (s.ss == 0 && s.se != 0) || (s.ss > 0 && s.n != 1) ||
          s.al > 13)
        fail("JPEG: bad progressive scan parameters");
    } else if (s.ss != 0 || s.se != 63 || s.ah != 0 || s.al != 0) {
      fail("JPEG: bad sequential scan parameters");
    }
    for (int i = 0; i < s.n; ++i) {
      Component& c = comp_[s.comps[i]];
      if (!c.latched) {  // the table in force at the component's first scan
        if (!qdefined_[c.tq]) fail("JPEG: quantization table not defined");
        std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
        c.latched = true;
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      }
      const bool needs_dc = s.ss == 0 && s.ah == 0;
      const bool needs_ac = s.se > 0;
      if ((needs_dc && !dc_[c.dc_tbl].defined) || (needs_ac && !ac_[c.ac_tbl].defined))
        fail("JPEG: Huffman table not defined");
    }
    reset_reader();
    for (int i = 0; i < ncomp_; ++i) comp_[i].pred = 0;
    eobrun_ = 0;

    int restarts_left = restart_interval_;
    auto maybe_restart = [&](bool last) {
      if (!restart_interval_) return;
      if (--restarts_left == 0 && !last) {
        restart();
        restarts_left = restart_interval_;
      }
    };
    if (s.n == 1) {  // non-interleaved: the component's own blocks, in raster order
      Component& c = comp_[s.comps[0]];
      const int bx_n = (c.dw + 7) / 8, by_n = (c.dh + 7) / 8;
      for (int by = 0; by < by_n; ++by)
        for (int bx = 0; bx < bx_n; ++bx) {
          decode_block(s, c, &c.coef[((size_t)by * c.bw + bx) * 64]);
          maybe_restart(by == by_n - 1 && bx == bx_n - 1);
        }
    } else {
      for (int my = 0; my < mcuy_; ++my)
        for (int mx = 0; mx < mcux_; ++mx) {
          for (int i = 0; i < s.n; ++i) {
            Component& c = comp_[s.comps[i]];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                const size_t b = (size_t)(my * c.v + y) * c.bw + (mx * c.h + x);
                decode_block(s, c, &c.coef[b * 64]);
              }
          }
          maybe_restart(my == mcuy_ - 1 && mx == mcux_ - 1);
        }
    }
    // step to the next marker
    while (pos_ + 1 < n_ && !(p_[pos_] == 0xFF && p_[pos_ + 1] != 0 &&
                              !(p_[pos_ + 1] >= 0xD0 && p_[pos_ + 1] <= 0xD7)))
      ++pos_;
  }

  void decode_block(const Scan& s, Component& c, int16_t* blk) {
    if (!progressive_) {
      int t = decode_symbol(dc_[c.dc_tbl]);
      const int diff = t ? extend(get_bits(t), t) : 0;
      c.pred = (int)((unsigned)c.pred + (unsigned)diff);  // wraps on corrupt data
      blk[0] = (int16_t)c.pred;
      const Huffman& ac = ac_[c.ac_tbl];
      for (int k = 1; k < 64; ++k) {
        const int rs = decode_symbol(ac);
        const int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          blk[kNatural[k]] = (int16_t)extend(get_bits(sz), sz);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (s.ss == 0) {  // DC scans
      if (s.ah == 0) {
        int t = decode_symbol(dc_[c.dc_tbl]);
        const int diff = t ? extend(get_bits(t), t) : 0;
        c.pred = (int)((unsigned)c.pred + (unsigned)diff);
        blk[0] = (int16_t)((unsigned)c.pred << s.al);
      } else if (get_bit()) {
        blk[0] |= (int16_t)(1 << s.al);
      }
      return;
    }
    const Huffman& ac = ac_[c.ac_tbl];
    if (s.ah == 0) {  // AC first
      if (eobrun_ > 0) {
        --eobrun_;
        return;
      }
      for (int k = s.ss; k <= s.se; ++k) {
        const int rs = decode_symbol(ac);
        int r = rs >> 4;
        const int sz = rs & 15;
        if (sz) {
          k += r;
          blk[kNatural[k]] = (int16_t)(extend(get_bits(sz), sz) * (1 << s.al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          --eobrun_;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    const int p1 = 1 << s.al, m1 = -1 * (1 << s.al);
    int k = s.ss;
    if (eobrun_ == 0) {
      for (; k <= s.se; ++k) {
        const int rs = decode_symbol(ac);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          sz = get_bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (get_bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= s.se);
        if (sz) blk[kNatural[k]] = (int16_t)sz;
      }
    }
    if (eobrun_ > 0) {
      for (; k <= s.se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && get_bit() && (*coef & p1) == 0)
          *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
      }
      --eobrun_;
    }
  }

  // ---------------------------------------------------------------- IDCT
  static inline uint8_t range_limit(int x) {
    // libjpeg's post-IDCT table: the low 10 bits as a signed value, + 128,
    // clamped to 0..255
    int v = x & 1023;
    if (v >= 512) v -= 1024;
    v += 128;
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
  }

  // jpeg_idct_islow: 13-bit constants, 2 extra bits between the passes
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    constexpr int kConst = 13, kPass1 = 2;
    constexpr long long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                        F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                        F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](long long x, int n) { return (x + (1LL << (n - 1))) >> n; };
    int ws[64];
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      int* wp = ws + col;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        const int dc = (ip[0] * (int)qp[0]) * (1 << kPass1);
        for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
        continue;
      }
      long long z2 = (long long)ip[16] * qp[16], z3 = (long long)ip[48] * qp[48];
      long long z1 = (z2 + z3) * F0541;
      long long tmp2 = z1 + z3 * -F1847;
      long long tmp3 = z1 + z2 * F0765;
      z2 = (long long)ip[0] * qp[0];
      z3 = (long long)ip[32] * qp[32];
      long long tmp0 = (z2 + z3) * (1LL << kConst);
      long long tmp1 = (z2 - z3) * (1LL << kConst);
      const long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (long long)ip[56] * qp[56];
      tmp1 = (long long)ip[40] * qp[40];
      tmp2 = (long long)ip[24] * qp[24];
      tmp3 = (long long)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      long long z4 = tmp1 + tmp3;
      const long long z5 = (z3 + z4) * F1175;
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
      constexpr int sh = kConst - kPass1;
      wp[0] = (int)descale(tmp10 + tmp3, sh);
      wp[56] = (int)descale(tmp10 - tmp3, sh);
      wp[8] = (int)descale(tmp11 + tmp2, sh);
      wp[48] = (int)descale(tmp11 - tmp2, sh);
      wp[16] = (int)descale(tmp12 + tmp1, sh);
      wp[40] = (int)descale(tmp12 - tmp1, sh);
      wp[24] = (int)descale(tmp13 + tmp0, sh);
      wp[32] = (int)descale(tmp13 - tmp0, sh);
    }
    for (int row = 0; row < 8; ++row) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + (size_t)row * stride;
      constexpr int sh = kConst + kPass1 + 3;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        const uint8_t v = range_limit((int)descale(wp[0], kPass1 + 3));
        for (int c = 0; c < 8; ++c) op[c] = v;
        continue;
      }
      long long z2 = wp[2], z3 = wp[6];
      long long z1 = (z2 + z3) * F0541;
      long long tmp2 = z1 + z3 * -F1847;
      long long tmp3 = z1 + z2 * F0765;
      long long tmp0 = ((long long)wp[0] + wp[4]) * (1LL << kConst);
      long long tmp1 = ((long long)wp[0] - wp[4]) * (1LL << kConst);
      const long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      long long z4 = tmp1 + tmp3;
      const long long z5 = (z3 + z4) * F1175;
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
      op[0] = range_limit((int)descale(tmp10 + tmp3, sh));
      op[7] = range_limit((int)descale(tmp10 - tmp3, sh));
      op[1] = range_limit((int)descale(tmp11 + tmp2, sh));
      op[6] = range_limit((int)descale(tmp11 - tmp2, sh));
      op[2] = range_limit((int)descale(tmp12 + tmp1, sh));
      op[5] = range_limit((int)descale(tmp12 - tmp1, sh));
      op[3] = range_limit((int)descale(tmp13 + tmp0, sh));
      op[4] = range_limit((int)descale(tmp13 - tmp0, sh));
    }
  }

  void idct_component(int ci) {
    Component& c = comp_[ci];
    if (!c.latched) fail("JPEG: a component has no scan");
    const int stride = c.bw * 8;
    planes_.resize(ncomp_);
    std::vector<uint8_t>& plane = planes_[ci];
    plane.assign((size_t)stride * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q,
                   &plane[(size_t)by * 8 * stride + bx * 8], stride);
  }

  // ------------------------------------------------------ upsampling, colour
  // One component's row `y` of full-resolution samples (jdsample.c), cols
  // 0..width_-1, into `out`.
  void upsample_row(int ci, int y, uint8_t* out, std::vector<int>& tmp) const {
    const Component& c = comp_[ci];
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    const int stride = c.bw * 8;
    const uint8_t* plane = planes_[ci].data();
    auto row = [&](int r) {  // rows past the last real one repeat it; row -1 is row 0
      r = std::max(0, std::min(r, c.dh - 1));
      return plane + (size_t)r * stride;
    };
    const int dw = c.dw;
    const bool fancy = dw > 2;
    if (rh == 1 && rv == 1) {
      std::memcpy(out, row(y), width_);
      return;
    }
    if (!((rh == 2 && rv == 1) || (rh == 1 && rv == 2) || (rh == 2 && rv == 2))) {
      // another integral ratio: each sample replicated rh x rv (int_upsample)
      const uint8_t* in = row(y / rv);
      for (int x = 0; x < width_; ++x) out[x] = in[x / rh];
      return;
    }
    if (rv == 1) {  // 2x1
      const uint8_t* in = row(y);
      if (!fancy) {
        for (int x = 0; x < width_; ++x) out[x] = in[x >> 1];
        return;
      }
      tmp.resize(2 * dw);
      int* o = tmp.data();
      o[0] = in[0];
      o[1] = (in[0] * 3 + in[1] + 2) >> 2;
      for (int i = 1; i < dw - 1; ++i) {
        const int v = in[i] * 3;
        o[2 * i] = (v + in[i - 1] + 1) >> 2;
        o[2 * i + 1] = (v + in[i + 1] + 2) >> 2;
      }
      o[2 * dw - 2] = (in[dw - 1] * 3 + in[dw - 2] + 1) >> 2;
      o[2 * dw - 1] = in[dw - 1];
      for (int x = 0; x < width_; ++x) out[x] = (uint8_t)o[x];
      return;
    }
    // vertical 2x: the nearer row and the next nearer one (above for even y)
    const int yi = y >> 1;
    const uint8_t* in0 = row(yi);
    const uint8_t* in1 = row((y & 1) ? yi + 1 : yi - 1);
    if (rh == 1) {  // 1x2 (jdsample.c h1v2_fancy_upsample)
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width_; ++x) out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    if (!fancy) {  // h2v2_upsample: each sample twice across, each row twice down
      for (int x = 0; x < width_; ++x) out[x] = in0[x >> 1];
      return;
    }
    tmp.resize(2 * dw);
    int* o = tmp.data();
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    o[0] = (this_sum * 4 + 8) >> 4;
    o[1] = (this_sum * 3 + next_sum + 7) >> 4;
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int i = 1; i < dw - 1; ++i) {
      next_sum = in0[i + 1] * 3 + in1[i + 1];
      o[2 * i] = (this_sum * 3 + last_sum + 8) >> 4;
      o[2 * i + 1] = (this_sum * 3 + next_sum + 7) >> 4;
      last_sum = this_sum;
      this_sum = next_sum;
    }
    o[2 * dw - 2] = (this_sum * 3 + last_sum + 8) >> 4;
    o[2 * dw - 1] = (this_sum * 4 + 7) >> 4;
    for (int x = 0; x < width_; ++x) out[x] = (uint8_t)o[x];
  }

  // libjpeg's colour space (jdapimin.c default_decompress_parms): JFIF
  // means YCbCr; else an Adobe segment's transform (0: RGB or CMYK, 1: YCbCr,
  // 2 and others: YCCK for 4 components, YCbCr for 3); else component ids
  // R, G, B mean RGB, and 4 components without an Adobe segment are CMYK.
  enum Space { kGrey, kYCbCr, kRGB, kCMYK, kYCCK };
  Space colour_space() const {
    if (ncomp_ == 1) return kGrey;
    if (ncomp_ == 4) return adobe_transform_ < 0 || adobe_transform_ == 0 ? kCMYK : kYCCK;
    if (saw_jfif_) return kYCbCr;
    if (adobe_transform_ >= 0) return adobe_transform_ == 0 ? kRGB : kYCbCr;
    return comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B' ? kRGB : kYCbCr;
  }

  // The pixels Pillow's convert("RGB") gives. A 4-component file opens as
  // "CMYK" read with inverted samples (Pillow's rawmode "CMYK;I", whatever
  // the Adobe segment says) from libjpeg's CMYK output (YCCK converted as
  // libjpeg does: C, M, Y = 255 - the YCbCr conversion's R, G, B; K as it
  // is); Pillow's CMYK -> RGB is then R = nk - nk·C / 255 (rounded as its
  // MULDIV255), nk = 255 - K, so R = k - k·(255 - c) / 255 in libjpeg's
  // samples.
  void write_pixels(uint8_t* out) const {
    const Space space = colour_space();
    if (space == kGrey) {
      std::vector<int> tmp;
      for (int y = 0; y < height_; ++y) upsample_row(0, y, out + (size_t)y * width_, tmp);
      return;
    }
    // jdcolor.c build_ycc_rgb_table: 16-bit fixed point
    constexpr int kScale = 16;
    constexpr long long kHalf = 1LL << (kScale - 1);
    auto fix = [](double x) { return (long long)(x * (1LL << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    long long cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const long long x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto muldiv255 = [](int a, int b) {
      const int t = a * b + 128;
      return ((t >> 8) + t) >> 8;
    };
    std::vector<uint8_t> rows((size_t)ncomp_ * width_);
    std::vector<int> tmp;
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int y = 0; y < height_; ++y) {
      for (int ci = 0; ci < ncomp_; ++ci)
        upsample_row(ci, y, &rows[(size_t)ci * width_], tmp);
      const uint8_t *c0 = &rows[0], *c1 = &rows[width_], *c2 = &rows[2 * (size_t)width_];
      const uint8_t* c3 = ncomp_ == 4 ? &rows[3 * (size_t)width_] : nullptr;
      uint8_t* o = out + (size_t)y * width_ * 3;
      for (int x = 0; x < width_; ++x) {
        int rgb[3];
        if (space == kRGB || space == kCMYK) {
          rgb[0] = c0[x], rgb[1] = c1[x], rgb[2] = c2[x];
        } else {
          const int yy = c0[x], cb = c1[x], cr = c2[x];
          rgb[0] = clamp(yy + cr_r[cr]);
          rgb[1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> kScale));
          rgb[2] = clamp(yy + cb_b[cb]);
        }
        if (space == kCMYK) {
          for (int k = 0; k < 3; ++k) o[3 * x + k] = (uint8_t)(c3[x] - muldiv255(255 - rgb[k], c3[x]));
        } else if (space == kYCCK) {
          for (int k = 0; k < 3; ++k) o[3 * x + k] = (uint8_t)(c3[x] - muldiv255(rgb[k], c3[x]));
        } else {
          for (int k = 0; k < 3; ++k) o[3 * x + k] = (uint8_t)rgb[k];
        }
      }
    }
  }
};

// ------------------------------------------------------------------- BMP
//
// As Pillow's BmpImagePlugin reads them: headers of 12, 40, 52, 56, 64, 108
// and 124 bytes; 1-, 4- and 8-bit palettes (BGRX, or BGR after a 12-byte
// header; an index past the palette reads black); 16-bit 5-5-5, 24- and
// 32-bit (BGRX) pixels, bottom-up or top-down; BI_BITFIELDS with the masks
// Pillow accepts (5-6-5 and 5-5-5 at 16 bits, its byte orders at 32; a
// 16-bit channel of n bits scales by 255 / (2^n - 1), truncated); RLE8 and
// RLE4 as its BmpRleDecoder runs them. Pillow's quirks are kept: a palette
// of grey levels (entry i = i, i, i; two entries black and white) makes the
// image "L" or "1", whose pixels are then the indices themselves whatever
// the palette's size, or the row's bytes (bits) at fewer bits a pixel; an offset that points at the palette skips
// it; an RLE delta skips two bytes before its (right, up) pair and moves
// right + up x width pixels on; an RLE4 absolute run of odd length drops
// its last pixel; RLE data that fills fewer pixels than the image is
// refused ("not enough image data").
struct Bmp {
  int width = 0, height = 0, bits = 0, compression = 0;
  bool top_down = false;
  size_t offset = 0, row_bytes = 0;
  uint8_t pal[256][3] = {};  // RGB, black past the palette
  enum { kPalette, kGrey, kBilevel, kDirect } kind = kDirect;
  uint32_t mask[3] = {0xFF0000, 0xFF00, 0xFF};  // R, G, B of a 16- or 32-bit pixel
  std::vector<uint8_t> indices;  // RLE: [height][width], bottom row first where bottom-up

  Bmp(const uint8_t* p, size_t n) {
    if (n < 26) fail("BMP: file too short");
    auto u16 = [&](size_t o) { return (uint32_t)p[o] | ((uint32_t)p[o + 1] << 8); };
    auto u32 = [&](size_t o) { return u16(o) | (u16(o + 2) << 16); };
    offset = u32(10);
    const uint32_t header = u32(14);
    if (n < 14 + (size_t)header) fail("BMP: file too short");
    int colours = 0, entry = 4;
    size_t pos = 14 + header;  // after the header: masks, then the palette
    if (header == 12) {  // OS/2 BITMAPCOREHEADER: bottom-up, uncompressed
      width = (int)u16(18);
      height = (int)u16(20);
      bits = (int)u16(24);
      entry = 3;
    } else if (header == 40 || header == 52 || header == 56 || header == 64 || header == 108 ||
               header == 124) {
      width = (int32_t)u32(18);
      top_down = p[25] == 0xFF;
      height = top_down ? (int)(0x100000000LL - u32(22)) : (int32_t)u32(22);
      bits = (int)u16(28);
      compression = (int)u32(30);
      colours = (int)u32(46);
      if (compression == 3) {  // BI_BITFIELDS
        size_t at = 54;
        if (header == 40) {  // the masks follow the header
          at = pos;
          pos += 12;
        }
        if (n < at + 12) fail("BMP: file too short");
        const uint32_t m[4] = {u32(at), u32(at + 4), u32(at + 8), header >= 56 ? u32(66) : 0};
        bitfields(m);
      } else if (compression == 1 || compression == 2) {
        if (bits != (compression == 1 ? 8 : 4))
          fail("BMP: RLE" + std::string(compression == 1 ? "8" : "4") + " with " +
               std::to_string(bits) + "-bit pixels");
      } else if (compression != 0) {
        fail("BMP: compression " + std::to_string(compression) + " (JPEG or PNG inside) is "
             "not supported");
      }
    } else {
      fail("BMP: header of " + std::to_string(header) + " bytes is not supported");
    }
    if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 && bits != 32)
      fail("BMP: " + std::to_string(bits) + "-bit pixels are not supported (Pillow reads 1, 4, "
           "8, 16, 24 and 32)");
    if (width <= 0 || height <= 0) fail("BMP: bad size");
    if ((long long)width * height > (1LL << 28)) fail("BMP: image too large");
    if (colours == 0) colours = 1 << std::min(bits, 16);
    if (bits <= 8) {
      if (offset == 14 + (size_t)header) offset += 4 * (size_t)colours;
      if (colours <= 0 || colours > 65536) fail("BMP: bad palette size");
      const size_t have = pos < n ? std::min((size_t)colours * entry, n - pos) : 0;
      const uint8_t* pe = p + pos;
      bool grey = true;
      for (int i = 0; i < colours && grey; ++i) {
        const int want = colours == 2 ? (i ? 255 : 0) : i;
        grey = (size_t)i * entry + 3 <= have && pe[i * entry] == want &&
               pe[i * entry + 1] == want && pe[i * entry + 2] == want;
      }
      for (int i = 0; i < std::min(colours, 256) && (size_t)(i * entry + 3) <= have; ++i) {
        pal[i][0] = pe[i * entry + 2];
        pal[i][1] = pe[i * entry + 1];
        pal[i][2] = pe[i * entry];
      }
      kind = !grey ? kPalette : colours == 2 ? kBilevel : kGrey;
      if (kind == kBilevel && compression) fail("BMP: RLE with a black-and-white palette");
    }
    if (compression == 1 || compression == 2) {
      rle(p, n, compression == 2);
      return;
    }
    row_bytes = (((size_t)width * bits + 31) / 32) * 4;
    if (kind == kGrey && bits < 8 && (size_t)width > row_bytes)
      fail("BMP: " + std::to_string(bits) + "-bit pixels with a palette of grey levels, wider "
           "than a row's bytes (Pillow refuses them: codec configuration error)");
    if (offset > n || row_bytes * height > n - offset)
      fail("BMP: pixel data runs past the end of the file");
  }

  void bitfields(const uint32_t m[4]) {
    const bool zero = !m[0] && !m[1] && !m[2] && !m[3];
    bool ok = false;
    if (bits == 32) {
      static const uint32_t kOk[8][4] = {
          {0xFF0000, 0xFF00, 0xFF, 0x0},         {0xFF000000, 0xFF0000, 0xFF00, 0x0},
          {0xFF000000, 0xFF00, 0xFF, 0x0},       {0xFF000000, 0xFF0000, 0xFF00, 0xFF},
          {0xFF, 0xFF00, 0xFF0000, 0xFF000000},  {0xFF0000, 0xFF00, 0xFF, 0xFF000000},
          {0xFF000000, 0xFF00, 0xFF, 0xFF0000},  {0x0, 0x0, 0x0, 0x0}};
      for (const auto& k : kOk) ok |= !std::memcmp(k, m, sizeof(k));
    } else if (bits == 24) {
      ok = m[0] == 0xFF0000 && m[1] == 0xFF00 && m[2] == 0xFF;
    } else if (bits == 16) {
      ok = (m[0] == 0xF800 && m[1] == 0x7E0 && m[2] == 0x1F) ||
           (m[0] == 0x7C00 && m[1] == 0x3E0 && m[2] == 0x1F);
    }
    if (!ok) {
      char buf[96];
      std::snprintf(buf, sizeof(buf), "BMP: bit fields %X/%X/%X/%X at %d bits", m[0], m[1], m[2],
                    m[3], bits);
      fail(std::string(buf) + " (Pillow refuses the layout)");
    }
    if (!zero) std::memcpy(mask, m, sizeof(mask));  // all zero: Pillow reads BGRA
  }

  // Pillow's BmpRleDecoder: the indices, width x height, rows as stored
  void rle(const uint8_t* p, size_t n, bool rle4) {
    const size_t total = (size_t)width * height;
    std::vector<uint8_t>& data = indices;
    data.reserve(total);
    size_t pos = offset;
    long long x = 0;
    while (data.size() < total) {
      if (pos + 2 > n) break;
      const int count = p[pos], byte = p[pos + 1];
      pos += 2;
      if (count) {  // a run
        long long k = count;
        if (x + k > width) k = std::max(0LL, width - x);
        for (long long i = 0; i < k; ++i)
          data.push_back((uint8_t)(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte));
        x += k;
      } else if (byte == 0) {  // end of line
        while (data.size() % width) data.push_back(0);
        x = 0;
      } else if (byte == 1) {  // end of bitmap
        break;
      } else if (byte == 2) {  // delta: Pillow reads two bytes, then (right, up)
        if (pos + 2 > n) break;
        pos += 2;
        if (pos + 2 > n) fail("BMP: RLE delta past the end of the file");
        const size_t skip = p[pos] + (size_t)p[pos + 1] * width;
        pos += 2;
        data.resize(data.size() + skip, 0);
        x = (long long)(data.size() % width);
      } else {  // an absolute run of `byte` pixels
        const size_t nbytes = rle4 ? byte / 2 : byte;
        const size_t got = std::min(nbytes, n - pos);
        for (size_t i = 0; i < got; ++i) {
          if (rle4) {
            data.push_back(p[pos + i] >> 4);
            data.push_back(p[pos + i] & 15);
          } else {
            data.push_back(p[pos + i]);
          }
        }
        pos += got;
        if (got < nbytes) break;
        x += byte;
        if (pos % 2) ++pos;  // word alignment, of the file position
      }
    }
    if (data.size() < total)
      fail("BMP: RLE data fills " + std::to_string(data.size()) + " of " +
           std::to_string(total) + " pixels (Pillow refuses: not enough image data)");
    data.resize(total);
  }

  void decode(const uint8_t* p, uint8_t* out) const {
    for (int y = 0; y < height; ++y) {
      const int src_y = top_down ? y : height - 1 - y;
      uint8_t* o = out + (size_t)y * width * 3;
      if (!indices.empty()) {
        const uint8_t* row = &indices[(size_t)src_y * width];
        for (int x = 0; x < width; ++x) put_index(row[x], o + 3 * x);
        continue;
      }
      const uint8_t* row = p + offset + row_bytes * (size_t)src_y;
      for (int x = 0; x < width; ++x) {
        uint8_t* px = o + 3 * x;
        if (bits <= 8) {
          const int at = x * bits;
          const int i = (row[at >> 3] >> (8 - bits - (at & 7))) & ((1 << bits) - 1);
          if (kind == kBilevel) {  // Pillow's "1": the pixel's bit of a 1-bit row
            const int bit = (row[x >> 3] >> (7 - (x & 7))) & 1;
            px[0] = px[1] = px[2] = bit ? 255 : 0;
          } else if (kind == kGrey && bits < 8) {  // Pillow's "L": the row's bytes
            px[0] = px[1] = px[2] = row[x];
          } else {
            put_index(i, px);
          }
        } else if (bits == 16) {
          const uint32_t v = row[2 * x] | (row[2 * x + 1] << 8);
          const uint32_t m[3] = {compression == 3 ? mask[0] : 0x7C00,
                                 compression == 3 ? mask[1] : 0x3E0, 0x1F};
          for (int c = 0; c < 3; ++c) {
            const int shift = __builtin_ctz(m[c]);
            const uint32_t top = m[c] >> shift;
            px[c] = (uint8_t)(((v & m[c]) >> shift) * 255 / top);
          }
        } else if (bits == 24) {
          px[0] = row[3 * x + 2];
          px[1] = row[3 * x + 1];
          px[2] = row[3 * x];
        } else {
          const uint32_t v = row[4 * x] | (row[4 * x + 1] << 8) | (row[4 * x + 2] << 16) |
                             ((uint32_t)row[4 * x + 3] << 24);
          for (int c = 0; c < 3; ++c) px[c] = (uint8_t)((v & mask[c]) >> __builtin_ctz(mask[c]));
        }
      }
    }
  }

  void put_index(int i, uint8_t* px) const {
    if (kind == kGrey) {  // Pillow's "L": the index is the grey level
      px[0] = px[1] = px[2] = (uint8_t)i;
    } else {
      std::memcpy(px, pal[i], 3);
    }
  }
};

// ------------------------------------------------------------------- GIF
//
// GIF87a and GIF89a: global and local palettes, LZW codes of 2 to 12 bits
// (clear and end codes; a full table is kept until the next clear code),
// interlaced frames, and the graphic control extension's transparent index
// and disposal method. The frames are composited onto the logical screen as
// Pillow gives them for `seek(i)` then `convert("RGB")` (its default
// RGB_AFTER_FIRST loading):
// - frame 0 keeps palette indices: the screen outside its rectangle holds
//   index 0, or its transparent index, and its own transparent pixels keep
//   their index, so both show their palette colour;
// - from frame 1 on the screen is RGB: a frame's pixels go through its
//   palette (its local one, else the global one), and its transparent
//   pixels leave what is under them;
// - an index past a palette reads black;
// - before each frame the previous frame's rectangle is disposed of by the
//   disposal method in force (a method stays in force over later frames
//   whose own is 0, as Pillow keeps it): 2 fills the rectangle with the
//   transparent index, else the background index, through the new frame's
//   palette from frame 1 on; 3 restores what was there before the frame was
//   drawn (after frame 0 only where it had a transparent index, which then
//   fills the rectangle).
// A GIF whose frame 0 has no palette, or the grey ramp (entry i = i, i, i),
// is grey (Pillow's "L"): indices are grey levels, every frame is drawn as
// indices, and disposal 2 fills with frame 0's transparent index first.
// Refused with a message: a frame outside the logical screen or empty, a
// frame with a palette after a grey frame 0 and one without after a
// paletted frame 0, LZW minimum code sizes outside 1..8, a code not yet in
// the table, and a file that ends inside a header or a frame's data.

class Gif {
 public:
  struct Frame {
    int x0 = 0, y0 = 0, w = 0, h = 0;
    bool interlace = false;
    int transparency = -1;  // the transparent index, or -1
    int dispose = 0;        // the disposal method's bits, 0 where unspecified
    const uint8_t* pal = nullptr;  // the local palette, or null
    int pal_n = 0;
    int min_code = 0;
    size_t data = 0;  // the first sub-block of the LZW data
  };

  int width = 0, height = 0;
  std::vector<Frame> frames;

  Gif(const uint8_t* p, size_t n) : p_(p), n_(n) { parse(); }

  // out: [count, height, width, 3] uint8, the first `count` frames
  void decode(uint8_t* out, size_t count) const {
    const size_t screen = (size_t)width * height;
    std::vector<uint8_t> idx(screen, 0), rgb;
    uint8_t pal0[256 * 3];
    enum { P, L, RGB } mode = P;
    int method = 0, info_t = -1;
    Dispose pending;
    std::vector<int> px;
    for (size_t f = 0; f < std::min(count, frames.size()); ++f) {
      const Frame& fr = frames[f];
      const uint8_t* fp = nullptr;  // the frame's palette, null if grey
      int fp_n = 0;
      if (fr.pal) {
        if (!grey_ramp(fr.pal, fr.pal_n)) fp = fr.pal, fp_n = fr.pal_n;
      } else if (gpal_ && !grey_ramp(gpal_, gpal_n_)) {
        fp = gpal_, fp_n = gpal_n_;
      }
      if (f > 0) apply(pending, mode == RGB ? rgb.data() : idx.data());
      if (fr.dispose) method = fr.dispose;
      if (f == 0) {
        mode = fp ? P : L;
        if (fp) table(fp, fp_n, pal0);
      } else if (mode == L && fp) {
        fail("GIF: a frame with a palette after a first frame without one");
      } else if (mode != L && !fp) {
        fail("GIF: a frame without a palette after a first frame with one");
      } else if (mode == P) {
        rgb.resize(3 * screen);
        for (size_t i = 0; i < screen; ++i) std::memcpy(&rgb[3 * i], &pal0[3 * idx[i]], 3);
        mode = RGB;
      }
      // what replaces this frame's rectangle before the next frame
      pending = Dispose();
      pending.x0 = fr.x0, pending.y0 = fr.y0, pending.w = fr.w, pending.h = fr.h;
      if (method == 2) {
        int c = mode == L && info_t >= 0 ? info_t : fr.transparency;
        if (c < 0) c = background_;
        if (mode == RGB) {
          pending.kind = 2;
          const int e = (c + 1) * 3 > 3 * fp_n ? 0 : c;
          std::memcpy(pending.colour, fp + 3 * e, 3);
        } else {
          pending.kind = 1, pending.index = c;
        }
      } else if (method >= 3) {
        if (f > 0) {
          const int ch = mode == RGB ? 3 : 1;
          const uint8_t* src = mode == RGB ? rgb.data() : idx.data();
          pending.kind = mode == RGB ? 4 : 3;
          pending.patch.resize((size_t)fr.w * fr.h * ch);
          for (int y = 0; y < fr.h; ++y)
            std::memcpy(&pending.patch[(size_t)y * fr.w * ch],
                        src + (((size_t)(fr.y0 + y) * width) + fr.x0) * ch, (size_t)fr.w * ch);
        } else if (fr.transparency >= 0) {
          pending.kind = 1, pending.index = fr.transparency;
        }
      }
      if (f == 0 && mode == L) info_t = fr.transparency;

      lzw(fr, px);
      const int t = fr.transparency;
      if (f == 0) {
        std::fill(idx.begin(), idx.end(), (uint8_t)(t >= 0 ? t : 0));
      }
      uint8_t ft[256 * 3];
      if (mode == RGB) table(fp, fp_n, ft);
      for (int y = 0; y < fr.h; ++y) {
        for (int x = 0; x < fr.w; ++x) {
          int v = px[(size_t)y * fr.w + x];
          const size_t o = (size_t)(fr.y0 + y) * width + fr.x0 + x;
          if (f == 0) {
            if (v >= 0) idx[o] = (uint8_t)v;
          } else if (mode == L) {
            if (v >= 0 && v != t) idx[o] = (uint8_t)v;
          } else {
            if (v < 0) v = t >= 0 ? t : 0;  // the rectangle's fill
            if (v != t) std::memcpy(&rgb[3 * o], &ft[3 * v], 3);
          }
        }
      }
      uint8_t* o = out + f * screen * 3;
      if (mode == RGB) {
        std::memcpy(o, rgb.data(), 3 * screen);
      } else {
        for (size_t i = 0; i < screen; ++i) {
          const uint8_t* c = &pal0[3 * idx[i]];
          for (int k = 0; k < 3; ++k) o[3 * i + k] = mode == P ? c[k] : idx[i];
        }
      }
    }
  }

 private:
  // what replaces a frame's rectangle before the next frame
  struct Dispose {
    int kind = 0;  // 0 nothing, 1 an index, 2 a colour, 3 indices, 4 colours
    int index = 0;
    uint8_t colour[3] = {0, 0, 0};
    std::vector<uint8_t> patch;  // [h, w, 1 or 3]
    int x0 = 0, y0 = 0, w = 0, h = 0;
  };

  const uint8_t* p_;
  size_t n_;
  const uint8_t* gpal_ = nullptr;
  int gpal_n_ = 0, background_ = 0;

  static bool grey_ramp(const uint8_t* pal, int n) {
    for (int i = 0; i < n; ++i)
      if (pal[3 * i] != i || pal[3 * i + 1] != i || pal[3 * i + 2] != i) return false;
    return true;
  }

  // 256 palette entries, black past the palette's own
  static void table(const uint8_t* pal, int n, uint8_t* out) {
    std::memset(out, 0, 256 * 3);
    std::memcpy(out, pal, (size_t)std::min(n, 256) * 3);
  }

  void apply(const Dispose& d, uint8_t* im) const {
    const int ch = d.kind == 2 || d.kind == 4 ? 3 : 1;
    for (int y = 0; y < d.h && d.kind; ++y) {
      uint8_t* row = im + ((size_t)(d.y0 + y) * width + d.x0) * ch;
      if (d.kind >= 3) {
        std::memcpy(row, &d.patch[(size_t)y * d.w * ch], (size_t)d.w * ch);
      } else if (d.kind == 1) {
        std::memset(row, d.index, d.w);
      } else {
        for (int x = 0; x < d.w; ++x) std::memcpy(row + 3 * x, d.colour, 3);
      }
    }
  }

  size_t skip_blocks(size_t pos, const char* where) const {
    while (true) {
      if (pos >= n_) fail(std::string("GIF: file ends inside ") + where);
      const size_t len = p_[pos++];
      if (len == 0) return pos;
      if (pos + len > n_) fail(std::string("GIF: file ends inside ") + where);
      pos += len;
    }
  }

  void parse() {
    if (n_ < 13) fail("GIF: file ends inside the header");
    if (std::memcmp(p_, "GIF87a", 6) != 0 && std::memcmp(p_, "GIF89a", 6) != 0)
      fail("not a GIF87a or GIF89a file");
    width = p_[6] | p_[7] << 8;
    height = p_[8] | p_[9] << 8;
    if (width == 0 || height == 0) fail("GIF: empty logical screen");
    const int flags = p_[10];
    size_t pos = 13;
    if (flags & 0x80) {
      background_ = p_[11];
      gpal_n_ = 1 << ((flags & 7) + 1);
      gpal_ = p_ + pos;
      pos += 3 * (size_t)gpal_n_;
      if (pos > n_) fail("GIF: file ends inside the global palette");
    }
    int transparency = -1, dispose = 0;
    while (pos < n_) {
      const uint8_t b = p_[pos++];
      if (b == ';') break;
      if (b == '!') {
        if (pos >= n_) fail("GIF: file ends inside an extension");
        const int label = p_[pos++];
        if (label == 0xF9 && pos < n_ && p_[pos] > 0) {
          if (p_[pos] < 4 || pos + 5 > n_) fail("GIF: bad graphic control extension");
          const int gflags = p_[pos + 1];
          if (gflags & 1) transparency = p_[pos + 4];
          dispose = (gflags >> 2) & 7;
        }
        pos = skip_blocks(pos, "an extension");
      } else if (b == ',') {
        if (pos + 9 > n_) fail("GIF: file ends inside an image descriptor");
        Frame fr;
        fr.x0 = p_[pos] | p_[pos + 1] << 8;
        fr.y0 = p_[pos + 2] | p_[pos + 3] << 8;
        fr.w = p_[pos + 4] | p_[pos + 5] << 8;
        fr.h = p_[pos + 6] | p_[pos + 7] << 8;
        const int iflags = p_[pos + 8];
        pos += 9;
        if (fr.w == 0 || fr.h == 0) fail("GIF: empty frame");
        if (fr.x0 + fr.w > width || fr.y0 + fr.h > height)
          fail("GIF: a frame outside the logical screen");
        fr.interlace = (iflags & 0x40) != 0;
        if (iflags & 0x80) {
          fr.pal_n = 1 << ((iflags & 7) + 1);
          fr.pal = p_ + pos;
          pos += 3 * (size_t)fr.pal_n;
          if (pos > n_) fail("GIF: file ends inside a local palette");
        }
        if (pos >= n_) fail("GIF: file ends inside a frame's data");
        fr.min_code = p_[pos++];
        if (fr.min_code < 1 || fr.min_code > 8)
          fail("GIF: LZW minimum code size " + std::to_string(fr.min_code) +
               " (1 to 8 are taken)");
        fr.data = pos;
        pos = skip_blocks(pos, "a frame's data");
        fr.transparency = transparency;
        fr.dispose = dispose;
        frames.push_back(fr);
        transparency = -1, dispose = 0;
      }
      // any other byte between blocks is skipped, as Pillow skips it
    }
    if (frames.empty()) fail("GIF: no image in the file");
  }

  // The frame's pixel indices in raster order, -1 where the data ended first.
  void lzw(const Frame& fr, std::vector<int>& px) const {
    const size_t total = (size_t)fr.w * fr.h;
    px.assign(total, -1);
    std::vector<int> rows(fr.h);
    if (fr.interlace) {
      int k = 0;
      const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
      for (int pass = 0; pass < 4; ++pass)
        for (int y = start[pass]; y < fr.h; y += step[pass]) rows[k++] = y;
    } else {
      for (int y = 0; y < fr.h; ++y) rows[y] = y;
    }
    const int clear = 1 << fr.min_code, end = clear + 1;
    int size = fr.min_code + 1, next = end + 1, prev = -1, first = 0;
    uint16_t prefix[4096];
    uint8_t suffix[4096];
    std::vector<uint8_t> stack(4097);
    size_t pos = fr.data, block_end = fr.data, written = 0;
    uint32_t acc = 0;
    int nbits = 0;
    bool done = false;
    auto put = [&](int v) {
      if (written < total) {
        const size_t y = written / fr.w, x = written % fr.w;
        px[(size_t)rows[y] * fr.w + x] = v;
        ++written;
      }
    };
    while (!done && written < total) {
      while (nbits < size) {
        if (pos == block_end) {
          const size_t len = p_[pos++];
          if (len == 0) {
            done = true;
            break;
          }
          block_end = pos + len;
        }
        acc |= (uint32_t)p_[pos++] << nbits;
        nbits += 8;
      }
      if (done) break;
      const int code = acc & ((1u << size) - 1);
      acc >>= size;
      nbits -= size;
      if (code == clear) {
        size = fr.min_code + 1, next = end + 1, prev = -1;
        continue;
      }
      if (code == end) break;
      if (prev < 0) {
        if (code > clear) fail("GIF: LZW code not in the table");
        put(code);
        prev = first = code;
        continue;
      }
      int c = code, sp = 0;
      if (code >= next) {
        if (code > next) fail("GIF: LZW code not in the table");
        stack[sp++] = (uint8_t)first;  // the KwKwK case
        c = prev;
      }
      while (c > clear) {
        stack[sp++] = suffix[c];
        c = prefix[c];
      }
      stack[sp++] = (uint8_t)c;
      first = c;
      while (sp) put(stack[--sp]);
      if (next < 4096) {
        prefix[next] = (uint16_t)prev;
        suffix[next] = (uint8_t)first;
        ++next;
        if (next == (1 << size) && size < 12) ++size;
      }
      prev = code;
    }
  }
};

int report(const Error& e, char* err, int err_len) {
  if (err && err_len > 0) std::snprintf(err, (size_t)err_len, "%s", e.msg.c_str());
  return 1;
}

bool is_jpeg(const uint8_t* p, size_t n) { return n >= 3 && p[0] == 0xFF && p[1] == 0xD8; }
bool is_bmp(const uint8_t* p, size_t n) { return n >= 2 && p[0] == 'B' && p[1] == 'M'; }

}  // namespace

extern "C" {

// The decoded image's width, height and channels (1 or 3).
int image_info(const uint8_t* data, size_t n, int* w, int* h, int* c, char* err, int err_len) {
  try {
    if (is_jpeg(data, n)) {
      Jpeg(data, n).info(w, h, c);
    } else if (is_bmp(data, n)) {
      Bmp b(data, n);
      *w = b.width;
      *h = b.height;
      *c = 3;
    } else {
      fail("neither a JPEG nor a BMP file");
    }
    return 0;
  } catch (const Error& e) {
    return report(e, err, err_len);
  }
}

// Decode into out [h, w, c] uint8 (the shape `image_info` gave).
int image_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int err_len) {
  try {
    if (is_jpeg(data, n)) {
      Jpeg(data, n).decode(out);
    } else if (is_bmp(data, n)) {
      Bmp(data, n).decode(data, out);
    } else {
      fail("neither a JPEG nor a BMP file");
    }
    return 0;
  } catch (const Error& e) {
    return report(e, err, err_len);
  }
}

// A GIF's logical screen and its number of frames.
int gif_info(const uint8_t* data, size_t n, int* w, int* h, int* frames, char* err,
             int err_len) {
  try {
    Gif g(data, n);
    *w = g.width;
    *h = g.height;
    *frames = (int)g.frames.size();
    return 0;
  } catch (const Error& e) {
    return report(e, err, err_len);
  }
}

// Decode the first `count` frames into out [count, h, w, 3] uint8 (the
// screen `gif_info` gave), composited onto the logical screen.
int gif_decode(const uint8_t* data, size_t n, uint8_t* out, int count, char* err,
               int err_len) {
  try {
    Gif(data, n).decode(out, (size_t)std::max(count, 0));
    return 0;
  } catch (const Error& e) {
    return report(e, err, err_len);
  }
}

}  // extern "C"
