// JPEG and BMP decoding for the host data path (C ABI, loaded with ctypes).
//
// The pixels are those Pillow gives for `Image.open(path)` on a build with
// libjpeg-turbo at its defaults: the integer ISLOW IDCT (jidctint.c),
// "fancy" triangle upsampling of subsampled chroma (jdsample.c), and
// libjpeg's fixed-point YCbCr -> RGB tables (jdcolor.c), bit for bit.
//
// JPEG: 8-bit Huffman-coded sequential (SOF0, SOF1) and progressive (SOF2)
// with spectral selection and successive approximation, restart intervals,
// one component (grey) or three (YCbCr) with the chroma at 1x1 or 2x1, 1x2,
// 2x2 of the luma. BMP: uncompressed 24- and 32-bit, and 8-bit paletted,
// bottom-up or top-down. Anything else is refused with a message naming
// what was found; nothing is passed on silently.
//
// Two calls: `image_info` parses the headers into the output's shape, then
// `image_decode` fills a caller-owned [H, W, C] uint8 buffer (C = 1 for a
// grey JPEG, else 3). Both return 0, or 1 with a message in `err`.

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
  Component comp_[3];
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
    if (ncomp_ == 4) fail("JPEG: 4 components (CMYK or YCCK) are not supported");
    if (ncomp_ != 1 && ncomp_ != 3)
      fail("JPEG: " + std::to_string(ncomp_) + " components are not supported");
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
    for (int i = 0; i < ncomp_; ++i) {
      const Component& c = comp_[i];
      factors += (i ? "," : "") + std::to_string(c.h) + "x" + std::to_string(c.v);
      const int rh = hmax_ / c.h, rv = vmax_ / c.v;
      if (hmax_ % c.h || vmax_ % c.v || rh > 2 || rv > 2)
        fail("JPEG: sampling factors " + factors + " are not supported (4:4:4, 4:2:2, 4:2:0 "
             "and 4:4:0 are)");
    }
    for (int i = 0; i < ncomp_; ++i) {
      if (hmax_ % comp_[i].h || vmax_ % comp_[i].v)
        fail("JPEG: sampling factors " + factors + " are not supported");
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
    if (ncomp_ == 3) {
      if (adobe_transform_ == 0 && !saw_jfif_)
        fail("JPEG: RGB colour (Adobe transform 0) is not supported");
      if (!saw_jfif_ && adobe_transform_ < 0 && comp_[0].id == 'R' && comp_[1].id == 'G' &&
          comp_[2].id == 'B')
        fail("JPEG: RGB colour (component ids R, G, B) is not supported");
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
    if (nbits_ < n) fill();
    const int v = (int)(bits_ >> (32 - n));
    bits_ <<= n;
    nbits_ -= n;
    return v;
  }
  int get_bit() { return get_bits(1); }
  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-1 << s) + 1 : v; }

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
    if (s.n < 1 || s.n > ncomp_) fail("JPEG: bad scan header");
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
      c.pred += diff;
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
        c.pred += diff;
        blk[0] = (int16_t)(c.pred * (1 << s.al));
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

  void write_pixels(uint8_t* out) const {
    if (ncomp_ == 1) {
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
    std::vector<uint8_t> rows(3 * (size_t)width_);
    std::vector<int> tmp;
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (int y = 0; y < height_; ++y) {
      for (int ci = 0; ci < 3; ++ci) upsample_row(ci, y, &rows[(size_t)ci * width_], tmp);
      const uint8_t *Y = &rows[0], *Cb = &rows[width_], *Cr = &rows[2 * (size_t)width_];
      uint8_t* o = out + (size_t)y * width_ * 3;
      for (int x = 0; x < width_; ++x) {
        const int yy = Y[x], cb = Cb[x], cr = Cr[x];
        o[3 * x] = clamp(yy + cr_r[cr]);
        o[3 * x + 1] = clamp(yy + (int)((cb_g[cb] + cr_g[cr]) >> kScale));
        o[3 * x + 2] = clamp(yy + cb_b[cb]);
      }
    }
  }
};

// ------------------------------------------------------------------- BMP
struct Bmp {
  int width = 0, height = 0, bits = 0;
  bool top_down = false;
  size_t offset = 0, row_bytes = 0;
  const uint8_t* palette = nullptr;
  int colours = 0, palette_entry = 4;

  Bmp(const uint8_t* p, size_t n) {
    if (n < 26) fail("BMP: file too short");
    auto u16 = [&](size_t o) { return (uint32_t)p[o] | ((uint32_t)p[o + 1] << 8); };
    auto u32 = [&](size_t o) { return u16(o) | (u16(o + 2) << 16); };
    offset = u32(10);
    const uint32_t header = u32(14);
    if (header == 12) {  // OS/2 BITMAPCOREHEADER
      width = (int)u16(18);
      height = (int)(int16_t)u16(20);
      bits = (int)u16(24);
      palette_entry = 3;
    } else if (header == 40 || header == 52 || header == 56 || header == 108 || header == 124) {
      if (n < 14 + header) fail("BMP: file too short");
      width = (int32_t)u32(18);
      height = (int32_t)u32(22);
      bits = (int)u16(28);
      const uint32_t compression = u32(30);
      if (compression == 1 || compression == 2)
        fail("BMP: RLE compression is not supported");
      if (compression != 0)
        fail("BMP: compression " + std::to_string(compression) + " (bit fields, JPEG or PNG "
             "inside) is not supported");
      colours = (int)u32(46);
    } else {
      fail("BMP: header of " + std::to_string(header) + " bytes is not supported");
    }
    if (bits != 8 && bits != 24 && bits != 32)
      fail("BMP: " + std::to_string(bits) + "-bit pixels are not supported (8, 24 and 32 are)");
    top_down = height < 0;
    height = std::abs(height);
    if (width <= 0 || height <= 0) fail("BMP: bad size");
    row_bytes = (((size_t)width * bits + 31) / 32) * 4;
    if (offset + row_bytes * height > n) fail("BMP: pixel data runs past the end of the file");
    if (bits == 8) {
      if (colours == 0) colours = 256;
      if (colours > 256) fail("BMP: bad palette size");
      palette = p + 14 + header;
      if (14 + header + (size_t)colours * palette_entry > offset) fail("BMP: bad palette");
    }
  }

  void decode(const uint8_t* p, uint8_t* out) const {
    for (int y = 0; y < height; ++y) {
      const uint8_t* row = p + offset + row_bytes * (size_t)(top_down ? y : height - 1 - y);
      uint8_t* o = out + (size_t)y * width * 3;
      for (int x = 0; x < width; ++x) {
        const uint8_t* px;
        if (bits == 8) {
          const int i = row[x];
          // an index past the palette reads black, as Pillow pads its palette
          static const uint8_t black[4] = {0, 0, 0, 0};
          px = i < colours ? palette + (size_t)i * palette_entry : black;
        } else {
          px = row + (size_t)x * (bits / 8);
        }
        o[3 * x] = px[2];
        o[3 * x + 1] = px[1];
        o[3 * x + 2] = px[0];
      }
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

}  // extern "C"
