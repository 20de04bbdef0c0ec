// Baseline JPEG decoder with libjpeg's arithmetic.
//
// Decodes Huffman-coded sequential 8-bit JPEG (SOF0/SOF1) with one or three
// components, any integer sampling factors, restart markers and sizes that
// are not a multiple of the MCU. The pixels equal libjpeg(-turbo)'s default
// decompression bit for bit: the ISLOW integer IDCT (jidctint.c), "fancy"
// triangle upsampling for 2x horizontal, 2x2 and 2x vertical chroma
// (jdsample.c, with the edge rows and columns replicated as jdmainct.c
// does), replication for other ratios, and the fixed-point YCbCr->RGB
// tables of jdcolor.c. Progressive, arithmetic-coded, lossless, 12-bit and
// four-component files are refused with an error message.
//
// C interface (ctypes):
//   int gsj_info(data, n, &width, &height, &components, err, errlen)
//   int gsj_decode(data, n, out, width, height, err, errlen)
// `out` receives height*width*3 bytes of RGB (a grey file is replicated
// into the three channels). Both return 0 on success and write a message
// into `err` otherwise.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huff {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int mincode[17] = {0};
  int maxcode[18] = {0};
  int valptr[17] = {0};
  uint8_t look_len[1 << kLookBits] = {0};
  uint8_t look_sym[1 << kLookBits] = {0};

  void build() {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l];
      k += bits[l];
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look_len, 0, sizeof(look_len));
    code = 0;
    k = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < bits[l]; i++, k++, code++) {
        int lo = code << (kLookBits - l), cnt = 1 << (kLookBits - l);
        for (int j = 0; j < cnt; j++) {
          look_len[lo + j] = (uint8_t)l;
          look_sym[lo + j] = vals[k];
        }
      }
      code <<= 1;
    }
    defined = true;
  }
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks per row and column, padded to the MCU
  int dw = 0, dh = 0;  // the component's real (downsampled) size
  int dc_pred = 0;
  std::vector<uint8_t> plane;  // (bh*8) x (bw*8)
};

struct Error {
  std::string msg;
};

struct Decoder {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qdef[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  Comp comp[4];
  int restart_interval = 0;
  int adobe_transform = -1;
  bool have_sof = false, done = false;
  // entropy-coded bit reader
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  Decoder(const uint8_t* data, size_t size) : p(data), n(size) {}

  [[noreturn]] void fail(const std::string& m) { throw Error{m}; }

  int byte() {
    if (pos >= n) fail("unexpected end of data");
    return p[pos++];
  }
  int word() {
    int a = byte();
    return (a << 8) | byte();
  }

  int next_marker() {
    // skip to the next 0xFF xx with xx not 0 and not 0xFF
    for (;;) {
      int b = byte();
      if (b != 0xFF) continue;
      int m = byte();
      while (m == 0xFF) m = byte();
      if (m != 0) return m;
    }
  }

  void read_dqt(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad quantization table id");
      for (int i = 0; i < 64; i++)
        qt[tq][kNatural[i]] = (uint16_t)(pq ? word() : byte());
      qdef[tq] = true;
    }
  }

  void read_dht(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (th > 3 || tc > 1) fail("bad Huffman table id");
      Huff& h = tc ? ac[th] : dc[th];
      int total = 0;
      h.bits[0] = 0;
      for (int i = 1; i <= 16; i++) {
        h.bits[i] = (uint8_t)byte();
        total += h.bits[i];
      }
      if (total > 256) fail("bad Huffman table");
      for (int i = 0; i < total; i++) h.vals[i] = (uint8_t)byte();
      h.build();
    }
  }

  void read_sof(int marker, int len) {
    (void)len;
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA ||
        marker == 0xCE)
      fail("progressive JPEG is not supported");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB ||
        marker == 0xCF)
      fail("lossless JPEG is not supported");
    if (marker >= 0xC9)
      fail("arithmetic-coded JPEG is not supported");
    int precision = byte();
    if (precision != 8) fail("only 8-bit JPEG is supported");
    height = word();
    width = word();
    ncomp = byte();
    if (height <= 0 || width <= 0) fail("bad image size");
    if (ncomp != 1 && ncomp != 3)
      fail("only 1- and 3-component JPEG is supported");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      if (hmax % c.h || vmax % c.v) fail("unsupported sampling factors");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (int)(((long long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long long)height * c.v + vmax - 1) / vmax);
      c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
    }
    have_sof = true;
  }

  // --- bit reader -------------------------------------------------------
  void reset_bits() {
    bitbuf = 0;
    bitcnt = 0;
    hit_marker = false;
  }
  void fill() {
    while (bitcnt <= 24) {
      uint32_t b = 0;
      if (!hit_marker && pos < n) {
        b = p[pos];
        if (b == 0xFF) {
          int nx = pos + 1 < n ? p[pos + 1] : 0xD9;
          if (nx == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // libjpeg feeds zeros past a marker
            b = 0;
          }
        } else {
          pos++;
        }
      }
      bitbuf |= b << (24 - bitcnt);
      bitcnt += 8;
    }
  }
  int get_bits(int s) {
    fill();
    int v = (int)(bitbuf >> (32 - s));
    bitbuf <<= s;
    bitcnt -= s;
    return v;
  }
  int decode(const Huff& h) {
    fill();
    int look = (int)(bitbuf >> (32 - kLookBits));
    int l = h.look_len[look];
    if (l) {
      bitbuf <<= l;
      bitcnt -= l;
      return h.look_sym[look];
    }
    for (l = kLookBits + 1; l <= 16; l++) {
      int code = (int)(bitbuf >> (32 - l));
      if (code <= h.maxcode[l]) {
        bitbuf <<= l;
        bitcnt -= l;
        return h.vals[h.valptr[l] + code - h.mincode[l]];
      }
    }
    // corrupt data: libjpeg warns and returns 0
    bitbuf <<= 16;
    bitcnt -= 16;
    return 0;
  }
  int receive_extend(int s) {
    if (s == 0) return 0;
    int v = get_bits(s);
    if (v < (1 << (s - 1))) v += (-1 << s) + 1;
    return v;
  }

  void decode_block(Comp& c, int bx, int by) {
    int coef[64];
    std::memset(coef, 0, sizeof(coef));
    int s = decode(dc[c.td]);
    c.dc_pred += receive_extend(s);
    coef[0] = c.dc_pred;
    const Huff& h = ac[c.ta];
    for (int k = 1; k < 64;) {
      int rs = decode(h);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = receive_extend(s);
        if (k < 64) coef[kNatural[k]] = v;
        k++;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, qt[c.tq], &c.plane[(size_t)by * 8 * stride + bx * 8],
               stride);
  }

  // jidctint.c: jpeg_idct_islow, CONST_BITS 13, PASS1_BITS 2
  static void idct_islow(const int* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433,
                  F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int* ip = in + col;
      const uint16_t* qp = q + col;
      int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * (-F1_847);
      int64_t tmp3 = z1 + z2 * F0_765;
      z2 = (int64_t)ip[0] * qp[0];
      z3 = (int64_t)ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * 8192;
      int64_t tmp1 = (z2 - z3) * 8192;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (int64_t)ip[56] * qp[56];
      tmp1 = (int64_t)ip[40] * qp[40];
      tmp2 = (int64_t)ip[24] * qp[24];
      tmp3 = (int64_t)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 13 - 2;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      ws[col + 0] = (int)((tmp10 + tmp3 + rnd) >> sh);
      ws[col + 56] = (int)((tmp10 - tmp3 + rnd) >> sh);
      ws[col + 8] = (int)((tmp11 + tmp2 + rnd) >> sh);
      ws[col + 48] = (int)((tmp11 - tmp2 + rnd) >> sh);
      ws[col + 16] = (int)((tmp12 + tmp1 + rnd) >> sh);
      ws[col + 40] = (int)((tmp12 - tmp1 + rnd) >> sh);
      ws[col + 24] = (int)((tmp13 + tmp0 + rnd) >> sh);
      ws[col + 32] = (int)((tmp13 - tmp0 + rnd) >> sh);
    }
    for (int row = 0; row < 8; row++) {
      const int* w = ws + row * 8;
      uint8_t* op = out + row * stride;
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * (-F1_847);
      int64_t tmp3 = z1 + z2 * F0_765;
      int64_t tmp0 = ((int64_t)w[0] + w[4]) * 8192;
      int64_t tmp1 = ((int64_t)w[0] - w[4]) * 8192;
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
      int64_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 13 + 2 + 3;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      auto lim = [](int64_t x) -> uint8_t {
        x += 128;
        return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
      };
      op[0] = lim((tmp10 + tmp3 + rnd) >> sh);
      op[7] = lim((tmp10 - tmp3 + rnd) >> sh);
      op[1] = lim((tmp11 + tmp2 + rnd) >> sh);
      op[6] = lim((tmp11 - tmp2 + rnd) >> sh);
      op[2] = lim((tmp12 + tmp1 + rnd) >> sh);
      op[5] = lim((tmp12 - tmp1 + rnd) >> sh);
      op[3] = lim((tmp13 + tmp0 + rnd) >> sh);
      op[4] = lim((tmp13 - tmp0 + rnd) >> sh);
    }
  }

  void read_restart() {
    // the entropy segment ends at a marker: skip to it and check it is RSTn
    reset_bits();
    int m = next_marker();
    if (m < 0xD0 || m > 0xD7) fail("expected a restart marker");
    for (int i = 0; i < ncomp; i++) comp[i].dc_pred = 0;
  }

  void read_sos() {
    if (!have_sof) fail("SOS before SOF");
    int ns = byte();
    if (ns < 1 || ns > ncomp) fail("bad scan");
    Comp* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      Comp* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined ||
          !ac[c->ta].defined)
        fail("scan uses an undefined Huffman table");
      if (!qdef[c->tq]) fail("component uses an undefined quant table");
      c->dc_pred = 0;
      sc[i] = c;
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0)
      fail("progressive JPEG is not supported");
    if (ns != ncomp)
      fail("JPEG with more than one scan is not supported");
    reset_bits();
    int mcu = 0;
    if (ns == 1) {
      Comp& c = *sc[0];
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      for (int by = 0; by < nby; by++)
        for (int bx = 0; bx < nbx; bx++) {
          if (restart_interval && mcu && mcu % restart_interval == 0)
            read_restart();
          decode_block(c, bx, by);
          mcu++;
        }
    } else {
      int mcux = (width + 8 * hmax - 1) / (8 * hmax);
      int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (restart_interval && mcu && mcu % restart_interval == 0)
            read_restart();
          for (int i = 0; i < ns; i++) {
            Comp& c = *sc[i];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++)
                decode_block(c, mx * c.h + h, my * c.v + v);
          }
          mcu++;
        }
    }
    // leave the reader before the marker that ends the segment
    reset_bits();
    done = true;
  }

  void parse(bool header_only) {
    if (n < 4 || p[0] != 0xFF || p[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m >= 0xD0 && m <= 0xD7) continue;
      int len = word();
      if (len < 2) fail("bad segment length");
      size_t seg_end = pos + len - 2;
      if (seg_end > n) fail("truncated segment");
      if (m == 0xDB) {
        read_dqt(len);
      } else if (m == 0xC4) {
        read_dht(len);
      } else if (m == 0xCC) {
        fail("arithmetic-coded JPEG is not supported");
      } else if (m >= 0xC0 && m <= 0xCF) {
        read_sof(m, len);
        if (header_only) return;
      } else if (m == 0xDD) {
        restart_interval = word();
      } else if (m == 0xEE && len >= 14 && !std::memcmp(p + pos, "Adobe", 5)) {
        adobe_transform = p[pos + 11];
      } else if (m == 0xDA) {
        read_sos();
        if (done) return;
        continue;
      }
      pos = seg_end;
    }
    if (!done) fail("no image data");
  }

  // jdsample.c: the component upsampled to (hmax/h, vmax/v) x its size,
  // then cropped to the image size
  std::vector<uint8_t> upsample(const Comp& c) const {
    int hx = hmax / c.h, vx = vmax / c.v;
    int ow = c.dw * hx, oh = c.dh * vx, st = c.bw * 8;
    std::vector<uint8_t> out((size_t)ow * oh);
    auto in = [&](int r, int col) -> int {
      r = std::min(std::max(r, 0), c.dh - 1);  // replicated context rows
      return c.plane[(size_t)r * st + col];
    };
    if (hx == 1 && vx == 1) {
      for (int r = 0; r < oh; r++)
        std::memcpy(&out[(size_t)r * ow], &c.plane[(size_t)r * st], ow);
    } else if (hx == 2 && vx == 1 && c.dw > 2) {
      for (int r = 0; r < c.dh; r++) {
        uint8_t* o = &out[(size_t)r * ow];
        int w = c.dw;
        o[0] = (uint8_t)in(r, 0);
        o[1] = (uint8_t)((in(r, 0) * 3 + in(r, 1) + 2) >> 2);
        for (int col = 1; col < w - 1; col++) {
          int t = in(r, col) * 3;
          o[2 * col] = (uint8_t)((t + in(r, col - 1) + 1) >> 2);
          o[2 * col + 1] = (uint8_t)((t + in(r, col + 1) + 2) >> 2);
        }
        o[2 * (w - 1)] = (uint8_t)((in(r, w - 1) * 3 + in(r, w - 2) + 1) >> 2);
        o[2 * (w - 1) + 1] = (uint8_t)in(r, w - 1);
      }
    } else if (hx == 2 && vx == 2 && c.dw > 2) {
      int w = c.dw;
      std::vector<int> sum(w);
      for (int r = 0; r < c.dh; r++) {
        for (int v = 0; v < 2; v++) {
          int other = v == 0 ? r - 1 : r + 1;
          for (int col = 0; col < w; col++)
            sum[col] = in(r, col) * 3 + in(other, col);
          uint8_t* o = &out[(size_t)(2 * r + v) * ow];
          o[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
          o[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
          for (int col = 1; col < w - 1; col++) {
            o[2 * col] = (uint8_t)((sum[col] * 3 + sum[col - 1] + 8) >> 4);
            o[2 * col + 1] = (uint8_t)((sum[col] * 3 + sum[col + 1] + 7) >> 4);
          }
          o[2 * (w - 1)] =
              (uint8_t)((sum[w - 1] * 3 + sum[w - 2] + 8) >> 4);
          o[2 * (w - 1) + 1] = (uint8_t)((sum[w - 1] * 4 + 7) >> 4);
        }
      }
    } else if (hx == 1 && vx == 2) {
      for (int r = 0; r < c.dh; r++)
        for (int v = 0; v < 2; v++) {
          int other = v == 0 ? r - 1 : r + 1, bias = v == 0 ? 1 : 2;
          uint8_t* o = &out[(size_t)(2 * r + v) * ow];
          for (int col = 0; col < c.dw; col++)
            o[col] = (uint8_t)((in(r, col) * 3 + in(other, col) + bias) >> 2);
        }
    } else {
      // int_upsample: plain replication
      for (int r = 0; r < oh; r++)
        for (int col = 0; col < ow; col++)
          out[(size_t)r * ow + col] = (uint8_t)in(r / vx, col / hx);
    }
    // crop to the image's size
    std::vector<uint8_t> crop((size_t)width * height);
    for (int r = 0; r < height; r++)
      std::memcpy(&crop[(size_t)r * width], &out[(size_t)r * ow], width);
    return crop;
  }

  void to_rgb(uint8_t* rgb) const {
    size_t np = (size_t)width * height;
    if (ncomp == 1) {
      const Comp& c = comp[0];
      int st = c.bw * 8;
      for (int r = 0; r < height; r++)
        for (int col = 0; col < width; col++) {
          uint8_t g = c.plane[(size_t)r * st + col];
          uint8_t* o = rgb + ((size_t)r * width + col) * 3;
          o[0] = o[1] = o[2] = g;
        }
      return;
    }
    std::vector<uint8_t> ch[3];
    for (int i = 0; i < 3; i++) ch[i] = upsample(comp[i]);
    bool is_rgb = adobe_transform == 0 ||
                  (adobe_transform < 0 && comp[0].id == 'R' &&
                   comp[1].id == 'G' && comp[2].id == 'B');
    if (is_rgb) {
      for (size_t i = 0; i < np; i++)
        for (int k = 0; k < 3; k++) rgb[i * 3 + k] = ch[k][i];
      return;
    }
    // jdcolor.c: build_ycc_rgb_table, SCALEBITS 16
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t ONE_HALF = (int64_t)1 << 15;
    auto FIX = [](double x) -> int64_t {
      return (int64_t)(x * (1 << 16) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> 16);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> 16);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
    auto lim = [](int x) -> uint8_t {
      return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
    };
    for (size_t i = 0; i < np; i++) {
      int y = ch[0][i], cb = ch[1][i], cr = ch[2][i];
      rgb[i * 3 + 0] = lim(y + cr_r[cr]);
      rgb[i * 3 + 1] = lim(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      rgb[i * 3 + 2] = lim(y + cb_b[cb]);
    }
  }
};

void put_err(char* err, int errlen, const std::string& m) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", m.c_str());
}

}  // namespace

extern "C" {

int gsj_info(const uint8_t* data, size_t n, int* width, int* height,
             int* components, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.parse(true);
    if (!d.have_sof) d.fail("no frame header");
    *width = d.width;
    *height = d.height;
    *components = d.ncomp;
    return 0;
  } catch (const Error& e) {
    put_err(err, errlen, e.msg);
    return 1;
  }
}

int gsj_decode(const uint8_t* data, size_t n, uint8_t* out, int width,
               int height, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.parse(false);
    if (d.width != width || d.height != height)
      d.fail("the output buffer's size differs from the image's");
    d.to_rgb(out);
    return 0;
  } catch (const Error& e) {
    put_err(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    put_err(err, errlen, "out of memory");
    return 1;
  }
}

}  // extern "C"
