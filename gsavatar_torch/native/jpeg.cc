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
// The encoder writes what libjpeg-turbo's default compression writes (the
// settings `cv2.imwrite` uses for a .jpg): baseline, a JFIF 1.01 APP0,
// 4:2:0, the Annex K quantization tables scaled to the quality as
// jcparam.c scales them, the standard Huffman tables, no restart markers.
// Its arithmetic is libjpeg-turbo's: the fixed-point RGB->YCbCr tables of
// jccolor.c, h2v2 downsampling with the alternating bias of jcsample.c,
// the edge replication of jcprepct.c and jcsample.c, the ISLOW integer
// FDCT (jfdctint.c), the reciprocal quantization of jcdctmgr.c (with the
// 16-bit DCTELEM of its SIMD builds) and the dummy blocks of jccoefct.c.
//
// C interface (ctypes):
//   int gsj_info(data, n, &width, &height, &components, err, errlen)
//   int gsj_decode(data, n, out, width, height, err, errlen)
//   long gsj_encode(rgb, width, height, quality, out, cap, err, errlen)
// `out` receives height*width*3 bytes of RGB (a grey file is replicated
// into the three channels). Both return 0 on success and write a message
// into `err` otherwise. gsj_encode reads height*width*3 bytes of RGB and
// returns the length of the file written into `out` (at most `cap`
// bytes), or -1 with a message in `err`.
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

// ---- encoder ----

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

// Annex K.3: counts of codes of each length 1..16, then the symbols
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
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
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
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

// jchuff.c: jpeg_make_c_derived_tbl, the canonical code of each symbol
struct HuffEnc {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint16_t code[256] = {0};
  uint8_t size[256] = {0};

  HuffEnc(const uint8_t* b, const uint8_t* v, int n)
      : bits(b), vals(v), nvals(n) {
    int c = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l - 1]; i++, k++) {
        code[vals[k]] = (uint16_t)c++;
        size[vals[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct BitSink {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitSink(std::vector<uint8_t>& o) : out(o) {}

  void put(uint32_t bits, int len) {  // len <= 16
    acc = (acc << len) | (bits & ((1u << len) - 1));
    n += len;
    while (n >= 8) {
      uint8_t b = (uint8_t)(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);  // byte stuffing
      n -= 8;
    }
    acc &= (1u << n) - 1;
  }
  // jchuff.c flush_bits: pad the last byte with one-bits
  void flush() {
    put(0x7F, 7);
    acc = 0;
    n = 0;
  }
};

// jfdctint.c: jpeg_fdct_islow, output scaled up by 8
void fdct_islow(int32_t* d) {
  const int CB = 13, P1 = 2;
  auto descale = [](int64_t x, int n) -> int32_t {
    return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n);
  };
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    for (int r = 0; r < 8; r++) {
      int32_t* p = d + r * stride;
      int64_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
      int64_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
      int64_t t2 = p[2 * step] + p[5 * step], t5 = p[2 * step] - p[5 * step];
      int64_t t3 = p[3 * step] + p[4 * step], t4 = p[3 * step] - p[4 * step];
      int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      const int sh = pass == 0 ? CB - P1 : CB + P1;
      if (pass == 0) {
        p[0] = (int32_t)((t10 + t11) * (1 << P1));
        p[4 * step] = (int32_t)((t10 - t11) * (1 << P1));
      } else {
        p[0] = descale(t10 + t11, P1);
        p[4 * step] = descale(t10 - t11, P1);
      }
      int64_t z1 = (t12 + t13) * 4433;
      p[2 * step] = descale(z1 + t13 * 6270, sh);
      p[6 * step] = descale(z1 + t12 * -15137, sh);
      z1 = t4 + t7;
      int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
      int64_t z5 = (z3 + z4) * 9633;
      t4 *= 2446;
      t5 *= 16819;
      t6 *= 25172;
      t7 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 *= -16069;
      z4 *= -3196;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(t4 + z1 + z3, sh);
      p[5 * step] = descale(t5 + z2 + z4, sh);
      p[3 * step] = descale(t6 + z2 + z3, sh);
      p[step] = descale(t7 + z1 + z4, sh);
    }
  }
}

// jcdctmgr.c: compute_reciprocal with a 16-bit DCTELEM (its SIMD builds)
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) b++;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
  uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

int32_t quantize(int32_t x, const Divisor& q) {
  uint32_t a = (uint32_t)(x < 0 ? -x : x);
  int32_t v = (int32_t)(((uint64_t)(uint16_t)(a + q.corr) * q.recip) >> q.shift);
  return x < 0 ? -v : v;
}

void scaled_table(const uint8_t* base, int quality, uint16_t* out) {
  // jcparam.c: jpeg_quality_scaling, jpeg_add_quant_table(force_baseline)
  quality = quality <= 0 ? 1 : quality > 100 ? 100 : quality;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    out[i] = (uint16_t)(t <= 0 ? 1 : t > 255 ? 255 : t);
  }
}

struct Encoder {
  int w, h, quality;
  std::vector<uint8_t> out;

  void marker(uint8_t m, const std::vector<uint8_t>& body) {
    out.push_back(0xFF);
    out.push_back(m);
    size_t len = body.size() + 2;
    out.push_back((uint8_t)(len >> 8));
    out.push_back((uint8_t)len);
    out.insert(out.end(), body.begin(), body.end());
  }

  void dht(uint8_t cls_id, const HuffEnc& t) {
    std::vector<uint8_t> b{cls_id};
    b.insert(b.end(), t.bits, t.bits + 16);
    b.insert(b.end(), t.vals, t.vals + t.nvals);
    marker(0xC4, b);
  }

  // encode_one_block of jchuff.c; `blk` in natural order, quantized
  static void block(BitSink& s, const int32_t* blk, int& last_dc,
                    const HuffEnc& dc, const HuffEnc& ac) {
    auto nbits = [](int32_t v) {
      int n = 0;
      for (uint32_t a = (uint32_t)(v < 0 ? -v : v); a; a >>= 1) n++;
      return n;
    };
    int32_t diff = blk[0] - last_dc;
    last_dc = blk[0];
    int n = nbits(diff);
    s.put(dc.code[n], dc.size[n]);
    if (n) s.put((uint32_t)(diff < 0 ? diff - 1 : diff), n);
    int run = 0;
    for (int k = 1; k < 64; k++) {
      int32_t v = blk[kNatural[k]];
      if (v == 0) {
        run++;
        continue;
      }
      for (; run > 15; run -= 16) s.put(ac.code[0xF0], ac.size[0xF0]);
      n = nbits(v);
      int sym = (run << 4) + n;
      s.put(ac.code[sym], ac.size[sym]);
      s.put((uint32_t)(v < 0 ? v - 1 : v), n);
      run = 0;
    }
    if (run > 0) s.put(ac.code[0], ac.size[0]);
  }

  void encode(const uint8_t* rgb) {
    if (w <= 0 || h <= 0 || w > 65535 || h > 65535)
      throw Error{"the image's size is out of JPEG's range"};
    const int mx = (w + 15) / 16, my = (h + 15) / 16;
    const int yw = (w + 7) / 8 * 8, yh = my * 16;  // Y plane, edge-padded
    const int fw = mx * 16, fh = (h + 1) / 2 * 2;  // full-size chroma
    const int cw = mx * 8, ch = my * 8;            // downsampled chroma
    // jccolor.c: rgb_ycc_start, SCALEBITS 16
    const int64_t ONE_HALF = (int64_t)1 << 15, CBCR = (int64_t)128 << 16;
    auto FIX = [](double x) -> int64_t {
      return (int64_t)(x * (1L << 16) + 0.5);
    };
    std::vector<uint8_t> Y((size_t)yw * yh), Cb((size_t)fw * fh),
        Cr((size_t)fw * fh);
    for (int y = 0; y < std::max(yh, fh); y++) {
      const uint8_t* row = rgb + (size_t)std::min(y, h - 1) * w * 3;
      for (int x = 0; x < std::max(yw, fw); x++) {
        const uint8_t* px = row + (size_t)std::min(x, w - 1) * 3;
        int64_t r = px[0], g = px[1], b = px[2];
        if (y < yh && x < yw)
          Y[(size_t)y * yw + x] = (uint8_t)(
              (FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b +
               ONE_HALF) >> 16);
        if (y < fh && x < fw) {
          Cb[(size_t)y * fw + x] = (uint8_t)(
              (-FIX(0.16874) * r - FIX(0.33126) * g + FIX(0.50000) * b +
               CBCR + ONE_HALF - 1) >> 16);
          Cr[(size_t)y * fw + x] = (uint8_t)(
              (FIX(0.50000) * r - FIX(0.41869) * g - FIX(0.08131) * b +
               CBCR + ONE_HALF - 1) >> 16);
        }
      }
    }
    // jcsample.c: h2v2_downsample (bias 1, 2, 1, 2, ... along a row),
    // then the last row repeated to the iMCU's height (jcprepct.c)
    auto down = [&](const std::vector<uint8_t>& full) {
      std::vector<uint8_t> c((size_t)cw * ch);
      for (int y = 0; y < ch; y++) {
        int sy = std::min(y, fh / 2 - 1) * 2;
        const uint8_t* r0 = &full[(size_t)sy * fw];
        const uint8_t* r1 = r0 + fw;
        for (int x = 0, bias = 1; x < cw; x++, bias ^= 3)
          c[(size_t)y * cw + x] = (uint8_t)(
              (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >>
              2);
      }
      return c;
    };
    std::vector<uint8_t> CbD = down(Cb), CrD = down(Cr);

    uint16_t qt[2][64];
    scaled_table(kStdLumaQuant, quality, qt[0]);
    scaled_table(kStdChromaQuant, quality, qt[1]);
    Divisor div[2][64];
    for (int t = 0; t < 2; t++)
      for (int i = 0; i < 64; i++) div[t][i] = reciprocal(qt[t][i] << 3);

    HuffEnc dcl(kDcLumaBits, kDcVals, 12), acl(kAcLumaBits, kAcLumaVals, 162);
    HuffEnc dcc(kDcChromaBits, kDcVals, 12),
        acc(kAcChromaBits, kAcChromaVals, 162);

    out.clear();
    out.push_back(0xFF);
    out.push_back(0xD8);
    marker(0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
    for (int t = 0; t < 2; t++) {
      std::vector<uint8_t> b{(uint8_t)t};
      for (int i = 0; i < 64; i++) b.push_back((uint8_t)qt[t][kNatural[i]]);
      marker(0xDB, b);
    }
    marker(0xC0, {8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8),
                  (uint8_t)w, 3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
    dht(0x00, dcl);
    dht(0x10, acl);
    dht(0x01, dcc);
    dht(0x11, acc);
    marker(0xDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

    const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;  // Y's real blocks
    auto coefs = [&](const std::vector<uint8_t>& plane, int stride, int bx,
                     int by, const Divisor* q, int32_t* blk) {
      int32_t ws[64];
      for (int r = 0; r < 8; r++)
        for (int c = 0; c < 8; c++)
          ws[r * 8 + c] =
              (int32_t)plane[(size_t)(by * 8 + r) * stride + bx * 8 + c] - 128;
      fdct_islow(ws);
      for (int i = 0; i < 64; i++) blk[i] = quantize(ws[i], q[i]);
    };
    BitSink s(out);
    int last[3] = {0, 0, 0};
    int32_t blk[6][64];
    for (int m = 0; m < my; m++) {
      for (int n = 0; n < mx; n++) {
        // jccoefct.c: blocks past the image's last block column or row
        // are dummies, zero with the previous block's DC
        for (int k = 0; k < 4; k++) {
          int bx = 2 * n + (k & 1), by = 2 * m + (k >> 1);
          if (by >= ybh) {
            std::memset(blk[k], 0, sizeof(blk[k]));
            blk[k][0] = blk[k - 1][0];
          } else if (bx >= ybw) {
            std::memset(blk[k], 0, sizeof(blk[k]));
            blk[k][0] = blk[k - 1][0];
          } else {
            coefs(Y, yw, bx, by, div[0], blk[k]);
          }
        }
        coefs(CbD, cw, n, m, div[1], blk[4]);
        coefs(CrD, cw, n, m, div[1], blk[5]);
        for (int k = 0; k < 4; k++) block(s, blk[k], last[0], dcl, acl);
        block(s, blk[4], last[1], dcc, acc);
        block(s, blk[5], last[2], dcc, acc);
      }
    }
    s.flush();
    out.push_back(0xFF);
    out.push_back(0xD9);
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

long gsj_encode(const uint8_t* rgb, int width, int height, int quality,
                uint8_t* out, size_t cap, char* err, int errlen) {
  try {
    Encoder e{width, height, quality, {}};
    e.encode(rgb);
    if (e.out.size() > cap) {
      put_err(err, errlen, "the output buffer is too small");
      return -1;
    }
    std::memcpy(out, e.out.data(), e.out.size());
    return (long)e.out.size();
  } catch (const Error& e) {
    put_err(err, errlen, e.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    put_err(err, errlen, "out of memory");
    return -1;
  }
}

}  // extern "C"
