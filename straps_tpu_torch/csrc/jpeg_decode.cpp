// jpeg_decode: a JPEG decoder for the predict path's photos, equal bit for
// bit to libjpeg-turbo 3.1's defaults (what `cv2.imread` decodes with).
//
// Reads the DCT codings with 8-bit samples, Huffman or arithmetic:
// baseline and extended sequential (SOF0, SOF1, SOF9) and progressive
// (SOF2, SOF10); and lossless Huffman frames (SOF3) of 2-8 bits, with
// predictors 1-7 and any point transform.  1, 3 or 4 components, any
// sampling factors whose ratios to the largest are integers, restart
// intervals, images of any size.  Every DCT scan is decoded into one
// coefficient buffer per component, then each block is dequantised and
// inverse transformed by libjpeg's JDCT_ISLOW (13-bit constants, two
// passes), the chroma planes are upsampled as libjpeg's fancy upsampling
// does (the triangle filters of h2v1, h2v2 and h1v2 with their
// alternating rounding biases, replication for other ratios and for
// planes of 2 columns or fewer), and YCbCr is converted to RGB with the
// 16-bit fixed-point tables of jdcolor.c.  Four components are CMYK as
// stored (Adobe transform 0, or no Adobe marker) or YCCK (any other
// transform), which libjpeg turns into CMYK with the same tables; cv2 then
// converts CMYK to BGR with its own integer formula.  A component that no
// scan carries keeps zero coefficients (mid-grey), as in libjpeg's buffer.
//
// Arithmetic decoding is jdarith.c's: the QM coder of T.81 Annex D over
// Table D.2 (jpeg_aritab.h), the DC and AC statistics of F.1.4.4 and
// G.1.3.3 with the DAC conditioning values, statistics reset at each
// restart.  Lossless decoding is jdlhuff.c's and jdlossls.c's: samples are
// output as stored, shifted by the point transform, not rescaled; as
// libjpeg-turbo converts no colours in lossless mode, cv2 reads (and this
// decoder decodes) only RGB and CMYK lossless files.
//
// A file that ends inside its entropy-coded data decodes as libjpeg does:
// for Huffman coding the bits past the end read as zeros for the MCU in
// progress (the lossless MCU row), and the MCUs after it keep the
// coefficients they have (zero for a sequential file; zero differences for
// a lossless one) until a restart marker; for arithmetic coding zero bytes
// are fed to the decoder to the end of the scan.  A progressive file whose
// coefficients 1-9 are then incomplete is block-smoothed as libjpeg-turbo
// 3.1 does (jdcoefct.c decompress_smooth_data).
//
// Refused with a message naming the marker, as cv2.imread reads no image
// from them: precisions other than 8 bits (2-8 for lossless),
// arithmetic-coded lossless (SOF11) and hierarchical frames (SOF5-SOF7,
// SOF13-SOF15, DHP, EXP), 2 components, and lossless greyscale and YCbCr.
//
// Plain C interface for ctypes (straps_tpu_torch/utils/jpeg.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "jpeg_aritab.h"

namespace {

struct JpegError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError{msg}; }

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // Extra entries for corrupt run lengths past the end, as libjpeg's
    // jpeg_natural_order: they land on the last coefficient.
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t huffval[256];
  // 9-bit lookahead: (code length << 8) | symbol, or 0 for longer codes.
  uint16_t look[512];

  void build(const uint8_t* bits, const uint8_t* vals, int nvals) {
    memcpy(huffval, vals, static_cast<size_t>(nvals));
    int code = 0, k = 0;
    int huffcode[257];
    int huffsize[257];
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l - 1]; ++i) huffsize[k++] = l;
    huffsize[k] = 0;
    int p = 0, si = huffsize[0];
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l - 1];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++p) {
        int fill = 1 << (9 - l);
        int base = huffcode[p] << (9 - l);
        for (int j = 0; j < fill; ++j)
          look[base + j] = static_cast<uint16_t>((l << 8) | huffval[p]);
      }
    }
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;            // downsampled size in samples
  int wblocks = 0, hblocks = 0;  // blocks that hold samples
  int bw = 0, bh = 0;            // blocks of the buffer (whole MCUs)
  std::vector<int16_t> coef;     // bh * bw * 64
  int dc_tbl = 0, ac_tbl = 0;
  int last_dc = 0;
  bool scanned = false;
  int coef_bits[64];  // progressive: Al of the last scan of each coefficient, -1 before any
  int prev_bits[64];  // coef_bits before the last scan that carried the component
  std::vector<uint16_t> samples;  // lossless: bh * bw samples
  int pt = 0;                     // lossless: the point transform
  int16_t* block(int by, int bx) {
    return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64;
  }
};

// Entropy-coded bits of one scan: 0xFF00 unstuffed; a marker or the end of
// the file stops the real data, after which the reader gives zero bits and
// records that a decode went past the data (libjpeg's insufficient_data).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;       // bits in buf
  int real = 0;        // of which real data
  bool at_marker = false;
  bool past_end = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      bool is_real = false;
      if (!at_marker) {
        if (p >= end) {
          at_marker = true;
        } else if (p[0] == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            byte = 0xFF;
            p += 2;
            is_real = true;
          } else {
            at_marker = true;
          }
        } else {
          byte = *p++;
          is_real = true;
        }
      }
      buf |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
      if (is_real) real += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    if (nbits < n) fill();
    buf <<= n;
    nbits -= n;
    real -= n;
    if (real < 0) {
      past_end = true;
      real = 0;
    }
  }
  int bits(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }
  int bit() { return bits(1); }
  int decode(const Huffman& t) {
    uint32_t v = peek(16);
    int e = t.look[v >> 7];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = 10;
    int code = static_cast<int>(v >> 6);
    while (code > t.maxcode[l]) {
      ++l;
      if (l > 16) {
        // A corrupt code: libjpeg warns and returns symbol 0.
        skip(16);
        return 0;
      }
      code = static_cast<int>(v >> (16 - l));
    }
    skip(l);
    return t.huffval[(code + t.valoffset[l]) & 0xFF];
  }
  // Drop the buffered bits and move past the next marker if it is a
  // restart marker.  Returns true when a restart marker was consumed.
  bool restart() {
    if (!at_marker) {
      // Skip to the next marker: the rest of this byte's padding and any
      // bytes before it.
      const uint8_t* q = p;
      while (q < end) {
        if (q[0] == 0xFF && q + 1 < end && q[1] != 0x00 && q[1] != 0xFF) break;
        ++q;
      }
      p = q;
    }
    buf = 0;
    nbits = real = 0;
    at_marker = false;
    if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
      return true;
    }
    at_marker = true;
    return false;
  }
  // Position of the first marker after this scan's data.
  const uint8_t* next_marker() const {
    const uint8_t* q = p;
    while (q < end) {
      if (q[0] == 0xFF && q + 1 < end && q[1] != 0x00 && q[1] != 0xFF &&
          !(q[1] >= 0xD0 && q[1] <= 0xD7))
        return q;
      ++q;
    }
    return end;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// The arithmetic decoder of T.81 Annex D as libjpeg's jdarith.c runs it:
// the C register holds the interval base and the bits not yet shifted in,
// CT counts those bits, and the probability states are
// kJpegAritab's.  A marker (or the end of the file, where libjpeg's source
// manager supplies EOI) stops the data: zero bytes are fed after it until
// the scan ends, and the marker is left unread.
struct ArithReader {
  const uint8_t* p;
  const uint8_t* end;
  bool at_marker = false;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read before the first decision; -1: error

  int next_byte() {
    if (at_marker) return 0;
    if (p >= end) {
      at_marker = true;
      return 0;
    }
    if (p[0] != 0xFF) return *p++;
    const uint8_t* q = p + 1;
    while (q < end && *q == 0xFF) ++q;
    if (q < end && *q == 0x00) {
      p = q + 1;
      return 0xFF;
    }
    p = q - 1;  // the marker's last 0xFF
    at_marker = true;
    return 0;
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t e = kJpegAritab[sv & 0x7F];
    int64_t qe = e >> 16;
    int nm = (e >> 8) & 0xFF, nl = e & 0xFF;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // A restart: the next marker is read if it is a restart marker (as
  // BitReader::restart), and the coder starts afresh.
  bool restart() {
    if (!at_marker) {
      const uint8_t* q = p;
      while (q < end) {
        if (q[0] == 0xFF && q + 1 < end && q[1] != 0x00 && q[1] != 0xFF) break;
        ++q;
      }
      p = q;
    }
    c = a = 0;
    ct = -16;
    at_marker = false;
    if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
      return true;
    }
    at_marker = true;
    return false;
  }

  const uint8_t* next_marker() const {
    BitReader br{p, end};
    return br.next_marker();
  }
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  int width = 0, height = 0, ncomp = 0, precision = 8;
  bool progressive = false, arithmetic = false, lossless = false;
  bool have_frame = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int orientation = 0;
  int restart_interval = 0;
  int maxh = 1, maxv = 1;
  int mcux = 0, mcuy = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  // DAC conditioning (T.81 F.1.4.4) of the 16 arithmetic tables: DC L and
  // U, AC Kx; libjpeg's defaults.
  int dac_l[16], dac_u[16], dac_k[16];
  Component comp[4];
  int scans = 0;
  // libjpeg's last_good_iMCU_row: the iMCU row of the last MCU a scan
  // began to decode with data left.
  int last_good_row = 0;

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {
    for (int t = 0; t < 16; ++t) {
      dac_l[t] = 0;
      dac_u[t] = 1;
      dac_k[t] = 5;
    }
  }

  static int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

  void read_exif(const uint8_t* p, int n) {
    if (n < 14 || memcmp(p, "Exif\0\0", 6) != 0 || orientation) return;
    const uint8_t* t = p + 6;
    int tn = n - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto g16 = [&](int off) -> int {
      return le ? (t[off] | (t[off + 1] << 8)) : ((t[off] << 8) | t[off + 1]);
    };
    auto g32 = [&](int off) -> uint32_t {
      return le ? (static_cast<uint32_t>(t[off]) | (t[off + 1] << 8) |
                   (t[off + 2] << 16) | (static_cast<uint32_t>(t[off + 3]) << 24))
                : ((static_cast<uint32_t>(t[off]) << 24) | (t[off + 1] << 16) |
                   (t[off + 2] << 8) | t[off + 3]);
    };
    if (g16(2) != 42) return;
    uint32_t ifd = g32(4);
    if (ifd + 2 > static_cast<uint32_t>(tn)) return;
    int count = g16(static_cast<int>(ifd));
    for (int i = 0; i < count; ++i) {
      uint32_t e = ifd + 2 + 12 * i;
      if (e + 12 > static_cast<uint32_t>(tn)) return;
      if (g16(static_cast<int>(e)) == 0x0112) {
        int o = g16(static_cast<int>(e) + 8);
        if (o >= 1 && o <= 8) orientation = o;
        return;
      }
    }
  }

  void read_sof(const uint8_t* p, int n, int marker) {
    if (have_frame) fail("more than one frame header");
    if (n < 6) fail("short SOF segment");
    char name[8];
    snprintf(name, sizeof(name), "SOF%d", marker - 0xC0);
    lossless = marker == 0xC3;
    progressive = marker == 0xC2 || marker == 0xCA;
    arithmetic = marker >= 0xC9;
    precision = p[0];
    // cv2 reads samples through libjpeg's 8-bit interface: 8-bit DCT
    // frames, and lossless frames of 2-8 bits (whose samples are not
    // rescaled).  libjpeg refuses the 8-bit interface for anything wider.
    if (lossless ? (precision < 2 || precision > 8) : precision != 8)
      fail(std::string(name) + " precision " + std::to_string(precision) +
           " (cv2.imread reads 8-bit samples only" +
           (lossless ? ", and lossless frames of 2-8 bits)" : ")"));
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = p[5];
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(std::to_string(ncomp) + " components in " + name +
           " (only greyscale, YCbCr/RGB and CMYK/YCCK are read)");
    if (n != 6 + 3 * ncomp) fail("bad SOF segment length");
    if (height == 0) fail("DNL line counts (height 0 in the frame header) are not read");
    if (width == 0) fail("width 0 in the frame header");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = p[6 + 3 * i];
      c.h = p[7 + 3 * i] >> 4;
      c.v = p[7 + 3 * i] & 15;
      c.tq = p[8 + 3 * i] & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors");
      if (c.h > maxh) maxh = c.h;
      if (c.v > maxv) maxv = c.v;
    }
    // A lossless "block" is one sample.
    const int bs = lossless ? 1 : 8;
    mcux = (width + bs * maxh - 1) / (bs * maxh);
    mcuy = (height + bs * maxv - 1) / (bs * maxv);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (maxh % c.h || maxv % c.v)
        fail("sampling factors whose ratios are not integers");
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + maxh - 1) / maxh);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + maxv - 1) / maxv);
      c.wblocks = (c.dw + bs - 1) / bs;
      c.hblocks = (c.dh + bs - 1) / bs;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      if (lossless)
        c.samples.assign(static_cast<size_t>(c.bw) * c.bh, 0);
      else
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  void read_dqt(const uint8_t* p, int n) {
    int off = 0;
    while (off < n) {
      int pq = p[off] >> 4, tq = p[off] & 15;
      if (tq > 3) fail("bad quantisation table id");
      ++off;
      for (int k = 0; k < 64; ++k) {
        int v;
        if (pq) {
          if (off + 2 > n) fail("short DQT segment");
          v = u16(p + off);
          off += 2;
        } else {
          if (off + 1 > n) fail("short DQT segment");
          v = p[off++];
        }
        qt[tq][kNatural[k]] = static_cast<uint16_t>(v);
      }
      qt_defined[tq] = true;
    }
  }

  void read_dht(const uint8_t* p, int n) {
    int off = 0;
    while (off < n) {
      if (off + 17 > n) fail("short DHT segment");
      int tc = p[off] >> 4, th = p[off] & 15;
      if (th > 3 || tc > 1) fail("bad Huffman table id");
      const uint8_t* bits = p + off + 1;
      int count = 0;
      for (int i = 0; i < 16; ++i) count += bits[i];
      if (count > 256 || off + 17 + count > n) fail("bad DHT segment");
      (tc ? ac[th] : dc[th]).build(bits, p + off + 17, count);
      off += 17 + count;
    }
  }

  // DAC (jdmarker.c get_dac): per table (0-15 DC, 16-31 AC), DC L (low
  // nibble) and U, or AC Kx, which libjpeg takes as it comes.
  void read_dac(const uint8_t* p, int n) {
    if (n % 2) fail("bad DAC segment");
    for (int off = 0; off < n; off += 2) {
      int index = p[off], val = p[off + 1];
      if (index >= 32) fail("bad DAC table id");
      if (index >= 16) {
        dac_k[index - 16] = val;
      } else {
        dac_l[index] = val & 15;
        dac_u[index] = val >> 4;
        if (dac_l[index] > dac_u[index]) fail("bad DAC DC conditioning");
      }
    }
  }

  // Calls `block(c, blk)` for every block of one scan in MCU order, with
  // `before(row)` ahead of each MCU (`row` its iMCU row); `before` returns
  // false to skip the MCU.
  template <class Before, class Block>
  void for_each_mcu(int ns, Component** sc, Before before, Block block) {
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.hblocks; ++by)
        for (int bx = 0; bx < c.wblocks; ++bx)
          if (before(by / c.v)) block(c, c.block(by, bx));
      return;
    }
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        if (!before(my)) continue;
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) block(c, c.block(my * c.v + v, mx * c.h + h));
        }
      }
  }

  // One scan's entropy-coded data, starting at `p`.  Returns the position
  // of the marker after it.
  const uint8_t* decode_scan(const uint8_t* hdr, int n, const uint8_t* p) {
    if (!have_frame) fail("SOS before the frame header");
    int ns = n > 0 ? hdr[0] : 0;
    if (ns < 1 || ns > 4 || n != 1 + 2 * ns + 3) fail("bad SOS segment");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = hdr[1 + 2 * i];
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i]) fail("SOS names an unknown component");
      sc[i]->dc_tbl = hdr[2 + 2 * i] >> 4;
      sc[i]->ac_tbl = hdr[2 + 2 * i] & 15;
      if (!arithmetic && (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3))
        fail("bad Huffman table selector");
    }
    int ss = hdr[1 + 2 * ns], se = hdr[2 + 2 * ns];
    int ah = hdr[3 + 2 * ns] >> 4, al = hdr[3 + 2 * ns] & 15;
    ++scans;
    if (lossless) {
      if (ss < 1 || ss > 7 || al >= precision) fail("bad lossless scan parameters");
      return decode_lossless_scan(ns, sc, ss, al, p);
    }
    if (!progressive) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13) {
      fail("bad progression parameters");
    }
    bool need_dc = ss == 0 && ah == 0, need_ac = se > 0;
    for (int i = 0; i < ns; ++i) {
      if (!arithmetic) {
        if (need_dc && !dc[sc[i]->dc_tbl].defined) fail("undefined DC Huffman table");
        if (need_ac && !ac[sc[i]->ac_tbl].defined) fail("undefined AC Huffman table");
      }
      sc[i]->scanned = true;
      // jdphuff.c/jdarith.c start_pass: the bits before this scan.
      for (int k = std::min(ss, 1); k <= std::max(se, 9); ++k)
        sc[i]->prev_bits[k] = scans > 1 ? sc[i]->coef_bits[k] : 0;
      for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
    }
    if (arithmetic) return decode_arith_scan(ns, sc, ss, se, ah, al, p);
    return decode_huffman_scan(ns, sc, ss, se, ah, al, p);
  }

  const uint8_t* decode_huffman_scan(int ns, Component** sc, int ss, int se, int ah, int al,
                                     const uint8_t* p) {
    for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
    BitReader br{p, data + len};
    int eobrun = 0;
    bool insufficient = false;
    int restarts_left = restart_interval;

    auto decode_block = [&](Component& c, int16_t* blk) {
      if (!progressive) {
        int s = br.decode(dc[c.dc_tbl]);
        int diff = s ? extend(br.bits(s), s) : 0;
        c.last_dc += diff;
        blk[0] = static_cast<int16_t>(c.last_dc);
        const Huffman& t = ac[c.ac_tbl];
        for (int k = 1; k < 64; ++k) {
          int rs = br.decode(t);
          int r = rs >> 4;
          s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
          } else {
            if (r != 15) break;
            k += 15;
          }
        }
        return;
      }
      if (ss == 0) {
        if (ah == 0) {
          int s = br.decode(dc[c.dc_tbl]);
          int diff = s ? extend(br.bits(s), s) : 0;
          c.last_dc += diff;
          blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c.last_dc) << al);
        } else if (br.bit()) {
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
        return;
      }
      const Huffman& t = ac[c.ac_tbl];
      if (ah == 0) {
        if (eobrun > 0) {
          --eobrun;
          return;
        }
        for (int k = ss; k <= se; ++k) {
          int rs = br.decode(t);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            blk[kNatural[k]] = static_cast<int16_t>(
                static_cast<uint32_t>(extend(br.bits(s), s)) << al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.bits(r);
            --eobrun;
            break;
          }
        }
        return;
      }
      // AC refinement (jdphuff.c decode_mcu_AC_refine).
      int p1 = 1 << al, m1 = -1 * (1 << al);
      int k = ss;
      if (eobrun == 0) {
        for (; k <= se; ++k) {
          int rs = br.decode(t);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            s = br.bit() ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += br.bits(r);
            break;
          }
          do {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0) {
              if (br.bit() && (*coef & p1) == 0)
                *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
            } else {
              if (--r < 0) break;
            }
            ++k;
          } while (k <= se);
          if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= se; ++k) {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0 && br.bit() && (*coef & p1) == 0)
            *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
        }
        --eobrun;
      }
    };

    // jdhuff.c: a restart resets the predictions and EOB run, and ends an
    // out-of-data stretch when its marker is there; MCUs met out of data
    // are skipped (they keep their coefficients).
    bool in_mcu = false;
    auto before_mcu = [&](int row) {
      if (in_mcu && br.past_end) insufficient = true;
      in_mcu = true;
      if (!insufficient) last_good_row = row;
      if (restart_interval) {
        if (restarts_left == 0) {
          if (br.restart()) insufficient = false;
          for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
          eobrun = 0;
          restarts_left = restart_interval;
        }
        --restarts_left;
      }
      return !insufficient;
    };
    for_each_mcu(ns, sc, before_mcu, decode_block);
    return br.next_marker();
  }

  // jdarith.c: statistics areas of 64 (DC) and 256 (AC) bins per table,
  // zeroed at the start of a scan and at each restart for the tables the
  // scan codes; a restart also resets the DC predictions and contexts.
  const uint8_t* decode_arith_scan(int ns, Component** sc, int ss, int se, int ah, int al,
                                   const uint8_t* p) {
    uint8_t dc_stats[16][64], ac_stats[16][256];
    uint8_t fixed_bin = 113;
    int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
    const bool codes_dc = !progressive || (ss == 0 && ah == 0);
    const bool codes_ac = !progressive || ss > 0;
    auto reset_stats = [&]() {
      for (int i = 0; i < ns; ++i) {
        if (codes_dc) {
          memset(dc_stats[sc[i]->dc_tbl], 0, 64);
          last_dc[i] = dc_context[i] = 0;
        }
        if (codes_ac) memset(ac_stats[sc[i]->ac_tbl], 0, 256);
      }
    };
    reset_stats();
    ArithReader ar{p, data + len};
    int restarts_left = restart_interval;

    // Figures F.19-F.24: one DC difference added to the prediction of the
    // scan's component `ci`; false on a magnitude overflow.
    auto decode_dc = [&](int ci, int tbl) -> bool {
      uint8_t* st = dc_stats[tbl] + dc_context[ci];
      if (ar.decode(st) == 0) {
        dc_context[ci] = 0;
        return true;
      }
      int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m) {
        st = dc_stats[tbl] + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          ++st;
        }
      }
      if (m < ((1 << dac_l[tbl]) >> 1))
        dc_context[ci] = 0;
      else if (m > ((1 << dac_u[tbl]) >> 1))
        dc_context[ci] = 12 + sign * 4;
      else
        dc_context[ci] = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      last_dc[ci] = (last_dc[ci] + v) & 0xFFFF;
      return true;
    };
    // AC coefficients k0..k1 of one block; false on an overflow.
    auto decode_ac = [&](int tbl, int16_t* blk, int k0, int k1, int shift) -> bool {
      for (int k = k0; k <= k1; ++k) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (ar.decode(st)) break;  // EOB
        while (ar.decode(st + 1) == 0) {
          st += 3;
          if (++k > k1) return false;
        }
        int sign = ar.decode(&fixed_bin);
        st += 2;
        int m = ar.decode(st);
        if (m && ar.decode(st)) {
          m <<= 1;
          st = ac_stats[tbl] + (k <= dac_k[tbl] ? 189 : 217);
          while (ar.decode(st)) {
            if ((m <<= 1) == 0x8000) return false;
            ++st;
          }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
          if (ar.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << shift);
      }
      return true;
    };

    auto before_mcu = [&](int row) {
      last_good_row = row;  // arithmetic decoding never runs out of data
      if (restart_interval) {
        if (restarts_left == 0) {
          ar.restart();
          reset_stats();
          restarts_left = restart_interval;
        }
        --restarts_left;
      }
      // A DC refinement scan decodes on after an error (jdarith.c).
      return ar.ct != -1 || (progressive && ss == 0 && ah != 0);
    };
    auto decode_block = [&](Component& c, int16_t* blk) {
      int ci = 0;  // the block's component in the scan
      while (sc[ci] != &c) ++ci;
      if (ar.ct == -1 && !(progressive && ss == 0 && ah != 0)) return;
      if (!progressive) {
        if (!decode_dc(ci, c.dc_tbl)) {
          ar.ct = -1;
          return;
        }
        blk[0] = static_cast<int16_t>(last_dc[ci]);
        if (!decode_ac(c.ac_tbl, blk, 1, 63, 0)) ar.ct = -1;
        return;
      }
      if (ss == 0 && ah == 0) {
        if (!decode_dc(ci, c.dc_tbl)) {
          ar.ct = -1;
          return;
        }
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(last_dc[ci]) << al);
        return;
      }
      if (ss == 0) {
        if (ar.decode(&fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        return;
      }
      if (ah == 0) {
        if (!decode_ac(c.ac_tbl, blk, ss, se, al)) ar.ct = -1;
        return;
      }
      // AC refinement (decode_mcu_AC_refine).
      const int p1 = 1 << al, m1 = -1 * (1 << al);
      int kex = se;
      for (; kex > 0; --kex)
        if (blk[kNatural[kex]]) break;
      for (int k = ss; k <= se; ++k) {
        uint8_t* st = ac_stats[c.ac_tbl] + 3 * (k - 1);
        if (k > kex && ar.decode(st)) break;
        for (;;) {
          int16_t* coef = blk + kNatural[k];
          if (*coef) {
            if (ar.decode(st + 2))
              *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
            break;
          }
          if (ar.decode(st + 1)) {
            *coef = static_cast<int16_t>(ar.decode(&fixed_bin) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > se) {
            ar.ct = -1;
            return;
          }
        }
      }
    };
    for_each_mcu(ns, sc, before_mcu, decode_block);
    return ar.next_marker();
  }

  // A lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c): per sample a
  // Huffman-coded difference (category 16 is 32768 with no extra bits),
  // added modulo 2^16 to the prediction of selector `psv` from the sample
  // on the left (Ra), above (Rb) and above-left (Rc).  The first row of the
  // scan and of each restart interval predicts from the left, its first
  // sample from 2^(P - Pt - 1); every other row's first sample from above.
  // Out of data, the rest of the MCU row reads zero bits, and every MCU row
  // after it holds zero differences from a first-row prediction.
  const uint8_t* decode_lossless_scan(int ns, Component** sc, int psv, int pt,
                                      const uint8_t* p) {
    for (int i = 0; i < ns; ++i) {
      if (!dc[sc[i]->dc_tbl].defined) fail("undefined lossless Huffman table");
      sc[i]->scanned = true;
    }
    // The scan's MCU grid: one sample per MCU for a single component.
    const int cols = ns == 1 ? sc[0]->dw : mcux;
    const int rows = ns == 1 ? sc[0]->dh : mcuy;
    // Differences, then samples, in each component's sample grid.
    std::vector<std::vector<int32_t>> diff(ns);
    for (int i = 0; i < ns; ++i)
      diff[i].assign(static_cast<size_t>(sc[i]->bw) * sc[i]->bh, 0);
    std::vector<uint8_t> first_row(static_cast<size_t>(rows), 0);
    BitReader br{p, data + len};
    bool insufficient = false;
    const int rows_per_restart = restart_interval ? std::max(restart_interval / cols, 1) : 0;
    int restart_rows_left = rows_per_restart;
    first_row[0] = 1;
    for (int r = 0; r < rows; ++r) {
      if (restart_interval) {
        if (restart_rows_left == 0) {
          if (br.restart()) insufficient = false;
          restart_rows_left = rows_per_restart;
          first_row[r] = 1;
        }
        --restart_rows_left;
      }
      if (insufficient) {
        first_row[r] = 1;  // zero differences from a reset predictor
        continue;
      }
      for (int m = 0; m < cols; ++m) {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          const int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
          for (int v = 0; v < bh; ++v)
            for (int h = 0; h < bw; ++h) {
              int s = br.decode(dc[c.dc_tbl]);
              int d = s == 16 ? 32768 : (s ? extend(br.bits(s), s) : 0);
              diff[i][static_cast<size_t>(r * bh + v) * c.bw + m * bw + h] = d;
            }
        }
      }
      if (br.past_end) insufficient = true;
    }
    // Undifference each component's rows; the restart (or out-of-data)
    // resets apply to the first sample row of their MCU row.
    const int initial = 1 << (precision - pt - 1);
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      const int rows_per_mcu = ns == 1 ? 1 : c.v;
      const int w = ns == 1 ? c.dw : c.bw;
      for (int y = 0; y < rows * rows_per_mcu; ++y) {
        const int32_t* d = diff[i].data() + static_cast<size_t>(y) * c.bw;
        uint16_t* out = c.samples.data() + static_cast<size_t>(y) * c.bw;
        const uint16_t* up = out - c.bw;
        const bool first = y % rows_per_mcu == 0 && first_row[y / rows_per_mcu];
        if (first) {
          int ra = (d[0] + initial) & 0xFFFF;
          out[0] = static_cast<uint16_t>(ra);
          for (int x = 1; x < w; ++x) out[x] = static_cast<uint16_t>(ra = (d[x] + ra) & 0xFFFF);
          continue;
        }
        int rb = up[0];
        int ra = (d[0] + rb) & 0xFFFF;
        out[0] = static_cast<uint16_t>(ra);
        for (int x = 1; x < w; ++x) {
          int rc = rb;
          rb = up[x];
          int pred;
          switch (psv) {
            case 1: pred = ra; break;
            case 2: pred = rb; break;
            case 3: pred = rc; break;
            case 4: pred = ra + rb - rc; break;
            case 5: pred = ra + ((rb - rc) >> 1); break;
            case 6: pred = rb + ((ra - rc) >> 1); break;
            default: pred = (ra + rb) >> 1; break;
          }
          out[x] = static_cast<uint16_t>(ra = (d[x] + pred) & 0xFFFF);
        }
      }
      c.pt = pt;
    }
    return br.next_marker();
  }

  void parse() {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    const uint8_t* p = data + 2;
    const uint8_t* end = data + len;
    for (;;) {
      // Next marker: skip anything up to 0xFF and fill bytes.
      while (p < end && *p != 0xFF) ++p;
      while (p < end && *p == 0xFF) ++p;
      if (p >= end) {
        if (scans) return;  // a truncated file: libjpeg inserts EOI
        fail("file ends before the image data");
      }
      int marker = *p++;
      if (marker == 0xD9) {
        if (!scans) fail("EOI before any scan");
        return;
      }
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      // A segment that the file ends inside reads on into the EOI markers
      // libjpeg's source manager supplies past the end (FF D9 FF D9 ...):
      // most segments then fail its checks, a few decode with those bytes.
      std::vector<uint8_t> padded;
      const uint8_t* body;
      int seg;
      if (p + 2 <= end && p + u16(p) <= end) {
        seg = u16(p) - 2;
        body = p + 2;
        p = body + (seg > 0 ? seg : 0);
      } else {
        const size_t at = static_cast<size_t>(p - data);
        auto byte = [&](size_t i) -> int {
          return i < len ? data[i] : ((i - len) % 2 ? 0xD9 : 0xFF);
        };
        seg = ((byte(at) << 8) | byte(at + 1)) - 2;
        padded.resize(seg > 0 ? static_cast<size_t>(seg) : 0);
        for (size_t i = 0; i < padded.size(); ++i) padded[i] = static_cast<uint8_t>(byte(at + 2 + i));
        body = padded.data();
        p = end;
      }
      if (seg < 0) fail("bad marker segment length");
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          read_sof(body, seg, marker);
          break;
        case 0xC5: case 0xC6: case 0xC7: case 0xCB: case 0xCD: case 0xCE: case 0xCF: {
          static const char* kinds[16] = {
              "", "", "", "", "", "differential sequential",
              "differential progressive", "differential lossless", "", "", "",
              "arithmetic-coded lossless", "",
              "arithmetic-coded differential sequential",
              "arithmetic-coded differential progressive",
              "arithmetic-coded differential lossless"};
          char m[16];
          snprintf(m, sizeof(m), "SOF%d", marker - 0xC0);
          fail(std::string(m) + " (" + kinds[marker - 0xC0] +
               ") is not read: cv2.imread reads no image from it (libjpeg-turbo "
               "decodes no hierarchical or arithmetic-coded lossless frames)");
        }
        case 0xCC:
          read_dac(body, seg);
          break;
        case 0xC4:
          read_dht(body, seg);
          break;
        case 0xDB:
          read_dqt(body, seg);
          break;
        case 0xDD:
          if (seg != 2) fail("bad DRI segment");
          restart_interval = u16(body);
          break;
        case 0xDA:
          p = decode_scan(body, seg, p);
          break;
        case 0xE0:
          if (seg >= 5 && memcmp(body, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xE1:
          read_exif(body, seg);
          break;
        case 0xEE:
          if (seg >= 12 && memcmp(body, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = body[11];
          }
          break;
        case 0xDE: case 0xDF:
          fail("hierarchical JPEG (DHP/EXP) is not read: cv2.imread reads no image from it");
        default:
          break;
      }
    }
  }

  bool is_rgb() const {
    if (ncomp != 3) return false;
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  // libjpeg's JDCT_ISLOW as libjpeg-turbo's SIMD code computes it
  // (jidctint-avx2.asm; the SSE2 code computes the same), into an 8x8
  // block of samples.  On valid data it equals jidctint.c; where the data
  // leave 16 bits (corrupt or zero-filled entropy data) it wraps and
  // saturates as the SIMD lanes do: dequantisation and the sums in0 + in4,
  // in0 - in4, in7 + in3 and in5 + in1 keep 16 bits, each pass's outputs
  // saturate to 16 bits, the final ones to 8 bits before the centre 128 is
  // added, and a block whose rows 1-7 are all zero takes the short path of
  // dequantised row 0 shifted left by two in 16 bits.
  static inline int32_t wrap16(int64_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
  static inline int32_t sat16(int64_t x) { return static_cast<int32_t>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x)); }
  static inline int32_t wrap32(int64_t x) { return static_cast<int32_t>(static_cast<uint32_t>(x)); }

  // One 8-point pass over `in` (16-bit values) into `out`, descaled by
  // `shift` and saturated to 16 bits.
  static void idct_pass(const int32_t* in, int32_t* out, int shift) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    const int64_t tmp0 = static_cast<int64_t>(wrap16(in[0] + in[4])) * 8192;
    const int64_t tmp1 = static_cast<int64_t>(wrap16(in[0] - in[4])) * 8192;
    const int64_t tmp2 = in[2] * F0541 + in[6] * (F0541 - F1847);
    const int64_t tmp3 = in[2] * (F0541 + F0765) + in[6] * F0541;
    const int64_t t10 = wrap32(tmp0 + tmp3), t13 = wrap32(tmp0 - tmp3);
    const int64_t t11 = wrap32(tmp1 + tmp2), t12 = wrap32(tmp1 - tmp2);
    const int64_t z3 = wrap16(in[7] + in[3]), z4 = wrap16(in[5] + in[1]);
    const int64_t z3p = wrap32(z3 * (F1175 - F1961) + z4 * F1175);
    const int64_t z4p = wrap32(z3 * F1175 + z4 * (F1175 - F0390));
    const int64_t o0 = wrap32(in[7] * (F0298 - F0899) - in[1] * F0899 + z3p);
    const int64_t o3 = wrap32(-in[7] * F0899 + in[1] * (F1501 - F0899) + z4p);
    const int64_t o1 = wrap32(in[5] * (F2053 - F2562) - in[3] * F2562 + z4p);
    const int64_t o2 = wrap32(-in[5] * F2562 + in[3] * (F3072 - F2562) + z3p);
    const int64_t r = int64_t{1} << (shift - 1);
    auto d = [&](int64_t x) { return sat16(static_cast<int64_t>(wrap32(wrap32(x) + r)) >> shift); };
    out[0] = d(t10 + o3);
    out[7] = d(t10 - o3);
    out[1] = d(t11 + o2);
    out[6] = d(t11 - o2);
    out[2] = d(t12 + o1);
    out[5] = d(t12 - o1);
    out[3] = d(t13 + o0);
    out[4] = d(t13 - o0);
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int32_t ws[64];
    bool rows_zero = true;
    for (int k = 8; k < 64; ++k)
      if (in[k]) rows_zero = false;
    if (rows_zero) {
      for (int c = 0; c < 8; ++c) {
        int32_t v = wrap16(static_cast<int64_t>(wrap16(in[c] * q[c])) * 4);
        for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
      }
    } else {
      for (int c = 0; c < 8; ++c) {
        int32_t col[8], res[8];
        for (int r = 0; r < 8; ++r) col[r] = wrap16(in[8 * r + c] * q[8 * r + c]);
        idct_pass(col, res, 11);
        for (int r = 0; r < 8; ++r) ws[8 * r + c] = res[r];
      }
    }
    for (int r = 0; r < 8; ++r) {
      int32_t res[8];
      idct_pass(ws + 8 * r, res, 18);
      uint8_t* o = out + r * stride;
      for (int x = 0; x < 8; ++x) {
        int v = res[x] < -128 ? -128 : (res[x] > 127 ? 127 : res[x]);
        o[x] = static_cast<uint8_t>(v + 128);
      }
    }
  }

  // libjpeg-turbo's block smoothing (jdcoefct.c smoothing_ok and
  // decompress_smooth_data, the 2.1+ form): a progressive file whose scans
  // leave any of coefficients 1-9 of a component incomplete, once every
  // component has its DC, gets those coefficients estimated from the DC
  // values of the 5x5 neighbourhood of blocks wherever they are still zero.
  bool smoothing() const {
    if (!progressive) return false;
    bool useful = false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!qt_defined[c.tq]) return false;
      for (int k = 0; k < 10; ++k)
        if (qt[c.tq][kPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // The smoothed copy of block (by, bx) of component `c` in `ws`.
  void smooth_block(Component& c, int by, int bx, int16_t* ws) {
    memcpy(ws, c.block(by, bx), 64 * sizeof(int16_t));
    // Rows the last scan did not reach with data use the bits before it
    // (none before the first scan).
    int prev[10];
    for (int k = 1; k < 10; ++k) prev[k] = scans > 1 ? c.prev_bits[k] : -1;
    const int* bits = by / c.v > last_good_row ? prev : c.coef_bits;
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                           bits[5] == -1 && bits[6] == -1 && bits[7] == -1 &&
                           bits[8] == -1 && bits[9] == -1;
    // The block rows libjpeg reads around this one: two above and two
    // below, clamped to the image's rows, except that the iMCU row before
    // the last reads the last one's dummy rows too (a component's block
    // rows come in iMCU rows of v, the last holding what is left).
    const int last = mcuy - 1, r = by / c.v;
    const int lowest = r < last ? c.bh - 1 : c.hblocks - 1;
    int rows[5];
    rows[2] = by;
    rows[1] = by > 0 ? by - 1 : by;
    rows[0] = by > 1 ? by - 2 : rows[1];
    // Measured against libjpeg-turbo: when the second iMCU row is the last
    // and holds fewer block rows than v, its first row's upper neighbour
    // two up is the one above it.
    if (r == 1 && r == last && c.hblocks % c.v && by % c.v <= 1) rows[0] = rows[1];
    rows[3] = by + 1 <= lowest ? by + 1 : by;
    rows[4] = by + 2 <= lowest ? by + 2 : rows[3];
    int64_t DC[26];
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 5; ++j) {
        int x = bx + j - 2;
        x = x < 0 ? 0 : (x > c.wblocks - 1 ? c.wblocks - 1 : x);
        DC[1 + 5 * i + j] = c.block(rows[i], x)[0];
      }
    const uint16_t* q = qt[c.tq];
    const int64_t Q00 = q[0];
    auto predict = [&](int k, int pos, int64_t num) {
      int al = bits[k];
      if (al == 0 || ws[pos] != 0) return;
      const int64_t qk = q[pos];
      num *= Q00;
      int64_t pred;
      if (num >= 0) {
        pred = ((qk << 7) + num) / (qk << 8);
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = ((qk << 7) - num) / (qk << 8);
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      ws[pos] = static_cast<int16_t>(pred);
    };
    const int64_t* D = DC;
    // AC01, AC10, AC20, AC11, AC02.
    predict(1, 1, change_dc ? (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] +
                               3 * D[10] - 3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] -
                               3 * D[16] + 13 * D[17] - 13 * D[19] + 3 * D[20] - D[21] -
                               D[22] + D[24] + D[25])
                            : (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]));
    predict(2, 8, change_dc ? (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] +
                               13 * D[7] + 38 * D[8] + 13 * D[9] - D[10] + D[16] -
                               13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
                               3 * D[22] + 3 * D[23] + 3 * D[24] + D[25])
                            : (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]));
    predict(3, 16, change_dc ? (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] -
                                14 * D[13] - 5 * D[14] + 2 * D[17] + 7 * D[18] + 2 * D[19] +
                                D[23])
                             : (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]));
    predict(4, 9, change_dc ? (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] +
                               D[21] - D[25])
                            : (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] -
                               D[24] + D[4] - D[6] + 10 * D[7] - 10 * D[9]));
    predict(5, 2, change_dc ? (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] +
                               7 * D[14] + D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19])
                            : (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]));
    if (!change_dc) return;
    // AC03, AC12, AC21, AC30, then the DC itself.
    predict(6, 3, D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]);
    predict(7, 10, D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]);
    predict(8, 17, D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]);
    predict(9, 24, D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]);
    int64_t num = Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] +
                         6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] +
                         42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] - 6 * D[16] +
                         6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] - 2 * D[21] -
                         6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
    int64_t pred = num >= 0 ? ((Q00 << 7) + num) / (Q00 << 8)
                            : -(((Q00 << 7) - num) / (Q00 << 8));
    ws[0] = static_cast<int16_t>(pred);
  }

  // One component's samples at full size (width x height): a DCT
  // component inverse transformed (smoothed first where `smooth`) and
  // upsampled as libjpeg's fancy upsampling does; a lossless component's
  // samples shifted by the point transform and replicated (libjpeg does
  // no fancy upsampling of 1x1 blocks).
  std::vector<uint8_t> plane(int ci, bool smooth) {
    Component& c = comp[ci];
    int pw, ph;
    std::vector<uint8_t> s;
    if (lossless) {
      pw = c.bw;
      ph = c.bh;
      s.resize(c.samples.size());
      for (size_t i = 0; i < s.size(); ++i)
        s[i] = static_cast<uint8_t>(c.samples[i] << c.pt);
    } else {
      // A component no scan carries has zero coefficients: mid-grey
      // whatever its table.
      if (c.scanned && !qt_defined[c.tq]) fail("undefined quantisation table");
      pw = c.wblocks * 8;
      ph = c.hblocks * 8;
      s.resize(static_cast<size_t>(pw) * ph);
      int16_t ws[64];
      for (int by = 0; by < c.hblocks; ++by)
        for (int bx = 0; bx < c.wblocks; ++bx) {
          const int16_t* blk = c.block(by, bx);
          if (smooth) {
            smooth_block(c, by, bx, ws);
            blk = ws;
          }
          idct_islow(blk, qt[c.tq], s.data() + (by * 8) * pw + bx * 8, pw);
        }
    }
    int fh = maxh / c.h, fv = maxv / c.v;
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);
      x = x < 0 ? 0 : (x >= c.dw ? c.dw - 1 : x);
      return s[static_cast<size_t>(y) * pw + x];
    };
    bool h2 = !lossless && fh == 2 && fv == 1 && c.dw > 2;
    bool v2 = !lossless && fh == 1 && fv == 2;
    bool hv2 = !lossless && fh == 2 && fv == 2 && c.dw > 2;
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out.data() + static_cast<size_t>(y) * width;
      if (h2) {
        for (int x = 0; x < width; ++x) {
          int i = x >> 1;
          int near = at(y, i) * 3;
          o[x] = static_cast<uint8_t>((x & 1) ? (near + at(y, i + 1) + 2) >> 2
                                              : (near + at(y, i - 1) + 1) >> 2);
        }
      } else if (v2) {
        int i = y >> 1;
        int other = (y & 1) ? i + 1 : i - 1;
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; ++x)
          o[x] = static_cast<uint8_t>((at(i, x) * 3 + at(other, x) + bias) >> 2);
      } else if (hv2) {
        int i = y >> 1;
        int other = (y & 1) ? i + 1 : i - 1;
        for (int x = 0; x < width; ++x) {
          int j = x >> 1;
          int jn = (x & 1) ? j + 1 : j - 1;
          int thiscol = at(i, j) * 3 + at(other, j);
          int nextcol = at(i, jn) * 3 + at(other, jn);
          o[x] = static_cast<uint8_t>((x & 1) ? (thiscol * 3 + nextcol + 7) >> 4
                                              : (thiscol * 3 + nextcol + 8) >> 4);
        }
      } else {
        for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>(at(y / fv, x / fh));
      }
    }
    return out;
  }

  void to_rgb(uint8_t* rgb) {
    // libjpeg-turbo converts no colours in lossless mode but RGB's own
    // orders, and cv2 asks for BGR: it reads a lossless file only as RGB
    // (or as CMYK, converted by cv2 itself).
    if (lossless && !(is_rgb() || (ncomp == 4 && !(saw_adobe && adobe_transform != 0))))
      fail(std::string("lossless JPEG of ") + (ncomp == 1 ? "one (greyscale)" : "YCbCr/YCCK") +
           " component" + (ncomp == 1 ? "" : "s") +
           ": cv2.imread reads no image from it (libjpeg-turbo converts no colours in "
           "lossless mode)");
    const bool smooth = smoothing();
    if (ncomp == 1) {
      std::vector<uint8_t> g = plane(0, smooth);
      for (size_t i = 0; i < g.size(); ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> p0 = plane(0, smooth), p1 = plane(1, smooth), p2 = plane(2, smooth);
    size_t n = p0.size();
    if (is_rgb()) {
      for (size_t i = 0; i < n; ++i) {
        rgb[3 * i] = p0[i];
        rgb[3 * i + 1] = p1[i];
        rgb[3 * i + 2] = p2[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table: 16 scale bits, ONE_HALF folded into
    // the Cb term of green.
    const int64_t half = 1 << 15;
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((91881 * x + half) >> 16);
      cb_b[i] = static_cast<int>((116130 * x + half) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + half;
    }
    auto clamp = [](int v) -> uint8_t {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    if (ncomp == 3) {
      for (size_t i = 0; i < n; ++i) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        rgb[3 * i] = clamp(y + cr_r[cr]);
        rgb[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
        rgb[3 * i + 2] = clamp(y + cb_b[cb]);
      }
      return;
    }
    // Four components.  libjpeg reads CMYK as stored under Adobe transform
    // 0 or without an Adobe marker, and YCCK under any other transform
    // (jdcolor.c ycck_cmyk_convert: 255 minus the YCbCr->RGB result, K
    // unchanged).  cv2 then converts CMYK to BGR: each of C, M, Y becomes
    // k - ((255 - x) * k >> 8), and R, G, B are those of C, M, Y.
    std::vector<uint8_t> p3 = plane(3, smooth);
    bool ycck = saw_adobe && adobe_transform != 0;
    for (size_t i = 0; i < n; ++i) {
      int c = p0[i], m = p1[i], yv = p2[i], k = p3[i];
      if (ycck) {
        int y = c, cb = m, cr = yv;
        c = clamp(255 - (y + cr_r[cr]));
        m = clamp(255 - (y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16)));
        yv = clamp(255 - (y + cb_b[cb]));
      }
      rgb[3 * i] = static_cast<uint8_t>(k - ((255 - c) * k >> 8));
      rgb[3 * i + 1] = static_cast<uint8_t>(k - ((255 - m) * k >> 8));
      rgb[3 * i + 2] = static_cast<uint8_t>(k - ((255 - yv) * k >> 8));
    }
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// Decodes a whole file into a new buffer of height * width * 3 bytes (rows
// of RGB as stored, before any Exif orientation), which the caller frees
// with sj_free.  `orientation` is 1-8 from an APP1 Exif tag, else 0.
// Returns 0, or -1 with a message in `err`.
int sj_jpeg_decode(const uint8_t* data, int64_t len, uint8_t** rgb, int32_t* height,
                   int32_t* width, int32_t* orientation, char* err, int32_t errlen) {
  *rgb = nullptr;
  try {
    Decoder d(data, static_cast<size_t>(len));
    d.parse();
    std::vector<uint8_t> out(static_cast<size_t>(d.width) * d.height * 3);
    d.to_rgb(out.data());
    uint8_t* buf = static_cast<uint8_t*>(malloc(out.size()));
    if (!buf) fail("out of memory");
    memcpy(buf, out.data(), out.size());
    *rgb = buf;
    *height = d.height;
    *width = d.width;
    *orientation = d.orientation;
    return 0;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return -1;
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("cannot decode: ") + e.what());
    return -1;
  }
}

void sj_free(uint8_t* p) { free(p); }

}  // extern "C"
