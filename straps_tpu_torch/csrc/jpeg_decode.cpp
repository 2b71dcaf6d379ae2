// jpeg_decode: a JPEG decoder for the predict path's photos, equal bit for
// bit to libjpeg-turbo's defaults (what `cv2.imread` decodes with).
//
// Reads baseline and extended sequential Huffman (SOF0, SOF1) and
// progressive Huffman (SOF2) JPEGs of 8-bit samples with 1, 3 or 4
// components, any sampling factors whose ratios to the largest are
// integers, restart intervals, and images of any size.  Every scan is
// decoded into one coefficient buffer per component, then each block is
// dequantised and inverse transformed by libjpeg's JDCT_ISLOW (13-bit
// constants, two passes), the chroma planes are upsampled as libjpeg's
// fancy upsampling does (the triangle filters of h2v1, h2v2 and h1v2 with
// their alternating rounding biases, replication for other ratios and for
// planes of 2 columns or fewer), and YCbCr is converted to RGB with the
// 16-bit fixed-point tables of jdcolor.c.  Four components are CMYK as
// stored (Adobe transform 0, or no Adobe marker) or YCCK (any other
// transform), which libjpeg turns into CMYK with the same tables; cv2 then
// converts CMYK to BGR with its own integer formula.  A component that no
// scan carries keeps zero coefficients (mid-grey), as in libjpeg's buffer.
//
// A file that ends inside its entropy-coded data decodes as libjpeg does:
// the bits past the end read as zeros for the MCU in progress, and the
// MCUs after it keep the coefficients they have (zero for a sequential
// file) until a restart marker.  Arithmetic coding, lossless and
// hierarchical frames, precisions other than 8 bits and 2 components are
// refused with a message naming the marker.
//
// Plain C interface for ctypes (straps_tpu_torch/utils/jpeg.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

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

struct Decoder {
  const uint8_t* data;
  size_t len;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false;
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
  Component comp[4];
  int scans = 0;

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {}

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
    if (p[0] != 8) fail("SOF precision " + std::to_string(p[0]) + " (only 8-bit samples are read)");
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = p[5];
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail(std::to_string(ncomp) + " components in SOF" + std::to_string(marker - 0xC0) +
           " (only greyscale, YCbCr/RGB and CMYK/YCCK are read)");
    if (n < 6 + 3 * ncomp) fail("short SOF segment");
    if (height == 0) fail("DNL line counts (height 0 in the frame header) are not read");
    if (width == 0) fail("width 0 in the frame header");
    progressive = marker == 0xC2;
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
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (maxh % c.h || maxv % c.v)
        fail("sampling factors whose ratios are not integers");
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + maxh - 1) / maxh);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + maxv - 1) / maxv);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
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

  // One scan's entropy-coded data, starting at `p`.  Returns the position
  // of the marker after it.
  const uint8_t* decode_scan(const uint8_t* hdr, int n, const uint8_t* p) {
    if (!have_frame) fail("SOS before the frame header");
    int ns = hdr[0];
    if (ns < 1 || ns > 4 || n < 1 + 2 * ns + 3) fail("bad SOS segment");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = hdr[1 + 2 * i];
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i]) fail("SOS names an unknown component");
      sc[i]->dc_tbl = hdr[2 + 2 * i] >> 4;
      sc[i]->ac_tbl = hdr[2 + 2 * i] & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3) fail("bad Huffman table selector");
    }
    int ss = hdr[1 + 2 * ns], se = hdr[2 + 2 * ns];
    int ah = hdr[3 + 2 * ns] >> 4, al = hdr[3 + 2 * ns] & 15;
    if (!progressive) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13) {
      fail("bad progression parameters");
    }
    bool need_dc = ss == 0 && ah == 0, need_ac = se > 0;
    for (int i = 0; i < ns; ++i) {
      if (need_dc && !dc[sc[i]->dc_tbl].defined) fail("undefined DC Huffman table");
      if (need_ac && !ac[sc[i]->ac_tbl].defined) fail("undefined AC Huffman table");
      sc[i]->last_dc = 0;
      sc[i]->scanned = true;
      for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
    }
    ++scans;

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

    auto before_mcu = [&]() {
      if (!restart_interval) return;
      if (restarts_left == 0) {
        if (br.restart() ) insufficient = false;
        for (int i = 0; i < ns; ++i) sc[i]->last_dc = 0;
        eobrun = 0;
        restarts_left = restart_interval;
      }
      --restarts_left;
    };

    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.hblocks; ++by) {
        for (int bx = 0; bx < c.wblocks; ++bx) {
          before_mcu();
          if (insufficient) continue;
          decode_block(c, c.block(by, bx));
          if (br.past_end) insufficient = true;
        }
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          before_mcu();
          if (insufficient) continue;
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h)
                decode_block(c, c.block(my * c.v + v, mx * c.h + h));
          }
          if (br.past_end) insufficient = true;
        }
      }
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
      if (p + 2 > end) {
        if (scans) return;
        fail("file ends inside a marker segment");
      }
      int seg = u16(p) - 2;
      const uint8_t* body = p + 2;
      if (seg < 0 || body + seg > end) {
        if (scans) return;
        fail("file ends inside a marker segment");
      }
      p = body + seg;
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(body, seg, marker);
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA:
        case 0xCB: case 0xCD: case 0xCE: case 0xCF: {
          static const char* kinds[16] = {
              "", "", "", "lossless", "", "differential sequential",
              "differential progressive", "differential lossless", "",
              "arithmetic-coded sequential", "arithmetic-coded progressive",
              "arithmetic-coded lossless", "",
              "arithmetic-coded differential sequential",
              "arithmetic-coded differential progressive",
              "arithmetic-coded differential lossless"};
          char m[16];
          snprintf(m, sizeof(m), "SOF%d", marker - 0xC0);
          fail(std::string(m) + " (" + kinds[marker - 0xC0] +
               ") is not read: only baseline, extended sequential and "
               "progressive Huffman JPEGs are");
        }
        case 0xCC:
          fail("DAC (arithmetic coding conditioning) is not read: only Huffman-coded JPEGs are");
        case 0xC4:
          read_dht(body, seg);
          break;
        case 0xDB:
          read_dqt(body, seg);
          break;
        case 0xDD:
          if (seg < 2) fail("short DRI segment");
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
          fail("hierarchical JPEG (DHP/EXP) is not read");
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

  // libjpeg's jpeg_idct_islow into an 8x8 block of samples.
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* w = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dc = (ip[0] * qp[0]) * 4;
        for (int r = 0; r < 8; ++r) w[8 * r] = dc;
        continue;
      }
      int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 - z3 * F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = ip[0] * qp[0];
      z3 = ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
      int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = ip[56] * qp[56];
      tmp1 = ip[40] * qp[40];
      tmp2 = ip[24] * qp[24];
      tmp3 = ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 11;
      const int64_t rnd = 1 << (sh - 1);
      w[0] = static_cast<int>((t10 + tmp3 + rnd) >> sh);
      w[56] = static_cast<int>((t10 - tmp3 + rnd) >> sh);
      w[8] = static_cast<int>((t11 + tmp2 + rnd) >> sh);
      w[48] = static_cast<int>((t11 - tmp2 + rnd) >> sh);
      w[16] = static_cast<int>((t12 + tmp1 + rnd) >> sh);
      w[40] = static_cast<int>((t12 - tmp1 + rnd) >> sh);
      w[24] = static_cast<int>((t13 + tmp0 + rnd) >> sh);
      w[32] = static_cast<int>((t13 - tmp0 + rnd) >> sh);
    }
    // libjpeg-turbo's SIMD IDCT saturates the result to [-128, 127] before
    // adding 128 (its C range-limit table agrees within that range).
    auto limit = [](int64_t x) -> uint8_t {
      int v = static_cast<int>(x) + 128;
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (int r = 0; r < 8; ++r) {
      const int* w = ws + 8 * r;
      uint8_t* o = out + r * stride;
      const int sh = 18;
      const int64_t rnd = 1 << (sh - 1);
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 - z3 * F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * 8192;
      int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * 8192;
      int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = limit((t10 + tmp3 + rnd) >> sh);
      o[7] = limit((t10 - tmp3 + rnd) >> sh);
      o[1] = limit((t11 + tmp2 + rnd) >> sh);
      o[6] = limit((t11 - tmp2 + rnd) >> sh);
      o[2] = limit((t12 + tmp1 + rnd) >> sh);
      o[5] = limit((t12 - tmp1 + rnd) >> sh);
      o[3] = limit((t13 + tmp0 + rnd) >> sh);
      o[4] = limit((t13 - tmp0 + rnd) >> sh);
    }
  }

  // One component's samples at full size (width x height), upsampled as
  // libjpeg's fancy upsampling does.
  std::vector<uint8_t> plane(int ci) {
    Component& c = comp[ci];
    // A component no scan carries has zero coefficients: mid-grey whatever
    // its table.
    if (c.scanned && !qt_defined[c.tq]) fail("undefined quantisation table");
    int pw = c.wblocks * 8, ph = c.hblocks * 8;
    std::vector<uint8_t> s(static_cast<size_t>(pw) * ph);
    for (int by = 0; by < c.hblocks; ++by)
      for (int bx = 0; bx < c.wblocks; ++bx)
        idct_islow(c.block(by, bx), qt[c.tq], s.data() + (by * 8) * pw + bx * 8, pw);
    int fh = maxh / c.h, fv = maxv / c.v;
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);
      x = x < 0 ? 0 : (x >= c.dw ? c.dw - 1 : x);
      return s[static_cast<size_t>(y) * pw + x];
    };
    bool h2 = fh == 2 && fv == 1 && c.dw > 2;
    bool v2 = fh == 1 && fv == 2;
    bool hv2 = fh == 2 && fv == 2 && c.dw > 2;
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

  // libjpeg smooths the blocks of a progressive file whose scans stop
  // before coefficients 1-9 of every component are complete (jdcoefct.c,
  // decompress_smooth_data): a file cut short.  That smoothing is not
  // ported, so such files are refused rather than decoded differently.
  void check_complete() const {
    if (!progressive) return;
    for (int i = 0; i < ncomp; ++i)
      if (comp[i].coef_bits[0] < 0) return;
    for (int i = 0; i < ncomp; ++i)
      for (int k = 1; k < 10; ++k)
        if (comp[i].coef_bits[k] != 0)
          fail("progressive JPEG cut short before its low-frequency coefficients are "
               "complete (libjpeg's block smoothing of such files is not ported)");
  }

  void to_rgb(uint8_t* rgb) {
    check_complete();
    if (ncomp == 1) {
      std::vector<uint8_t> g = plane(0);
      for (size_t i = 0; i < g.size(); ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> p0 = plane(0), p1 = plane(1), p2 = plane(2);
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
    std::vector<uint8_t> p3 = plane(3);
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
