// zstd_decode: a Zstandard decompressor (RFC 8878) and CRC-32C, the host
// side of reading the JAX package's orbax checkpoints (OCDBT nodes and
// zarr chunks are zstd frames; OCDBT nodes end in a CRC-32C).  Bound with
// ctypes by straps_tpu_torch/utils/zstd.py.
//
//   * sz_decompress: every frame of the input (Zstandard frames and
//     skippable frames, concatenated) into one buffer (sz_data, sz_size).  Raw, RLE
//     and compressed blocks; raw, RLE, Huffman (1 or 4 streams) and
//     treeless literals; predefined, RLE, FSE and repeat sequence tables;
//     the three repeat offsets; matches back across blocks of a frame;
//     the XXH64 content checksum, verified.  A dictionary ID other than 0
//     and any malformed input fail with a message naming what was met;
//     nothing is returned then.
//   * sz_free: releases sz_decompress's buffer.
//   * sz_count_names / sz_num_counts: what sz_decompress counts.
//   * sz_crc32c: CRC-32C (Castagnoli) of a buffer.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Error(what); }

// Counts of what the decoder met, in the order of sz_count_names.
enum Count {
  kFrames, kSkippableFrames, kRawBlocks, kRleBlocks, kCompressedBlocks,
  kRawLiterals, kRleLiterals, kHuffmanLiterals, kTreelessLiterals,
  kHuffman1Stream, kHuffman4Streams, kSeqPredefined, kSeqRle, kSeqFse,
  kSeqRepeat, kChecksums, kNumCounts
};
const char* kCountNames =
    "frames,skippable_frames,raw_blocks,rle_blocks,compressed_blocks,"
    "raw_literals,rle_literals,huffman_literals,treeless_literals,"
    "huffman_1_stream,huffman_4_streams,seq_predefined,seq_rle,seq_fse,"
    "seq_repeat,checksums";

inline uint32_t read_le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}
inline uint64_t read_le64(const uint8_t* p) {
  return uint64_t(read_le32(p)) | uint64_t(read_le32(p + 4)) << 32;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- XXH64
const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xxh_round(v1, read_le64(p));
      v2 = xxh_round(v2, read_le64(p + 8));
      v3 = xxh_round(v3, read_le64(p + 16));
      v4 = xxh_round(v4, read_le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xxh_round(0, read_le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(read_le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------- bit readers
// Forward little-endian bits (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n, bit = 0;
  uint32_t read(int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++bit) {
      if (bit / 8 >= n) fail("FSE table description runs past its section");
      v |= uint32_t((p[bit / 8] >> (bit % 8)) & 1) << i;
    }
    return v;
  }
  uint32_t peek(int nb) { size_t b = bit; uint32_t v = read(nb); bit = b; return v; }
  size_t bytes() const { return (bit + 7) / 8; }
};

// Backward bits (Huffman, FSE and sequence streams): read from the end,
// after the final byte's highest set bit; bits before the start read as 0
// (the FSE overflow rule) and leave `pos` negative.
struct BackwardBits {
  const uint8_t* p;
  int64_t nbytes;
  int64_t pos;   // bits left to read
  BackwardBits(const uint8_t* src, size_t n, const char* what) : p(src), nbytes(int64_t(n)) {
    if (n == 0) fail(std::string(what) + " bitstream is empty");
    if (src[n - 1] == 0) fail(std::string(what) + " bitstream has no end mark");
    pos = int64_t(n) * 8 - (8 - highbit(src[n - 1]));
  }
  uint64_t peek(int nb) const {   // nb <= 56
    if (nb == 0 || pos <= 0) return 0;
    int64_t lo = pos - nb;
    if (lo >= 0 && lo / 8 + 8 <= nbytes) {
      uint64_t v;
      memcpy(&v, p + lo / 8, 8);
      return (v >> (lo % 8)) & ((1ULL << nb) - 1);
    }
    int64_t start = lo < 0 ? 0 : lo;
    int64_t first = start / 8, last = (pos - 1) / 8;
    uint64_t v = 0;
    for (int64_t b = last; b >= first; --b) v = (v << 8) | p[b];
    v >>= (start - first * 8);
    v &= (1ULL << (pos - start)) - 1;
    return v << (start - lo);
  }
  uint64_t read(int nb) { uint64_t v = peek(nb); pos -= nb; return v; }
};

// -------------------------------------------------------------------- FSE
struct FseEntry { uint16_t symbol; uint8_t nbits; uint16_t base; };
struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// A table description (RFC 8878 4.1.1) -> normalized counts; returns the
// bytes used.
size_t read_fse_counts(const uint8_t* src, size_t n, int max_log, int max_symbol,
                       std::vector<int>& norm, int& log, const char* what) {
  ForwardBits in{src, n};
  log = int(in.read(4)) + 5;
  if (log > max_log) fail(std::string(what) + " FSE accuracy log " + std::to_string(log) +
                          " exceeds " + std::to_string(max_log));
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, symbol = 0;
  norm.assign(max_symbol + 1, 0);
  while (remaining > 1) {
    if (symbol > max_symbol) fail(std::string(what) + " FSE table has too many symbols");
    int max = 2 * threshold - 1 - remaining;
    int count;
    int low = int(in.peek(nb - 1));
    if (low < max) {
      count = low;
      in.bit += nb - 1;
    } else {
      count = int(in.peek(nb)) & (2 * threshold - 1);
      if (count >= threshold) count -= max;
      in.bit += nb;
    }
    if (in.bytes() > n) fail(std::string(what) + " FSE table description runs past its section");
    --count;
    remaining -= count < 0 ? -count : count;
    norm[symbol++] = count;
    if (count == 0) {
      for (;;) {
        int rep = int(in.read(2));
        for (int i = 0; i < rep; ++i) {
          if (symbol > max_symbol) fail(std::string(what) + " FSE zero run past the last symbol");
          norm[symbol++] = 0;
        }
        if (rep != 3) break;
      }
    }
    while (remaining < threshold) { --nb; threshold >>= 1; }
  }
  if (remaining != 1) fail(std::string(what) + " FSE counts do not sum to the table size");
  norm.resize(symbol);
  return in.bytes();
}

void build_fse(const std::vector<int>& norm, int log, FseTable& table, const char* what) {
  const int size = 1 << log;
  table.log = log;
  table.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      if (high < 0) fail(std::string(what) + " FSE table overfull");
      table.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      table.t[pos].symbol = uint16_t(s);
      do { pos = (pos + step) & mask; } while (pos > high);
    }
  }
  if (pos != 0) fail(std::string(what) + " FSE counts do not spread over the table");
  for (int u = 0; u < size; ++u) {
    FseEntry& e = table.t[u];
    uint32_t ns = next[e.symbol]++;
    if (ns == 0) fail(std::string(what) + " FSE table is inconsistent");
    e.nbits = uint8_t(log - highbit(ns));
    e.base = uint16_t((ns << e.nbits) - size);
  }
}

void rle_fse(uint8_t symbol, FseTable& table) {
  table.log = 0;
  table.t.assign(1, FseEntry{symbol, 0, 0});
}

// ---------------------------------------------------------------- Huffman
struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> symbol, nbits;   // indexed by the next max_bits bits
};

// The tree description (RFC 8878 4.2.1); returns the bytes used.
size_t read_huffman(const uint8_t* src, size_t n, Huffman& h) {
  if (n < 1) fail("Huffman tree description is missing");
  uint8_t weights[256] = {0};
  int count = 0;
  size_t used;
  uint8_t header = src[0];
  if (header >= 128) {
    count = header - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) fail("Huffman direct weights run past the literals section");
    for (int i = 0; i < count; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
  } else {
    used = 1 + header;
    if (used > n || header == 0) fail("Huffman FSE weights run past the literals section");
    std::vector<int> norm;
    int log;
    size_t hb = read_fse_counts(src + 1, header, 6, 255, norm, log, "Huffman weights");
    FseTable t;
    build_fse(norm, log, t, "Huffman weights");
    if (hb >= header) fail("Huffman FSE weights have no bitstream");
    BackwardBits in(src + 1 + hb, header - hb, "Huffman weights");
    uint32_t s1 = uint32_t(in.read(log)), s2 = uint32_t(in.read(log));
    for (;;) {
      if (count > 254) fail("Huffman FSE weights decode to too many symbols");
      weights[count++] = uint8_t(t.t[s1].symbol);
      s1 = t.t[s1].base + uint32_t(in.read(t.t[s1].nbits));
      if (in.pos < 0) { weights[count++] = uint8_t(t.t[s2].symbol); break; }
      if (count > 254) fail("Huffman FSE weights decode to too many symbols");
      weights[count++] = uint8_t(t.t[s2].symbol);
      s2 = t.t[s2].base + uint32_t(in.read(t.t[s2].nbits));
      if (in.pos < 0) { weights[count++] = uint8_t(t.t[s1].symbol); break; }
    }
  }
  uint32_t total = 0;
  for (int i = 0; i < count; ++i) {
    if (weights[i] > 11) fail("Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  int max_bits = highbit(total) + 1;
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights leave no power of two for the last symbol");
  if (count > 255) fail("Huffman tree has too many symbols");
  weights[count++] = uint8_t(highbit(rest) + 1);
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  h.max_bits = max_bits;
  const int size = 1 << max_bits;
  h.symbol.assign(size, 0);
  h.nbits.assign(size, 0);
  uint32_t rank_count[13] = {0};
  uint8_t bits[256] = {0};
  for (int i = 0; i < count; ++i) {
    if (weights[i]) bits[i] = uint8_t(max_bits + 1 - weights[i]);
    rank_count[bits[i]]++;
  }
  uint32_t rank_idx[13] = {0};
  rank_idx[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    rank_idx[b - 1] = rank_idx[b] + rank_count[b] * (1u << (max_bits - b));
    for (uint32_t k = rank_idx[b]; k < rank_idx[b - 1]; ++k) h.nbits[k] = uint8_t(b);
  }
  if (rank_idx[0] != uint32_t(size)) fail("Huffman code lengths do not fill the table");
  for (int i = 0; i < count; ++i) {
    if (!bits[i]) continue;
    uint32_t len = 1u << (max_bits - bits[i]);
    for (uint32_t k = 0; k < len; ++k) h.symbol[rank_idx[bits[i]] + k] = uint8_t(i);
    rank_idx[bits[i]] += len;
  }
  return used;
}

// Up to four Huffman streams decoded in step (independent chains keep the
// core busy), each then finished alone; every stream must end exactly at
// its first bit.
void huffman_streams(const Huffman& h, int nstreams, const uint8_t* const* src,
                     const size_t* n, uint8_t* const* out, const size_t* count) {
  const int mb = h.max_bits;
  std::vector<uint16_t> table(h.symbol.size());
  for (size_t k = 0; k < table.size(); ++k) table[k] = uint16_t(h.symbol[k] | h.nbits[k] << 8);
  const uint16_t* dt = table.data();
  BackwardBits in[4] = {BackwardBits(src[0], n[0], "Huffman"),
                        BackwardBits(src[nstreams > 1 ? 1 : 0], n[nstreams > 1 ? 1 : 0], "Huffman"),
                        BackwardBits(src[nstreams > 2 ? 2 : 0], n[nstreams > 2 ? 2 : 0], "Huffman"),
                        BackwardBits(src[nstreams > 3 ? 3 : 0], n[nstreams > 3 ? 3 : 0], "Huffman")};
  size_t done = 0;
  if (nstreams == 4) {
    // Four symbols a stream (at most 44 bits) from one 64-bit load while
    // 57 bits lie below each read position; the four chains in scalars,
    // since `out` may alias anything.
    int64_t p0 = in[0].pos, p1 = in[1].pos, p2 = in[2].pos, p3 = in[3].pos;
    uint8_t *o0 = out[0], *o1 = out[1], *o2 = out[2], *o3 = out[3];
    const size_t least = count[3] < count[0] ? count[3] : count[0];
    const int shift = 64 - mb;
#define STRAPS_LOAD(x, p, src)                 \
    do {                                       \
      int64_t b = (p + 7) / 8 - 8;             \
      uint64_t w;                              \
      memcpy(&w, src + b, 8);                  \
      x = w << (8 * b + 64 - p);               \
    } while (0)
#define STRAPS_SYM(x, p, o)                    \
    do {                                       \
      uint16_t e = dt[x >> shift];             \
      *o++ = uint8_t(e);                       \
      x <<= e >> 8;                            \
      p -= e >> 8;                             \
    } while (0)
    while (done + 4 <= least && p0 >= 57 && p1 >= 57 && p2 >= 57 && p3 >= 57) {
      uint64_t x0, x1, x2, x3;
      STRAPS_LOAD(x0, p0, src[0]);
      STRAPS_LOAD(x1, p1, src[1]);
      STRAPS_LOAD(x2, p2, src[2]);
      STRAPS_LOAD(x3, p3, src[3]);
      for (int k = 0; k < 4; ++k) {
        STRAPS_SYM(x0, p0, o0);
        STRAPS_SYM(x1, p1, o1);
        STRAPS_SYM(x2, p2, o2);
        STRAPS_SYM(x3, p3, o3);
      }
      done += 4;
    }
#undef STRAPS_LOAD
#undef STRAPS_SYM
    in[0].pos = p0; in[1].pos = p1; in[2].pos = p2; in[3].pos = p3;
  }
  for (int s = 0; s < nstreams; ++s) {
    for (size_t i = done; i < count[s]; ++i) {
      uint16_t e = dt[in[s].peek(mb)];
      out[s][i] = uint8_t(e);
      in[s].pos -= e >> 8;
      if (in[s].pos < 0) fail("Huffman stream ends before its literals");
    }
    if (in[s].pos != 0) fail("Huffman stream has bits left after its literals");
  }
}

// ---------------------------------------------------------------- frames
const uint32_t LL_BASE[36] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                              4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37,
                              39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
                              4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7,
                             8, 9, 10, 11, 12, 13, 14, 15, 16};
const int LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  Huffman huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
};

struct Decoder {
  std::vector<uint8_t> out;
  uint64_t counts[kNumCounts] = {0};
  FseTable ll_default, of_default, ml_default;
  std::vector<uint8_t> literals;

  Decoder() {
    build_fse(std::vector<int>(LL_DEFAULT, LL_DEFAULT + 36), 6, ll_default, "literal lengths");
    build_fse(std::vector<int>(ML_DEFAULT, ML_DEFAULT + 53), 6, ml_default, "match lengths");
    build_fse(std::vector<int>(OF_DEFAULT, OF_DEFAULT + 29), 5, of_default, "offsets");
  }

  // Literals section -> `literals`; returns the bytes used.
  size_t read_literals(const uint8_t* src, size_t n, FrameState& fs, size_t block_max) {
    if (n < 1) fail("literals section is missing");
    int type = src[0] & 3, size_format = (src[0] >> 2) & 3;
    if (type <= 1) {
      size_t regen, hdr;
      if ((size_format & 1) == 0) { regen = src[0] >> 3; hdr = 1; }
      else if (size_format == 1) {
        if (n < 2) fail("literals header is truncated");
        regen = (src[0] >> 4) + (size_t(src[1]) << 4); hdr = 2;
      } else {
        if (n < 3) fail("literals header is truncated");
        regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12); hdr = 3;
      }
      if (regen > block_max) fail("literals larger than the block maximum");
      literals.resize(regen);
      if (type == 0) {
        counts[kRawLiterals]++;
        if (hdr + regen > n) fail("raw literals run past the block");
        if (regen) memcpy(literals.data(), src + hdr, regen);
        return hdr + regen;
      }
      counts[kRleLiterals]++;
      if (hdr + 1 > n) fail("RLE literals run past the block");
      memset(literals.data(), src[hdr], regen);
      return hdr + 1;
    }
    size_t hdr, regen, comp;
    int streams = size_format == 0 ? 1 : 4;
    if (size_format <= 1) {
      if (n < 3) fail("literals header is truncated");
      uint32_t v = uint32_t(src[0]) | uint32_t(src[1]) << 8 | uint32_t(src[2]) << 16;
      hdr = 3; regen = (v >> 4) & 1023; comp = (v >> 14) & 1023;
    } else if (size_format == 2) {
      if (n < 4) fail("literals header is truncated");
      uint32_t v = read_le32(src);
      hdr = 4; regen = (v >> 4) & 16383; comp = (v >> 18) & 16383;
    } else {
      if (n < 5) fail("literals header is truncated");
      uint64_t v = uint64_t(read_le32(src)) | uint64_t(src[4]) << 32;
      hdr = 5; regen = (v >> 4) & 262143; comp = (v >> 22) & 262143;
    }
    if (regen > block_max) fail("literals larger than the block maximum");
    if (hdr + comp > n) fail("compressed literals run past the block");
    const uint8_t* p = src + hdr;
    size_t left = comp;
    if (type == 2) {
      counts[kHuffmanLiterals]++;
      size_t used = read_huffman(p, left, fs.huf);
      fs.have_huf = true;
      p += used; left -= used;
    } else {
      counts[kTreelessLiterals]++;
      if (!fs.have_huf) fail("treeless literals with no earlier Huffman table in the frame");
    }
    literals.resize(regen);
    if (streams == 1) {
      counts[kHuffman1Stream]++;
      const uint8_t* src1[1] = {p};
      uint8_t* out1[1] = {literals.data()};
      huffman_streams(fs.huf, 1, src1, &left, out1, &regen);
    } else {
      counts[kHuffman4Streams]++;
      if (left < 6) fail("Huffman jump table is truncated");
      size_t s1 = p[0] | p[1] << 8, s2 = p[2] | p[3] << 8, s3 = p[4] | p[5] << 8;
      if (6 + s1 + s2 + s3 > left) fail("Huffman jump table points past the literals");
      size_t s4 = left - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("four Huffman streams for too few literals");
      const uint8_t* q = p + 6;
      const uint8_t* src4[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
      size_t n4[4] = {s1, s2, s3, s4};
      uint8_t* out4[4] = {literals.data(), literals.data() + seg, literals.data() + 2 * seg,
                          literals.data() + 3 * seg};
      size_t c4[4] = {seg, seg, seg, regen - 3 * seg};
      huffman_streams(fs.huf, 4, src4, n4, out4, c4);
    }
    return hdr + comp;
  }

  size_t read_table(const uint8_t* src, size_t n, int mode, FseTable& table, bool& have,
                    const FseTable& preset, int max_log, int max_symbol, const char* what) {
    switch (mode) {
      case 0:
        counts[kSeqPredefined]++;
        table = preset; have = true;
        return 0;
      case 1:
        counts[kSeqRle]++;
        if (n < 1) fail(std::string(what) + " RLE symbol is missing");
        if (src[0] > max_symbol) fail(std::string(what) + " RLE symbol out of range");
        rle_fse(src[0], table); have = true;
        return 1;
      case 2: {
        counts[kSeqFse]++;
        std::vector<int> norm;
        int log;
        size_t used = read_fse_counts(src, n, max_log, max_symbol, norm, log, what);
        build_fse(norm, log, table, what);
        have = true;
        return used;
      }
      default:
        counts[kSeqRepeat]++;
        if (!have) fail(std::string(what) + " repeat mode with no earlier table in the frame");
        return 0;
    }
  }

  void compressed_block(const uint8_t* src, size_t n, FrameState& fs, size_t frame_start,
                        size_t block_max) {
    size_t used = read_literals(src, n, fs, block_max);
    src += used; n -= used;
    if (n < 1) fail("sequences section is missing");
    size_t nseq;
    size_t hdr;
    if (src[0] < 128) { nseq = src[0]; hdr = 1; }
    else if (src[0] < 255) {
      if (n < 2) fail("sequence count is truncated");
      nseq = ((size_t(src[0]) - 128) << 8) + src[1]; hdr = 2;
    } else {
      if (n < 3) fail("sequence count is truncated");
      nseq = src[1] + (size_t(src[2]) << 8) + 0x7F00; hdr = 3;
    }
    src += hdr; n -= hdr;
    size_t block_start = out.size();
    if (nseq == 0) {
      if (n != 0) fail("bytes after a block with no sequences");
      out.insert(out.end(), literals.begin(), literals.end());
      return;
    }
    if (n < 1) fail("sequence modes are missing");
    uint8_t modes = src[0];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    src += 1; n -= 1;
    size_t u;
    u = read_table(src, n, modes >> 6, fs.ll, fs.have_ll, ll_default, 9, 35, "literal lengths");
    src += u; n -= u;
    u = read_table(src, n, (modes >> 4) & 3, fs.of, fs.have_of, of_default, 8, 31, "offsets");
    src += u; n -= u;
    u = read_table(src, n, (modes >> 2) & 3, fs.ml, fs.have_ml, ml_default, 9, 52, "match lengths");
    src += u; n -= u;
    BackwardBits in(src, n, "sequences");
    uint32_t sll = uint32_t(in.read(fs.ll.log)), sof = uint32_t(in.read(fs.of.log)),
             sml = uint32_t(in.read(fs.ml.log));
    size_t lit = 0;
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry& ell = fs.ll.t[sll];
      const FseEntry& eof = fs.of.t[sof];
      const FseEntry& eml = fs.ml.t[sml];
      int ofc = eof.symbol, llc = ell.symbol, mlc = eml.symbol;
      if (llc > 35 || mlc > 52 || ofc > 31) fail("sequence code out of range");
      uint32_t of_value = (1u << ofc) + uint32_t(in.read(ofc));
      uint32_t ml = ML_BASE[mlc] + uint32_t(in.read(ML_BITS[mlc]));
      uint32_t ll = LL_BASE[llc] + uint32_t(in.read(LL_BITS[llc]));
      uint32_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        fs.rep[2] = fs.rep[1]; fs.rep[1] = fs.rep[0]; fs.rep[0] = offset;
      } else {
        uint32_t idx = of_value - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = fs.rep[0];
        } else {
          offset = idx == 3 ? fs.rep[0] - 1 : fs.rep[idx];
          if (idx > 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = ell.base + uint32_t(in.read(ell.nbits));
        sml = eml.base + uint32_t(in.read(eml.nbits));
        sof = eof.base + uint32_t(in.read(eof.nbits));
      }
      if (in.pos < 0) fail("sequences bitstream ends before its sequences");
      if (ll > literals.size() - lit) fail("sequence takes more literals than the block holds");
      out.insert(out.end(), literals.begin() + lit, literals.begin() + lit + ll);
      lit += ll;
      if (offset == 0 || offset > out.size() - frame_start)
        fail("match offset reaches before the start of the frame");
      if (out.size() - block_start + ml > block_max) fail("block larger than the block maximum");
      size_t from = out.size() - offset;
      out.resize(out.size() + ml);
      uint8_t* o = out.data();
      size_t to = out.size() - ml;
      if (offset >= ml) memcpy(o + to, o + from, ml);
      else for (uint32_t k = 0; k < ml; ++k) o[to + k] = o[from + k];
    }
    if (in.pos != 0) fail("sequences bitstream has bits left after its sequences");
    out.insert(out.end(), literals.begin() + lit, literals.end());
    if (out.size() - block_start > block_max) fail("block larger than the block maximum");
  }

  // One frame at `src`; returns the bytes it used.
  size_t frame(const uint8_t* src, size_t n) {
    if (n < 4) fail("truncated frame magic");
    uint32_t magic = read_le32(src);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n < 8) fail("truncated skippable frame header");
      uint64_t len = read_le32(src + 4);
      if (8 + len > n) fail("skippable frame runs past the input");
      counts[kSkippableFrames]++;
      return size_t(8 + len);
    }
    if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic)");
    counts[kFrames]++;
    size_t p = 4;
    if (p >= n) fail("truncated frame header");
    uint8_t fhd = src[p++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
        dict_flag = fhd & 3;
    if (fhd & 8) fail("reserved bit set in the frame header");
    uint64_t window = 0;
    if (!single) {
      if (p >= n) fail("truncated frame header");
      uint8_t wd = src[p++];
      int wlog = 10 + (wd >> 3);
      uint64_t base = 1ULL << wlog;
      window = base + (base / 8) * (wd & 7);
    }
    static const int dict_bytes[4] = {0, 1, 2, 4};
    if (p + dict_bytes[dict_flag] > n) fail("truncated frame header");
    uint32_t dict = 0;
    for (int i = 0; i < dict_bytes[dict_flag]; ++i) dict |= uint32_t(src[p + i]) << (8 * i);
    p += dict_bytes[dict_flag];
    if (dict != 0) fail("frame needs dictionary " + std::to_string(dict) + " (dictionaries are not supported)");
    static const int fcs_bytes[4] = {0, 2, 4, 8};
    int fb = (fcs_flag == 0 && single) ? 1 : fcs_bytes[fcs_flag];
    if (p + fb > n) fail("truncated frame header");
    bool has_size = fb > 0;
    uint64_t content = 0;
    for (int i = 0; i < fb; ++i) content |= uint64_t(src[p + i]) << (8 * i);
    if (fb == 2) content += 256;
    p += fb;
    if (single) window = content;
    size_t block_max = size_t(window < (128u << 10) ? window : (128u << 10));
    FrameState fs;
    size_t frame_start = out.size();
    if (has_size && content > (uint64_t(1) << 40)) fail("frame content size is implausible");
    if (has_size) {   // a frame's size field is not trusted beyond 64x its input
      uint64_t cap = 64 * uint64_t(n) + (1u << 20);
      out.reserve(frame_start + size_t(content < cap ? content : cap));
    }
    for (;;) {
      if (p + 3 > n) fail("truncated block header");
      uint32_t bh = uint32_t(src[p]) | uint32_t(src[p + 1]) << 8 | uint32_t(src[p + 2]) << 16;
      p += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) fail("reserved block type");
      if (type == 1) {
        counts[kRleBlocks]++;
        if (size > block_max) fail("block larger than the block maximum");
        if (p + 1 > n) fail("RLE block runs past the input");
        out.insert(out.end(), size, src[p]);
        p += 1;
      } else {
        if (size > block_max) fail("block larger than the block maximum");
        if (p + size > n) fail("block runs past the input (truncated frame)");
        if (type == 0) {
          counts[kRawBlocks]++;
          out.insert(out.end(), src + p, src + p + size);
        } else {
          counts[kCompressedBlocks]++;
          compressed_block(src + p, size, fs, frame_start, block_max);
        }
        p += size;
      }
      if (has_size && out.size() - frame_start > content)
        fail("frame decodes to more than its content size");
      if (last) break;
    }
    if (has_size && out.size() - frame_start != content)
      fail("frame decodes to " + std::to_string(out.size() - frame_start) +
           " bytes, not its content size " + std::to_string(content));
    if (checksum) {
      if (p + 4 > n) fail("truncated content checksum");
      uint32_t want = read_le32(src + p);
      uint32_t got = uint32_t(xxh64(out.data() + frame_start, out.size() - frame_start));
      if (want != got) fail("content checksum mismatch");
      counts[kChecksums]++;
      p += 4;
    }
    return p;
  }
};

struct CrcTable {
  uint32_t t[8][256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int k = 1; k < 8; ++k) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

}  // namespace

extern "C" {

const char* sz_count_names() { return kCountNames; }
int sz_num_counts() { return kNumCounts; }

// Decompress `n` bytes at `src` (`hint`: the expected output size, or 0).
// On success returns a handle to the output (sz_data, sz_size; release with
// sz_free) and adds to `counts` (sz_num_counts entries; may be NULL); on
// failure returns NULL with the reason in `err`.
void* sz_decompress(const uint8_t* src, size_t n, size_t hint, uint64_t* counts, char* err,
                    size_t err_len) {
  try {
    Decoder d;
    if (n == 0) fail("empty input holds no frame");
    d.out.reserve(hint);
    for (size_t p = 0; p < n;) p += d.frame(src + p, n - p);
    if (counts)
      for (int i = 0; i < kNumCounts; ++i) counts[i] += d.counts[i];
    return new std::vector<uint8_t>(std::move(d.out));
  } catch (const std::exception& e) {
    snprintf(err, err_len, "%s", e.what());
    return nullptr;
  }
}

const uint8_t* sz_data(void* h) { return static_cast<std::vector<uint8_t>*>(h)->data(); }
size_t sz_size(void* h) { return static_cast<std::vector<uint8_t>*>(h)->size(); }
void sz_free(void* h) { delete static_cast<std::vector<uint8_t>*>(h); }

uint32_t sz_crc32c(const uint8_t* p, size_t n) {
  static const CrcTable table;
  const auto& t = table.t;
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {
    uint32_t lo = read_le32(p) ^ c, hi = read_le32(p + 4);
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
        t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; n; --n, ++p) c = (c >> 8) ^ t[0][(c ^ *p) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
