// straps_io: host IO of the predict and training paths, the PyTorch port's
// own copy of the JAX package's native reader (same entry points, same
// shuffle), bound with ctypes by straps_tpu_torch/data/native_io.py.
//
//   * si_open_npy / si_close_npy: a .npy file memory-mapped read-only, its
//     header parsed (dtype kind, item size, byte order, C or Fortran order,
//     shape).
//   * si_load_batch_f32: many same-sized .npy files read into one
//     contiguous float32 batch by a pool of threads, each file converted
//     from its own dtype (float32/64, signed and unsigned integers of 1-8
//     bytes, bool; either byte order; C or Fortran order) as numpy's
//     astype(float32) converts it.
//   * si_shuffled_indices: the deterministic xorshift64* Fisher-Yates
//     permutation of [0, n).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct NpyInfo {
  void* data;         // pointer to the first element (inside the mmap)
  void* map_base;     // mmap base (for munmap)
  int64_t map_len;    // mmap length
  int64_t num_elems;  // total element count
  int32_t word_size;  // bytes per element
  int32_t ndim;
  int64_t shape[8];
  char dtype_char;    // 'f' float, 'i' int, 'u' uint, 'b' bool
  char byte_order;    // '<' little, '>' big, '|' not applicable
  int32_t fortran_order;
};

// Parse a v1.x/v2.x/v3.x .npy header. Returns 0 on success.
static int parse_npy_header(const char* buf, int64_t len, NpyInfo* info,
                            int64_t* data_offset) {
  if (len < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return -1;
  const uint8_t major = static_cast<uint8_t>(buf[6]);
  int64_t header_len, header_off;
  if (major == 1) {
    header_len = static_cast<uint16_t>(
        static_cast<uint8_t>(buf[8]) | (static_cast<uint8_t>(buf[9]) << 8));
    header_off = 10;
  } else {
    if (len < 12) return -2;
    uint32_t hl;
    memcpy(&hl, buf + 8, 4);
    header_len = hl;
    header_off = 12;
  }
  if (header_off + header_len > len) return -2;
  std::string header(buf + header_off, static_cast<size_t>(header_len));
  *data_offset = header_off + header_len;

  // descr: e.g. '<f4', '<i8', '|b1'
  size_t dp = header.find("'descr'");
  if (dp == std::string::npos) return -3;
  size_t q1 = header.find('\'', dp + 7);
  size_t q2 = header.find('\'', q1 + 1);
  if (q1 == std::string::npos || q2 == std::string::npos) return -3;
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr.size() < 3) return -3;
  info->byte_order = descr[0] == '=' ? '<' : descr[0];
  if (info->byte_order != '<' && info->byte_order != '>' && info->byte_order != '|') return -3;
  info->dtype_char = descr[1];
  info->word_size = atoi(descr.c_str() + 2);
  if (info->word_size <= 0) return -3;

  info->fortran_order = header.find("'fortran_order': True") != std::string::npos;

  size_t sp = header.find("'shape'");
  if (sp == std::string::npos) return -3;
  size_t p1 = header.find('(', sp);
  size_t p2 = header.find(')', p1);
  if (p1 == std::string::npos || p2 == std::string::npos) return -3;
  std::string shape_s = header.substr(p1 + 1, p2 - p1 - 1);
  info->ndim = 0;
  info->num_elems = 1;
  const char* s = shape_s.c_str();
  char* end = nullptr;
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    int64_t dim = strtoll(s, &end, 10);
    if (end == s) break;
    if (info->ndim == 8) return -3;
    info->shape[info->ndim++] = dim;
    info->num_elems *= dim;
    s = end;
  }
  if (info->ndim == 0) {  // scalar
    info->shape[0] = 1;
    info->ndim = 1;
  }
  if (*data_offset + info->num_elems * info->word_size > len) return -6;  // cut short
  return 0;
}

// Memory-map an .npy file. Returns 0 on success.
int si_open_npy(const char* path, NpyInfo* info) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -10;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -11;
  }
  if (st.st_size == 0) {
    close(fd);
    return -1;
  }
  void* base = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                    MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -12;
  int64_t data_off = 0;
  int rc = parse_npy_header(static_cast<const char*>(base), st.st_size, info,
                            &data_off);
  if (rc != 0) {
    munmap(base, static_cast<size_t>(st.st_size));
    return rc;
  }
  info->map_base = base;
  info->map_len = st.st_size;
  info->data = static_cast<char*>(base) + data_off;
  return 0;
}

void si_close_npy(NpyInfo* info) {
  if (info->map_base) {
    munmap(info->map_base, static_cast<size_t>(info->map_len));
    info->map_base = nullptr;
    info->data = nullptr;
  }
}

}  // extern "C"

namespace {

template <typename T>
float load_as_float(const uint8_t* p, bool swap) {
  uint8_t b[sizeof(T)];
  memcpy(b, p, sizeof(T));
  if (swap)
    for (size_t i = 0; i < sizeof(T) / 2; ++i) std::swap(b[i], b[sizeof(T) - 1 - i]);
  T v;
  memcpy(&v, b, sizeof(T));
  return static_cast<float>(v);
}

using Converter = float (*)(const uint8_t*, bool);

Converter converter(char kind, int size) {
  switch (kind) {
    case 'f':
      if (size == 4) return load_as_float<float>;
      if (size == 8) return load_as_float<double>;
      return nullptr;
    case 'i':
      if (size == 1) return load_as_float<int8_t>;
      if (size == 2) return load_as_float<int16_t>;
      if (size == 4) return load_as_float<int32_t>;
      if (size == 8) return load_as_float<int64_t>;
      return nullptr;
    case 'u':
      if (size == 1) return load_as_float<uint8_t>;
      if (size == 2) return load_as_float<uint16_t>;
      if (size == 4) return load_as_float<uint32_t>;
      if (size == 8) return load_as_float<uint64_t>;
      return nullptr;
    case 'b':
      if (size == 1)
        return [](const uint8_t* p, bool) -> float { return *p ? 1.0f : 0.0f; };
      return nullptr;
    default:
      return nullptr;
  }
}

// One file's elements as float32 in C order.
int convert_file(const NpyInfo& info, float* out) {
  Converter cv = converter(info.dtype_char, info.word_size);
  if (!cv) return -21;
  const uint8_t* src = static_cast<const uint8_t*>(info.data);
  const bool swap = info.byte_order == '>' && info.word_size > 1;
  const int64_t n = info.num_elems;
  const int64_t ws = info.word_size;
  if (info.dtype_char == 'f' && ws == 4 && !swap && (!info.fortran_order || info.ndim < 2)) {
    memcpy(out, src, static_cast<size_t>(n) * 4);
    return 0;
  }
  if (!info.fortran_order || info.ndim < 2) {
    for (int64_t i = 0; i < n; ++i) out[i] = cv(src + i * ws, swap);
    return 0;
  }
  // Fortran order: the element at C index (i0, ..., ik) lies at
  // sum_j i_j * prod_{l < j} shape_l.
  int64_t fstride[8];
  int64_t acc = 1;
  for (int d = 0; d < info.ndim; ++d) {
    fstride[d] = acc;
    acc *= info.shape[d];
  }
  int64_t idx[8] = {0};
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    out[i] = cv(src + off * ws, swap);
    for (int d = info.ndim - 1; d >= 0; --d) {
      if (++idx[d] < info.shape[d]) {
        off += fstride[d];
        break;
      }
      off -= fstride[d] * (info.shape[d] - 1);
      idx[d] = 0;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Load `n` .npy files of `elems_per_item` elements each into one
// contiguous float32 batch, parallelised over `threads` workers. paths:
// array of C strings. Returns 0 on success, else the first error code met,
// with the index of its file in `*failed` (-20: another element count,
// -21: a dtype that is not read).
int si_load_batch_f32(const char** paths, int64_t n, float* out,
                      int64_t elems_per_item, int32_t threads, int64_t* failed) {
  if (threads < 1) threads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  std::atomic<int64_t> bad(-1);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      NpyInfo info{};
      int rc = si_open_npy(paths[i], &info);
      if (rc == 0) {
        rc = info.num_elems != elems_per_item ? -20 : convert_file(info, out + i * elems_per_item);
        si_close_npy(&info);
      }
      if (rc != 0) {
        int expected = 0;
        if (err.compare_exchange_strong(expected, rc)) bad.store(i);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  const int tn = static_cast<int>(threads < n ? threads : n);
  pool.reserve(static_cast<size_t>(tn));
  for (int t = 0; t < tn; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  *failed = bad.load();
  return err.load();
}

// Deterministic Fisher-Yates shuffle of [0, n) with xorshift64* RNG.
void si_shuffled_indices(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t x = seed ? seed : 0x9E3779B97F4A7C15ULL;
  for (int64_t i = n - 1; i > 0; --i) {
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    uint64_t r = x * 0x2545F4914F6CDD1DULL;
    int64_t j = static_cast<int64_t>(r % static_cast<uint64_t>(i + 1));
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

}  // extern "C"
