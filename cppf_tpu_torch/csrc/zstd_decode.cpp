// A Zstandard decoder (RFC 8878), written for reading orbax checkpoints:
// the OCDBT nodes and the zarr chunks of a checkpoint are zstd frames.
//
// Host code, not a CUDA kernel: a checkpoint is read once, before any pose,
// and its ~120 MB decode on one host thread takes well under a second.  It
// compiles with g++ at first use (cppf_tpu_torch/train/orbax.py) and is bound
// by ctypes through three C functions:
//
//   int64_t cppf_zstd_decode(src, n, max_out, &out, err, errcap)
//       every frame of src[0:n] back to back (skippable frames skipped),
//       into a buffer it allocates; returns the decoded length, or -1 with
//       the reason in err.  More than max_out bytes of output is an error.
//   void cppf_zstd_release(out)      frees that buffer.
//   uint32_t cppf_crc32c(p, n)       CRC-32C (Castagnoli), the OCDBT checksum.
//
// Covered: raw, RLE and compressed blocks; raw, RLE, Huffman (1 and 4
// streams) and treeless literals; Huffman weights FSE-coded or direct;
// sequences in predefined, RLE, FSE and repeat modes; repeat offsets; frames
// with and without a content size; the XXH64 content checksum.  Not covered:
// dictionaries (a frame that names one is refused).  Every read and write is
// bounds-checked: corrupt or truncated input gives an error, never a crash.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <new>
#include <stdexcept>
#include <string>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "little-endian host expected");

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Corrupt(msg); }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

inline uint64_t load_le(const uint8_t* p, size_t k) {  // k <= 8
  uint64_t v = 0;
  std::memcpy(&v, p, k);
  return v;
}

// ---- XXH64 ---------------------------------------------------------------

constexpr uint64_t kP1 = 11400714785074694791ULL, kP2 = 14029467366897019727ULL,
                   kP3 = 1609587929392839161ULL, kP4 = 9650029242287828579ULL,
                   kP5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * kP2, 31) * kP1; }
inline uint64_t xmerge(uint64_t h, uint64_t v) { return (h ^ xround(0, v)) * kP1 + kP4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
    do {
      v1 = xround(v1, load_le(p, 8));
      v2 = xround(v2, load_le(p + 8, 8));
      v3 = xround(v3, load_le(p + 16, 8));
      v4 = xround(v4, load_le(p + 24, 8));
      p += 32;
    } while (end - p >= 32);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = kP5;
  }
  h += len;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, load_le(p, 8)), 27) * kP1 + kP4;
  if (end - p >= 4) {
    h = rotl(h ^ (load_le(p, 4) * kP1), 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * kP5), 11) * kP1;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// ---- output buffer -------------------------------------------------------

struct Out {
  uint8_t* p = nullptr;
  size_t n = 0, cap = 0, max;
  explicit Out(size_t max_out) : max(max_out) {}
  ~Out() { std::free(p); }
  void reserve(size_t want) {
    if (want <= cap) return;
    if (want > max) fail("decoded size exceeds the limit of " + std::to_string(max) + " bytes");
    size_t c = cap ? cap : 4096;
    while (c < want) c = c > max / 2 ? max : 2 * c;
    auto* q = static_cast<uint8_t*>(std::realloc(p, c));
    if (!q) throw std::bad_alloc();
    p = q;
    cap = c;
  }
  uint8_t* extend(size_t k) {  // room for k more bytes, returns where they go
    if (k > max - n) fail("decoded size exceeds the limit of " + std::to_string(max) + " bytes");
    reserve(n + k);
    uint8_t* at = p + n;
    n += k;
    return at;
  }
};

// ---- bit readers ---------------------------------------------------------

// Forward, least significant bit first (FSE table descriptions).  Bits past
// the end read as zeros; the caller checks how many bytes were consumed.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bit position
  FwdBits(const uint8_t* src, size_t len) : p(src), n(len) {}
  uint32_t peek(int k) const {  // k <= 24
    size_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte < n) v = load_le(p + byte, n - byte < 8 ? n - byte : 8);
    return static_cast<uint32_t>((v >> (pos & 7)) & ((1ULL << k) - 1));
  }
  void skip(int k) { pos += k; }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// Backward: the stream is read from its last bit towards its first, after
// the end marker (the highest set bit of the last byte).  ``left`` counts
// the bits still unread; reading past the start gives zeros and drives
// ``left`` negative, which callers treat as overflow.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t left = 0;
  BackBits() = default;
  BackBits(const uint8_t* src, size_t len) : p(src), n(len) {
    if (len == 0) fail("empty bitstream");
    uint8_t last = src[len - 1];
    if (last == 0) fail("bitstream without its end marker");
    left = static_cast<int64_t>(len - 1) * 8 + highbit(last);
  }
  uint64_t bits_at(int64_t lo, int k) const {  // bits [lo, lo + k), lo >= 0, k <= 56
    size_t byte = static_cast<size_t>(lo >> 3);
    uint64_t w = byte + 8 <= n ? load_le(p + byte, 8) : load_le(p + byte, n - byte);
    return (w >> (lo & 7)) & ((1ULL << k) - 1);
  }
  uint64_t peek(int k) const {  // the next k bits, first read as most significant
    if (k == 0 || left <= 0) return 0;
    int64_t lo = left - k;
    if (lo >= 0) return bits_at(lo, k);
    return bits_at(0, static_cast<int>(left)) << (-lo);
  }
  uint64_t read(int k) {
    uint64_t v = peek(k);
    left -= k;
    return v;
  }
};

// ---- FSE -----------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = -1;  // -1: no table yet
  FseEntry e[1 << 9];
};

// Table description (RFC 8878 4.1.1) → normalized counts; returns bytes used.
size_t read_ncount(const uint8_t* src, size_t n, int max_log, int max_symbol, int16_t* norm,
                   int* log_out, int* nsym_out) {
  if (n == 0) fail("FSE table description missing");
  FwdBits bits(src, n);
  int log = static_cast<int>(bits.peek(4)) + 5;
  bits.skip(4);
  if (log > max_log) fail("FSE accuracy log " + std::to_string(log) + " above its maximum");
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, sym = 0;
  bool previous0 = false;
  while (remaining > 1) {
    if (previous0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = bits.peek(2);
        bits.skip(2);
        n0 += static_cast<int>(r);
        if (r != 3) break;
        if (n0 > max_symbol + 1) fail("FSE zero run past the last symbol");
      }
      if (n0 > max_symbol) fail("FSE zero run past the last symbol");
      while (sym < n0) norm[sym++] = 0;
    }
    if (sym > max_symbol) fail("FSE table description names too many symbols");
    int max = (2 * threshold - 1) - remaining;
    uint32_t v = bits.peek(nb);
    int count;
    if (static_cast<int>(v & (threshold - 1)) < max) {
      count = static_cast<int>(v & (threshold - 1));
      bits.skip(nb - 1);
    } else {
      count = static_cast<int>(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bits.skip(nb);
    }
    --count;  // stored as probability + 1
    remaining -= count < 0 ? -count : count;
    norm[sym++] = static_cast<int16_t>(count);
    previous0 = count == 0;
    if (remaining < 1) fail("FSE probabilities overrun their total");
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE probabilities do not sum to their total");
  if (bits.bytes_used() > n) fail("FSE table description truncated");
  *log_out = log;
  *nsym_out = sym;
  return bits.bytes_used();
}

void build_fse(FseTable& t, const int16_t* norm, int nsym, int log) {
  int size = 1 << log, high = size - 1;
  uint16_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.e[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.e[pos].symbol = static_cast<uint16_t>(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table spread did not close");
  for (int u = 0; u < size; ++u) {
    uint16_t s = t.e[u].symbol;
    uint32_t ns = next[s]++;
    int nb = log - highbit(ns);
    t.e[u].nbits = static_cast<uint8_t>(nb);
    t.e[u].base = static_cast<uint16_t>((ns << nb) - size);
  }
  t.log = log;
}

void rle_fse(FseTable& t, uint8_t symbol) {
  t.e[0] = FseEntry{symbol, 0, 0};
  t.log = 0;
}

// ---- Huffman -------------------------------------------------------------

struct HufTable {
  int max_bits = 0;     // 0: no table yet
  uint16_t e[1 << 11];  // symbol | code length << 8, indexed by the next max_bits bits
};

// FSE-coded Huffman weights: two states over one table, alternating, until
// the bitstream overflows (RFC 8878 4.2.1.2).
int decode_weights_fse(const uint8_t* src, size_t n, uint8_t* w) {
  int16_t norm[256];
  int log, nsym;
  size_t used = read_ncount(src, n, 6, 15, norm, &log, &nsym);
  static thread_local FseTable t;
  build_fse(t, norm, nsym, log);
  BackBits bits(src + used, n - used);
  uint32_t s1 = static_cast<uint32_t>(bits.read(log)), s2 = static_cast<uint32_t>(bits.read(log));
  int k = 0;
  auto emit = [&](uint32_t& s, bool update) {
    if (k >= 255) fail("more than 255 Huffman weights");
    const FseEntry& e = t.e[s];
    w[k++] = static_cast<uint8_t>(e.symbol);
    if (update) s = e.base + static_cast<uint32_t>(bits.read(e.nbits));
  };
  for (;;) {
    emit(s1, true);
    if (bits.left < 0) {
      emit(s2, false);
      break;
    }
    emit(s2, true);
    if (bits.left < 0) {
      emit(s1, false);
      break;
    }
  }
  return k;
}

// Huffman tree description; returns bytes used.
size_t read_huffman(const uint8_t* src, size_t n, HufTable& h) {
  if (n == 0) fail("Huffman tree description missing");
  uint8_t w[256];
  int nw;
  size_t used;
  uint8_t head = src[0];
  if (head < 128) {
    if (head == 0 || 1 + static_cast<size_t>(head) > n) fail("Huffman weights truncated");
    nw = decode_weights_fse(src + 1, head, w);
    used = 1 + head;
  } else {
    nw = head - 127;
    used = 1 + (nw + 1) / 2;
    if (used > n) fail("Huffman weights truncated");
    for (int i = 0; i < nw; ++i) w[i] = i % 2 == 0 ? src[1 + i / 2] >> 4 : src[1 + i / 2] & 15;
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > 11) fail("Huffman weight above 11");
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights leave no power of two for the last symbol");
  w[nw++] = static_cast<uint8_t>(highbit(rest) + 1);
  // canonical codes: by weight, then by symbol, from the lowest weight up
  uint32_t pos = 0;
  for (int weight = 1; weight <= max_bits; ++weight) {
    for (int s = 0; s < nw; ++s) {
      if (w[s] != weight) continue;
      uint32_t len = 1u << (weight - 1);
      uint16_t entry = static_cast<uint16_t>(s | (max_bits + 1 - weight) << 8);
      for (uint32_t j = 0; j < len; ++j) h.e[pos + j] = entry;
      pos += len;
    }
  }
  if (pos != (1u << max_bits)) fail("Huffman table does not fill");
  h.max_bits = max_bits;
  return used;
}

// The rest of one stream from symbol ``i`` on; the stream must end exactly.
void huffman_finish(BackBits& bits, const HufTable& h, uint8_t* dst, size_t i, size_t count) {
  int mb = h.max_bits;
  uint64_t mask = (1ULL << mb) - 1;
  // four symbols (at most 44 bits) from each 56-bit window while one fits
  while (bits.left >= 56 && count - i >= 4) {
    int64_t start = bits.left - 56;
    uint64_t w = load_le(bits.p + (start >> 3), 8) >> (start & 7);
    int used = 0;
    for (int k = 0; k < 4; ++k, ++i) {
      uint16_t e = h.e[(w >> (56 - used - mb)) & mask];
      dst[i] = static_cast<uint8_t>(e);
      used += e >> 8;
    }
    bits.left -= used;
  }
  for (; i < count; ++i) {
    uint16_t e = h.e[bits.peek(mb)];
    dst[i] = static_cast<uint8_t>(e);
    bits.left -= e >> 8;
    if (bits.left < 0) fail("Huffman stream overrun");
  }
  if (bits.left != 0) fail("Huffman stream not fully consumed");
}

// Four streams in lockstep (independent chains of table lookups overlap),
// then each one's rest.
void huffman_four(const uint8_t* const* src, const size_t* n, const HufTable& h, uint8_t* dst,
                  size_t seg, size_t last) {
  BackBits b[4];
  for (int k = 0; k < 4; ++k) b[k] = BackBits(src[k], n[k]);
  int mb = h.max_bits;
  uint64_t mask = (1ULL << mb) - 1;
  size_t i = 0, common = last < seg ? last : seg;
  while (i + 4 <= common && b[0].left >= 56 && b[1].left >= 56 && b[2].left >= 56 &&
         b[3].left >= 56) {
    uint64_t w[4];
    int used[4];
    for (int k = 0; k < 4; ++k) {
      int64_t start = b[k].left - 56;
      w[k] = load_le(b[k].p + (start >> 3), 8) >> (start & 7);
      used[k] = 0;
    }
    for (int j = 0; j < 4; ++j) {
      for (int k = 0; k < 4; ++k) {
        uint16_t e = h.e[(w[k] >> (56 - used[k] - mb)) & mask];
        dst[k * seg + i + j] = static_cast<uint8_t>(e);
        used[k] += e >> 8;
      }
    }
    for (int k = 0; k < 4; ++k) b[k].left -= used[k];
    i += 4;
  }
  for (int k = 0; k < 4; ++k) huffman_finish(b[k], h, dst + k * seg, i, k < 3 ? seg : last);
}

// ---- sequences -----------------------------------------------------------

constexpr uint32_t kLLBase[36] = {0,  1,  2,  3,  4,   5,   6,   7,   8,    9,    10,   11,
                                  12, 13, 14, 15, 16,  18,  20,  22,  24,   28,   32,   40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,   10,  11,  12,  13,   14,   15,  16,
                                  17, 18, 19, 20, 21, 22, 23,  24,  25,  26,  27,   28,   29,  30,
                                  31, 32, 33, 34, 35, 37, 39,  41,  43,  47,  51,   59,   67,  83,
                                  99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
  uint8_t lits[1 << 17];
};

// Literals section; returns bytes used, sets *lits / *nlits.
size_t read_literals(const uint8_t* src, size_t n, Frame& f, const uint8_t** lits, size_t* nlits,
                     size_t block_max) {
  if (n == 0) fail("literals section missing");
  int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  if (type <= 1) {  // raw or RLE
    size_t hsize, size;
    if ((fmt & 1) == 0) {
      hsize = 1;
      size = src[0] >> 3;
    } else if (fmt == 1) {
      hsize = 2;
      if (n < 2) fail("literals header truncated");
      size = (src[0] >> 4) | (static_cast<size_t>(src[1]) << 4);
    } else {
      hsize = 3;
      if (n < 3) fail("literals header truncated");
      size = (src[0] >> 4) | (static_cast<size_t>(src[1]) << 4) | (static_cast<size_t>(src[2]) << 12);
    }
    if (size > block_max) fail("literals larger than a block");
    if (type == 0) {
      if (hsize + size > n) fail("raw literals truncated");
      *lits = src + hsize;
      *nlits = size;
      return hsize + size;
    }
    if (hsize + 1 > n) fail("RLE literals truncated");
    std::memset(f.lits, src[hsize], size);
    *lits = f.lits;
    *nlits = size;
    return hsize + 1;
  }
  // Huffman (type 2) or treeless (type 3)
  size_t hsize = fmt <= 1 ? 3 : fmt == 2 ? 4 : 5;
  int field = fmt <= 1 ? 10 : fmt == 2 ? 14 : 18;
  if (n < hsize) fail("literals header truncated");
  uint64_t hv = load_le(src, hsize);
  size_t regen = (hv >> 4) & ((1u << field) - 1);
  size_t csize = (hv >> (4 + field)) & ((1u << field) - 1);
  bool four = fmt != 0;
  if (regen > block_max) fail("literals larger than a block");
  if (hsize + csize > n) fail("compressed literals truncated");
  const uint8_t* p = src + hsize;
  size_t left = csize;
  if (type == 2) {
    size_t used = read_huffman(p, left, f.huf);
    p += used;
    left -= used;
  } else if (f.huf.max_bits == 0) {
    fail("treeless literals with no earlier Huffman table");
  }
  if (!four) {
    BackBits bits(p, left);
    huffman_finish(bits, f.huf, f.lits, 0, regen);
  } else {
    if (left < 6) fail("Huffman jump table truncated");
    size_t s1 = load_le(p, 2), s2 = load_le(p + 2, 2), s3 = load_le(p + 4, 2);
    if (s1 + s2 + s3 > left - 6) fail("Huffman streams overrun the literals");
    size_t s4 = left - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("too few literals for four streams");
    const uint8_t* q[4] = {p + 6, p + 6 + s1, p + 6 + s1 + s2, p + 6 + s1 + s2 + s3};
    size_t sizes[4] = {s1, s2, s3, s4};
    huffman_four(q, sizes, f.huf, f.lits, seg, regen - 3 * seg);
  }
  *lits = f.lits;
  *nlits = regen;
  return hsize + csize;
}

// One table of the sequences section by its mode; returns bytes used.
size_t read_seq_table(const uint8_t* src, size_t n, int mode, FseTable& t, const int16_t* def,
                      int ndef, int def_log, int max_log, int max_symbol, const char* what) {
  switch (mode) {
    case 0:
      build_fse(t, def, ndef, def_log);
      return 0;
    case 1:
      if (n < 1) fail(std::string(what) + " RLE symbol missing");
      if (src[0] > max_symbol) fail(std::string(what) + " RLE symbol out of range");
      rle_fse(t, src[0]);
      return 1;
    case 2: {
      int16_t norm[256];
      int log, nsym;
      size_t used = read_ncount(src, n, max_log, max_symbol, norm, &log, &nsym);
      build_fse(t, norm, nsym, log);
      return used;
    }
    default:
      if (t.log < 0) fail(std::string(what) + " repeat mode with no earlier table");
      return 0;
  }
}

void copy_match(Out& out, size_t frame_start, size_t offset, size_t len) {
  if (offset == 0 || offset > out.n - frame_start) fail("match offset before the frame start");
  uint8_t* dst = out.extend(len);
  const uint8_t* from = dst - offset;
  if (offset >= len) {
    std::memcpy(dst, from, len);
  } else {
    for (size_t i = 0; i < len; ++i) dst[i] = from[i];
  }
}

void compressed_block(const uint8_t* src, size_t n, Frame& f, Out& out, size_t frame_start,
                      size_t block_max) {
  const uint8_t* lits;
  size_t nlits;
  size_t used = read_literals(src, n, f, &lits, &nlits, block_max);
  src += used;
  n -= used;
  if (n == 0) fail("sequences section missing");
  size_t nseq, hs;
  if (src[0] < 128) {
    nseq = src[0];
    hs = 1;
  } else if (src[0] < 255) {
    if (n < 2) fail("sequences header truncated");
    nseq = ((static_cast<size_t>(src[0]) - 128) << 8) + src[1];
    hs = 2;
  } else {
    if (n < 3) fail("sequences header truncated");
    nseq = src[1] + (static_cast<size_t>(src[2]) << 8) + 0x7F00;
    hs = 3;
  }
  size_t before = out.n;
  if (nseq == 0) {
    if (hs != n) fail("bytes after an empty sequences section");
    std::memcpy(out.extend(nlits), lits, nlits);
    if (out.n - before > block_max) fail("block decodes past its maximum size");
    return;
  }
  if (hs >= n) fail("sequences modes missing");
  uint8_t modes = src[hs];
  if (modes & 3) fail("reserved bits of the sequences modes set");
  src += hs + 1;
  n -= hs + 1;
  used = read_seq_table(src, n, modes >> 6, f.ll, kLLNorm, 36, 6, 9, 35, "literals length");
  src += used;
  n -= used;
  used = read_seq_table(src, n, (modes >> 4) & 3, f.of, kOFNorm, 29, 5, 8, 31, "offset");
  src += used;
  n -= used;
  used = read_seq_table(src, n, (modes >> 2) & 3, f.ml, kMLNorm, 53, 6, 9, 52, "match length");
  src += used;
  n -= used;

  BackBits bits(src, n);
  uint32_t sll = static_cast<uint32_t>(bits.read(f.ll.log));
  uint32_t sof = static_cast<uint32_t>(bits.read(f.of.log));
  uint32_t sml = static_cast<uint32_t>(bits.read(f.ml.log));
  size_t lpos = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry& el = f.ll.e[sll];
    const FseEntry& eo = f.of.e[sof];
    const FseEntry& em = f.ml.e[sml];
    uint32_t ofc = eo.symbol, mlc = em.symbol, llc = el.symbol;
    if (ofc > 31) fail("offset code above 31");
    if (mlc > 52 || llc > 35) fail("length code out of range");
    uint64_t ofv = (1ULL << ofc) + bits.read(ofc);
    size_t ml = kMLBase[mlc] + bits.read(kMLBits[mlc]);
    size_t ll = kLLBase[llc] + bits.read(kLLBits[llc]);
    size_t offset;
    if (ofv > 3) {
      offset = static_cast<size_t>(ofv - 3);
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = static_cast<uint32_t>(offset);
    } else {
      uint32_t idx = static_cast<uint32_t>(ofv) + (ll == 0 ? 1 : 0);
      if (idx == 1) {
        offset = f.rep[0];
      } else {
        offset = idx == 2 ? f.rep[1] : idx == 3 ? f.rep[2] : f.rep[0] - 1;
        if (idx != 2) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = static_cast<uint32_t>(offset);
      }
    }
    if (ll > nlits - lpos) fail("sequence takes more literals than there are");
    std::memcpy(out.extend(ll), lits + lpos, ll);
    lpos += ll;
    copy_match(out, frame_start, offset, ml);
    if (out.n - before > block_max) fail("block decodes past its maximum size");
    if (i + 1 < nseq) {
      sll = el.base + static_cast<uint32_t>(bits.read(el.nbits));
      sml = em.base + static_cast<uint32_t>(bits.read(em.nbits));
      sof = eo.base + static_cast<uint32_t>(bits.read(eo.nbits));
    }
    if (bits.left < 0) fail("sequences bitstream overrun");
  }
  if (bits.left != 0) fail("sequences bitstream not fully consumed");
  std::memcpy(out.extend(nlits - lpos), lits + lpos, nlits - lpos);
  if (out.n - before > block_max) fail("block decodes past its maximum size");
}

// One zstd frame at src; returns its length in bytes.
size_t decode_frame(const uint8_t* src, size_t n, Out& out, Frame& f) {
  if (n < 5) fail("frame header truncated");
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did = fhd & 3;
  if (fhd & 8) fail("reserved bit of the frame header set");
  size_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) fail("frame header truncated");
    uint8_t wd = src[pos++];
    uint64_t base = 1ULL << (10 + (wd >> 3));
    window = base + (base / 8) * (wd & 7);
  }
  static const int kDidSize[4] = {0, 1, 2, 4};
  if (pos + kDidSize[did] > n) fail("frame header truncated");
  if (did && load_le(src + pos, kDidSize[did]) != 0) fail("frame needs a dictionary");
  pos += kDidSize[did];
  int fcs_size = fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  bool has_fcs = fcs_size > 0;
  uint64_t fcs = 0;
  if (pos + fcs_size > n) fail("frame header truncated");
  if (has_fcs) {
    fcs = load_le(src + pos, fcs_size) + (fcs_size == 2 ? 256 : 0);
    pos += fcs_size;
  }
  if (single) window = fcs;
  size_t block_max = window < (1u << 17) ? static_cast<size_t>(window) : (1u << 17);
  size_t start = out.n;
  if (has_fcs) {
    if (fcs > out.max - out.n) fail("frame content size exceeds the limit");
    out.reserve(out.n + static_cast<size_t>(fcs));
  }
  f.huf.max_bits = 0;
  f.ll.log = f.of.log = f.ml.log = -1;
  f.rep[0] = 1;
  f.rep[1] = 4;
  f.rep[2] = 8;
  for (bool last = false; !last;) {
    if (pos + 3 > n) fail("block header truncated");
    uint32_t bh = static_cast<uint32_t>(load_le(src + pos, 3));
    pos += 3;
    last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (size > block_max) fail("block larger than its maximum size");
    if (type == 1) {  // RLE: one byte, repeated size times
      if (pos + 1 > n) fail("RLE block truncated");
      std::memset(out.extend(size), src[pos], size);
      pos += 1;
      continue;
    }
    if (pos + size > n) fail("block truncated");
    if (type == 0) {
      std::memcpy(out.extend(size), src + pos, size);
    } else {
      compressed_block(src + pos, size, f, out, start, block_max);
    }
    pos += size;
  }
  if (has_fcs && out.n - start != fcs) fail("frame decodes to other than its content size");
  if (checksum) {
    if (pos + 4 > n) fail("content checksum truncated");
    uint32_t want = static_cast<uint32_t>(load_le(src + pos, 4));
    if (static_cast<uint32_t>(xxh64(out.p + start, out.n - start)) != want)
      fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decode_all(const uint8_t* src, size_t n, Out& out) {
  static thread_local Frame* frame = nullptr;
  if (!frame) frame = new Frame();
  if (n == 0) fail("no zstd frame");
  size_t pos = 0;
  while (pos < n) {
    if (n - pos < 4) fail("trailing bytes after the last frame");
    uint32_t magic = static_cast<uint32_t>(load_le(src + pos, 4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail("skippable frame truncated");
      uint64_t len = load_le(src + pos + 4, 4);
      if (len > n - pos - 8) fail("skippable frame truncated");
      pos += 8 + static_cast<size_t>(len);
    } else if (magic == 0xFD2FB528u) {
      pos += decode_frame(src + pos, n - pos, out, *frame);
    } else {
      fail("not a zstd frame (bad magic number)");
    }
  }
}

uint32_t crc_table[256];
bool crc_ready = false;

}  // namespace

extern "C" {

int64_t cppf_zstd_decode(const uint8_t* src, int64_t n, int64_t max_out, uint8_t** out_ptr,
                         char* err, int64_t errcap) {
  *out_ptr = nullptr;
  std::string msg;
  try {
    Out out(static_cast<size_t>(max_out < 0 ? 0 : max_out));
    decode_all(src, static_cast<size_t>(n), out);
    *out_ptr = out.p;  // null when nothing was decoded
    out.p = nullptr;
    return static_cast<int64_t>(out.n);
  } catch (const Corrupt& e) {
    msg = e.what();
  } catch (const std::bad_alloc&) {
    msg = "out of memory";
  } catch (const std::exception& e) {
    msg = e.what();
  }
  if (errcap > 0) {
    size_t k = msg.size() < static_cast<size_t>(errcap - 1) ? msg.size() : errcap - 1;
    std::memcpy(err, msg.data(), k);
    err[k] = 0;
  }
  return -1;
}

void cppf_zstd_release(uint8_t* p) { std::free(p); }

uint32_t cppf_crc32c(const uint8_t* p, int64_t n) {
  if (!crc_ready) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      crc_table[i] = c;
    }
    crc_ready = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; ++i) c = crc_table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
