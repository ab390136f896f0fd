// zstd frames (RFC 8878), CRC-32C and XXH64 for the Orbax checkpoints of
// checkpoint/orbax_backend.py and checkpoint/ocdbt.py.
//
// The decoder reads every frame a zstd encoder writes: raw, RLE and
// compressed blocks; literals sections raw, RLE, Huffman-compressed and
// treeless, in one and four streams, with FSE-compressed and direct
// Huffman weights; sequences in the predefined, RLE, FSE-compressed and
// repeat table modes, with repeat offsets and matches that reach back
// across blocks; single-segment and windowed frames, concatenated frames
// and skippable frames. A frame that names a dictionary is refused; a
// frame with the content-checksum flag is checked with XXH64. Output goes
// into a buffer the caller sizes (zstd_content_size, or the array's own
// size); no byte outside the input or that buffer is touched, and a
// malformed frame fails with its byte offset and what was wrong.
//
// There is no compressor. zstd_write_raw writes a frame of raw blocks
// (at most 128 KiB each) that any zstd decoder reads: about 8% larger
// than level-1 zstd on normal f32 weights, as large as the data for
// anything else.
//
// Build: python -m lirec_tpu_torch.native.build  (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

typedef uint8_t u8;
typedef uint16_t u16;
typedef uint32_t u32;
typedef uint64_t u64;
typedef int64_t i64;

const u32 kMagic = 0xFD2FB528u;
const i64 kBlockMax = 128 * 1024;

struct Error {
  i64 offset;
  std::string what;
};

[[noreturn]] void fail(i64 offset, const char* fmt, i64 a = 0, i64 b = 0) {
  char buf[256];
  snprintf(buf, sizeof buf, fmt, (long long)a, (long long)b);
  throw Error{offset, buf};
}

inline u64 load64(const u8* p) {
  u64 v;
  memcpy(&v, p, 8);
  return v;
}

inline u32 load_le(const u8* p, int n) {
  u32 v = 0;
  for (int i = 0; i < n; i++) v |= u32(p[i]) << (8 * i);
  return v;
}

inline int highbit(u64 v) { return 63 - __builtin_clzll(v); }

// ---------------------------------------------------------------- counts
// How often each mode was met since the last reset (the tests ask which
// paths a set of frames reached).
enum {
  C_BLOCK_RAW, C_BLOCK_RLE, C_BLOCK_COMPRESSED,
  C_LIT_RAW, C_LIT_RLE, C_LIT_COMPRESSED, C_LIT_TREELESS,
  C_LIT_1STREAM, C_LIT_4STREAMS,
  C_HUF_WEIGHTS_FSE, C_HUF_WEIGHTS_DIRECT,
  C_SEQ_PREDEFINED, C_SEQ_RLE, C_SEQ_FSE, C_SEQ_REPEAT,
  C_REPEAT_OFFSET, C_SKIPPABLE, C_FRAMES, C_CHECKSUMS, C_SEQ_NONE,
  C_N
};
i64 g_counts[C_N];

// ------------------------------------------------------------- bit readers

// Forward little-endian bits (FSE table descriptions).
struct FwdBits {
  const u8* p;
  i64 size, bit, base;  // base: offset of p in the frame, for errors
  u32 peek(int n) const {  // n <= 24; bits past the end read as 0
    i64 byte = bit >> 3;
    u32 v = 0;
    for (int i = 0; i < 4 && byte + i < size; i++) v |= u32(p[byte + i]) << (8 * i);
    return (v >> (bit & 7)) & ((1u << n) - 1);
  }
  void skip(int n) {
    bit += n;
    if (bit > size * 8) fail(base + size, "table description runs past its section");
  }
};

// Backward bits, as zstd writes Huffman, FSE and sequence streams: read
// from the last byte down, the highest set bit of the last byte marks the
// start. `consumed` past 64 means bits below the stream's start were
// read (as zeros): an overflow.
struct BackBits {
  const u8 *start, *ptr;
  u64 c = 0;
  u32 consumed = 0;
  i64 base = 0;

  void init(const u8* src, i64 size, i64 at) {
    base = at;
    if (size < 1) fail(at, "empty bitstream");
    start = src;
    u8 last = src[size - 1];
    if (last == 0) fail(at + size - 1, "bitstream's last byte has no end mark");
    if (size >= 8) {
      ptr = src + size - 8;
      c = load64(ptr);
      consumed = 8 - highbit(last);
    } else {
      ptr = src;
      c = 0;
      for (i64 i = 0; i < size; i++) c |= u64(src[i]) << (8 * i);
      consumed = 8 - highbit(last) + u32(8 - size) * 8;
    }
  }
  inline u64 look(int n) const {
    if (n == 0) return 0;
    return ((c << (consumed & 63)) >> 1) >> ((63 - n) & 63);
  }
  inline void skip(int n) { consumed += n; }
  inline u64 read(int n) {
    u64 v = look(n);
    consumed += n;
    return v;
  }
  // false once bits below the start were read
  inline bool reload() {
    if (consumed > 64) return false;
    if (ptr >= start + 8) {
      ptr -= consumed >> 3;
      consumed &= 7;
      c = load64(ptr);
      return true;
    }
    if (ptr == start) return true;
    u32 n = consumed >> 3;
    if (ptr - n < start) n = u32(ptr - start);
    ptr -= n;
    consumed -= n * 8;
    c = load64(ptr);
    return true;
  }
  bool overflowed() const { return consumed > 64; }
  bool finished() const { return ptr == start && consumed == 64; }
};

// --------------------------------------------------------------------- FSE

struct FseEntry {
  u16 symbol;
  u8 bits;
  u16 baseline;
};

struct FseTable {
  int log = 0;
  FseEntry e[1 << 9];
  bool valid = false;
};

void fse_build(FseTable& t, const short* prob, int nsym, int log, i64 at) {
  int size = 1 << log;
  int high = size - 1;
  u16 next[256];
  for (int s = 0; s < nsym; s++) {
    if (prob[s] == -1) {
      t.e[high--].symbol = u16(s);
      next[s] = 1;
    } else {
      next[s] = u16(prob[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    for (int i = 0; i < prob[s]; i++) {
      t.e[pos].symbol = u16(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0) fail(at, "FSE table does not fill its states");
  for (int u = 0; u < size; u++) {
    int s = t.e[u].symbol;
    u32 n = next[s]++;
    int bits = log - highbit(n);
    t.e[u].bits = u8(bits);
    t.e[u].baseline = u16((n << bits) - size);
  }
  t.log = log;
  t.valid = true;
}

// An FSE table description (RFC 8878 4.1.1); returns the bytes it took.
i64 fse_read(FseTable& t, const u8* src, i64 size, i64 at, int max_log,
             int max_sym) {
  FwdBits in{src, size, 0, at};
  if (size < 1) fail(at, "missing FSE table description");
  int log = int(in.peek(4)) + 5;
  in.skip(4);
  if (log > max_log) fail(at, "FSE accuracy log %lld above its limit %lld", log, max_log);
  short prob[256];
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  while (remaining > 1) {
    if (sym > max_sym) fail(at + (in.bit >> 3), "FSE probabilities past the last symbol");
    int max = (2 * threshold - 1) - remaining;
    int v;
    u32 low = in.peek(nbits - 1);
    if (int(low) < max) {
      v = int(low);
      in.skip(nbits - 1);
    } else {
      v = int(in.peek(nbits));
      if (v >= threshold) v -= max;
      in.skip(nbits);
    }
    int count = v - 1;
    remaining -= count < 0 ? -count : count;
    prob[sym++] = short(count);
    if (count == 0) {
      for (;;) {
        int rep = int(in.peek(2));
        in.skip(2);
        for (int i = 0; i < rep; i++) {
          if (sym > max_sym) fail(at + (in.bit >> 3), "FSE zero run past the last symbol");
          prob[sym++] = 0;
        }
        if (rep != 3) break;
      }
    }
    while (remaining < threshold && threshold > 1) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(at, "FSE probabilities do not add up");
  fse_build(t, prob, sym, log, at);
  return (in.bit + 7) >> 3;
}

void fse_rle(FseTable& t, int sym) {
  t.log = 0;
  t.e[0] = FseEntry{u16(sym), 0, 0};
  t.valid = true;
}

// ------------------------------------------------------------------ Huffman

struct HufTable {
  int max_bits = 0;
  u16 e[1 << 11];  // symbol << 8 | bits
  bool valid = false;
};

// A Huffman tree description; returns the bytes it took.
i64 huf_read(HufTable& h, const u8* src, i64 size, i64 at) {
  if (size < 1) fail(at, "missing Huffman tree description");
  u8 weights[256];
  int n = 0;
  i64 used;
  int header = src[0];
  if (header >= 128) {
    g_counts[C_HUF_WEIGHTS_DIRECT]++;
    n = header - 127;
    used = 1 + (n + 1) / 2;
    if (used > size) fail(at, "direct Huffman weights run past their section");
    for (int i = 0; i < n; i++) {
      u8 b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {
    g_counts[C_HUF_WEIGHTS_FSE]++;
    used = 1 + header;
    if (used > size || header == 0) fail(at, "FSE Huffman weights run past their section");
    static thread_local FseTable t;
    i64 tbytes = fse_read(t, src + 1, header, at + 1, 6, 255);
    if (tbytes >= header) fail(at + 1, "no bitstream after the Huffman weights' FSE table");
    BackBits b;
    b.init(src + 1 + tbytes, header - tbytes, at + 1 + tbytes);
    u32 s1 = u32(b.read(t.log)), s2 = u32(b.read(t.log));
    b.reload();
    for (;;) {
      if (n > 253) fail(at, "too many Huffman weights");
      weights[n++] = u8(t.e[s1].symbol);
      s1 = t.e[s1].baseline + u32(b.read(t.e[s1].bits));
      b.reload();
      if (b.overflowed()) {
        weights[n++] = u8(t.e[s2].symbol);
        break;
      }
      if (n > 253) fail(at, "too many Huffman weights");
      weights[n++] = u8(t.e[s2].symbol);
      s2 = t.e[s2].baseline + u32(b.read(t.e[s2].bits));
      b.reload();
      if (b.overflowed()) {
        weights[n++] = u8(t.e[s1].symbol);
        break;
      }
    }
  }
  u32 sum = 0;
  for (int i = 0; i < n; i++) {
    if (weights[i] > 11) fail(at, "Huffman weight above 11");
    if (weights[i]) sum += 1u << (weights[i] - 1);
  }
  if (sum == 0) fail(at, "Huffman weights are all zero");
  int max_bits = highbit(sum) + 1;
  if (max_bits > 11) fail(at, "Huffman code longer than 11 bits");
  u32 left = (1u << max_bits) - sum;
  if (left & (left - 1)) fail(at, "Huffman weights leave no power of two");
  weights[n++] = u8(highbit(left) + 1);
  // canonical codes: by weight, then by symbol; weight w takes 2^(w-1) slots
  int pos = 0;
  for (int w = 1; w <= max_bits; w++)
    for (int s = 0; s < n; s++)
      if (weights[s] == w) {
        u16 v = u16((s << 8) | (max_bits + 1 - w));
        for (int k = 0; k < (1 << (w - 1)); k++) h.e[pos++] = v;
      }
  if (pos != (1 << max_bits)) fail(at, "Huffman table does not fill its slots");
  h.max_bits = max_bits;
  h.valid = true;
  return used;
}

inline void huf_one(const HufTable& h, BackBits& b, u8* out) {
  u16 v = h.e[b.look(h.max_bits)];
  *out = u8(v >> 8);
  b.skip(v & 255);
}

// Decode n[k] symbols of each of `count` streams into out[k]; the four
// streams of a literals section go through the loop side by side.
void huf_streams(const HufTable& h, int count, const u8* const* src,
                 const i64* size, const i64* at, u8* const* out,
                 const i64* n) {
  BackBits b[4];
  for (int k = 0; k < count; k++) b[k].init(src[k], size[k], at[k]);
  i64 common = n[count - 1];  // the last stream is the shortest
  i64 i = 0;
  // four symbols of at most 11 bits fit in the 57 bits a reload leaves
  for (; i + 4 <= common; i += 4) {
    for (int k = 0; k < count; k++) {
      huf_one(h, b[k], out[k] + i);
      huf_one(h, b[k], out[k] + i + 1);
      huf_one(h, b[k], out[k] + i + 2);
      huf_one(h, b[k], out[k] + i + 3);
    }
    for (int k = 0; k < count; k++)
      if (!b[k].reload()) fail(at[k], "Huffman stream read past its start");
  }
  for (int k = 0; k < count; k++) {
    for (i64 j = i; j < n[k]; j++) {
      huf_one(h, b[k], out[k] + j);
      if (!b[k].reload()) fail(at[k], "Huffman stream read past its start");
    }
    if (!b[k].finished()) fail(at[k], "Huffman stream not consumed to its start");
  }
}

// ---------------------------------------------------------------- sequences

const u32 kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                         12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                         48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const u8 kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                        1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const u32 kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                         17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                         31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                         99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const u8 kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                        2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const short kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                              2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const short kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const short kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                              1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ------------------------------------------------------------------- XXH64

const u64 P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
          P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
          P5 = 2870177450012600261ull;

inline u64 rotl(u64 x, int r) { return (x << r) | (x >> (64 - r)); }
inline u64 xround(u64 acc, u64 in) {
  acc += in * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}
inline u64 xmerge(u64 acc, u64 v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

u64 xxh64_impl(const u8* p, i64 n, u64 seed) {
  const u8* end = p + n;
  u64 h;
  if (n >= 32) {
    u64 v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const u8* limit = end - 32;
    do {
      v1 = xround(v1, load64(p));
      v2 = xround(v2, load64(p + 8));
      v3 = xround(v3, load64(p + 16));
      v4 = xround(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += u64(n);
  while (p + 8 <= end) {
    h ^= xround(0, load64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= u64(load_le(p, 4)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// -------------------------------------------------------------- the frame

struct Frame {
  const u8* src;
  i64 size;
  u8* dst;
  i64 cap;
  i64 out;          // bytes written to dst
  i64 frame_start;  // where this frame's output begins
  u64 window;
  u32 rep[3];
  HufTable huf;
  FseTable ll, of, ml;
  u8 lit[kBlockMax];
};

void read_table(FseTable& t, int mode, const u8* src, i64 size, i64& pos,
                i64 at, const short* dflt, int ndflt, int dlog, int max_log,
                int max_sym) {
  if (mode == 0) {
    g_counts[C_SEQ_PREDEFINED]++;
    fse_build(t, dflt, ndflt, dlog, at);
  } else if (mode == 1) {
    g_counts[C_SEQ_RLE]++;
    if (pos >= size) fail(at + pos, "missing RLE symbol of a sequences table");
    if (src[pos] > max_sym) fail(at + pos, "RLE symbol %lld past its alphabet", src[pos]);
    fse_rle(t, src[pos++]);
  } else if (mode == 2) {
    g_counts[C_SEQ_FSE]++;
    pos += fse_read(t, src + pos, size - pos, at + pos, max_log, max_sym);
  } else {
    g_counts[C_SEQ_REPEAT]++;
    if (!t.valid) fail(at + pos, "repeat mode with no earlier table");
  }
}

void put_literals(Frame& f, const u8* lit, i64 n, i64 at) {
  if (n > f.cap - f.out) fail(at, "output past the buffer's %lld bytes", f.cap);
  memcpy(f.dst + f.out, lit, n);
  f.out += n;
}

void put_match(Frame& f, u64 offset, u64 len, i64 at) {
  if (offset == 0 || offset > u64(f.out - f.frame_start))
    fail(at, "match offset %lld reaches before the frame's output (%lld bytes)",
         i64(offset), f.out - f.frame_start);
  if (offset > f.window) fail(at, "match offset %lld past the window", i64(offset));
  if (i64(len) > f.cap - f.out) fail(at, "output past the buffer's %lld bytes", f.cap);
  u8* d = f.dst + f.out;
  const u8* s = d - offset;
  if (offset >= len) {
    memcpy(d, s, len);
  } else if (offset >= 8) {
    u64 i = 0;
    for (; i + 8 <= len; i += 8) memcpy(d + i, s + i, 8);
    for (; i < len; i++) d[i] = s[i];
  } else {
    for (u64 i = 0; i < len; i++) d[i] = s[i];
  }
  f.out += len;
}

void compressed_block(Frame& f, const u8* src, i64 size, i64 at) {
  // ---- literals section
  if (size < 1) fail(at, "empty compressed block");
  int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  i64 regen = 0, csize = 0, hdr = 0;
  const u8* lit = nullptr;
  if (type <= 1) {
    if (fmt == 0 || fmt == 2) {
      hdr = 1;
      regen = src[0] >> 3;
    } else if (fmt == 1) {
      hdr = 2;
      if (size < 2) fail(at, "truncated literals header");
      regen = (src[0] >> 4) + (i64(src[1]) << 4);
    } else {
      hdr = 3;
      if (size < 3) fail(at, "truncated literals header");
      regen = (src[0] >> 4) + (i64(src[1]) << 4) + (i64(src[2]) << 12);
    }
    if (regen > kBlockMax) fail(at, "literals of %lld bytes past the block limit", regen);
    if (type == 0) {
      g_counts[C_LIT_RAW]++;
      if (hdr + regen > size) fail(at, "raw literals run past the block");
      lit = src + hdr;
      csize = regen;
    } else {
      g_counts[C_LIT_RLE]++;
      if (hdr + 1 > size) fail(at, "RLE literals run past the block");
      memset(f.lit, src[hdr], regen);
      lit = f.lit;
      csize = 1;
    }
  } else {
    int streams = fmt == 0 ? 1 : 4;
    if (fmt <= 1) {
      hdr = 3;
      if (size < 3) fail(at, "truncated literals header");
      u32 v = load_le(src, 3);
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
    } else if (fmt == 2) {
      hdr = 4;
      if (size < 4) fail(at, "truncated literals header");
      u32 v = load_le(src, 4);
      regen = (v >> 4) & 0x3FFF;
      csize = (v >> 18) & 0x3FFF;
    } else {
      hdr = 5;
      if (size < 5) fail(at, "truncated literals header");
      u64 v = load_le(src, 4) | (u64(src[4]) << 32);
      regen = (v >> 4) & 0x3FFFF;
      csize = (v >> 22) & 0x3FFFF;
    }
    if (regen > kBlockMax) fail(at, "literals of %lld bytes past the block limit", regen);
    if (hdr + csize > size) fail(at, "compressed literals run past the block");
    const u8* p = src + hdr;
    i64 left = csize, pat = at + hdr;
    if (type == 2) {
      g_counts[C_LIT_COMPRESSED]++;
      i64 used = huf_read(f.huf, p, left, pat);
      p += used;
      left -= used;
      pat += used;
    } else {
      g_counts[C_LIT_TREELESS]++;
      if (!f.huf.valid) fail(at, "treeless literals with no earlier Huffman table");
    }
    if (streams == 1) {
      g_counts[C_LIT_1STREAM]++;
      u8* out = f.lit;
      huf_streams(f.huf, 1, &p, &left, &pat, &out, &regen);
    } else {
      g_counts[C_LIT_4STREAMS]++;
      if (left < 10) fail(pat, "four-stream literals shorter than their jump table");
      i64 sz[4] = {load_le(p, 2), load_le(p + 2, 2), load_le(p + 4, 2), 0};
      sz[3] = left - 6 - sz[0] - sz[1] - sz[2];
      if (sz[3] < 1) fail(pat, "jump table's streams run past the literals");
      i64 seg = (regen + 3) / 4;
      if (3 * seg > regen) fail(pat, "too few literals for four streams");
      const u8* q[4];
      i64 qa[4], n[4] = {seg, seg, seg, regen - 3 * seg};
      u8* out[4];
      for (int k = 0; k < 4; k++) {
        q[k] = k ? q[k - 1] + sz[k - 1] : p + 6;
        qa[k] = k ? qa[k - 1] + sz[k - 1] : pat + 6;
        out[k] = f.lit + k * seg;
      }
      huf_streams(f.huf, 4, q, sz, qa, out, n);
    }
    lit = f.lit;
  }
  i64 pos = hdr + csize;
  // ---- sequences section
  if (pos >= size) fail(at + pos, "missing sequences section");
  i64 nseq = src[pos];
  if (nseq == 0) {
    g_counts[C_SEQ_NONE]++;
    if (pos + 1 != size) fail(at + pos, "bytes after an empty sequences section");
    put_literals(f, lit, regen, at + pos);
    return;
  }
  if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    if (pos + 2 > size) fail(at + pos, "truncated sequences header");
    nseq = ((nseq - 128) << 8) + src[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > size) fail(at + pos, "truncated sequences header");
    nseq = src[pos + 1] + (i64(src[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  if (pos >= size) fail(at + pos, "missing symbol compression modes");
  int modes = src[pos++];
  if (modes & 3) fail(at + pos - 1, "reserved bits set in the symbol compression modes");
  read_table(f.ll, modes >> 6, src, size, pos, at, kLLDefault, 36, 6, 9, 35);
  read_table(f.of, (modes >> 4) & 3, src, size, pos, at, kOFDefault, 29, 5, 8, 31);
  read_table(f.ml, (modes >> 2) & 3, src, size, pos, at, kMLDefault, 53, 6, 9, 52);
  if (pos >= size) fail(at + pos, "missing sequences bitstream");
  BackBits b;
  b.init(src + pos, size - pos, at + pos);
  u32 sll = u32(b.read(f.ll.log));
  u32 sof = u32(b.read(f.of.log));
  u32 sml = u32(b.read(f.ml.log));
  b.reload();
  i64 lit_used = 0;
  for (i64 i = 0; i < nseq; i++) {
    const FseEntry &ell = f.ll.e[sll], &eof = f.of.e[sof], &eml = f.ml.e[sml];
    int ofc = eof.symbol, llc = ell.symbol, mlc = eml.symbol;
    if (ofc > 31) fail(at + pos, "offset code %lld above 31", ofc);
    u64 ov = (u64(1) << ofc) + b.read(ofc);
    b.reload();
    u64 ml = kMLBase[mlc] + b.read(kMLBits[mlc]);
    u64 ll = kLLBase[llc] + b.read(kLLBits[llc]);
    b.reload();
    if (i + 1 < nseq) {
      sll = ell.baseline + u32(b.read(ell.bits));
      sml = eml.baseline + u32(b.read(eml.bits));
      sof = eof.baseline + u32(b.read(eof.bits));
      b.reload();
    }
    if (b.overflowed()) fail(at + pos, "sequences bitstream read past its start");
    u64 offset;
    if (ov > 3) {
      offset = ov - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = u32(offset);
    } else {
      g_counts[C_REPEAT_OFFSET]++;
      int idx = int(ov) - 1 + (ll == 0);
      if (idx == 0) {
        offset = f.rep[0];
      } else if (idx == 1) {
        offset = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = u32(offset);
      } else if (idx == 2) {
        offset = f.rep[2];
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = u32(offset);
      } else {
        offset = u64(f.rep[0]) - 1;
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = u32(offset);
      }
    }
    if (i64(ll) > regen - lit_used) fail(at + pos, "sequence takes more literals than the block has");
    put_literals(f, lit + lit_used, ll, at + pos);
    lit_used += ll;
    put_match(f, offset, ml, at + pos);
  }
  if (!b.finished()) fail(at + pos, "sequences bitstream not consumed to its start");
  put_literals(f, lit + lit_used, regen - lit_used, at + pos);
}

// One frame at src[pos..]; returns the position after it.
i64 decode_frame(Frame& f, i64 pos) {
  const u8* s = f.src;
  i64 at = pos;
  if (pos + 4 > f.size) fail(pos, "truncated frame magic");
  u32 magic = load_le(s + pos, 4);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    g_counts[C_SKIPPABLE]++;
    if (pos + 8 > f.size) fail(pos, "truncated skippable frame header");
    i64 n = load_le(s + pos + 4, 4);
    if (pos + 8 + n > f.size) fail(pos, "skippable frame runs past the input");
    return pos + 8 + n;
  }
  if (magic != kMagic) fail(pos, "not a zstd frame (magic %08llx)", magic);
  g_counts[C_FRAMES]++;
  pos += 4;
  if (pos >= f.size) fail(pos, "truncated frame header");
  u8 d = s[pos++];
  int fcs_flag = d >> 6, single = (d >> 5) & 1, checksum = (d >> 2) & 1;
  int did_flag = d & 3;
  if (d & 8) fail(pos - 1, "reserved bit set in the frame header");
  i64 hdr = (single ? 0 : 1) + (did_flag == 3 ? 4 : did_flag) +
            (fcs_flag == 0 ? single : (1 << fcs_flag));
  if (pos + hdr > f.size) fail(pos, "truncated frame header");
  u64 window = 0;
  if (!single) {
    u8 w = s[pos++];
    int wlog = 10 + (w >> 3);
    if (wlog > 41) fail(pos - 1, "window log %lld too large", wlog);
    u64 wbase = u64(1) << wlog;
    window = wbase + (wbase / 8) * (w & 7);
  }
  if (did_flag) {
    int n = did_flag == 3 ? 4 : did_flag;
    u32 did = load_le(s + pos, n);
    if (did != 0)
      fail(pos, "frame names dictionary %lld; no dictionary is supported", did);
    pos += n;
  }
  i64 content = -1;
  if (fcs_flag || single) {
    int n = fcs_flag == 0 ? 1 : (1 << fcs_flag);
    u64 v = 0;
    for (int i = 0; i < n; i++) v |= u64(s[pos + i]) << (8 * i);
    if (n == 2) v += 256;
    pos += n;
    content = i64(v);
  }
  if (single) window = u64(content);
  f.window = window;
  f.frame_start = f.out;
  f.rep[0] = 1;
  f.rep[1] = 4;
  f.rep[2] = 8;
  f.huf.valid = f.ll.valid = f.of.valid = f.ml.valid = false;
  if (content >= 0 && content > f.cap - f.out)
    fail(at, "frame content of %lld bytes past the buffer's %lld", content, f.cap - f.out);
  // Block_Maximum_Size: the window, at least 1 KiB, at most 128 KiB
  i64 block_max = window < 1024 ? 1024 : (window < u64(kBlockMax) ? i64(window) : kBlockMax);
  for (;;) {
    if (pos + 3 > f.size) fail(pos, "truncated block header");
    u32 bh = load_le(s + pos, 3);
    int last = bh & 1, type = (bh >> 1) & 3;
    i64 bsize = bh >> 3;
    i64 bat = pos;
    pos += 3;
    i64 before = f.out;
    if (type == 0) {
      g_counts[C_BLOCK_RAW]++;
      if (bsize > block_max) fail(bat, "raw block of %lld bytes past the block limit", bsize);
      if (pos + bsize > f.size) fail(bat, "raw block runs past the input");
      put_literals(f, s + pos, bsize, bat);
      pos += bsize;
    } else if (type == 1) {
      g_counts[C_BLOCK_RLE]++;
      if (bsize > block_max) fail(bat, "RLE block of %lld bytes past the block limit", bsize);
      if (pos + 1 > f.size) fail(bat, "RLE block runs past the input");
      if (bsize > f.cap - f.out) fail(bat, "output past the buffer's %lld bytes", f.cap);
      memset(f.dst + f.out, s[pos], bsize);
      f.out += bsize;
      pos += 1;
    } else if (type == 2) {
      g_counts[C_BLOCK_COMPRESSED]++;
      if (bsize > block_max) fail(bat, "compressed block of %lld bytes past the block limit", bsize);
      if (pos + bsize > f.size) fail(bat, "compressed block runs past the input");
      compressed_block(f, s + pos, bsize, pos);
      if (f.out - before > block_max)
        fail(bat, "block decodes to %lld bytes, past the block limit", f.out - before);
      pos += bsize;
    } else {
      fail(bat, "reserved block type");
    }
    if (last) break;
  }
  i64 produced = f.out - f.frame_start;
  if (content >= 0 && produced != content)
    fail(at, "frame decodes to %lld bytes; its header says %lld", produced, content);
  if (checksum) {
    if (pos + 4 > f.size) fail(pos, "truncated content checksum");
    u32 want = load_le(s + pos, 4);
    u32 got = u32(xxh64_impl(f.dst + f.frame_start, produced, 0));
    if (want != got) fail(pos, "content checksum %08llx, the data gives %08llx", want, got);
    g_counts[C_CHECKSUMS]++;
    pos += 4;
  }
  return pos;
}

// --------------------------------------------------------------- CRC-32C

u32 g_crc_table[256];
bool g_crc_ready = false;

void crc_init() {
  for (u32 i = 0; i < 256; i++) {
    u32 c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
    g_crc_table[i] = c;
  }
  g_crc_ready = true;
}

i64 report(const Error& e, char* err, i64 err_cap) {
  if (err && err_cap > 0) {
    snprintf(err, size_t(err_cap), "zstd: %s (at byte %lld)", e.what.c_str(),
             (long long)e.offset);
  }
  return -1;
}

}  // namespace

extern "C" {

// Decode the frames of src into dst (capacity cap); returns the bytes
// written, or -1 with the reason in err.
i64 zstd_decompress(const u8* src, i64 size, u8* dst, i64 cap, char* err,
                    i64 err_cap) {
  static thread_local Frame* f = new Frame();
  f->src = src;
  f->size = size;
  f->dst = dst;
  f->cap = cap;
  f->out = 0;
  try {
    if (size < 1) fail(0, "empty input");
    i64 pos = 0;
    while (pos < size) pos = decode_frame(*f, pos);
    return f->out;
  } catch (const Error& e) {
    return report(e, err, err_cap);
  }
}

// The summed content sizes of the frames in src, from their headers;
// -2 where a frame does not state its size, -1 (err) if malformed.
i64 zstd_content_size(const u8* src, i64 size, char* err, i64 err_cap) {
  try {
    i64 pos = 0, total = 0;
    bool unknown = false;
    while (pos < size) {
      if (pos + 5 > size) fail(pos, "truncated frame header");
      u32 magic = load_le(src + pos, 4);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (pos + 8 > size) fail(pos, "truncated skippable frame header");
        pos += 8 + i64(load_le(src + pos + 4, 4));
        continue;
      }
      if (magic != kMagic) fail(pos, "not a zstd frame (magic %08llx)", magic);
      u8 d = src[pos + 4];
      int fcs_flag = d >> 6, single = (d >> 5) & 1, did_flag = d & 3;
      if (!fcs_flag && !single) {
        unknown = true;
        break;  // the blocks would have to be walked to find the next frame
      }
      i64 p = pos + 5 + (single ? 0 : 1) + (did_flag == 3 ? 4 : did_flag);
      int n = fcs_flag == 0 ? 1 : (1 << fcs_flag);
      if (p + n > size) fail(pos, "truncated frame header");
      u64 v = 0;
      for (int i = 0; i < n; i++) v |= u64(src[p + i]) << (8 * i);
      if (n == 2) v += 256;
      total += i64(v);
      p += n;
      // walk the blocks to the next frame
      for (;;) {
        if (p + 3 > size) fail(p, "truncated block header");
        u32 bh = load_le(src + p, 3);
        i64 bsize = (bh >> 1 & 3) == 1 ? 1 : i64(bh >> 3);
        if ((bh >> 1 & 3) == 3) fail(p, "reserved block type");
        p += 3 + bsize;
        if (bh & 1) break;
      }
      if (d & 4) p += 4;
      if (p > size) fail(pos, "frame runs past the input");
      pos = p;
    }
    return unknown ? -2 : total;
  } catch (const Error& e) {
    return report(e, err, err_cap);
  }
}

// A frame of raw blocks holding src[0..n) (no compression): windowed,
// 128 KiB window, content size in the header. dst must hold
// zstd_raw_bound(n) bytes; returns the frame's length.
i64 zstd_raw_bound(i64 n) {
  i64 blocks = n == 0 ? 1 : (n + kBlockMax - 1) / kBlockMax;
  return 4 + 1 + 1 + 8 + 3 * blocks + n;
}

i64 zstd_write_raw(const u8* src, i64 n, u8* dst) {
  u8* o = dst;
  u32 magic = kMagic;
  memcpy(o, &magic, 4);
  o[4] = 0xC0;  // 8-byte content size, not single-segment, no checksum
  o[5] = 0x38;  // window 2^17
  u64 content = u64(n);
  memcpy(o + 6, &content, 8);
  o += 14;
  i64 pos = 0;
  do {
    i64 len = n - pos < kBlockMax ? n - pos : kBlockMax;
    u32 last = pos + len >= n ? 1 : 0;
    u32 bh = last | (u32(len) << 3);  // type 0: raw
    o[0] = u8(bh);
    o[1] = u8(bh >> 8);
    o[2] = u8(bh >> 16);
    memcpy(o + 3, src + pos, len);
    o += 3 + len;
    pos += len;
  } while (pos < n);
  return o - dst;
}

u32 crc32c(const u8* p, i64 n, u32 crc) {
  if (!g_crc_ready) crc_init();
  crc = ~crc;
  for (i64 i = 0; i < n; i++) crc = g_crc_table[(crc ^ p[i]) & 255] ^ (crc >> 8);
  return ~crc;
}

u64 xxh64(const u8* p, i64 n, u64 seed) { return xxh64_impl(p, n, seed); }

void zstd_counts(i64* out) {
  for (int i = 0; i < C_N; i++) out[i] = g_counts[i];
}

void zstd_reset_counts() {
  for (int i = 0; i < C_N; i++) g_counts[i] = 0;
}

}  // extern "C"
