// Lossless WebP (VP8L) decoder, RFC 9649, for the SOG reader (`io/webp.py`).
//
// Decodes what libwebp writes: the RIFF container (a plain VP8L chunk, or VP8X with a VP8L
// chunk inside), all four transforms (predictor with its 14 modes, cross-colour, subtract
// green, colour indexing with pixel bundling for 2, 4 and 16 colours), LZ77 backward
// references with the 120-entry distance map, the colour cache and meta prefix codes.
// Prefix codes decode through a 10-bit lookup table with a canonical bit-by-bit path for
// longer codes; a code with one used symbol reads no bits, as in libwebp.
//
// C interface (ctypes):
//   int tpu_splat_vp8l_size(const uint8_t* data, size_t size, int* width, int* height)
//   int tpu_splat_vp8l_decode(const uint8_t* data, size_t size, uint8_t* rgba, int w, int h,
//                             int64_t* stats)
// `stats` (may be null) receives what the file used, over the main image and its
// sub-images: [transform mask (bit t for transform type t), colour-indexing bits per pixel
// bundle (-1 without colour indexing), backward references, colour-cache hits, prefix-code
// groups of the main image, colour-cache bits of the main image].
// Both return 0 on success and a negative code on a malformed or truncated file
// (`tpu_splat_vp8l_error(code)` names it). Nothing is global: calls may run in parallel.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kNotRiff = -1,
  kNoVp8l = -2,
  kLossy = -3,
  kBadHeader = -4,
  kTruncated = -5,
  kBadCode = -6,
  kBadTransform = -7,
  kBadBackRef = -8,
  kBadCache = -9,
  kBadSize = -10,
};

struct Error {
  int code;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  uint32_t Peek(int n) {
    Fill();
    return static_cast<uint32_t>(buf_ & ((uint64_t{1} << n) - 1));
  }
  void Skip(int n) {
    buf_ >>= n;
    cnt_ -= n;
    consumed_ += static_cast<uint64_t>(n);
  }
  uint32_t Read(int n) {
    if (n == 0) return 0;
    const uint32_t v = Peek(n);
    Skip(n);
    return v;
  }
  // true once more bits were consumed than the stream holds (reads past it see zeros)
  bool Overrun() const { return consumed_ > 8 * static_cast<uint64_t>(size_); }
  void Check() const {
    if (Overrun()) throw Error{kTruncated};
  }

 private:
  void Fill() {
    while (cnt_ <= 56) {
      const uint64_t b = next_ < size_ ? data_[next_] : 0;
      ++next_;
      buf_ |= b << cnt_;
      cnt_ += 8;
    }
  }
  const uint8_t* data_;
  size_t size_;
  size_t next_ = 0;
  uint64_t buf_ = 0;
  int cnt_ = 0;
  uint64_t consumed_ = 0;
};

constexpr int kMaxCodeLength = 15;
constexpr int kFastBits = 10;

// A canonical prefix code: a lookup table on the next kFastBits bits (LSB first), and the
// per-length counts and sorted symbols for codes longer than that.
struct PrefixCode {
  int single = -1;  // the symbol of a code with one used symbol: it reads no bits
  int fast_bits = 0;
  std::vector<uint32_t> fast;  // symbol | length << 16; length 0 = a longer code
  int count[kMaxCodeLength + 1] = {0};
  std::vector<uint16_t> sorted;

  void Build(const std::vector<int>& lengths) {
    const int n = static_cast<int>(lengths.size());
    int used = 0, last = -1, max_len = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] < 0 || lengths[s] > kMaxCodeLength) throw Error{kBadCode};
      if (lengths[s]) {
        ++count[lengths[s]];
        ++used;
        last = s;
        if (lengths[s] > max_len) max_len = lengths[s];
      }
    }
    if (used == 0) throw Error{kBadCode};
    if (used == 1) {
      single = last;
      return;
    }
    int left = 1;  // Kraft: the code must be complete, neither over- nor under-subscribed
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      left = (left << 1) - count[len];
      if (left < 0) throw Error{kBadCode};
    }
    if (left != 0) throw Error{kBadCode};
    int offs[kMaxCodeLength + 2] = {0};
    for (int len = 1; len <= kMaxCodeLength; ++len) offs[len + 1] = offs[len] + count[len];
    sorted.assign(used, 0);
    int next_code[kMaxCodeLength + 2] = {0};
    for (int len = 1, code = 0; len <= kMaxCodeLength; ++len) {
      code = (code + count[len - 1]) << 1;
      next_code[len] = code;
    }
    fast_bits = max_len < kFastBits ? max_len : kFastBits;
    fast.assign(size_t{1} << fast_bits, 0);
    for (int s = 0; s < n; ++s) {
      const int len = lengths[s];
      if (!len) continue;
      sorted[offs[len]++] = static_cast<uint16_t>(s);
      const int code = next_code[len]++;
      if (len > fast_bits) continue;
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int r = rev; r < (1 << fast_bits); r += 1 << len)
        fast[r] = static_cast<uint32_t>(s) | (static_cast<uint32_t>(len) << 16);
    }
  }

  int Decode(BitReader& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.Peek(kMaxCodeLength);
    const uint32_t hit = fast[bits & ((1u << fast_bits) - 1)];
    if (hit >> 16) {
      br.Skip(static_cast<int>(hit >> 16));
      return static_cast<int>(hit & 0xffff);
    }
    int code = 0, first = 0, index = 0;  // canonical decode, the first bit the code's MSB
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      code |= (bits >> (len - 1)) & 1;
      if (code - first < count[len]) {
        br.Skip(len);
        return sorted[index + code - first];
      }
      index += count[len];
      first = (first + count[len]) << 1;
      code <<= 1;
    }
    throw Error{kBadCode};
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

void ReadCodeLengths(BitReader& br, int alphabet, std::vector<int>& lengths) {
  lengths.assign(alphabet, 0);
  if (br.Read(1)) {  // simple code: one or two symbols
    const int num = static_cast<int>(br.Read(1)) + 1;
    const int first8 = static_cast<int>(br.Read(1));
    const int s0 = static_cast<int>(br.Read(first8 ? 8 : 1));
    if (s0 >= alphabet) throw Error{kBadCode};
    lengths[s0] = 1;
    if (num == 2) {
      const int s1 = static_cast<int>(br.Read(8));
      if (s1 >= alphabet) throw Error{kBadCode};
      lengths[s1] = 1;
    }
    br.Check();
    return;
  }
  std::vector<int> cl_lengths(19, 0);
  const int num = static_cast<int>(br.Read(4)) + 4;
  for (int i = 0; i < num; ++i) cl_lengths[kCodeLengthOrder[i]] = static_cast<int>(br.Read(3));
  PrefixCode cl;
  cl.Build(cl_lengths);
  int max_symbol = alphabet;
  if (br.Read(1)) {
    const int nbits = 2 + 2 * static_cast<int>(br.Read(3));
    max_symbol = 2 + static_cast<int>(br.Read(nbits));
    if (max_symbol > alphabet) throw Error{kBadCode};
  }
  int symbol = 0, prev = 8;
  while (symbol < alphabet) {
    if (max_symbol-- == 0) break;
    br.Check();
    const int len = cl.Decode(br);
    if (len < 16) {
      lengths[symbol++] = len;
      if (len) prev = len;
      continue;
    }
    static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
    const int rep = static_cast<int>(br.Read(kExtra[len - 16])) + kOffset[len - 16];
    if (symbol + rep > alphabet) throw Error{kBadCode};
    const int v = len == 16 ? prev : 0;
    for (int k = 0; k < rep; ++k) lengths[symbol++] = v;
  }
  br.Check();
}

struct Group {
  PrefixCode code[5];  // green + lengths + cache, red, blue, alpha, distance
};

inline uint32_t AddPixels(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t Average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int Clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline uint32_t ClampedAddSubtractFull(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int v = static_cast<int>((a >> sh) & 0xff) + static_cast<int>((b >> sh) & 0xff) -
                  static_cast<int>((c >> sh) & 0xff);
    out |= static_cast<uint32_t>(Clip255(v)) << sh;
  }
  return out;
}
inline uint32_t ClampedAddSubtractHalf(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int x = static_cast<int>((a >> sh) & 0xff), y = static_cast<int>((b >> sh) & 0xff);
    out |= static_cast<uint32_t>(Clip255(x + (x - y) / 2)) << sh;
  }
  return out;
}
inline uint32_t Select(uint32_t L, uint32_t T, uint32_t TL) {
  int pl = 0, pt = 0;  // Manhattan distances of L and T to the estimate L + T - TL
  for (int sh = 0; sh < 32; sh += 8) {
    const int l = static_cast<int>((L >> sh) & 0xff), t = static_cast<int>((T >> sh) & 0xff);
    const int tl = static_cast<int>((TL >> sh) & 0xff);
    pl += std::abs(t - tl);
    pt += std::abs(l - tl);
  }
  return pl < pt ? L : T;
}

uint32_t Predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return Average2(Average2(L, TR), T);
    case 6: return Average2(L, TL);
    case 7: return Average2(L, T);
    case 8: return Average2(TL, T);
    case 9: return Average2(T, TR);
    case 10: return Average2(Average2(L, TL), Average2(T, TR));
    case 11: return Select(L, T, TL);
    case 12: return ClampedAddSubtractFull(L, T, TL);
    case 13: return ClampedAddSubtractHalf(Average2(L, T), TL);
    default: return 0xff000000u;  // 0, and 14-15 as libwebp
  }
}

inline int ColorDelta(int8_t t, int8_t c) { return (static_cast<int>(t) * c) >> 5; }

// (dx, dy) of the 120 short distance codes (RFC 9649 section 4.2.2)
const int8_t kPlane[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1},
    {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3},
    {3, 2},  {-3, 2}, {0, 4},  {4, 0},  {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3},
    {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2}, {4, 4},  {-4, 4},
    {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6},
    {6, 3},  {-6, 3}, {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7},
    {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5}, {8, 0},  {4, 7},  {-4, 7}, {7, 4},
    {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5},
    {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7},
};

inline int CopyLength(int prefix, BitReader& br) {  // lengths and distances alike
  if (prefix < 4) return prefix + 1;
  const int extra = (prefix - 2) >> 1;
  const int offset = (2 + (prefix & 1)) << extra;
  return offset + static_cast<int>(br.Read(extra)) + 1;
}

inline int DivRoundUp(int n, int bits) { return (n + (1 << bits) - 1) >> bits; }

struct Transform {
  int type = 0;
  int bits = 0;
  int xsize = 0;  // the width this transform's output has
  std::vector<uint32_t> data;
};

enum Stat { kTransforms, kIndexBits, kBackRefs, kCacheHits, kGroups, kCacheBits, kNumStats };

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : br_(data, size) { stats[kIndexBits] = -1; }

  BitReader& br() { return br_; }
  int64_t stats[kNumStats] = {0};

  // One image of xsize x ysize: the main image (`level0`: transforms and meta prefix codes)
  // or an entropy-coded sub-image.
  std::vector<uint32_t> DecodeImage(int xsize, int ysize, bool level0) {
    std::vector<Transform> transforms;
    int width = xsize;
    if (level0) {
      unsigned seen = 0;
      while (br_.Read(1)) {
        Transform t;
        t.type = static_cast<int>(br_.Read(2));
        if (seen & (1u << t.type)) throw Error{kBadTransform};
        seen |= 1u << t.type;
        stats[kTransforms] |= 1 << t.type;
        t.xsize = width;
        if (t.type == 0 || t.type == 1) {
          t.bits = static_cast<int>(br_.Read(3)) + 2;
          t.data = DecodeImage(DivRoundUp(width, t.bits), DivRoundUp(ysize, t.bits), false);
        } else if (t.type == 3) {
          const int ncolors = static_cast<int>(br_.Read(8)) + 1;
          t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
          stats[kIndexBits] = t.bits;
          std::vector<uint32_t> table = DecodeImage(ncolors, 1, false);
          for (int i = 1; i < ncolors; ++i) table[i] = AddPixels(table[i], table[i - 1]);
          table.resize(256, 0u);  // indices past the table give transparent black
          t.data.swap(table);
          width = DivRoundUp(width, t.bits);
        }
        br_.Check();
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br_.Read(1)) {
      cache_bits = static_cast<int>(br_.Read(4));
      if (cache_bits < 1 || cache_bits > 11) throw Error{kBadCache};
    }
    int prefix_bits = 0, meta_w = 0, num_groups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br_.Read(1)) {
      prefix_bits = static_cast<int>(br_.Read(3)) + 2;
      meta_w = DivRoundUp(width, prefix_bits);
      meta = DecodeImage(meta_w, DivRoundUp(ysize, prefix_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        if (static_cast<int>(m) + 1 > num_groups) num_groups = static_cast<int>(m) + 1;
      }
    }
    if (level0) {
      stats[kGroups] = num_groups;
      stats[kCacheBits] = cache_bits;
    }
    std::vector<char> used(num_groups, meta.empty() ? 1 : 0);
    for (uint32_t m : meta) used[m] = 1;
    const int alphabets[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0), 256, 256, 256, 40};
    std::vector<Group> groups(num_groups);
    std::vector<int> lengths;
    for (int g = 0; g < num_groups; ++g) {
      for (int c = 0; c < 5; ++c) {
        ReadCodeLengths(br_, alphabets[c], lengths);
        if (used[g]) {
          groups[g].code[c].Build(lengths);
        } else {
          PrefixCode unused;  // read and checked, but no table is kept
          unused.Build(lengths);
        }
      }
    }
    std::vector<uint32_t> px = DecodePixels(width, ysize, groups, meta, meta_w, prefix_bits,
                                            cache_bits);
    for (auto t = transforms.rbegin(); t != transforms.rend(); ++t) Inverse(*t, ysize, px);
    return px;
  }

 private:
  std::vector<uint32_t> DecodePixels(int w, int h, const std::vector<Group>& groups,
                                     const std::vector<uint32_t>& meta, int meta_w,
                                     int prefix_bits, int cache_bits) {
    const size_t total = static_cast<size_t>(w) * static_cast<size_t>(h);
    std::vector<uint32_t> px(total);
    std::vector<uint32_t> cache(cache_bits ? size_t{1} << cache_bits : 0, 0u);
    const int cache_shift = 32 - cache_bits;
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
    };
    size_t pos = 0;
    int x = 0, y = 0;
    while (pos < total) {
      const Group& g =
          meta.empty() ? groups[0]
                       : groups[meta[static_cast<size_t>(y >> prefix_bits) * meta_w +
                                     (x >> prefix_bits)]];
      const int code = g.code[0].Decode(br_);
      if (code < 256) {
        const uint32_t red = static_cast<uint32_t>(g.code[1].Decode(br_));
        const uint32_t blue = static_cast<uint32_t>(g.code[2].Decode(br_));
        const uint32_t alpha = static_cast<uint32_t>(g.code[3].Decode(br_));
        const uint32_t argb = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) |
                              blue;
        px[pos++] = argb;
        insert(argb);
        if (++x == w) {
          x = 0;
          ++y;
          br_.Check();
        }
      } else if (code < 256 + 24) {
        const int length = CopyLength(code - 256, br_);
        const int dsym = g.code[4].Decode(br_);
        const int dcode = CopyLength(dsym, br_);
        long dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          dist = kPlane[dcode - 1][0] + static_cast<long>(kPlane[dcode - 1][1]) * w;
          if (dist < 1) dist = 1;
        }
        if (static_cast<size_t>(dist) > pos || static_cast<size_t>(length) > total - pos)
          throw Error{kBadBackRef};
        ++stats[kBackRefs];
        for (int k = 0; k < length; ++k) {
          const uint32_t argb = px[pos - dist];
          px[pos++] = argb;
          insert(argb);
        }
        x += length;
        while (x >= w) {
          x -= w;
          ++y;
        }
        br_.Check();
      } else {
        const size_t key = static_cast<size_t>(code - 256 - 24);
        if (key >= cache.size()) throw Error{kBadCache};
        const uint32_t argb = cache[key];
        ++stats[kCacheHits];
        px[pos++] = argb;
        insert(argb);
        if (++x == w) {
          x = 0;
          ++y;
          br_.Check();
        }
      }
    }
    br_.Check();
    return px;
  }

  static void Inverse(const Transform& t, int h, std::vector<uint32_t>& px) {
    const int w = t.xsize;
    if (t.type == 0) {  // predictor
      const int bw = DivRoundUp(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* row = px.data() + static_cast<size_t>(y) * w;
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : row[x - 1];
          } else if (x == 0) {
            pred = row[x - w];
          } else {
            const int mode =
                (t.data[static_cast<size_t>(y >> t.bits) * bw + (x >> t.bits)] >> 8) & 0xf;
            // the top-right of the last column is the first pixel of this row (memory order)
            pred = Predict(mode, row[x - 1], row[x - w], row[x - w + 1], row[x - w - 1]);
          }
          row[x] = AddPixels(row[x], pred);
        }
      }
    } else if (t.type == 1) {  // cross-colour
      const int bw = DivRoundUp(w, t.bits);
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[static_cast<size_t>(y >> t.bits) * bw + (x >> t.bits)];
          uint32_t& p = px[static_cast<size_t>(y) * w + x];
          const int8_t green = static_cast<int8_t>(p >> 8);
          int red = static_cast<int>((p >> 16) & 0xff), blue = static_cast<int>(p & 0xff);
          red = (red + ColorDelta(static_cast<int8_t>(m & 0xff), green)) & 0xff;
          blue += ColorDelta(static_cast<int8_t>((m >> 8) & 0xff), green);
          blue += ColorDelta(static_cast<int8_t>((m >> 16) & 0xff), static_cast<int8_t>(red));
          p = (p & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) |
              static_cast<uint32_t>(blue & 0xff);
        }
      }
    } else if (t.type == 2) {  // subtract green
      for (uint32_t& p : px) {
        const uint32_t green = (p >> 8) & 0xff;
        p = AddPixels(p, (green << 16) | green);
      }
    } else {  // colour indexing, pixels bundled 8 >> bits to a byte of green
      const int packed_w = DivRoundUp(w, t.bits);
      std::vector<uint32_t> out(static_cast<size_t>(w) * h);
      const int bpp = 8 >> t.bits, per = 1 << t.bits;
      const uint32_t mask = (1u << bpp) - 1;
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t packed =
              (px[static_cast<size_t>(y) * packed_w + (x >> t.bits)] >> 8) & 0xff;
          const uint32_t idx = (packed >> ((x & (per - 1)) * bpp)) & mask;
          out[static_cast<size_t>(y) * w + x] = t.data[idx];
        }
      }
      px.swap(out);
    }
  }

  BitReader br_;
};

inline uint32_t Le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// The VP8L payload of a RIFF/WEBP file; throws on anything else.
void FindVp8l(const uint8_t* data, size_t size, const uint8_t** payload, size_t* payload_size) {
  if (size < 12 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4))
    throw Error{kNotRiff};
  const size_t riff_end = static_cast<size_t>(Le32(data + 4)) + 8;
  if (riff_end > size) throw Error{kTruncated};
  size_t pos = 12;
  while (pos + 8 <= riff_end) {
    const uint8_t* tag = data + pos;
    const size_t len = Le32(data + pos + 4);
    if (len > riff_end - pos - 8) throw Error{kTruncated};
    if (!std::memcmp(tag, "VP8L", 4)) {
      *payload = data + pos + 8;
      *payload_size = len;
      return;
    }
    if (!std::memcmp(tag, "VP8 ", 4)) throw Error{kLossy};
    pos += 8 + len + (len & 1);
  }
  throw Error{kNoVp8l};
}

void ReadHeader(BitReader& br, size_t payload_size, int* w, int* h) {
  if (payload_size < 5) throw Error{kTruncated};
  if (br.Read(8) != 0x2f) throw Error{kBadHeader};
  *w = static_cast<int>(br.Read(14)) + 1;
  *h = static_cast<int>(br.Read(14)) + 1;
  br.Read(1);  // alpha_is_used: a hint only
  if (br.Read(3) != 0) throw Error{kBadHeader};
}

}  // namespace

extern "C" {

int tpu_splat_vp8l_size(const uint8_t* data, size_t size, int* width, int* height) {
  try {
    const uint8_t* payload;
    size_t payload_size;
    FindVp8l(data, size, &payload, &payload_size);
    BitReader br(payload, payload_size);
    ReadHeader(br, payload_size, width, height);
    return kOk;
  } catch (const Error& e) {
    return e.code;
  }
}

int tpu_splat_vp8l_decode(const uint8_t* data, size_t size, uint8_t* rgba, int w, int h,
                          int64_t* stats) {
  try {
    const uint8_t* payload;
    size_t payload_size;
    FindVp8l(data, size, &payload, &payload_size);
    Decoder dec(payload, payload_size);
    int fw, fh;
    ReadHeader(dec.br(), payload_size, &fw, &fh);
    if (fw != w || fh != h) throw Error{kBadSize};
    const std::vector<uint32_t> px = dec.DecodeImage(w, h, true);
    if (stats) std::memcpy(stats, dec.stats, sizeof(dec.stats));
    for (size_t i = 0; i < px.size(); ++i) {
      const uint32_t p = px[i];
      rgba[4 * i + 0] = static_cast<uint8_t>(p >> 16);
      rgba[4 * i + 1] = static_cast<uint8_t>(p >> 8);
      rgba[4 * i + 2] = static_cast<uint8_t>(p);
      rgba[4 * i + 3] = static_cast<uint8_t>(p >> 24);
    }
    return kOk;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    return kBadSize;
  }
}

const char* tpu_splat_vp8l_error(int code) {
  switch (code) {
    case kNotRiff: return "not a RIFF/WEBP file";
    case kNoVp8l: return "no VP8L (lossless) chunk";
    case kLossy: return "a lossy (VP8) WebP: only lossless VP8L is supported";
    case kBadHeader: return "bad VP8L header";
    case kTruncated: return "truncated data";
    case kBadCode: return "invalid prefix code";
    case kBadTransform: return "invalid transform";
    case kBadBackRef: return "backward reference outside the image";
    case kBadCache: return "invalid colour cache";
    case kBadSize: return "image size does not match its header";
    default: return "unknown error";
  }
}

}  // extern "C"
