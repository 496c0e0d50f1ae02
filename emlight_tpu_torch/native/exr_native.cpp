// Native EXR codec and batch loader of emlight_tpu_torch (the port's copy
// of emlight_tpu/native/exr_native.cpp).
//
// An OpenEXR scanline codec with no external EXR dependency (zlib only):
//   - read: NONE / ZIPS / ZIP / PIZ compression, HALF / FLOAT / UINT
//     channels, the R, G, B planes as (H, W, 3) float32; PIZ decoding
//     mirrors core/piz.py, the pure-Python oracle it is tested against bit
//     for bit;
//   - write: (H, W, 3) float32 as a ZIP-compressed FLOAT or HALF file;
//   - the TonemapHDR alpha (gamma power + percentile of the nonzero values,
//     RegressionNetwork/util.py:36-66);
//   - a threaded batch loader: decode + area resize (bilinear-like when
//     upscaling: the box weights of one source pixel) + optional tonemap of
//     a whole batch in parallel, into one caller buffer.
//
// Exposed through a plain C ABI for ctypes (emlight_tpu_torch/native/
// __init__.py). A ctypes call releases the GIL, so a loader thread decodes
// here while the main thread drives the card.
// Build: g++ -O3 -std=c++17 -shared -fPIC exr_native.cpp -o <lib>.so -lz -pthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr int kMagic = 20000630;
enum PixelType { UINT = 0, HALF = 1, FLOAT = 2 };
enum Compression { NONE = 0, RLE = 1, ZIPS = 2, ZIP = 3, PIZ = 4 };

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

float half_to_float(uint16_t h) {
  uint16_t h_exp = (h & 0x7c00u);
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t bits;
  if (h_exp == 0) {  // subnormal or zero
    uint32_t mant = h & 0x03ffu;
    if (mant == 0) {
      bits = sign;
    } else {
      int e = -1;
      do {
        e++;
        mant <<= 1;
      } while ((mant & 0x0400u) == 0);
      bits = sign | ((uint32_t)(127 - 15 - e) << 23) | ((uint32_t)(mant & 0x03ffu) << 13);
    }
  } else if (h_exp == 0x7c00u) {  // inf/nan
    bits = sign | 0x7f800000u | ((uint32_t)(h & 0x03ffu) << 13);
  } else {
    bits = sign | ((uint32_t)((h >> 10 & 0x1f) - 15 + 127) << 23) |
           ((uint32_t)(h & 0x03ffu) << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

uint16_t float_to_half(float f) {
  // round-to-nearest-even, matching numpy's float16 cast
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint16_t sign = (bits >> 16) & 0x8000u;
  uint32_t f_exp = (bits >> 23) & 0xff;
  uint32_t mant = bits & 0x7fffffu;
  if (f_exp == 0xff) return sign | 0x7c00u | (mant ? 0x200u : 0);  // inf/nan
  int32_t e = (int32_t)f_exp - 127 + 15;
  if (e >= 31) return sign | 0x7c00u;  // overflow -> inf
  if (e <= 0) {
    if (e < -10) return sign;
    mant |= 0x800000u;
    int shift = 14 - e;
    uint32_t hm = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (hm & 1))) hm++;
    return sign | (uint16_t)hm;
  }
  uint32_t rounded = mant + 0xfffu + ((mant >> 13) & 1);
  if (rounded & 0x800000u) {
    rounded = 0;
    if (++e >= 31) return sign | 0x7c00u;
  }
  return sign | (uint16_t)(e << 10) | (uint16_t)(rounded >> 13);
}

struct Channel {
  std::string name;
  int type;
};

struct Header {
  std::vector<Channel> channels;
  int compression = NONE;
  int width = 0, height = 0, y_min = 0;
  size_t data_offset = 0;  // offset of the line-offset table
};

bool read_cstring(const std::vector<uint8_t>& buf, size_t& off, std::string* out) {
  size_t end = off;
  while (end < buf.size() && buf[end] != 0) end++;
  if (end >= buf.size()) return false;
  out->assign((const char*)&buf[off], end - off);
  off = end + 1;
  return true;
}

bool parse_header(const std::vector<uint8_t>& buf, Header* h) {
  if (buf.size() < 8) return set_error("truncated file"), false;
  int32_t magic, version;
  std::memcpy(&magic, &buf[0], 4);
  std::memcpy(&version, &buf[4], 4);
  if (magic != kMagic) return set_error("bad magic"), false;
  if (version & 0x200) return set_error("tiled not supported"), false;
  size_t off = 8;
  while (true) {
    if (off >= buf.size()) return set_error("truncated header"), false;
    if (buf[off] == 0) {
      off++;
      break;
    }
    std::string name, type;
    if (!read_cstring(buf, off, &name)) return set_error("truncated header"), false;
    if (!read_cstring(buf, off, &type)) return set_error("truncated header"), false;
    int32_t size;
    if (off + 4 > buf.size()) return set_error("truncated header"), false;
    std::memcpy(&size, &buf[off], 4);
    off += 4;
    if (size < 0 || off + (size_t)size > buf.size())
      return set_error("truncated header"), false;
    if (name == "channels") {
      size_t coff = off, cend = off + (size_t)size;
      while (coff < cend && buf[coff] != 0) {
        Channel c;
        if (!read_cstring(buf, coff, &c.name) || coff + 16 > cend)
          return set_error("bad channel list"), false;
        int32_t ptype;
        std::memcpy(&ptype, &buf[coff], 4);
        if (ptype != UINT && ptype != HALF && ptype != FLOAT)
          return set_error("unsupported pixel type " + std::to_string(ptype)), false;
        c.type = ptype;
        coff += 16;
        h->channels.push_back(c);
      }
    } else if (name == "compression") {
      if (size < 1) return set_error("bad compression attribute"), false;
      h->compression = buf[off];
    } else if (name == "dataWindow") {
      if (size < 16) return set_error("bad dataWindow"), false;
      int32_t box[4];
      std::memcpy(box, &buf[off], 16);
      h->width = box[2] - box[0] + 1;
      h->height = box[3] - box[1] + 1;
      h->y_min = box[1];
    }
    off += size;
  }
  if (h->width <= 0 || h->height <= 0) return set_error("bad dataWindow"), false;
  h->data_offset = off;
  return true;
}

// un-predictor + de-interleave (OpenEXR ImfZip)
void zip_postprocess(std::vector<uint8_t>& t, std::vector<uint8_t>* out) {
  for (size_t i = 1; i < t.size(); i++) t[i] = (uint8_t)(t[i] + t[i - 1] - 128);
  out->resize(t.size());
  size_t half = (t.size() + 1) / 2;
  const uint8_t* s1 = t.data();
  const uint8_t* s2 = t.data() + half;
  for (size_t i = 0, j = 0; i < t.size();) {
    (*out)[i++] = s1[j];
    if (i < t.size()) (*out)[i++] = s2[j];
    j++;
  }
}

void zip_preprocess(const uint8_t* raw, size_t n, std::vector<uint8_t>* out) {
  out->resize(n);
  size_t half = (n + 1) / 2;
  for (size_t i = 0, j = 0; i < n;) {
    (*out)[j] = raw[i++];
    if (i < n) (*out)[half + j] = raw[i++];
    j++;
  }
  uint8_t prev = (*out)[0];
  for (size_t i = 1; i < n; i++) {
    uint8_t cur = (*out)[i];
    (*out)[i] = (uint8_t)((int)cur - (int)prev + 384);
    prev = cur;
  }
}

int type_size(int t) { return t == HALF ? 2 : 4; }

// ---------------------------------------------------------------------------
// PIZ decode (wavelet + Huffman; the format core/piz.py implements in Python).
// Chunk := minNonZero:u16 maxNonZero:u16 bitmap[min..max] hufLen:u32 hufData.
namespace piz {

constexpr int kBitmapSize = 8192;
constexpr int kEncSize = 65537;  // u16 range + the run-length pseudo symbol
constexpr int kDecBits = 14;
constexpr int kMaxCodeLen = 58;
constexpr int kShortZerocodeRun = 59;
constexpr int kLongZerocodeRun = 63;
constexpr int kShortestLongRun = 2 + kLongZerocodeRun - kShortZerocodeRun;  // 6

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  unsigned __int128 acc = 0;
  int nbits = 0;
  BitReader(const uint8_t* data, size_t n) : p(data), end(data + n) {}
  void fill(int n) {
    while (nbits < n) {
      uint8_t b = p < end ? *p++ : 0;
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }
  uint64_t peek(int n) {
    fill(n);
    return (uint64_t)((acc >> (nbits - n)) & (((unsigned __int128)1 << n) - 1));
  }
  void consume(int n) {
    nbits -= n;
    acc &= ((unsigned __int128)1 << nbits) - 1;
  }
  uint64_t read(int n) {
    uint64_t v = peek(n);
    consume(n);
    return v;
  }
  void byte_align() {  // drop residual bits; stream resumes at next byte
    acc = 0;
    nbits = 0;
  }
};

inline void wdec14(uint16_t l, uint16_t h, uint16_t* a, uint16_t* b) {
  int16_t ls = (int16_t)l, hs = (int16_t)h;
  int hi = hs;
  int ai = (int)ls + (hi & 1) + (hi >> 1);
  int16_t as = (int16_t)ai;
  int16_t bs = (int16_t)(as - hi);
  *a = (uint16_t)as;
  *b = (uint16_t)bs;
}

inline void wdec16(uint16_t l, uint16_t h, uint16_t* a, uint16_t* b) {
  int m = l, d = h;
  int bb = (m - (d >> 1)) & 0xFFFF;
  int aa = (d + bb - 0x8000) & 0xFFFF;
  *b = (uint16_t)bb;
  *a = (uint16_t)aa;
}

// 2-D integer wavelet inverse over a (ny, nx) plane with x stride ox and
// y stride oy (u16 units): levels in reverse of the forward transform.
void wav2_decode(uint16_t* plane, int nx, int ox, int ny, int oy, int maxv) {
  bool w14 = maxv < (1 << 14);
  int n = nx < ny ? nx : ny;
  std::vector<std::pair<int, int>> levels;
  for (int p = 1, p2 = 2; p2 <= n; p = p2, p2 <<= 1) levels.push_back({p, p2});
  for (auto it = levels.rbegin(); it != levels.rend(); ++it) {
    int p = it->first, p2 = it->second;
    int oy1 = oy * p, oy2 = oy * p2, ox1 = ox * p, ox2 = ox * p2;
    uint16_t i00, i01, i10, i11, a, b;
    uint16_t* py = plane;
    uint16_t* ey = plane + (size_t)oy * (ny - p2);
    uint16_t* px = py;
    for (; py <= ey; py += oy2) {
      px = py;
      uint16_t* ex = py + (size_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t *q01 = px + ox1, *q10 = px + oy1, *q11 = q10 + ox1;
        if (w14) {
          wdec14(*px, *q10, &i00, &i10);
          wdec14(*q01, *q11, &i01, &i11);
          wdec14(i00, i01, px, q01);
          wdec14(i10, i11, q10, q11);
        } else {
          wdec16(*px, *q10, &i00, &i10);
          wdec16(*q01, *q11, &i01, &i11);
          wdec16(i00, i01, px, q01);
          wdec16(i10, i11, q10, q11);
        }
      }
      if (nx & p) {  // odd trailing column: 1-D vertical pass
        uint16_t* q10 = px + oy1;
        if (w14) wdec14(*px, *q10, &a, &b); else wdec16(*px, *q10, &a, &b);
        *px = a;
        *q10 = b;
      }
    }
    if (ny & p) {  // odd trailing line: 1-D horizontal pass
      px = py;
      uint16_t* ex = py + (size_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* q01 = px + ox1;
        if (w14) wdec14(*px, *q01, &a, &b); else wdec16(*px, *q01, &a, &b);
        *px = a;
        *q01 = b;
      }
    }
  }
}

// Canonical codes from lengths: first-code per length assigned from the
// longest length downward, then symbols in index order.
void canonical_codes(const uint8_t* lengths, uint64_t* codes) {
  uint64_t counts[kMaxCodeLen + 1] = {0};
  for (int i = 0; i < kEncSize; i++) counts[lengths[i]]++;
  uint64_t first[kMaxCodeLen + 1] = {0};
  uint64_t c = 0;
  for (int l = kMaxCodeLen; l > 0; l--) {
    first[l] = c;
    c = (c + counts[l]) >> 1;
  }
  for (int i = 0; i < kEncSize; i++)
    codes[i] = lengths[i] ? first[lengths[i]]++ : 0;
}

bool huf_decompress(const uint8_t* block, size_t size, uint16_t* out,
                    size_t n_out) {
  if (size < 20) return n_out == 0;
  uint32_t im, iM, n_bits;
  std::memcpy(&im, block, 4);
  std::memcpy(&iM, block + 4, 4);
  std::memcpy(&n_bits, block + 12, 4);
  if (im >= kEncSize || iM >= kEncSize || im > iM)
    return set_error("piz: corrupt huffman header"), false;
  BitReader r(block + 20, size - 20);

  std::vector<uint8_t> lengths(kEncSize, 0);
  for (uint32_t i = im; i <= iM;) {
    int l = (int)r.read(6);
    if (l == kLongZerocodeRun) {
      i += (uint32_t)r.read(8) + kShortestLongRun;
    } else if (l >= kShortZerocodeRun) {
      i += l - kShortZerocodeRun + 2;
    } else {
      if (l > kMaxCodeLen) return set_error("piz: code length > 58"), false;
      lengths[i++] = (uint8_t)l;
    }
    if (i > iM + 1) return set_error("piz: corrupt length table"), false;
  }
  r.byte_align();

  std::vector<uint64_t> codes(kEncSize);
  canonical_codes(lengths.data(), codes.data());

  // fast table over the top kDecBits bits; longer codes resolved by length
  // bucket: canonical codes of one length are CONSECUTIVE (assigned in
  // symbol-index order from first[l]), so lookup is a range check + offset
  std::vector<uint8_t> tbl_len(1 << kDecBits, 0);
  std::vector<uint32_t> tbl_lit(1 << kDecBits, 0);
  std::vector<uint64_t> long_first(kMaxCodeLen + 1, 0);
  std::vector<std::vector<uint32_t>> long_syms(kMaxCodeLen + 1);
  int max_len = 0;
  for (int s = 0; s < kEncSize; s++) {
    int l = lengths[s];
    if (!l) continue;
    if (l > max_len) max_len = l;
    if (l <= kDecBits) {
      uint64_t base = codes[s] << (kDecBits - l);
      for (uint64_t k = 0; k < (1ull << (kDecBits - l)); k++) {
        tbl_len[base + k] = (uint8_t)l;
        tbl_lit[base + k] = (uint32_t)s;
      }
    } else {
      if (long_syms[l].empty()) long_first[l] = codes[s];
      long_syms[l].push_back((uint32_t)s);
    }
  }

  const uint32_t rlc = iM;
  size_t i = 0;
  while (i < n_out) {
    uint64_t pk = r.peek(kDecBits);
    uint32_t s;
    int l = tbl_len[pk];
    if (l) {
      s = tbl_lit[pk];
      r.consume(l);
    } else {
      bool found = false;
      for (int cl = kDecBits + 1; cl <= max_len; cl++) {
        if (long_syms[cl].empty()) continue;
        uint64_t cand = r.peek(cl);
        uint64_t off = cand - long_first[cl];
        if (cand >= long_first[cl] && off < long_syms[cl].size()) {
          s = long_syms[cl][off];
          r.consume(cl);
          found = true;
          break;
        }
      }
      if (!found) return set_error("piz: invalid huffman code"), false;
    }
    if (s == rlc) {
      uint64_t run = r.read(8);
      if (i == 0 || i + run > n_out)
        return set_error("piz: corrupt run length"), false;
      uint16_t v = out[i - 1];
      for (uint64_t k = 0; k < run; k++) out[i++] = v;
    } else {
      out[i++] = (uint16_t)s;
    }
  }
  return true;
}

// Full PIZ chunk -> raw scanline-interleaved bytes (the NONE layout).
bool uncompress_chunk(const uint8_t* data, size_t size,
                      const std::vector<Channel>& chans, int width,
                      int n_lines, std::vector<uint8_t>* out) {
  if (size < 4) return set_error("piz: truncated chunk"), false;
  uint16_t min_nz, max_nz;
  std::memcpy(&min_nz, data, 2);
  std::memcpy(&max_nz, data + 2, 2);
  size_t pos = 4;
  if (min_nz >= kBitmapSize || max_nz >= kBitmapSize)
    return set_error("piz: corrupt bitmap range"), false;
  std::vector<uint8_t> bitmap(kBitmapSize, 0);
  if (min_nz <= max_nz) {
    size_t nb = (size_t)max_nz - min_nz + 1;
    if (pos + nb > size) return set_error("piz: truncated bitmap"), false;
    std::memcpy(bitmap.data() + min_nz, data + pos, nb);
    pos += nb;
  }
  // reverse LUT: dense index -> u16 value (0 implicit)
  std::vector<uint16_t> lut(65536, 0);
  int maxv = 0;
  {
    int k = 0;
    for (int v = 0; v < 65536; v++)
      if (v == 0 || (bitmap[v >> 3] & (1 << (v & 7)))) lut[k++] = (uint16_t)v;
    maxv = k - 1;
  }
  if (pos + 4 > size) return set_error("piz: truncated chunk"), false;
  uint32_t huf_len;
  std::memcpy(&huf_len, data + pos, 4);
  pos += 4;
  if (pos + huf_len > size) return set_error("piz: truncated huffman"), false;

  size_t total = 0;
  std::vector<size_t> offs;
  std::vector<int> units;
  for (const auto& c : chans) {
    offs.push_back(total);
    units.push_back(type_size(c.type) / 2);
    total += (size_t)width * units.back() * n_lines;
  }
  std::vector<uint16_t> buf(total);
  if (!huf_decompress(data + pos, huf_len, buf.data(), total)) return false;

  for (size_t ci = 0; ci < chans.size(); ci++) {
    int u = units[ci];
    uint16_t* plane = buf.data() + offs[ci];
    // each u16 lane of a multi-u16 channel wavelets independently
    for (int j = 0; j < u; j++)
      wav2_decode(plane + j, width, u, n_lines, width * u, maxv);
  }
  for (auto& v : buf) v = lut[v];

  // reinterleave: line y = channel 0 row y, channel 1 row y, ...
  out->resize(total * 2);
  uint8_t* dst = out->data();
  for (int y = 0; y < n_lines; y++) {
    for (size_t ci = 0; ci < chans.size(); ci++) {
      size_t n = (size_t)width * units[ci];
      std::memcpy(dst, buf.data() + offs[ci] + (size_t)y * n, n * 2);
      dst += n * 2;
    }
  }
  return true;
}

}  // namespace piz

// Decode an EXR file into HxWx3 float32 (R,G,B; missing channels zero).
bool decode_exr(const std::string& path, std::vector<float>* out, int* height,
                int* width) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return set_error("cannot open " + path), false;
  std::vector<uint8_t> buf((std::istreambuf_iterator<char>(f)),
                           std::istreambuf_iterator<char>());
  Header h;
  if (!parse_header(buf, &h)) return false;
  if (h.compression != NONE && h.compression != ZIPS && h.compression != ZIP &&
      h.compression != PIZ)
    return set_error("unsupported compression " + std::to_string(h.compression)), false;

  int lines_per_chunk = h.compression == ZIP ? 16 : h.compression == PIZ ? 32 : 1;
  int n_chunks = (h.height + lines_per_chunk - 1) / lines_per_chunk;
  size_t off = h.data_offset;
  if (off + 8 * (size_t)n_chunks > buf.size()) return set_error("truncated offset table"), false;
  std::vector<int64_t> offsets(n_chunks);
  std::memcpy(offsets.data(), &buf[off], 8 * n_chunks);
  // the R, G, B planes are the output; a file without one of them is read
  // by core/exr.py::read_exr(path, channels=...), not zero-filled here
  for (const char* need : {"R", "G", "B"}) {
    bool found = false;
    for (auto& c : h.channels) found = found || c.name == need;
    if (!found) return set_error(std::string("no channel ") + need), false;
  }

  // map channel name -> output plane (R=0, G=1, B=2; others skipped)
  int w = h.width, ht = h.height;
  out->assign((size_t)ht * w * 3, 0.0f);
  size_t bytes_per_line = 0;
  for (auto& c : h.channels) bytes_per_line += (size_t)w * type_size(c.type);

  std::vector<uint8_t> decomp;
  std::vector<uint8_t> tmp;
  for (int ci = 0; ci < n_chunks; ci++) {
    size_t coff = (size_t)offsets[ci];
    if (offsets[ci] < 0 || coff + 8 > buf.size()) return set_error("bad chunk offset"), false;
    int32_t y, size;
    std::memcpy(&y, &buf[coff], 4);
    std::memcpy(&size, &buf[coff + 4], 4);
    if (size < 0 || coff + 8 + (size_t)size > buf.size())
      return set_error("truncated chunk"), false;
    const uint8_t* data = &buf[coff + 8];
    y -= h.y_min;  // the chunk's first row in the output
    if (y < 0 || y >= ht) return set_error("chunk row outside the data window"), false;
    int n_lines = std::min(lines_per_chunk, ht - y);
    size_t expected = bytes_per_line * n_lines;
    const uint8_t* src = data;
    if (h.compression != NONE && (size_t)size < expected) {
      if (h.compression == PIZ) {
        if (!piz::uncompress_chunk(data, (size_t)size, h.channels, w, n_lines,
                                   &decomp))
          return false;
        src = decomp.data();
      } else {
        uLongf dst_len = expected;
        tmp.resize(expected);
        if (uncompress(tmp.data(), &dst_len, data, size) != Z_OK || dst_len != expected)
          return set_error("zlib inflate failed"), false;
        zip_postprocess(tmp, &decomp);
        src = decomp.data();
      }
    }
    size_t pos = 0;
    for (int li = 0; li < n_lines; li++) {
      int row = y + li;
      for (auto& c : h.channels) {
        int plane = c.name == "R" ? 0 : c.name == "G" ? 1 : c.name == "B" ? 2 : -1;
        int ts = type_size(c.type);
        if (plane >= 0) {
          float* dst = out->data() + ((size_t)row * w) * 3 + plane;
          if (c.type == FLOAT) {
            const float* s = (const float*)(src + pos);
            for (int x = 0; x < w; x++) dst[x * 3] = s[x];
          } else if (c.type == HALF) {
            const uint16_t* s = (const uint16_t*)(src + pos);
            for (int x = 0; x < w; x++) dst[x * 3] = half_to_float(s[x]);
          } else {
            const uint32_t* s = (const uint32_t*)(src + pos);
            for (int x = 0; x < w; x++) dst[x * 3] = (float)s[x];
          }
        }
        pos += (size_t)w * ts;
      }
    }
  }
  *height = ht;
  *width = w;
  return true;
}

// Box-filter area resize: each output pixel averages the source area it
// covers, with fractional edge weights (downscale); when upscaling that
// area lies within one or two source pixels.
void area_resize(const float* src, int sh, int sw, float* dst, int dh, int dw) {
  if (dh == sh && dw == sw) {
    std::memcpy(dst, src, (size_t)sh * sw * 3 * sizeof(float));
    return;
  }
  double sy = (double)sh / dh, sx = (double)sw / dw;
  for (int y = 0; y < dh; y++) {
    double y0 = y * sy, y1 = (y + 1) * sy;
    int iy0 = (int)y0, iy1 = std::min((int)std::ceil(y1), sh);
    for (int x = 0; x < dw; x++) {
      double x0 = x * sx, x1 = (x + 1) * sx;
      int ix0 = (int)x0, ix1 = std::min((int)std::ceil(x1), sw);
      double acc[3] = {0, 0, 0}, total = 0;
      for (int yy = iy0; yy < iy1; yy++) {
        double wy = std::min((double)yy + 1, y1) - std::max((double)yy, y0);
        for (int xx = ix0; xx < ix1; xx++) {
          double wx = std::min((double)xx + 1, x1) - std::max((double)xx, x0);
          double wgt = wy * wx;
          const float* p = src + ((size_t)yy * sw + xx) * 3;
          // fused multiply-adds, as g++ contracts these products where the
          // target has FMA (the JAX package builds with -march=native); this
          // library is built for any x86-64, so it asks for them explicitly
          acc[0] = std::fma(wgt, (double)p[0], acc[0]);
          acc[1] = std::fma(wgt, (double)p[1], acc[1]);
          acc[2] = std::fma(wgt, (double)p[2], acc[2]);
          total += wgt;
        }
      }
      float* q = dst + ((size_t)y * dw + x) * 3;
      q[0] = (float)(acc[0] / total);
      q[1] = (float)(acc[1] / total);
      q[2] = (float)(acc[2] / total);
    }
  }
}

// numpy-style linear-interpolated percentile of the positive values of the
// gamma-powered pixels; returns alpha = max_mapping / (pct + 1e-10) and
// optionally writes the clipped tonemapped image (TonemapHDR semantics).
float tonemap_alpha_impl(float* img, size_t n, float gamma, float percentile,
                         float max_mapping, bool apply) {
  std::vector<float> powered(n);
  float inv_g = 1.0f / gamma;
  for (size_t i = 0; i < n; i++)
    powered[i] = img[i] > 0 ? std::pow(img[i], inv_g) : (img[i] == 0 ? 0.0f : NAN);
  std::vector<float> nz;
  nz.reserve(n);
  for (float v : powered)
    if (v > 0) nz.push_back(v);
  std::vector<float>& pool = nz.empty() ? powered : nz;
  double idx = (pool.size() - 1) * (double)percentile / 100.0;
  size_t lo = (size_t)idx;
  double frac = idx - lo;
  std::nth_element(pool.begin(), pool.begin() + lo, pool.end());
  float vlo = pool[lo];
  float vhi = vlo;
  if (frac > 0 && lo + 1 < pool.size()) {
    vhi = *std::min_element(pool.begin() + lo + 1, pool.end());
  }
  float pct = (float)(vlo * (1 - frac) + vhi * frac);
  float alpha = max_mapping / (pct + 1e-10f);
  if (apply) {
    for (size_t i = 0; i < n; i++) {
      float v = alpha * powered[i];
      img[i] = v < 0 ? 0 : (v > 1 ? 1 : v);
    }
  }
  return alpha;
}

}  // namespace

extern "C" {

const char* emlight_last_error() { return g_error.c_str(); }

// Probe dimensions: returns 0 on success.
int emlight_exr_dims(const char* path, int* height, int* width) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return set_error("cannot open"), 1;
  // the whole file: a header has no size limit (a preview image, comments)
  std::vector<uint8_t> buf((std::istreambuf_iterator<char>(f)),
                           std::istreambuf_iterator<char>());
  Header h;
  if (!parse_header(buf, &h)) return 1;
  *height = h.height;
  *width = h.width;
  return 0;
}

// Decode one EXR into a caller buffer of h*w*3 floats (native size).
int emlight_read_exr(const char* path, float* out, int height, int width) {
  std::vector<float> img;
  int h, w;
  if (!decode_exr(path, &img, &h, &w)) return 1;
  if (h != height || w != width) return set_error("dim mismatch"), 1;
  std::memcpy(out, img.data(), img.size() * sizeof(float));
  return 0;
}

// Multithreaded batch load: decode n files, area-resize to (out_h, out_w),
// optional tonemap (gamma/percentile/max_mapping; apply=0 computes alpha
// only, alphas may be null), write into out (n, out_h, out_w, 3) and
// alphas (n). On failure returns 1, the error naming the first file (in
// batch order) that failed.
int emlight_load_batch(const char** paths, int n, float* out, int out_h,
                       int out_w, int apply_tonemap, float gamma,
                       float percentile, float max_mapping, float* alphas,
                       int n_threads) {
  std::atomic<int> next(0);
  std::atomic<bool> failed(false);
  std::vector<std::string> errors(n);  // one slot per file: no shared writes
  int workers = n_threads > 0 ? n_threads
                              : std::min<int>(n, std::thread::hardware_concurrency());
  workers = std::max(workers, 1);
  auto work = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load()) return;
      std::vector<float> img;
      int h, w;
      if (!decode_exr(paths[i], &img, &h, &w)) {
        errors[i] = g_error.empty() ? "decode failed" : g_error;  // this thread's
        failed.store(true);
        return;
      }
      float* dst = out + (size_t)i * out_h * out_w * 3;
      area_resize(img.data(), h, w, dst, out_h, out_w);
      if (alphas) {
        alphas[i] = tonemap_alpha_impl(dst, (size_t)out_h * out_w * 3, gamma,
                                       percentile, max_mapping,
                                       apply_tonemap != 0);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; t++) pool.emplace_back(work);
  for (auto& t : pool) t.join();
  for (int i = 0; i < n; i++)
    if (!errors[i].empty())
      return set_error(std::string(paths[i]) + ": " + errors[i]), 1;
  return 0;
}

// TonemapHDR: returns alpha; apply!=0 also writes the clipped tonemap in place.
float emlight_tonemap_alpha(float* img, long long n, float gamma,
                            float percentile, float max_mapping, int apply) {
  return tonemap_alpha_impl(img, (size_t)n, gamma, percentile, max_mapping,
                            apply != 0);
}

// Write (h, w, 3) float32 as a ZIP-compressed FLOAT or HALF EXR.
int emlight_write_exr(const char* path, const float* data, int h, int w,
                      int half) {
  std::ofstream f(path, std::ios::binary);
  if (!f) return set_error("cannot open for write"), 1;
  auto put32 = [&](int32_t v) { f.write((const char*)&v, 4); };
  auto put64 = [&](int64_t v) { f.write((const char*)&v, 8); };
  auto attr = [&](const char* name, const char* type, const void* payload,
                  int size) {
    f.write(name, std::strlen(name) + 1);
    f.write(type, std::strlen(type) + 1);
    put32(size);
    f.write((const char*)payload, size);
  };
  put32(kMagic);
  put32(2);
  // channels B, G, R (alphabetical)
  std::vector<uint8_t> chan;
  for (const char* nm : {"B", "G", "R"}) {
    chan.insert(chan.end(), (const uint8_t*)nm, (const uint8_t*)nm + 2);
    int32_t vals[4] = {half ? HALF : FLOAT, 0, 1, 1};
    chan.insert(chan.end(), (uint8_t*)vals, (uint8_t*)vals + 16);
  }
  chan.push_back(0);
  // header (attribute order mirrors the python codec)
  attr("channels", "chlist", chan.data(), (int)chan.size());
  int8_t comp = ZIP;
  attr("compression", "compression", &comp, 1);
  int32_t box[4] = {0, 0, w - 1, h - 1};
  attr("dataWindow", "box2i", box, 16);
  attr("displayWindow", "box2i", box, 16);
  int8_t lo = 0;
  attr("lineOrder", "lineOrder", &lo, 1);
  float par = 1.0f;
  attr("pixelAspectRatio", "float", &par, 4);
  float swc[2] = {0, 0};
  attr("screenWindowCenter", "v2f", swc, 8);
  float sww = 1.0f;
  attr("screenWindowWidth", "float", &sww, 4);
  char zero = 0;
  f.write(&zero, 1);

  int ts = half ? 2 : 4;
  int lines_per_chunk = 16;
  int n_chunks = (h + lines_per_chunk - 1) / lines_per_chunk;
  size_t bytes_per_line = (size_t)w * 3 * ts;

  // build chunks first to know offsets
  std::vector<std::vector<uint8_t>> chunks(n_chunks);
  std::vector<uint8_t> raw, pre, comp_buf;
  for (int ci = 0; ci < n_chunks; ci++) {
    int row0 = ci * lines_per_chunk;
    int n_lines = std::min(lines_per_chunk, h - row0);
    raw.resize(bytes_per_line * n_lines);
    size_t pos = 0;
    for (int li = 0; li < n_lines; li++) {
      const float* srcrow = data + (size_t)(row0 + li) * w * 3;
      for (int plane : {2, 1, 0}) {  // B, G, R
        if (half) {
          uint16_t* d = (uint16_t*)(raw.data() + pos);
          for (int x = 0; x < w; x++) d[x] = float_to_half(srcrow[x * 3 + plane]);
        } else {
          float* d = (float*)(raw.data() + pos);
          for (int x = 0; x < w; x++) d[x] = srcrow[x * 3 + plane];
        }
        pos += (size_t)w * ts;
      }
    }
    zip_preprocess(raw.data(), raw.size(), &pre);
    uLongf bound = compressBound(pre.size());
    comp_buf.resize(bound);
    compress2(comp_buf.data(), &bound, pre.data(), pre.size(), 6);
    if (bound >= raw.size()) {
      chunks[ci] = raw;
    } else {
      chunks[ci].assign(comp_buf.begin(), comp_buf.begin() + bound);
    }
  }
  int64_t off = (int64_t)f.tellp() + 8LL * n_chunks;
  for (int ci = 0; ci < n_chunks; ci++) {
    put64(off);
    off += 8 + (int64_t)chunks[ci].size();
  }
  for (int ci = 0; ci < n_chunks; ci++) {
    put32(ci * lines_per_chunk);
    put32((int32_t)chunks[ci].size());
    f.write((const char*)chunks[ci].data(), chunks[ci].size());
  }
  return f.good() ? 0 : 1;
}

}  // extern "C"
