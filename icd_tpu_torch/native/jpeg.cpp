// JPEG codec and bilinear resize whose pixels equal Pillow's.
//
// decode: baseline, extended (SOF1) and progressive Huffman JPEGs of 8-bit
// precision, 1, 3 or 4 components, with the output that
// Image.open(f).convert("RGB") gives over libjpeg-turbo: the ISLOW inverse
// DCT (jidctint.c), fancy upsampling (jdsample.c: h2v1, h1v2 and h2v2,
// box upsampling where libjpeg-turbo takes it), the YCC->RGB tables of
// jdcolor.c, libjpeg's colour-space guess (jdapimin.c) and Pillow's
// CMYK -> RGB (Convert.c). Arithmetic coding, lossless and 12-bit files
// are refused, and so are truncated or corrupt files: a partial image is
// never returned. Every read of the input is bounds-checked.
//
// resize: Pillow's Image.resize((w, h), BILINEAR) (Resample.c: coefficients
// in double, 22 fraction bits rounded half away from zero, the horizontal
// pass over the rows that the vertical pass needs, clipping after each).
//
// encode: what libjpeg-turbo writes under Pillow's save(): jccolor.c's
// RGB->YCC, jcsample.c's downsampling, the ISLOW forward DCT (jfdctint.c),
// jcdctmgr.c's reciprocal quantizer, jcparam.c's quality scaling, Annex K
// Huffman tables or jchuff.c's optimal ones, jcphuff.c's progressive
// scans (jcparam.c's jpeg_simple_progression), restart intervals and the
// JFIF APP0 header.
//
// C ABI for ctypes; no global mutable state, so calls may run in parallel.

#include <algorithm>
#include <cmath>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

const int kZigzag[64 + 16] = {  // natural order of the k-th zigzag coefficient
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// Huffman tables (jdhuff.c: jpeg_make_d_derived_tbl; jstdhuff.c)

struct HuffSpec {
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  bool defined = false;
};

const uint8_t kBitsDcLum[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kValDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsDcChr[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kBitsAcLum[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValAcLum[162] = {
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
const uint8_t kBitsAcChr[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValAcChr[162] = {
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

HuffSpec std_spec(bool dc, bool chroma) {
  HuffSpec s;
  const uint8_t* bits = dc ? (chroma ? kBitsDcChr : kBitsDcLum)
                           : (chroma ? kBitsAcChr : kBitsAcLum);
  const uint8_t* vals = dc ? kValDc : (chroma ? kValAcChr : kValAcLum);
  int n = 0;
  for (int i = 0; i <= 16; ++i) {
    s.bits[i] = bits[i];
    if (i) n += bits[i];
  }
  std::memcpy(s.vals, vals, n);
  s.defined = true;
  return s;
}

constexpr int kLookBits = 9;

struct DecodeTable {
  int32_t maxcode[17];
  int32_t valoffset[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | symbol, or 0 for longer codes.
  uint16_t look[1 << kLookBits];
};

void build_decode_table(const HuffSpec& s, bool dc, DecodeTable* t) {
  int huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int count = s.bits[l];
    if (p + count > 256) fail("corrupt Huffman table (more than 256 codes)");
    while (count--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  int numsymbols = p;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1u << si)) fail("corrupt Huffman table (code overflow)");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (s.bits[l]) {
      t->valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += s.bits[l];
      t->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  std::memcpy(t->vals, s.vals, 256);
  std::memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 1; i <= s.bits[l]; ++i, ++p) {
      int lookbits = static_cast<int>(huffcode[p]) << (kLookBits - l);
      for (int ctr = 1 << (kLookBits - l); ctr > 0; --ctr)
        t->look[lookbits++] = static_cast<uint16_t>((l << 8) | s.vals[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < numsymbols; ++i)
      if (s.vals[i] > 15) fail("corrupt Huffman table (DC symbol above 15)");
  }
}

// ---------------------------------------------------------------------------
// Entropy-coded segment reader (jdhuff.c: jpeg_fill_bit_buffer)

struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;
  int64_t real_bits = 0;  // bits taken from the segment (zeros past a marker do not count)
  int64_t used_bits = 0;

  void start(const uint8_t* data, size_t size, size_t p) {
    d = data;
    n = size;
    pos = p;
    buf = 0;
    cnt = 0;
    at_marker = false;
    real_bits = used_bits = 0;
  }

  void fill() {
    while (cnt <= 56) {
      unsigned c = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
        } else {
          c = d[pos];
          if (c == 0xFF) {
            size_t q = pos + 1;
            while (q < n && d[q] == 0xFF) ++q;
            if (q < n && d[q] == 0) {
              pos = q + 1;  // FF (FF)* 00 is one FF data byte
            } else {
              at_marker = true;  // pos stays on the marker
              c = 0;
            }
          } else {
            ++pos;
          }
          if (!at_marker) real_bits += 8;
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - cnt);
      cnt += 8;
    }
  }

  inline unsigned peek(int k) {
    if (cnt < k) fill();
    return static_cast<unsigned>(buf >> (64 - k));
  }
  inline void skip(int k) {
    buf <<= k;
    cnt -= k;
    used_bits += k;
  }
  inline int bits(int k) {  // k in 0..16
    if (k == 0) return 0;
    unsigned v = peek(k);
    skip(k);
    return static_cast<int>(v);
  }
  inline int bit() { return bits(1); }

  inline int decode(const DecodeTable& t) {
    unsigned look = peek(kLookBits);
    uint16_t e = t.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    unsigned code = peek(16);
    int l = kLookBits + 1;
    int32_t c = 0;
    for (; l <= 16; ++l) {
      c = static_cast<int32_t>(code >> (16 - l));
      if (c <= t.maxcode[l]) break;
    }
    if (l > 16) fail("corrupt JPEG data: bad Huffman code");
    skip(l);
    int idx = c + t.valoffset[l];
    if (idx < 0 || idx > 255) fail("corrupt JPEG data: bad Huffman code");
    return t.vals[idx];
  }

  void check() const {
    if (used_bits > real_bits)
      fail("corrupt or truncated JPEG: entropy-coded data ends early");
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// The DC predictor plus a difference, refused where libjpeg-turbo
// refuses it (the sum would overflow an int).
inline int add_dc(int pred, int diff) {
  int64_t sum = static_cast<int64_t>(pred) + diff;
  if (sum > INT32_MAX || sum < INT32_MIN)
    fail("corrupt JPEG data: DC coefficient out of range");
  return static_cast<int>(sum);
}

// ---------------------------------------------------------------------------
// Inverse DCT: jidctint.c jpeg_idct_islow

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: the sample, taken as a signed 10-bit
// value, plus 128, clamped to 0..255.
inline uint8_t idct_limit(int64_t x) {
  int v = static_cast<int>(x & 1023);
  if (v >= 512) v -= 1024;
  return clamp255(v + 128);
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = (int(ip[0]) * int(qp[0])) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int(ip[16]) * int(qp[16]);
    int64_t z3 = int(ip[48]) * int(qp[48]);
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int(ip[0]) * int(qp[0]);
    z3 = int(ip[32]) * int(qp[32]);
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int(ip[56]) * int(qp[56]);
    tmp1 = int(ip[40]) * int(qp[40]);
    tmp2 = int(ip[24]) * int(qp[24]);
    tmp3 = int(ip[8]) * int(qp[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = int(descale(tmp10 + tmp3, sh));
    wp[56] = int(descale(tmp10 - tmp3, sh));
    wp[8] = int(descale(tmp11 + tmp2, sh));
    wp[48] = int(descale(tmp11 - tmp2, sh));
    wp[16] = int(descale(tmp12 + tmp1, sh));
    wp[40] = int(descale(tmp12 - tmp1, sh));
    wp[24] = int(descale(tmp13 + tmp0, sh));
    wp[32] = int(descale(tmp13 - tmp0, sh));
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = idct_limit(descale(wp[0], kPass1Bits + 3));
      for (int i = 0; i < 8; ++i) op[i] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(descale(tmp10 + tmp3, sh));
    op[7] = idct_limit(descale(tmp10 - tmp3, sh));
    op[1] = idct_limit(descale(tmp11 + tmp2, sh));
    op[6] = idct_limit(descale(tmp11 - tmp2, sh));
    op[2] = idct_limit(descale(tmp12 + tmp1, sh));
    op[5] = idct_limit(descale(tmp12 - tmp1, sh));
    op[3] = idct_limit(descale(tmp13 + tmp0, sh));
    op[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// ---------------------------------------------------------------------------
// Decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int cw = 0, ch = 0;      // samples (downsampled_width / height)
  int bw = 0, bh = 0;      // blocks of a non-interleaved scan
  int pbw = 0, pbh = 0;    // blocks allocated (whole MCUs)
  std::vector<int16_t> coef;
  int16_t qt[64];
  bool latched = false;
  int coef_bits[64];
  int dc_pred = 0;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;

  uint16_t qtables[4][64];
  bool qdefined[4] = {false, false, false, false};
  HuffSpec dc_spec[4], ac_spec[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;

  bool frame = false, progressive = false;
  int width = 0, height = 0, ncomp = 0;
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  bool std_tables_set = false;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u8() {
    if (pos >= n) fail("truncated JPEG: the file ends inside a marker");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // jdmarker.c next_marker: skip garbage and FF fill bytes.
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      if (pos >= n) fail("truncated JPEG: no EOI marker");
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) fail("truncated JPEG: no EOI marker");
      int c = d[pos++];
      if (c != 0) return c;
    }
  }

  size_t segment_end() {
    int len = u16();
    if (len < 2) fail("corrupt JPEG: marker length below 2");
    size_t end = pos + static_cast<size_t>(len) - 2;
    if (end > n) fail("truncated JPEG: the file ends inside a marker");
    return end;
  }

  void read_dqt() {
    size_t end = segment_end();
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("corrupt JPEG: quantization table id above 3");
      if (pq > 1) fail("corrupt JPEG: quantization table precision");
      if (pos + (pq ? 128 : 64) > end) fail("corrupt JPEG: short DQT");
      for (int k = 0; k < 64; ++k)
        qtables[tq][kZigzag[k]] = static_cast<uint16_t>(pq ? u16() : u8());
      qdefined[tq] = true;
    }
    if (pos != end) fail("corrupt JPEG: DQT length");
  }

  void read_dht() {
    size_t end = segment_end();
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: Huffman table class or id");
      HuffSpec s;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        s.bits[i] = static_cast<uint8_t>(u8());
        count += s.bits[i];
      }
      if (count > 256 || pos + count > end)
        fail("corrupt JPEG: Huffman table size");
      for (int i = 0; i < count; ++i) s.vals[i] = static_cast<uint8_t>(u8());
      s.defined = true;
      (tc ? ac_spec : dc_spec)[th] = s;
    }
    if (pos != end) fail("corrupt JPEG: DHT length");
  }

  void read_app(int marker) {
    size_t end = segment_end();
    size_t len = end - pos;
    const uint8_t* p = d + pos;
    if (marker == 0xE0 && len >= 14 && p[0] == 'J' && p[1] == 'F' &&
        p[2] == 'I' && p[3] == 'F' && p[4] == 0)
      saw_jfif = true;
    if (marker == 0xEE && len >= 12 && p[0] == 'A' && p[1] == 'd' &&
        p[2] == 'o' && p[3] == 'b' && p[4] == 'e') {
      saw_adobe = true;
      adobe_transform = p[11];
    }
    pos = end;
  }

  void read_sof(int marker) {
    if (frame) fail("corrupt JPEG: two frames");
    size_t end = segment_end();
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      fail("unsupported JPEG: " + std::to_string(precision) +
           "-bit precision (only 8-bit is read)");
    if (height == 0)
      fail("unsupported JPEG: height 0 (a DNL marker; not read)");
    if (width == 0) fail("corrupt JPEG: width 0");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("unsupported JPEG: " + std::to_string(ncomp) + " components");
    if (pos + 3 * ncomp != end) fail("corrupt JPEG: SOF length");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("corrupt JPEG: sampling factor");
      if (c.tq > 3) fail("corrupt JPEG: quantization table id above 3");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    if (static_cast<int64_t>(width) * height > (int64_t(1) << 30))
      fail("unsupported JPEG: more than 2^30 pixels");
    progressive = marker == 0xC2;
    mcux = (width + 8 * max_h - 1) / (8 * max_h);
    mcuy = (height + 8 * max_v - 1) / (8 * max_v);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (max_h % c.h || max_v % c.v)
        fail("unsupported JPEG: fractional sampling factors");
      c.cw = static_cast<int>((int64_t(width) * c.h + max_h - 1) / max_h);
      c.ch = static_cast<int>((int64_t(height) * c.v + max_v - 1) / max_v);
      c.bw = (c.cw + 7) / 8;
      c.bh = (c.ch + 7) / 8;
      c.pbw = mcux * c.h;
      c.pbh = mcuy * c.v;
      c.coef.assign(static_cast<size_t>(c.pbw) * c.pbh * 64, 0);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    frame = true;
  }

  void read_scan() {
    if (!frame) fail("corrupt JPEG: scan before frame");
    if (!std_tables_set) {
      // jdhuff.c: missing tables 0 and 1 are the standard ones (Motion JPEG).
      for (int i = 0; i < 2; ++i) {
        if (!dc_spec[i].defined) dc_spec[i] = std_spec(true, i == 1);
        if (!ac_spec[i].defined) ac_spec[i] = std_spec(false, i == 1);
      }
      std_tables_set = true;
    }
    size_t end = segment_end();
    int ns = u8();
    if (ns < 1 || ns > 4 || pos + 2 * ns + 3 != end)
      fail("corrupt JPEG: SOS length");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = u8();
      int t = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("corrupt JPEG: scan names an unknown component");
      for (int j = 0; j < i; ++j)
        if (sc[j] == c) fail("corrupt JPEG: component twice in a scan");
      c->dc_tbl = t >> 4;
      c->ac_tbl = t & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3)
        fail("corrupt JPEG: Huffman table id above 3");
      sc[i] = c;
    }
    int ss = u8(), se = u8(), a = u8();
    int ah = a >> 4, al = a & 15;
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) {
        // libjpeg ignores these fields in sequential scans (warning only)
        ss = 0;
        se = 63;
        ah = al = 0;
      }
    } else {
      bool bad = false;
      if (ss == 0) {
        if (se != 0) bad = true;
      } else {
        if (ss > se || se > 63) bad = true;
        if (ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("corrupt JPEG: invalid progressive scan parameters");
    }
    // jdinput.c latch_quant_tables: a component's table is fixed at its
    // first scan.
    for (int i = 0; i < ns; ++i) {
      Component* c = sc[i];
      if (c->latched) continue;
      if (!qdefined[c->tq]) fail("corrupt JPEG: quantization table missing");
      for (int k = 0; k < 64; ++k)
        c->qt[k] = static_cast<int16_t>(qtables[c->tq][k]);
      c->latched = true;
    }
    if (progressive) {
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
    }
    // Tables this scan needs.
    DecodeTable dct[4], act[4];
    bool need_dc = !progressive || (ss == 0 && ah == 0);
    bool need_ac = !progressive || ss > 0;
    for (int i = 0; i < ns; ++i) {
      if (need_dc) {
        const HuffSpec& s = dc_spec[sc[i]->dc_tbl];
        if (!s.defined) fail("corrupt JPEG: Huffman table missing");
        build_decode_table(s, true, &dct[sc[i]->dc_tbl]);
      }
      if (need_ac) {
        const HuffSpec& s = ac_spec[sc[i]->ac_tbl];
        if (!s.defined) fail("corrupt JPEG: Huffman table missing");
        build_decode_table(s, false, &act[sc[i]->ac_tbl]);
      }
    }
    decode_scan(sc, ns, ss, se, ah, al, dct, act);
  }

  void decode_scan(Component** sc, int ns, int ss, int se, int ah, int al,
                   const DecodeTable* dct, const DecodeTable* act) {
    BitReader br;
    br.start(d, n, pos);
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    int eobrun = 0;
    int64_t total;
    int units_x;
    if (ns == 1) {
      units_x = sc[0]->bw;
      total = static_cast<int64_t>(sc[0]->bw) * sc[0]->bh;
    } else {
      units_x = mcux;
      total = static_cast<int64_t>(mcux) * mcuy;
    }
    int next_rst = 0;
    int64_t togo = restart_interval;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && togo == 0) {
        // jdhuff.c process_restart: drop the partial byte, expect RSTn.
        pos = br.pos;
        int mk = next_marker();
        if (mk != 0xD0 + next_rst)
          fail("corrupt JPEG: restart marker missing or out of order");
        next_rst = (next_rst + 1) & 7;
        br.start(d, n, pos);
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        eobrun = 0;
        togo = restart_interval;
      }
      int mx = static_cast<int>(m % units_x), my = static_cast<int>(m / units_x);
      for (int i = 0; i < ns; ++i) {
        Component* c = sc[i];
        int nh = ns == 1 ? 1 : c->h, nv = ns == 1 ? 1 : c->v;
        for (int v = 0; v < nv; ++v) {
          for (int h = 0; h < nh; ++h) {
            int bx = ns == 1 ? mx : mx * c->h + h;
            int by = ns == 1 ? my : my * c->v + v;
            int16_t* blk = &c->coef[(static_cast<size_t>(by) * c->pbw + bx) * 64];
            if (!progressive) {
              decode_block(br, blk, dct[c->dc_tbl], act[c->ac_tbl], &c->dc_pred);
            } else if (ss == 0) {
              if (ah == 0) {
                int s = br.decode(dct[c->dc_tbl]);
                c->dc_pred = add_dc(c->dc_pred, s ? extend(br.bits(s), s) : 0);
                blk[0] = static_cast<int16_t>(static_cast<int64_t>(c->dc_pred)
                                              * (1 << al));
              } else if (br.bit()) {
                blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
              }
            } else if (ah == 0) {
              ac_first(br, blk, act[c->ac_tbl], ss, se, al, &eobrun);
            } else {
              ac_refine(br, blk, act[c->ac_tbl], ss, se, al, &eobrun);
            }
          }
        }
      }
      br.check();
      if (restart_interval) --togo;
    }
    pos = br.pos;
  }

  static void decode_block(BitReader& br, int16_t* blk, const DecodeTable& dc,
                           const DecodeTable& ac, int* pred) {
    int s = br.decode(dc);
    *pred = add_dc(*pred, s ? extend(br.bits(s), s) : 0);
    blk[0] = static_cast<int16_t>(*pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ac);
      int run = rs >> 4;
      s = rs & 15;
      if (s) {
        k += run;
        if (k > 63) fail("corrupt JPEG data: AC run past the block");
        blk[kZigzag[k]] = static_cast<int16_t>(extend(br.bits(s), s));
      } else {
        if (run != 15) break;
        k += 15;
      }
    }
  }

  static void ac_first(BitReader& br, int16_t* blk, const DecodeTable& ac,
                       int ss, int se, int al, int* eobrun) {
    if (*eobrun > 0) {
      --*eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) fail("corrupt JPEG data: AC run past the band");
        blk[kZigzag[k]] = static_cast<int16_t>(extend(br.bits(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += br.bits(r);
        --*eobrun;
        break;
      }
    }
  }

  static void ac_refine(BitReader& br, int16_t* blk, const DecodeTable& ac,
                        int ss, int se, int al, int* eobrun) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (*eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt JPEG data: refinement coefficient size");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* c = &blk[kZigzag[k]];
          if (*c != 0) {
            if (br.bit() && (*c & p1) == 0)
              *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          if (k > se) fail("corrupt JPEG data: AC run past the band");
          blk[kZigzag[k]] = static_cast<int16_t>(s);
        }
      }
    }
    if (*eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* c = &blk[kZigzag[k]];
        if (*c != 0 && br.bit() && (*c & p1) == 0)
          *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
      }
      --*eobrun;
    }
  }

  // Reads the markers and scans up to EOI, or only up to the frame
  // header when header_only is set.
  void parse(bool header_only = false) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG (no SOI marker)");
    pos = 2;
    bool scanned = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn: libjpeg skips it
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(m);
          if (header_only) return;
          break;
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail("unsupported JPEG: lossless coding");
        case 0xC5:
        case 0xC6:
        case 0xCD:
        case 0xCE:
          fail("unsupported JPEG: hierarchical (differential) coding");
        case 0xC9:
        case 0xCA:
          fail("unsupported JPEG: arithmetic coding");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD: {
          size_t end = segment_end();
          if (end - pos != 2) fail("corrupt JPEG: DRI length");
          restart_interval = u16();
          break;
        }
        case 0xDA:
          read_scan();
          scanned = true;
          break;
        case 0xD8:
          fail("corrupt JPEG: SOI inside the image");
        case 0xDC:
          fail("unsupported JPEG: DNL marker");
        case 0x01:  // TEM: no segment
          break;
        case 0xCC:  // DAC: only arithmetic frames, refused above, use it
        case 0xFE:  // COM
          pos = segment_end();
          break;
        default:
          if (m < 0xE0 || m > 0xEF)
            fail("corrupt JPEG: unknown marker 0x" + std::to_string(m));
          read_app(m);
      }
    }
    if (!frame || !scanned) fail("corrupt JPEG: no image data");
  }

  // jdcoefct.c smoothing_ok: libjpeg-turbo block-smooths a progressive
  // image whose first AC coefficients were left unrefined; that output is
  // not reproduced, so such files are refused.
  void check_smoothing() const {
    if (!progressive) return;
    static const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched) return;
      for (int k = 0; k < 10; ++k)
        if (c.qt[kQPos[k]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      fail("unsupported JPEG: progressive scans leave low AC coefficients "
           "unrefined (libjpeg block-smooths such images)");
  }

  // Component plane after the inverse DCT: pbw*8 x pbh*8 samples.
  std::vector<uint8_t> plane(const Component& c) const {
    int stride = c.pbw * 8;
    std::vector<uint8_t> out(static_cast<size_t>(stride) * c.pbh * 8, 0);
    int16_t zero_q[64] = {0};
    const int16_t* q = c.latched ? c.qt : zero_q;
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(&c.coef[(static_cast<size_t>(by) * c.pbw + bx) * 64], q,
                   &out[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
    return out;
  }
};

// Upsample one component plane to width x height (jdsample.c).
void upsample(const std::vector<uint8_t>& in, int stride, const Component& c,
              int max_h, int max_v, int width, int height, uint8_t* out) {
  const int hx = max_h / c.h, vx = max_v / c.v;
  const int cw = c.cw, ch = c.ch;
  auto row = [&](int y) {
    y = y < 0 ? 0 : (y >= ch ? ch - 1 : y);
    return &in[static_cast<size_t>(y) * stride];
  };
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < height; ++y)
      std::memcpy(out + static_cast<size_t>(y) * width, row(y), width);
    return;
  }
  if (hx == 2 && vx == 1 && cw > 2) {  // h2v1_fancy_upsample
    std::vector<uint8_t> tmp(2 * cw);
    for (int y = 0; y < height; ++y) {
      const uint8_t* ip = row(y);
      for (int i = 0; i < cw; ++i) {
        int l = ip[i > 0 ? i - 1 : 0], r = ip[i < cw - 1 ? i + 1 : cw - 1];
        int t = ip[i] * 3;
        tmp[2 * i] = static_cast<uint8_t>((t + l + 1) >> 2);
        tmp[2 * i + 1] = static_cast<uint8_t>((t + r + 2) >> 2);
      }
      std::memcpy(out + static_cast<size_t>(y) * width, tmp.data(), width);
    }
    return;
  }
  if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < height; ++y) {
      int j = y >> 1;
      const uint8_t* p0 = row(j);
      const uint8_t* p1 = row((y & 1) ? j + 1 : j - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* op = out + static_cast<size_t>(y) * width;
      for (int x = 0; x < width; ++x)
        op[x] = static_cast<uint8_t>((p0[x] * 3 + p1[x] + bias) >> 2);
    }
    return;
  }
  if (hx == 2 && vx == 2 && cw > 2) {  // h2v2_fancy_upsample
    std::vector<int> cs(cw);
    std::vector<uint8_t> tmp(2 * cw);
    for (int y = 0; y < height; ++y) {
      int j = y >> 1;
      const uint8_t* p0 = row(j);
      const uint8_t* p1 = row((y & 1) ? j + 1 : j - 1);
      for (int i = 0; i < cw; ++i) cs[i] = p0[i] * 3 + p1[i];
      for (int i = 0; i < cw; ++i) {
        int l = cs[i > 0 ? i - 1 : 0], r = cs[i < cw - 1 ? i + 1 : cw - 1];
        tmp[2 * i] = static_cast<uint8_t>((cs[i] * 3 + l + 8) >> 4);
        tmp[2 * i + 1] = static_cast<uint8_t>((cs[i] * 3 + r + 7) >> 4);
      }
      std::memcpy(out + static_cast<size_t>(y) * width, tmp.data(), width);
    }
    return;
  }
  // Box replication (h2v1_upsample, h2v2_upsample, int_upsample).
  for (int y = 0; y < height; ++y) {
    const uint8_t* ip = &in[static_cast<size_t>(y / vx) * stride];
    uint8_t* op = out + static_cast<size_t>(y) * width;
    for (int x = 0; x < width; ++x) op[x] = ip[x / hx];
  }
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {  // jdcolor.c build_ycc_rgb_table
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

// Pillow's Convert.c cmyk2rgb over Pillow's (inverted, "CMYK;I") samples.
inline uint8_t cmyk_channel(int c, int nk) {
  int tmp = c * nk + 128;
  int m = ((tmp >> 8) + tmp) >> 8;
  return clamp255(nk - m);
}

enum class Space { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

Space color_space(const Decoder& dec) {  // jdapimin.c default_decompress_parms
  if (dec.ncomp == 1) return Space::kGray;
  if (dec.ncomp == 3) {
    if (dec.saw_jfif) return Space::kYCbCr;
    if (dec.saw_adobe) return dec.adobe_transform == 0 ? Space::kRGB : Space::kYCbCr;
    int c0 = dec.comp[0].id, c1 = dec.comp[1].id, c2 = dec.comp[2].id;
    if (c0 == 82 && c1 == 71 && c2 == 66) return Space::kRGB;
    return Space::kYCbCr;
  }
  if (dec.saw_adobe && dec.adobe_transform == 0) return Space::kCMYK;
  return dec.saw_adobe ? Space::kYCCK : Space::kCMYK;
}

void decode_rgb(const uint8_t* data, size_t size, std::vector<uint8_t>* rgb,
                int* w, int* h) {
  Decoder dec(data, size);
  dec.parse();
  dec.check_smoothing();
  const int W = dec.width, H = dec.height;
  const size_t npix = static_cast<size_t>(W) * H;
  std::vector<uint8_t> planes[4];
  for (int i = 0; i < dec.ncomp; ++i) {
    const Component& c = dec.comp[i];
    std::vector<uint8_t> p = dec.plane(c);
    planes[i].resize(npix);
    upsample(p, c.pbw * 8, c, dec.max_h, dec.max_v, W, H, planes[i].data());
  }
  rgb->resize(npix * 3);
  uint8_t* o = rgb->data();
  Space space = color_space(dec);
  if (space == Space::kGray) {
    const uint8_t* g = planes[0].data();
    for (size_t i = 0; i < npix; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = g[i];
  } else if (space == Space::kRGB) {
    for (size_t i = 0; i < npix; ++i)
      for (int k = 0; k < 3; ++k) o[3 * i + k] = planes[k][i];
  } else {
    static const YccTables t;
    const uint8_t *p0 = planes[0].data(), *p1 = planes[1].data(),
                  *p2 = planes[2].data();
    for (size_t i = 0; i < npix; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      int r = y + t.cr_r[cr];
      int g = y + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> 16);
      int b = y + t.cb_b[cb];
      if (space == Space::kYCbCr) {
        o[3 * i] = clamp255(r);
        o[3 * i + 1] = clamp255(g);
        o[3 * i + 2] = clamp255(b);
        continue;
      }
      // libjpeg's CMYK samples: raw, or from YCCK by jdcolor.c
      // ycck_cmyk_convert; Pillow reads them inverted ("CMYK;I"), so its
      // C is 255 - c and its 255 - K is libjpeg's k.
      int c0 = y, c1 = cb, c2 = cr;
      if (space == Space::kYCCK) {
        c0 = clamp255(255 - r);
        c1 = clamp255(255 - g);
        c2 = clamp255(255 - b);
      }
      int nk = planes[3][i];
      o[3 * i] = cmyk_channel(255 - c0, nk);
      o[3 * i + 1] = cmyk_channel(255 - c1, nk);
      o[3 * i + 2] = cmyk_channel(255 - c2, nk);
    }
  }
  *w = W;
  *h = H;
}

// ---------------------------------------------------------------------------
// Pillow's BILINEAR resize (Resample.c)

constexpr int kPrecisionBits = 32 - 8 - 2;

int precompute_coeffs(int in_size, int out_size, std::vector<int>* bounds,
                      std::vector<int32_t>* kk) {
  const float in0 = 0.0f, in1 = static_cast<float>(in_size);
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  std::vector<double> k(static_cast<size_t>(out_size) * ksize, 0.0);
  bounds->assign(static_cast<size_t>(out_size) * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* kp = &k[static_cast<size_t>(xx) * ksize];
    for (int x = 0; x < xmax; ++x) {
      double t = (x + xmin - center + 0.5) * ss;
      if (t < 0.0) t = -t;
      double w = t < 1.0 ? 1.0 - t : 0.0;
      kp[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) kp[x] /= ww;
    (*bounds)[2 * xx] = xmin;
    (*bounds)[2 * xx + 1] = xmax;
  }
  kk->resize(k.size());
  for (size_t i = 0; i < k.size(); ++i) {  // normalize_coeffs_8bpc
    double v = k[i] * (1 << kPrecisionBits);
    (*kk)[i] = static_cast<int32_t>(k[i] < 0 ? -0.5 + v : 0.5 + v);
  }
  return ksize;
}

inline uint8_t clip8(int v) { return clamp255(v >> kPrecisionBits); }

void resize_bilinear(const uint8_t* in, int in_w, int in_h, uint8_t* out,
                     int out_w, int out_h) {
  if (in_w == out_w && in_h == out_h) {
    std::memcpy(out, in, static_cast<size_t>(in_w) * in_h * 3);
    return;
  }
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  int ksh = precompute_coeffs(in_w, out_w, &bh, &kh);
  int ksv = precompute_coeffs(in_h, out_h, &bv, &kv);
  const bool need_h = out_w != in_w, need_v = out_h != in_h;
  int y_first = bv[0];
  int y_last = bv[2 * out_h - 2] + bv[2 * out_h - 1];
  const uint8_t* src = in;
  int src_w = in_w;
  std::vector<uint8_t> tmp;
  if (need_h) {
    for (int i = 0; i < out_h; ++i) bv[2 * i] -= y_first;
    int rows = y_last - y_first;
    tmp.resize(static_cast<size_t>(out_w) * rows * 3);
    for (int yy = 0; yy < rows; ++yy) {
      const uint8_t* ip = in + static_cast<size_t>(yy + y_first) * in_w * 3;
      uint8_t* op = &tmp[static_cast<size_t>(yy) * out_w * 3];
      for (int xx = 0; xx < out_w; ++xx) {
        int xmin = bh[2 * xx], xmax = bh[2 * xx + 1];
        const int32_t* k = &kh[static_cast<size_t>(xx) * ksh];
        int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
        for (int x = 0; x < xmax; ++x) {
          const uint8_t* p = ip + (x + xmin) * 3;
          s0 += p[0] * k[x];
          s1 += p[1] * k[x];
          s2 += p[2] * k[x];
        }
        op[3 * xx] = clip8(s0);
        op[3 * xx + 1] = clip8(s1);
        op[3 * xx + 2] = clip8(s2);
      }
    }
    src = tmp.data();
    src_w = out_w;
  }
  if (!need_v) {
    std::memcpy(out, src, static_cast<size_t>(out_w) * out_h * 3);
    return;
  }
  for (int yy = 0; yy < out_h; ++yy) {
    const int32_t* k = &kv[static_cast<size_t>(yy) * ksv];
    int ymin = bv[2 * yy], ymax = bv[2 * yy + 1];
    uint8_t* op = out + static_cast<size_t>(yy) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
      for (int y = 0; y < ymax; ++y) {
        const uint8_t* p = src + (static_cast<size_t>(y + ymin) * src_w + xx) * 3;
        s0 += p[0] * k[y];
        s1 += p[1] * k[y];
        s2 += p[2] * k[y];
      }
      op[3 * xx] = clip8(s0);
      op[3 * xx + 1] = clip8(s1);
      op[3 * xx + 2] = clip8(s2);
    }
  }
}

// ---------------------------------------------------------------------------
// Encoder

void fdct_islow(int* data) {  // jfdctint.c jpeg_fdct_islow, in place
  int* p = data;
  for (int r = 0; r < 8; ++r, p += 8) {
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = kConstBits - kPass1Bits;
    p[2] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[6] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int>(descale(tmp4 + z1 + z3, sh));
    p[5] = static_cast<int>(descale(tmp5 + z2 + z4, sh));
    p[3] = static_cast<int>(descale(tmp6 + z2 + z3, sh));
    p[1] = static_cast<int>(descale(tmp7 + z1 + z4, sh));
  }
  for (int c = 0; c < 8; ++c) {
    p = data + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int sh = kConstBits + kPass1Bits;
    p[16] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865, sh));
    p[48] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065, sh));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int>(descale(tmp4 + z1 + z3, sh));
    p[40] = static_cast<int>(descale(tmp5 + z2 + z4, sh));
    p[24] = static_cast<int>(descale(tmp6 + z2 + z3, sh));
    p[8] = static_cast<int>(descale(tmp7 + z1 + z4, sh));
  }
}

// jcdctmgr.c compute_reciprocal / quantize (16-bit DCTELEM, SIMD builds).
struct Divisor {
  uint32_t recip, corr;
  int shift;  // total right shift
};

Divisor compute_reciprocal(unsigned divisor) {
  Divisor dv;
  if (divisor == 1) {
    dv.recip = 1;
    dv.corr = 0;
    dv.shift = 0;
    return dv;
  }
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  dv.recip = static_cast<uint32_t>(fq & 0xFFFF);
  dv.corr = c & 0xFFFF;
  dv.shift = r;
  return dv;
}

inline int quantize(int v, const Divisor& dv) {
  if (dv.recip == 1 && dv.corr == 0 && dv.shift == 0) return v;
  uint32_t a = static_cast<uint32_t>(v < 0 ? -v : v);
  uint32_t t = (a + dv.corr) & 0xFFFF;
  uint32_t q = static_cast<uint32_t>((uint64_t(t) * dv.recip) >> dv.shift) & 0xFFFF;
  int out = static_cast<int16_t>(q);
  return v < 0 ? -out : out;
}

const unsigned kStdLumQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const unsigned kStdChrQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

void quant_table(const unsigned* basic, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  long scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(basic[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 32767) t = 32767;
    if (t > 255) t = 255;  // force_baseline
    out[i] = static_cast<uint16_t>(t);
  }
}

struct EncTable {
  uint32_t code[256];
  uint8_t size[256];
};

void build_encode_table(const HuffSpec& s, EncTable* t) {
  std::memset(t->size, 0, sizeof(t->size));
  unsigned code = 0;
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < s.bits[l]; ++i, ++p) {
      t->code[s.vals[p]] = code++;
      t->size[s.vals[p]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
}

// jchuff.c jpeg_gen_optimal_table
HuffSpec gen_optimal_table(long freq_in[257]) {
  const int kMaxClen = 32;
  long freq[257];
  std::memcpy(freq, freq_in, sizeof(freq));
  uint8_t bits[kMaxClen + 1];
  int codesize[257], others[257];
  std::memset(bits, 0, sizeof(bits));
  std::memset(codesize, 0, sizeof(codesize));
  for (int i = 0; i < 257; ++i) others[i] = -1;
  freq[256] = 1;
  for (;;) {
    int c1 = -1, c2 = -1;
    long v = 1000000000L;
    for (int i = 0; i <= 256; ++i)
      if (freq[i] && freq[i] <= v) {
        v = freq[i];
        c1 = i;
      }
    v = 1000000000L;
    for (int i = 0; i <= 256; ++i)
      if (freq[i] && freq[i] <= v && i != c1) {
        v = freq[i];
        c2 = i;
      }
    if (c2 < 0) break;
    freq[c1] += freq[c2];
    freq[c2] = 0;
    ++codesize[c1];
    while (others[c1] >= 0) {
      c1 = others[c1];
      ++codesize[c1];
    }
    others[c1] = c2;
    ++codesize[c2];
    while (others[c2] >= 0) {
      c2 = others[c2];
      ++codesize[c2];
    }
  }
  for (int i = 0; i <= 256; ++i)
    if (codesize[i]) {
      if (codesize[i] > kMaxClen) fail("Huffman code length overflow");
      ++bits[codesize[i]];
    }
  int i;
  for (i = kMaxClen; i > 16; --i) {
    while (bits[i] > 0) {
      int j = i - 2;
      while (bits[j] == 0) --j;
      bits[i] -= 2;
      ++bits[i - 1];
      bits[j + 1] += 2;
      --bits[j];
    }
  }
  while (bits[i] == 0) --i;
  --bits[i];
  HuffSpec s;
  std::memcpy(s.bits, bits, 17);
  int p = 0;
  for (int l = 1; l <= kMaxClen; ++l)
    for (int j = 0; j <= 255; ++j)
      if (codesize[j] == l) s.vals[p++] = static_cast<uint8_t>(j);
  s.defined = true;
  return s;
}

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  int nacc = 0;
  void put(uint32_t code, int size) {
    if (size == 0) return;
    acc = (acc << size) | (code & ((uint64_t(1) << size) - 1));
    nacc += size;
    while (nacc >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (nacc - 8));
      out->push_back(b);
      if (b == 0xFF) out->push_back(0);
      nacc -= 8;
    }
  }
  void flush() {  // pad with 1-bits (jchuff.c flush_bits)
    if (nacc > 0) put(0x7F, 7);
    acc = 0;
    nacc = 0;
  }
};

inline int nbits_of(int v) {
  int a = v < 0 ? -v : v;
  int n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

struct EncComponent {
  int id, h, v, tq, tbl;
  int cw, ch, bw, bh, pbw, pbh;
  std::vector<int16_t> coef;  // quantized, natural order, pbw*pbh blocks
};

struct Scan {
  int ncomp;
  int comps[4];
  int ss, se, ah, al;
};

// jcparam.c jpeg_simple_progression
std::vector<Scan> simple_progression(int ncomps) {
  std::vector<Scan> s;
  auto add = [&](int n, std::initializer_list<int> cs, int ss, int se, int ah,
                 int al) {
    Scan x{};
    x.ncomp = n;
    int i = 0;
    for (int c : cs) x.comps[i++] = c;
    x.ss = ss;
    x.se = se;
    x.ah = ah;
    x.al = al;
    s.push_back(x);
  };
  if (ncomps == 3) {
    add(3, {0, 1, 2}, 0, 0, 0, 1);
    add(1, {0}, 1, 5, 0, 2);
    add(1, {2}, 1, 63, 0, 1);
    add(1, {1}, 1, 63, 0, 1);
    add(1, {0}, 6, 63, 0, 2);
    add(1, {0}, 1, 63, 2, 1);
    add(3, {0, 1, 2}, 0, 0, 1, 0);
    add(1, {2}, 1, 63, 1, 0);
    add(1, {1}, 1, 63, 1, 0);
    add(1, {0}, 1, 63, 1, 0);
  } else {
    add(1, {0}, 0, 0, 0, 1);
    add(1, {0}, 1, 5, 0, 2);
    add(1, {0}, 6, 63, 0, 2);
    add(1, {0}, 1, 63, 2, 1);
    add(1, {0}, 0, 0, 1, 0);
    add(1, {0}, 1, 63, 1, 0);
  }
  return s;
}

// One scan's entropy coder. With gather set it only counts symbols
// (jchuff.c / jcphuff.c gather passes); otherwise it writes.
struct ScanCoder {
  bool gather;
  long dc_freq[4][257];
  long ac_freq[4][257];
  const EncTable* dc_tab[4];
  const EncTable* ac_tab[4];
  BitWriter bw;
  int last_dc[4] = {0, 0, 0, 0};
  // progressive AC state (jcphuff.c)
  int ac_tbl = 0;
  int eobrun = 0;
  std::vector<char> be_bits;

  void sym_dc(int tbl, int s) {
    if (gather) {
      ++dc_freq[tbl][s];
      return;
    }
    const EncTable* t = dc_tab[tbl];
    if (!t->size[s]) fail("Huffman table lacks a symbol");
    bw.put(t->code[s], t->size[s]);
  }
  void sym_ac(int tbl, int s) {
    if (gather) {
      ++ac_freq[tbl][s];
      return;
    }
    const EncTable* t = ac_tab[tbl];
    if (!t->size[s]) fail("Huffman table lacks a symbol");
    bw.put(t->code[s], t->size[s]);
  }
  void bits(uint32_t v, int n) {
    if (!gather) bw.put(v, n);
  }
  void emit_buffered(const char* b, size_t n) {
    if (gather) return;
    for (size_t i = 0; i < n; ++i) bw.put(static_cast<uint32_t>(b[i]), 1);
  }

  void sequential_block(const int16_t* blk, int ci, int dct, int act) {
    int diff = blk[0] - last_dc[ci];
    last_dc[ci] = blk[0];
    int nb = nbits_of(diff);
    if (nb > 11) fail("DCT coefficient out of range");
    sym_dc(dct, nb);
    if (nb) bits(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nb);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      int v = blk[kZigzag[k]];
      if (v == 0) {
        ++r;
        continue;
      }
      while (r > 15) {
        sym_ac(act, 0xF0);
        r -= 16;
      }
      nb = nbits_of(v);
      if (nb > 10) fail("DCT coefficient out of range");
      sym_ac(act, (r << 4) + nb);
      bits(static_cast<uint32_t>(v < 0 ? v - 1 : v), nb);
      r = 0;
    }
    if (r > 0) sym_ac(act, 0);
  }

  void dc_first(const int16_t* blk, int ci, int dct, int al) {
    int t2 = blk[0] >> al;  // arithmetic shift
    int diff = t2 - last_dc[ci];
    last_dc[ci] = t2;
    int nb = nbits_of(diff);
    if (nb > 11) fail("DCT coefficient out of range");
    sym_dc(dct, nb);
    if (nb) bits(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nb);
  }

  void dc_refine(const int16_t* blk, int al) {
    bits(static_cast<uint32_t>(blk[0] >> al), 1);
  }

  void emit_eobrun() {
    if (eobrun > 0) {
      int t = eobrun, nb = 0;
      while ((t >>= 1)) ++nb;
      if (nb > 14) fail("EOB run too long");
      sym_ac(ac_tbl, nb << 4);
      if (nb) bits(static_cast<uint32_t>(eobrun), nb);
      eobrun = 0;
      emit_buffered(be_bits.data(), be_bits.size());
      be_bits.clear();
    }
  }

  void ac_first(const int16_t* blk, int ss, int se, int al) {
    int r = 0;
    for (int k = ss; k <= se; ++k) {
      int t = blk[kZigzag[k]];
      if (t == 0) {
        ++r;
        continue;
      }
      int t2;
      if (t < 0) {
        t = -t;
        t >>= al;
        t2 = ~t;
      } else {
        t >>= al;
        t2 = t;
      }
      if (t == 0) {
        ++r;
        continue;
      }
      if (eobrun > 0) emit_eobrun();
      while (r > 15) {
        sym_ac(ac_tbl, 0xF0);
        r -= 16;
      }
      int nb = nbits_of(t);
      if (nb > 10) fail("DCT coefficient out of range");
      sym_ac(ac_tbl, (r << 4) + nb);
      bits(static_cast<uint32_t>(t2), nb);
      r = 0;
    }
    if (r > 0) {
      ++eobrun;
      if (eobrun == 0x7FFF) emit_eobrun();
    }
  }

  void ac_refine(const int16_t* blk, int ss, int se, int al) {
    int absv[64];
    int eob = 0;
    for (int k = ss; k <= se; ++k) {
      int t = blk[kZigzag[k]];
      if (t < 0) t = -t;
      t >>= al;
      absv[k] = t;
      if (t == 1) eob = k;
    }
    int r = 0;
    std::vector<char> br;  // correction bits of this block not yet emitted
    for (int k = ss; k <= se; ++k) {
      int t = absv[k];
      if (t == 0) {
        ++r;
        continue;
      }
      while (r > 15 && k <= eob) {
        emit_eobrun();
        sym_ac(ac_tbl, 0xF0);
        r -= 16;
        emit_buffered(br.data(), br.size());
        br.clear();
      }
      if (t > 1) {
        br.push_back(static_cast<char>(t & 1));
        continue;
      }
      emit_eobrun();
      sym_ac(ac_tbl, (r << 4) + 1);
      bits(blk[kZigzag[k]] < 0 ? 0u : 1u, 1);
      emit_buffered(br.data(), br.size());
      br.clear();
      r = 0;
    }
    if (r > 0 || !br.empty()) {
      ++eobrun;
      be_bits.insert(be_bits.end(), br.begin(), br.end());
      if (eobrun == 0x7FFF || be_bits.size() > 1000 - 64 + 1) emit_eobrun();
    }
  }
};

void put_u16(std::vector<uint8_t>* o, int v) {
  o->push_back(static_cast<uint8_t>(v >> 8));
  o->push_back(static_cast<uint8_t>(v & 0xFF));
}

void put_dht(std::vector<uint8_t>* o, const HuffSpec& s, int cls, int id) {
  int count = 0;
  for (int i = 1; i <= 16; ++i) count += s.bits[i];
  o->push_back(0xFF);
  o->push_back(0xC4);
  put_u16(o, 2 + 1 + 16 + count);
  o->push_back(static_cast<uint8_t>((cls << 4) | id));
  for (int i = 1; i <= 16; ++i) o->push_back(s.bits[i]);
  for (int i = 0; i < count; ++i) o->push_back(s.vals[i]);
}

std::vector<uint8_t> encode(const uint8_t* px, int W, int H, int channels,
                            int quality, int hs, int vs, bool progressive,
                            bool optimize, int restart_interval,
                            int restart_rows) {
  if (W < 1 || H < 1 || W > 65535 || H > 65535)
    fail("image size out of JPEG's range");
  if (channels != 1 && channels != 3) fail("encode takes 1 or 3 channels");
  const int nc = channels;
  const int max_h = nc == 1 ? 1 : hs, max_v = nc == 1 ? 1 : vs;
  EncComponent comps[3];
  for (int i = 0; i < nc; ++i) {
    EncComponent& c = comps[i];
    c.id = i + 1;
    c.h = i == 0 ? max_h : 1;
    c.v = i == 0 ? max_v : 1;
    c.tq = c.tbl = i == 0 ? 0 : 1;
    c.cw = (W * c.h + max_h - 1) / max_h;
    c.ch = (H * c.v + max_v - 1) / max_v;
    c.bw = (c.cw + 7) / 8;
    c.bh = (c.ch + 7) / 8;
  }
  const int mcux = (W + 8 * max_h - 1) / (8 * max_h);
  const int mcuy = (H + 8 * max_v - 1) / (8 * max_v);
  // Colour conversion (jccolor.c rgb_ycc_convert) into full-size planes
  // expanded to whole row groups and MCU widths by edge replication
  // (jcprepct.c expand_bottom_edge, jcsample.c expand_right_edge).
  const int full_w = mcux * 8 * max_h;
  const int full_h = ((H + max_v - 1) / max_v) * max_v;
  std::vector<uint8_t> full[3];
  for (int i = 0; i < nc; ++i) full[i].assign(static_cast<size_t>(full_w) * full_h, 0);
  {
    const int64_t one_half = int64_t(1) << 15, cbcr_off = int64_t(128) << 16;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    for (int y = 0; y < full_h; ++y) {
      int sy = y < H ? y : H - 1;
      for (int x = 0; x < full_w; ++x) {
        int sx = x < W ? x : W - 1;
        const uint8_t* p = px + (static_cast<size_t>(sy) * W + sx) * nc;
        size_t o = static_cast<size_t>(y) * full_w + x;
        if (nc == 1) {
          full[0][o] = p[0];
          continue;
        }
        int64_t r = p[0], g = p[1], b = p[2];
        full[0][o] = static_cast<uint8_t>(
            (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + one_half) >> 16);
        full[1][o] = static_cast<uint8_t>(
            (-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b + cbcr_off +
             one_half - 1) >> 16);
        full[2][o] = static_cast<uint8_t>(
            (fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b + cbcr_off +
             one_half - 1) >> 16);
      }
    }
  }
  uint16_t qt[2][64];
  quant_table(kStdLumQ, quality, qt[0]);
  quant_table(kStdChrQ, quality, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = compute_reciprocal(qt[t][i] << 3);
  // Downsample (jcsample.c), pad to whole blocks, DCT and quantize.
  for (int i = 0; i < nc; ++i) {
    EncComponent& c = comps[i];
    const int hx = max_h / c.h, vx = max_v / c.v;
    const int ds_w = (nc == 1 ? c.bw : mcux * c.h) * 8;
    const int ds_rows = full_h / vx;  // rows from real row groups
    c.pbw = nc == 1 ? c.bw : mcux * c.h;
    c.pbh = nc == 1 ? c.bh : mcuy * c.v;
    const int ds_h = c.pbh * 8;
    std::vector<uint8_t> ds(static_cast<size_t>(ds_w) * ds_h);
    for (int y = 0; y < ds_h; ++y) {
      int yy = y < ds_rows ? y : ds_rows - 1;  // jcprepct.c bottom padding
      uint8_t* op = &ds[static_cast<size_t>(y) * ds_w];
      for (int x = 0; x < ds_w; ++x) {
        if (hx == 1 && vx == 1) {
          op[x] = full[i][static_cast<size_t>(yy) * full_w + x];
        } else if (hx == 2 && vx == 1) {
          const uint8_t* ip = &full[i][static_cast<size_t>(yy) * full_w];
          op[x] = static_cast<uint8_t>((ip[2 * x] + ip[2 * x + 1] + (x & 1)) >> 1);
        } else if (hx == 2 && vx == 2) {
          const uint8_t* i0 = &full[i][static_cast<size_t>(2 * yy) * full_w];
          const uint8_t* i1 = i0 + full_w;
          op[x] = static_cast<uint8_t>(
              (i0[2 * x] + i0[2 * x + 1] + i1[2 * x] + i1[2 * x + 1] + 1 + (x & 1)) >> 2);
        } else {  // int_downsample
          int sum = 0;
          for (int v = 0; v < vx; ++v)
            for (int h = 0; h < hx; ++h)
              sum += full[i][static_cast<size_t>(yy * vx + v) * full_w + x * hx + h];
          op[x] = static_cast<uint8_t>((sum + hx * vx / 2) / (hx * vx));
        }
      }
    }
    c.coef.assign(static_cast<size_t>(c.pbw) * c.pbh * 64, 0);
    const Divisor* dv = div[c.tq];
    for (int by = 0; by < c.pbh; ++by) {
      for (int bx = 0; bx < c.pbw; ++bx) {
        int16_t* blk = &c.coef[(static_cast<size_t>(by) * c.pbw + bx) * 64];
        if (bx >= c.bw || by >= c.bh) continue;  // dummy: filled below
        int data[64];
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x)
            data[8 * y + x] = ds[static_cast<size_t>(by * 8 + y) * ds_w + bx * 8 + x] - 128;
        fdct_islow(data);
        for (int k = 0; k < 64; ++k) blk[k] = static_cast<int16_t>(quantize(data[k], dv[k]));
      }
    }
    // jccoefct.c dummy blocks: zero AC, the DC of the last real block to
    // the left, or, in a dummy row, of the block above at the MCU's right.
    for (int by = 0; by < c.pbh; ++by) {
      for (int bx = 0; bx < c.pbw; ++bx) {
        int16_t* blk = &c.coef[(static_cast<size_t>(by) * c.pbw + bx) * 64];
        if (by < c.bh) {
          if (bx >= c.bw) blk[0] = blk[-64];
        } else {
          int mcu_last = (bx / c.h) * c.h + c.h - 1;
          blk[0] = c.coef[(static_cast<size_t>(by - 1) * c.pbw + mcu_last) * 64];
        }
      }
    }
  }
  // Restart interval in MCUs (jcmaster.c: restart_in_rows * MCUs per row).
  auto mcus_per_row = [&](const Scan& s) {
    return s.ncomp == 1 ? comps[s.comps[0]].bw : mcux;
  };
  std::vector<Scan> scans;
  if (progressive) {
    scans = simple_progression(nc);
  } else {
    Scan s{};
    s.ncomp = nc;
    for (int i = 0; i < nc; ++i) s.comps[i] = i;
    s.ss = 0;
    s.se = 63;
    scans.push_back(s);
  }
  if (progressive) optimize = true;  // jcmaster.c: default tables are no good
  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(W) * H / 2 + 1024);
  out.push_back(0xFF);
  out.push_back(0xD8);
  const uint8_t jfif[18] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.insert(out.end(), jfif, jfif + 18);
  for (int t = 0; t < (nc == 1 ? 1 : 2); ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put_u16(&out, 67);
    out.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; ++k) out.push_back(static_cast<uint8_t>(qt[t][kZigzag[k]]));
  }
  out.push_back(0xFF);
  out.push_back(progressive ? 0xC2 : 0xC0);
  put_u16(&out, 8 + 3 * nc);
  out.push_back(8);
  put_u16(&out, H);
  put_u16(&out, W);
  out.push_back(static_cast<uint8_t>(nc));
  for (int i = 0; i < nc; ++i) {
    out.push_back(static_cast<uint8_t>(comps[i].id));
    out.push_back(static_cast<uint8_t>((comps[i].h << 4) | comps[i].v));
    out.push_back(static_cast<uint8_t>(comps[i].tq));
  }
  HuffSpec dc_spec[2], ac_spec[2];
  for (int t = 0; t < 2; ++t) {
    dc_spec[t] = std_spec(true, t == 1);
    ac_spec[t] = std_spec(false, t == 1);
  }
  bool dc_sent[2] = {false, false}, ac_sent[2] = {false, false};
  int last_restart = 0;
  for (const Scan& s : scans) {
    int ri = restart_interval;
    if (restart_rows > 0) {
      long v = static_cast<long>(restart_rows) * mcus_per_row(s);
      ri = static_cast<int>(v > 65535 ? 65535 : v);
    }
    const bool is_dc = s.ss == 0;
    auto run = [&](ScanCoder& sc) {
      int64_t total = s.ncomp == 1
                          ? static_cast<int64_t>(comps[s.comps[0]].bw) * comps[s.comps[0]].bh
                          : static_cast<int64_t>(mcux) * mcuy;
      int ux = s.ncomp == 1 ? comps[s.comps[0]].bw : mcux;
      int togo = ri, next_rst = 0;
      for (int64_t m = 0; m < total; ++m) {
        if (ri && togo == 0) {
          if (progressive && !is_dc) sc.emit_eobrun();
          if (!sc.gather) {
            sc.bw.flush();
            out.push_back(0xFF);
            out.push_back(static_cast<uint8_t>(0xD0 + next_rst));
          }
          next_rst = (next_rst + 1) & 7;
          for (int i = 0; i < 4; ++i) sc.last_dc[i] = 0;
          sc.eobrun = 0;
          sc.be_bits.clear();
          togo = ri;
        }
        int mx = static_cast<int>(m % ux), my = static_cast<int>(m / ux);
        for (int i = 0; i < s.ncomp; ++i) {
          const EncComponent& c = comps[s.comps[i]];
          int nh = s.ncomp == 1 ? 1 : c.h, nv = s.ncomp == 1 ? 1 : c.v;
          for (int v = 0; v < nv; ++v)
            for (int h = 0; h < nh; ++h) {
              int bx = s.ncomp == 1 ? mx : mx * c.h + h;
              int by = s.ncomp == 1 ? my : my * c.v + v;
              const int16_t* blk = &c.coef[(static_cast<size_t>(by) * c.pbw + bx) * 64];
              if (!progressive) {
                sc.sequential_block(blk, i, c.tbl, c.tbl);
              } else if (is_dc) {
                if (s.ah == 0) sc.dc_first(blk, i, c.tbl, s.al);
                else sc.dc_refine(blk, s.al);
              } else {
                sc.ac_tbl = c.tbl;
                if (s.ah == 0) sc.ac_first(blk, s.ss, s.se, s.al);
                else sc.ac_refine(blk, s.ss, s.se, s.al);
              }
            }
        }
        if (ri) --togo;
      }
      if (progressive && !is_dc) sc.emit_eobrun();
    };
    if (optimize) {
      ScanCoder g;
      g.gather = true;
      std::memset(g.dc_freq, 0, sizeof(g.dc_freq));
      std::memset(g.ac_freq, 0, sizeof(g.ac_freq));
      std::vector<uint8_t> unused;
      g.bw.out = &unused;
      run(g);
      bool did_dc[2] = {false, false}, did_ac[2] = {false, false};
      for (int i = 0; i < s.ncomp; ++i) {
        int t = comps[s.comps[i]].tbl;
        if (!progressive || is_dc) {
          if (!(progressive && s.ah != 0) && !did_dc[t]) {
            dc_spec[t] = gen_optimal_table(g.dc_freq[t]);
            dc_sent[t] = false;
            did_dc[t] = true;
          }
        }
        if (!progressive || !is_dc) {
          if (!did_ac[t]) {
            ac_spec[t] = gen_optimal_table(g.ac_freq[t]);
            ac_sent[t] = false;
            did_ac[t] = true;
          }
        }
      }
    }
    // jcmarker.c write_scan_header
    for (int i = 0; i < s.ncomp; ++i) {
      int t = comps[s.comps[i]].tbl;
      bool want_dc = progressive ? (is_dc && s.ah == 0) : true;
      bool want_ac = progressive ? !is_dc : true;
      if (want_dc && !dc_sent[t]) {
        put_dht(&out, dc_spec[t], 0, t);
        dc_sent[t] = true;
      }
      if (want_ac && !ac_sent[t]) {
        put_dht(&out, ac_spec[t], 1, t);
        ac_sent[t] = true;
      }
    }
    if (ri != last_restart) {
      out.push_back(0xFF);
      out.push_back(0xDD);
      put_u16(&out, 4);
      put_u16(&out, ri);
      last_restart = ri;
    }
    out.push_back(0xFF);
    out.push_back(0xDA);
    put_u16(&out, 6 + 2 * s.ncomp);
    out.push_back(static_cast<uint8_t>(s.ncomp));
    for (int i = 0; i < s.ncomp; ++i) {
      const EncComponent& c = comps[s.comps[i]];
      out.push_back(static_cast<uint8_t>(c.id));
      int td = progressive && (!is_dc || s.ah) ? 0 : c.tbl;
      int ta = progressive && is_dc ? 0 : c.tbl;
      out.push_back(static_cast<uint8_t>((td << 4) | ta));
    }
    out.push_back(static_cast<uint8_t>(s.ss));
    out.push_back(static_cast<uint8_t>(s.se));
    out.push_back(static_cast<uint8_t>((s.ah << 4) | s.al));
    EncTable dct[2], act[2];
    for (int t = 0; t < 2; ++t) {
      build_encode_table(dc_spec[t], &dct[t]);
      build_encode_table(ac_spec[t], &act[t]);
    }
    ScanCoder w;
    w.gather = false;
    for (int t = 0; t < 4; ++t) {
      w.dc_tab[t] = &dct[t & 1];
      w.ac_tab[t] = &act[t & 1];
    }
    w.bw.out = &out;
    run(w);
    w.bw.flush();
  }
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, static_cast<size_t>(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Width and height from the frame header; 0 on success.
int icdjpeg_info(const uint8_t* data, uint64_t size, int32_t* w, int32_t* h,
                 char* err, int errlen) {
  try {
    Decoder dec(data, size);
    dec.parse(true);
    if (!dec.frame) fail("corrupt JPEG: no frame header");
    *w = dec.width;
    *h = dec.height;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decode to (h, w, 3) RGB into out (capacity cap bytes); 0 on success.
int icdjpeg_decode(const uint8_t* data, uint64_t size, uint8_t* out,
                   uint64_t cap, char* err, int errlen) {
  try {
    std::vector<uint8_t> rgb;
    int w, h;
    decode_rgb(data, size, &rgb, &w, &h);
    if (rgb.size() > cap) fail("output buffer too small");
    std::memcpy(out, rgb.data(), rgb.size());
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Decode and resize to (out_h, out_w, 3); 0 on success.
int icdjpeg_decode_resize(const uint8_t* data, uint64_t size, int32_t out_w,
                          int32_t out_h, uint8_t* out, char* err, int errlen) {
  try {
    std::vector<uint8_t> rgb;
    int w, h;
    decode_rgb(data, size, &rgb, &w, &h);
    resize_bilinear(rgb.data(), w, h, out, out_w, out_h);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

int icdjpeg_resize_bilinear(const uint8_t* in, int32_t in_w, int32_t in_h,
                            uint8_t* out, int32_t out_w, int32_t out_h) {
  if (in_w < 1 || in_h < 1 || out_w < 1 || out_h < 1) return 1;
  resize_bilinear(in, in_w, in_h, out, out_w, out_h);
  return 0;
}

// Encode (h, w, channels) uint8 pixels; the file is malloc'd into *out
// (free with icdjpeg_free). Returns its size, or -1 with err set.
int64_t icdjpeg_encode(const uint8_t* px, int32_t w, int32_t h,
                       int32_t channels, int32_t quality, int32_t h_samp,
                       int32_t v_samp, int32_t progressive, int32_t optimize,
                       int32_t restart_interval, int32_t restart_rows,
                       uint8_t** out, char* err, int errlen) {
  try {
    if (h_samp < 1 || h_samp > 2 || v_samp < 1 || v_samp > 2)
      fail("sampling factors are 1 or 2");
    std::vector<uint8_t> file =
        encode(px, w, h, channels, quality, h_samp, v_samp, progressive != 0,
               optimize != 0, restart_interval, restart_rows);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(file.size()));
    if (!buf) fail("out of memory");
    std::memcpy(buf, file.data(), file.size());
    *out = buf;
    return static_cast<int64_t>(file.size());
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

void icdjpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
