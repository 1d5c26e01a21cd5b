// RLE binary-mask kernel library.
//
// C++ reimplementation of the capability surface of the reference's
// vendored cocoapi native layer (reference: cocoapi/common/maskApi.h:13-60
// — encode/decode/merge/area/iou/nms/bbox/poly/string codec), exposed
// through a C ABI for ctypes binding (icd_tpu_torch/native/mask.py plays
// the role of the reference's Cython _mask.pyx shim). A copy of
// icd_tpu/native/maskapi.cpp with the same ABI.
//
// Format: a mask of size h x w is flattened in COLUMN-major order and
// stored as alternating run lengths, starting with the number of 0s.
// The compressed string form is the COCO LEB128-style codec: counts are
// delta-encoded against cnts[i-2] (i > 2) and written 5 bits per char
// with a continuation bit, offset by 48.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

using u8 = uint8_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;

namespace {

struct Rle {
  u64 h = 0, w = 0;
  std::vector<u32> cnts;  // alternating 0-run / 1-run lengths

  u64 area() const {
    u64 a = 0;
    for (size_t i = 1; i < cnts.size(); i += 2) a += cnts[i];
    return a;
  }
};

Rle encode_one(const u8* mask, u64 h, u64 w) {
  // mask is column-major h*w bytes.
  Rle r;
  r.h = h;
  r.w = w;
  const u64 n = h * w;
  u8 prev = 0;
  u32 run = 0;
  for (u64 i = 0; i < n; ++i) {
    const u8 v = mask[i] ? 1 : 0;
    if (v == prev) {
      ++run;
    } else {
      r.cnts.push_back(run);
      run = 1;
      prev = v;
    }
  }
  r.cnts.push_back(run);
  return r;
}

void decode_one(const Rle& r, u8* out) {
  u8 v = 0;
  u64 pos = 0;
  for (u32 c : r.cnts) {
    std::memset(out + pos, v, c);
    pos += c;
    v = !v;
  }
}

// Merge two RLEs with OR (intersect=0) or AND (intersect=1) by a
// two-pointer sweep over run boundaries — O(m) like the upstream, no
// dense materialization.
Rle merge_two(const Rle& a, const Rle& b, int intersect) {
  Rle out;
  out.h = a.h;
  out.w = a.w;
  size_t ia = 0, ib = 0;
  u64 ra = ia < a.cnts.size() ? a.cnts[0] : 0;  // remaining in current run
  u64 rb = ib < b.cnts.size() ? b.cnts[0] : 0;
  u8 va = 0, vb = 0;
  const u64 total = a.h * a.w;
  u64 done = 0;
  u8 prev = 0;
  u64 run = 0;
  bool first = true;
  while (done < total) {
    while (ra == 0 && ia + 1 < a.cnts.size()) { va = !va; ra = a.cnts[++ia]; }
    while (rb == 0 && ib + 1 < b.cnts.size()) { vb = !vb; rb = b.cnts[++ib]; }
    u64 step = std::min(ra, rb);
    if (step == 0) step = total - done;  // trailing implicit zeros
    step = std::min(step, total - done);
    const u8 v = intersect ? (va & vb) : (va | vb);
    if (first) {
      if (v) out.cnts.push_back(0);  // leading 1s need an explicit 0-run
      prev = v;
      run = step;
      first = false;
    } else if (v == prev) {
      run += step;
    } else {
      out.cnts.push_back(static_cast<u32>(run));
      prev = v;
      run = step;
    }
    ra -= std::min(step, ra);
    rb -= std::min(step, rb);
    done += step;
  }
  if (!first) out.cnts.push_back(static_cast<u32>(run));
  if (out.cnts.empty()) out.cnts.push_back(static_cast<u32>(total));
  return out;
}

u64 intersect_area(const Rle& a, const Rle& b) {
  size_t ia = 0, ib = 0;
  u64 ra = a.cnts.empty() ? 0 : a.cnts[0];
  u64 rb = b.cnts.empty() ? 0 : b.cnts[0];
  u8 va = 0, vb = 0;
  const u64 total = a.h * a.w;
  u64 done = 0, inter = 0;
  while (done < total) {
    while (ra == 0 && ia + 1 < a.cnts.size()) { va = !va; ra = a.cnts[++ia]; }
    while (rb == 0 && ib + 1 < b.cnts.size()) { vb = !vb; rb = b.cnts[++ib]; }
    u64 step = std::min(ra, rb);
    if (step == 0) step = total - done;
    step = std::min(step, total - done);
    if (va & vb) inter += step;
    ra -= std::min(step, ra);
    rb -= std::min(step, rb);
    done += step;
  }
  return inter;
}

// ---------------------------------------------------------------------
// Compressed string codec (COCO LEB128-style, delta vs cnts[i-2]).
// ---------------------------------------------------------------------

std::string to_string_codec(const std::vector<u32>& cnts) {
  std::string s;
  for (size_t i = 0; i < cnts.size(); ++i) {
    i64 x = static_cast<i64>(cnts[i]);
    if (i > 2) x -= static_cast<i64>(cnts[i - 2]);
    bool more = true;
    while (more) {
      i64 c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      s.push_back(static_cast<char>(c + 48));
    }
  }
  return s;
}

std::vector<u32> from_string_codec(const char* s) {
  std::vector<u32> cnts;
  size_t i = 0;
  while (s[i]) {
    i64 x = 0;
    int k = 0;
    bool more = true;
    i64 c = 0;
    while (more) {
      c = static_cast<i64>(s[i]) - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
      if (!more && (c & 0x10)) x |= (~0LL) << (5 * k);
    }
    if (cnts.size() > 2) x += static_cast<i64>(cnts[cnts.size() - 2]);
    cnts.push_back(static_cast<u32>(x));
  }
  return cnts;
}

// ---------------------------------------------------------------------
// Geometry
// ---------------------------------------------------------------------

void rle_to_bbox(const Rle& r, double* bb) {
  // bb = [x, y, w, h]; exact over runs, column-major positions.
  const u64 h = r.h;
  if (h == 0 || r.area() == 0) {
    bb[0] = bb[1] = bb[2] = bb[3] = 0;
    return;
  }
  u64 xmin = UINT64_MAX, xmax = 0, ymin = UINT64_MAX, ymax = 0;
  u64 pos = 0;
  u8 v = 0;
  for (u32 c : r.cnts) {
    if (v && c > 0) {
      const u64 s = pos, e = pos + c - 1;
      const u64 cs = s / h, ce = e / h;
      xmin = std::min(xmin, cs);
      xmax = std::max(xmax, ce);
      if (cs == ce) {
        ymin = std::min(ymin, s % h);
        ymax = std::max(ymax, e % h);
      } else {  // run spans full columns
        ymin = 0;
        ymax = h - 1;
      }
    }
    pos += c;
    v = !v;
  }
  bb[0] = static_cast<double>(xmin);
  bb[1] = static_cast<double>(ymin);
  bb[2] = static_cast<double>(xmax - xmin + 1);
  bb[3] = static_cast<double>(ymax - ymin + 1);
}

// Polygon rasterization: even-odd scanline fill sampling pixel
// centers. The upstream cocoapi rasterizer quantizes vertices to a
// 1/5-pixel grid and fills between column-center crossings with
// ceil(y - 0.4) row rounding; this implementation uses exact
// continuous crossings with strict center-inside rounding, so filled
// masks can differ from upstream by at most the edge pixels whose
// centers fall within 0.1 px of the outline (vertices with fractional
// parts in (0.4, 0.5]). Pixel convention matches upstream:
// bbox [0 0 1 1] encloses exactly pixel (0, 0).
Rle poly_to_rle(const double* xy, u64 k, u64 h, u64 w) {
  std::vector<u8> mask(h * w, 0);
  // Interior fill by pixel-center parity.
  for (u64 col = 0; col < w; ++col) {
    const double cx = col + 0.5;
    std::vector<double> ys;
    for (u64 i = 0; i < k; ++i) {
      const u64 j = (i + 1) % k;
      const double x0 = xy[2 * i], y0 = xy[2 * i + 1];
      const double x1 = xy[2 * j], y1 = xy[2 * j + 1];
      if ((x0 <= cx && x1 > cx) || (x1 <= cx && x0 > cx)) {
        const double t = (cx - x0) / (x1 - x0);
        ys.push_back(y0 + t * (y1 - y0));
      }
    }
    std::sort(ys.begin(), ys.end());
    for (size_t i = 0; i + 1 < ys.size(); i += 2) {
      // Fill rows whose center is strictly inside (ys[i], ys[i+1]).
      i64 r0 = static_cast<i64>(std::floor(ys[i] - 0.5)) + 1;
      i64 r1 = static_cast<i64>(std::ceil(ys[i + 1] - 0.5)) - 1;
      r0 = std::max<i64>(r0, 0);
      r1 = std::min<i64>(r1, static_cast<i64>(h) - 1);
      for (i64 r = r0; r <= r1; ++r) mask[col * h + r] = 1;
    }
  }
  return encode_one(mask.data(), h, w);
}

double bb_iou_one(const double* d, const double* g, bool crowd) {
  const double dx0 = d[0], dy0 = d[1], dx1 = d[0] + d[2], dy1 = d[1] + d[3];
  const double gx0 = g[0], gy0 = g[1], gx1 = g[0] + g[2], gy1 = g[1] + g[3];
  const double iw = std::min(dx1, gx1) - std::max(dx0, gx0);
  const double ih = std::min(dy1, gy1) - std::max(dy0, gy0);
  if (iw <= 0 || ih <= 0) return 0.0;
  const double inter = iw * ih;
  const double uni = crowd ? d[2] * d[3]
                           : d[2] * d[3] + g[2] * g[3] - inter;
  return uni > 0 ? inter / uni : 0.0;
}

Rle rle_from_parts(const u32* cnts, u64 m, u64 h, u64 w) {
  Rle r;
  r.h = h;
  r.w = w;
  r.cnts.assign(cnts, cnts + m);
  return r;
}

}  // namespace

extern "C" {

// mask: h*w*n column-major bytes; out_cnts: n*(h*w+1) u32 capacity;
// out_m: n u64 (runs written per mask).
void icd_rle_encode(const u8* mask, u64 h, u64 w, u64 n, u32* out_cnts,
                    u64* out_m) {
  const u64 stride = h * w + 1;
  for (u64 i = 0; i < n; ++i) {
    Rle r = encode_one(mask + i * h * w, h, w);
    std::copy(r.cnts.begin(), r.cnts.end(), out_cnts + i * stride);
    out_m[i] = r.cnts.size();
  }
}

// cnts: concatenated runs; ms: runs per mask; out: h*w*n column-major.
void icd_rle_decode(const u32* cnts, const u64* ms, u64 h, u64 w, u64 n,
                    u8* out) {
  u64 off = 0;
  for (u64 i = 0; i < n; ++i) {
    Rle r = rle_from_parts(cnts + off, ms[i], h, w);
    decode_one(r, out + i * h * w);
    off += ms[i];
  }
}

u64 icd_rle_merge(const u32* cnts, const u64* ms, u64 n, u64 h, u64 w,
                  int intersect, u32* out_cnts) {
  if (n == 0) return 0;
  u64 off = 0;
  Rle acc = rle_from_parts(cnts, ms[0], h, w);
  off += ms[0];
  for (u64 i = 1; i < n; ++i) {
    Rle next = rle_from_parts(cnts + off, ms[i], h, w);
    acc = merge_two(acc, next, intersect);
    off += ms[i];
  }
  std::copy(acc.cnts.begin(), acc.cnts.end(), out_cnts);
  return acc.cnts.size();
}

void icd_rle_area(const u32* cnts, const u64* ms, u64 n, u32* out) {
  u64 off = 0;
  for (u64 i = 0; i < n; ++i) {
    Rle r;
    r.cnts.assign(cnts + off, cnts + off + ms[i]);
    out[i] = static_cast<u32>(r.area());
    off += ms[i];
  }
}

// o filled row-major: o[d * n_gt + g].
void icd_rle_iou(const u32* dt_cnts, const u64* dt_ms, u64 n_dt,
                 const u32* gt_cnts, const u64* gt_ms, u64 n_gt,
                 u64 h, u64 w, const u8* iscrowd, double* o) {
  std::vector<Rle> dts, gts;
  u64 off = 0;
  for (u64 i = 0; i < n_dt; ++i) {
    dts.push_back(rle_from_parts(dt_cnts + off, dt_ms[i], h, w));
    off += dt_ms[i];
  }
  off = 0;
  for (u64 i = 0; i < n_gt; ++i) {
    gts.push_back(rle_from_parts(gt_cnts + off, gt_ms[i], h, w));
    off += gt_ms[i];
  }
  for (u64 d = 0; d < n_dt; ++d) {
    const u64 da = dts[d].area();
    for (u64 g = 0; g < n_gt; ++g) {
      const u64 inter = intersect_area(dts[d], gts[g]);
      const bool crowd = iscrowd && iscrowd[g];
      const double uni = crowd
          ? static_cast<double>(da)
          : static_cast<double>(da + gts[g].area() - inter);
      o[d * n_gt + g] = uni > 0 ? inter / uni : 0.0;
    }
  }
}

void icd_bb_iou(const double* dt, u64 n_dt, const double* gt, u64 n_gt,
                const u8* iscrowd, double* o) {
  for (u64 d = 0; d < n_dt; ++d)
    for (u64 g = 0; g < n_gt; ++g)
      o[d * n_gt + g] =
          bb_iou_one(dt + 4 * d, gt + 4 * g, iscrowd && iscrowd[g]);
}

void icd_rle_nms(const u32* cnts, const u64* ms, u64 n, u64 h, u64 w,
                 double thr, u32* keep) {
  std::vector<Rle> rs;
  u64 off = 0;
  for (u64 i = 0; i < n; ++i) {
    rs.push_back(rle_from_parts(cnts + off, ms[i], h, w));
    off += ms[i];
  }
  for (u64 i = 0; i < n; ++i) keep[i] = 1;
  for (u64 i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    for (u64 j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      const u64 inter = intersect_area(rs[i], rs[j]);
      const double uni =
          static_cast<double>(rs[i].area() + rs[j].area() - inter);
      if (uni > 0 && inter / uni > thr) keep[j] = 0;
    }
  }
}

void icd_bb_nms(const double* bb, u64 n, double thr, u32* keep) {
  for (u64 i = 0; i < n; ++i) keep[i] = 1;
  for (u64 i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    for (u64 j = i + 1; j < n; ++j) {
      if (keep[j] && bb_iou_one(bb + 4 * i, bb + 4 * j, false) > thr)
        keep[j] = 0;
    }
  }
}

void icd_rle_to_bbox(const u32* cnts, const u64* ms, u64 n, u64 h, u64 w,
                     double* bb) {
  u64 off = 0;
  for (u64 i = 0; i < n; ++i) {
    Rle r = rle_from_parts(cnts + off, ms[i], h, w);
    rle_to_bbox(r, bb + 4 * i);
    off += ms[i];
  }
}

u64 icd_rle_fr_bbox(const double* bb, u64 h, u64 w, u32* out_cnts) {
  const double xy[8] = {bb[0], bb[1], bb[0], bb[1] + bb[3],
                        bb[0] + bb[2], bb[1] + bb[3], bb[0] + bb[2], bb[1]};
  Rle r = poly_to_rle(xy, 4, h, w);
  std::copy(r.cnts.begin(), r.cnts.end(), out_cnts);
  return r.cnts.size();
}

u64 icd_rle_fr_poly(const double* xy, u64 k, u64 h, u64 w, u32* out_cnts) {
  Rle r = poly_to_rle(xy, k, h, w);
  std::copy(r.cnts.begin(), r.cnts.end(), out_cnts);
  return r.cnts.size();
}

// out must have capacity ~6x m chars + 1.
u64 icd_rle_to_string(const u32* cnts, u64 m, char* out) {
  std::vector<u32> v(cnts, cnts + m);
  std::string s = to_string_codec(v);
  std::memcpy(out, s.data(), s.size());
  out[s.size()] = '\0';
  return s.size();
}

u64 icd_rle_fr_string(const char* s, u32* out_cnts) {
  std::vector<u32> v = from_string_codec(s);
  std::copy(v.begin(), v.end(), out_cnts);
  return v.size();
}

}  // extern "C"
