// Host-side polygon geometry for evaluation and tile merging: the IoU of
// quads and greedy polygon NMS, in double precision.
//
// Copy of `jdet_tpu/csrc/polygon.cpp` for jdet_torch, which imports nothing
// of jdet_tpu. `jdet_torch/ops/polygon_native.py` builds it with
// `g++ -O3 -shared -fPIC` at first use into `build/` (keyed by a hash of
// this source) and binds the two extern "C" functions with ctypes. The
// numpy versions in `jdet_torch/data/devkits/polygon.py` compute the same
// values (Sutherland-Hodgman clipping of each quad by the other's edges,
// then the shoelace area); the tests hold the two together.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

inline double polygon_area(const std::vector<Pt>& p) {
  double s = 0.0;
  const size_t n = p.size();
  for (size_t i = 0; i < n; ++i) {
    const Pt& a = p[i];
    const Pt& b = p[(i + 1) % n];
    s += a.x * b.y - b.x * a.y;
  }
  return 0.5 * std::fabs(s);
}

// Clip polygon `sub` by the half-plane left of a->b (CCW interior).
std::vector<Pt> clip_halfplane(const std::vector<Pt>& sub, Pt a, Pt b) {
  std::vector<Pt> out;
  out.reserve(sub.size() + 1);
  const size_t n = sub.size();
  for (size_t i = 0; i < n; ++i) {
    const Pt& cur = sub[i];
    const Pt& nxt = sub[(i + 1) % n];
    const double d1 = cross(a, b, cur);
    const double d2 = cross(a, b, nxt);
    if (d1 >= 0) out.push_back(cur);
    if ((d1 >= 0) != (d2 >= 0)) {
      const double t = d1 / (d1 - d2);
      out.push_back({cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)});
    }
  }
  return out;
}

std::vector<Pt> to_ccw_quad(const double* q) {
  std::vector<Pt> p = {{q[0], q[1]}, {q[2], q[3]}, {q[4], q[5]}, {q[6], q[7]}};
  double s = 0.0;
  for (int i = 0; i < 4; ++i) {
    const Pt& a = p[i];
    const Pt& b = p[(i + 1) % 4];
    s += a.x * b.y - b.x * a.y;
  }
  if (s < 0) std::reverse(p.begin(), p.end());
  return p;
}

double quad_inter_area(const double* q1, const double* q2) {
  std::vector<Pt> poly = to_ccw_quad(q1);
  std::vector<Pt> clipper = to_ccw_quad(q2);
  for (int e = 0; e < 4 && !poly.empty(); ++e) {
    poly = clip_halfplane(poly, clipper[e], clipper[(e + 1) % 4]);
  }
  if (poly.size() < 3) return 0.0;
  return polygon_area(poly);
}

double quad_area(const double* q) {
  std::vector<Pt> p = {{q[0], q[1]}, {q[2], q[3]}, {q[4], q[5]}, {q[6], q[7]}};
  return polygon_area(p);
}

}  // namespace

extern "C" {

// Pairwise IoU matrix: polys1 (n, 8), polys2 (m, 8) -> out (n, m).
void poly_iou_matrix(const double* polys1, int64_t n, const double* polys2,
                     int64_t m, double* out) {
  std::vector<double> a2(m);
  for (int64_t j = 0; j < m; ++j) a2[j] = quad_area(polys2 + 8 * j);
  for (int64_t i = 0; i < n; ++i) {
    const double* p1 = polys1 + 8 * i;
    const double a1 = quad_area(p1);
    for (int64_t j = 0; j < m; ++j) {
      const double inter = quad_inter_area(p1, polys2 + 8 * j);
      const double uni = a1 + a2[j] - inter;
      out[i * m + j] = uni > 1e-9 ? inter / uni : 0.0;
    }
  }
}

// Greedy polygon NMS with hbb prefilter (reference
// py_cpu_nms_poly_fast semantics). Returns number kept; kept indices
// (score-descending order) written into `keep`.
int64_t poly_nms(const double* polys, const double* scores, int64_t n,
                 double iou_thr, int64_t* keep) {
  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return scores[a] > scores[b]; });
  std::vector<double> bx1(n), by1(n), bx2(n), by2(n);
  for (int64_t i = 0; i < n; ++i) {
    const double* p = polys + 8 * i;
    bx1[i] = std::min(std::min(p[0], p[2]), std::min(p[4], p[6]));
    bx2[i] = std::max(std::max(p[0], p[2]), std::max(p[4], p[6]));
    by1[i] = std::min(std::min(p[1], p[3]), std::min(p[5], p[7]));
    by2[i] = std::max(std::max(p[1], p[3]), std::max(p[5], p[7]));
  }
  std::vector<char> suppressed(n, 0);
  int64_t nkeep = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (suppressed[i]) continue;
    keep[nkeep++] = i;
    const double a1 = quad_area(polys + 8 * i);
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (suppressed[j]) continue;
      // hbb prefilter
      const double ix1 = std::max(bx1[i], bx1[j]);
      const double iy1 = std::max(by1[i], by1[j]);
      const double ix2 = std::min(bx2[i], bx2[j]);
      const double iy2 = std::min(by2[i], by2[j]);
      if (ix2 <= ix1 || iy2 <= iy1) continue;
      const double inter = quad_inter_area(polys + 8 * i, polys + 8 * j);
      const double a2 = quad_area(polys + 8 * j);
      const double uni = a1 + a2 - inter;
      if (uni > 1e-9 && inter / uni > iou_thr) suppressed[j] = 1;
    }
  }
  return nkeep;
}

}  // extern "C"
