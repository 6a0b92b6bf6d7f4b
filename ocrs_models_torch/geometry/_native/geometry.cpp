// Host geometry core of the serving postprocess and the detection masks:
// 8-connected component labeling, minimum-area rotated rectangles, mitre
// polygon offsets, Pillow-exact polygon fill and convex clip areas (the
// first-party replacements for cv2.findContours/minAreaRect, PIL.ImageDraw
// and the GEOS offsets and areas). Loaded through ctypes by ../native.py,
// which builds it with g++ at first use; ../components.py, ../polygon.py
// and ../raster.py hold the numpy versions of the same functions.
//
// Build: g++ -O3 -ffp-contract=off -shared -fPIC -std=c++17 -o libgeometry.so geometry.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
    double x, y;
};

double cross(const Pt& o, const Pt& a, const Pt& b) {
    return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Andrew monotone chain; returns CCW hull.
std::vector<Pt> convex_hull(std::vector<Pt> pts) {
    std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
        return a.x < b.x || (a.x == b.x && a.y < b.y);
    });
    pts.erase(std::unique(pts.begin(), pts.end(),
                          [](const Pt& a, const Pt& b) {
                              return a.x == b.x && a.y == b.y;
                          }),
              pts.end());
    size_t n = pts.size();
    if (n <= 2) return pts;
    std::vector<Pt> hull(2 * n);
    size_t k = 0;
    for (size_t i = 0; i < n; i++) {
        while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) k--;
        hull[k++] = pts[i];
    }
    size_t lower = k + 1;
    for (size_t i = n - 1; i-- > 0;) {
        while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) k--;
        hull[k++] = pts[i];
    }
    hull.resize(k - 1);
    return hull;
}

double polygon_area_signed(const double* poly, int n) {
    double area = 0.0;
    for (int i = 0; i < n; i++) {
        int j = (i + 1) % n;
        area += poly[2 * i] * poly[2 * j + 1] - poly[2 * j] * poly[2 * i + 1];
    }
    return 0.5 * area;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- CC label
// Two-pass 8-connectivity labeling. labels_out must hold h*w int32.
// Returns the number of components.
int cc_label(const uint8_t* mask, int h, int w, int32_t* labels_out) {
    std::vector<int32_t> parent(1, 0);
    auto find = [&](int32_t x) {
        int32_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int32_t next = parent[x];
            parent[x] = root;
            x = next;
        }
        return root;
    };
    auto unite = [&](int32_t a, int32_t b) {
        a = find(a);
        b = find(b);
        if (a != b) parent[std::max(a, b)] = std::min(a, b);
    };

    std::memset(labels_out, 0, sizeof(int32_t) * h * w);
    for (int y = 0; y < h; y++) {
        for (int x = 0; x < w; x++) {
            if (!mask[y * w + x]) continue;
            int32_t label = 0;
            // Check W, NW, N, NE neighbours.
            const int dx[4] = {-1, -1, 0, 1};
            const int dy[4] = {0, -1, -1, -1};
            for (int k = 0; k < 4; k++) {
                int nx = x + dx[k], ny = y + dy[k];
                if (nx < 0 || nx >= w || ny < 0) continue;
                int32_t nl = labels_out[ny * w + nx];
                if (!nl) continue;
                if (!label) {
                    label = nl;
                } else if (nl != label) {
                    unite(label, nl);
                }
            }
            if (!label) {
                label = (int32_t)parent.size();
                parent.push_back(label);
            }
            labels_out[y * w + x] = label;
        }
    }
    // Flatten and renumber.
    std::vector<int32_t> remap(parent.size(), 0);
    int32_t next_id = 0;
    for (size_t i = 1; i < parent.size(); i++) {
        if (find((int32_t)i) == (int32_t)i) remap[i] = ++next_id;
    }
    for (size_t i = 1; i < parent.size(); i++) remap[i] = remap[find((int32_t)i)];
    for (int i = 0; i < h * w; i++) labels_out[i] = remap[labels_out[i]];
    return next_id;
}

// --------------------------------------------------------- min-area rect
// pts: n (x, y) pairs. out8: 4 corner (x, y) pairs.
void min_area_rect(const double* pts, int n, double* out8) {
    std::vector<Pt> v(n);
    for (int i = 0; i < n; i++) v[i] = {pts[2 * i], pts[2 * i + 1]};
    std::vector<Pt> hull = convex_hull(v);
    size_t hn = hull.size();
    if (hn == 0) {
        std::memset(out8, 0, sizeof(double) * 8);
        return;
    }
    if (hn == 1) {
        for (int i = 0; i < 4; i++) {
            out8[2 * i] = hull[0].x;
            out8[2 * i + 1] = hull[0].y;
        }
        return;
    }
    if (hn == 2) {
        out8[0] = hull[0].x; out8[1] = hull[0].y;
        out8[2] = hull[1].x; out8[3] = hull[1].y;
        out8[4] = hull[1].x; out8[5] = hull[1].y;
        out8[6] = hull[0].x; out8[7] = hull[0].y;
        return;
    }
    double best_area = 1e300;
    double bd0 = 1, bd1 = 0, bx0 = 0, bx1 = 0, by0 = 0, by1 = 0;
    for (size_t i = 0; i < hn; i++) {
        size_t j = (i + 1) % hn;
        double ex = hull[j].x - hull[i].x, ey = hull[j].y - hull[i].y;
        double len = std::hypot(ex, ey);
        if (len < 1e-12) continue;
        ex /= len; ey /= len;
        double nx = -ey, ny = ex;
        double x0 = 1e300, x1 = -1e300, y0 = 1e300, y1 = -1e300;
        for (size_t k = 0; k < hn; k++) {
            double pd = hull[k].x * ex + hull[k].y * ey;
            double pn = hull[k].x * nx + hull[k].y * ny;
            x0 = std::min(x0, pd); x1 = std::max(x1, pd);
            y0 = std::min(y0, pn); y1 = std::max(y1, pn);
        }
        double area = (x1 - x0) * (y1 - y0);
        if (area < best_area) {
            best_area = area;
            bd0 = ex; bd1 = ey; bx0 = x0; bx1 = x1; by0 = y0; by1 = y1;
        }
    }
    double nx = -bd1, ny = bd0;
    const double cs[4][2] = {{bx0, by0}, {bx1, by0}, {bx1, by1}, {bx0, by1}};
    for (int i = 0; i < 4; i++) {
        out8[2 * i] = cs[i][0] * bd0 + cs[i][1] * nx;
        out8[2 * i + 1] = cs[i][0] * bd1 + cs[i][1] * ny;
    }
}

// -------------------------------------------------------- polygon offset
// Mitre offset towards the interior by dist (negative = outward).
// Writes up to n (x, y) pairs to out; returns the vertex count, or 0 when
// the polygon degenerates (orientation flip, area growth on shrink, or
// self-intersection) — mirroring the Python reference's empty result.
int polygon_offset(const double* poly_in, int n_in, double dist, double* out) {
    std::vector<Pt> p;
    p.reserve(n_in);
    for (int i = 0; i < n_in; i++) {
        Pt pt{poly_in[2 * i], poly_in[2 * i + 1]};
        if (p.empty() || std::hypot(pt.x - p.back().x, pt.y - p.back().y) > 1e-9)
            p.push_back(pt);
    }
    if (p.size() > 1 && std::hypot(p[0].x - p.back().x, p[0].y - p.back().y) <= 1e-9)
        p.pop_back();
    int n = (int)p.size();
    if (n < 3) return 0;

    std::vector<double> flat(2 * n);
    for (int i = 0; i < n; i++) {
        flat[2 * i] = p[i].x;
        flat[2 * i + 1] = p[i].y;
    }
    double area = polygon_area_signed(flat.data(), n);
    if (std::fabs(area) < 1e-9) return 0;
    double sign = area > 0 ? 1.0 : -1.0;

    std::vector<Pt> dirs(n), opts(n);
    for (int i = 0; i < n; i++) {
        int j = (i + 1) % n;
        double ex = p[j].x - p[i].x, ey = p[j].y - p[i].y;
        double len = std::hypot(ex, ey);
        dirs[i] = {ex / len, ey / len};
        // inward normal (left of direction for CCW)
        double inx = sign * -dirs[i].y, iny = sign * dirs[i].x;
        opts[i] = {p[i].x + dist * inx, p[i].y + dist * iny};
    }
    std::vector<Pt> result(n);
    for (int i = 0; i < n; i++) {
        int j = (i - 1 + n) % n;
        const Pt &d1 = dirs[j], &d2 = dirs[i], &p1 = opts[j], &p2 = opts[i];
        double denom = d1.x * d2.y - d1.y * d2.x;
        if (std::fabs(denom) < 1e-12) {
            double inx = sign * -d2.y, iny = sign * d2.x;
            result[i] = {p[i].x + dist * inx, p[i].y + dist * iny};
        } else {
            double t = ((p2.x - p1.x) * d2.y - (p2.y - p1.y) * d2.x) / denom;
            result[i] = {p1.x + t * d1.x, p1.y + t * d1.y};
        }
    }
    std::vector<double> rflat(2 * n);
    for (int i = 0; i < n; i++) {
        rflat[2 * i] = result[i].x;
        rflat[2 * i + 1] = result[i].y;
    }
    if (dist > 0) {  // shrink checks
        double new_area = polygon_area_signed(rflat.data(), n);
        if (new_area * area <= 0) return 0;
        if (std::fabs(new_area) >= std::fabs(area)) return 0;
        // Self-intersection check (non-adjacent edges).
        auto orient = [](const Pt& a, const Pt& b, const Pt& c) {
            double v = (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
            if (v > 1e-9) return 1;
            if (v < -1e-9) return -1;
            return 0;
        };
        for (int i = 0; i < n; i++) {
            for (int j = i + 1; j < n; j++) {
                if (j == i || (j + 1) % n == i || (i + 1) % n == j) continue;
                const Pt &a = result[i], &b = result[(i + 1) % n];
                const Pt &c = result[j], &d = result[(j + 1) % n];
                int o1 = orient(a, b, c), o2 = orient(a, b, d);
                int o3 = orient(c, d, a), o4 = orient(c, d, b);
                if (o1 != o2 && o3 != o4) return 0;
            }
        }
    }
    std::memcpy(out, rflat.data(), sizeof(double) * 2 * n);
    return n;
}


// ------------------------------------------------------ scanline raster
// Fill a polygon into a uint8 [h, w] mask, matching PIL ImageDraw.polygon
// bit-for-bit (see ../raster.py for the rule). All crossing math is
// float32 like Pillow's C; vertices are truncated to int like Pillow's
// binding.
namespace pilfill {

struct Edge {
    int x0, y0;
    int ymin, ymax;
    float dx;
};

static inline int round_up_half(float f) {
    return (f >= 0.0f) ? (int)std::floor(f + 0.5f) : -(int)std::floor(std::fabs(f) + 0.5f);
}
static inline int round_down_half(float f) {
    return (f >= 0.0f) ? (int)std::ceil(f - 0.5f) : -(int)std::ceil(std::fabs(f) - 0.5f);
}
static inline float cross_at(const Edge& e, int y) {
    float prod = (float)(y - e.y0) * e.dx;  // keep two float32 roundings
    return prod + (float)e.x0;              // (no FMA; built with -ffp-contract=off)
}
static inline void hline(uint8_t* out, int h, int w, int x0, int y, int x1) {
    // Pillow's hline: no swap — reversed spans draw nothing.
    if (y < 0 || y >= h || x0 > x1 || x1 < 0 || x0 >= w) return;
    x0 = std::max(x0, 0);
    x1 = std::min(x1, w - 1);
    std::memset(out + (size_t)y * w + x0, 1, (size_t)(x1 - x0 + 1));
}

}  // namespace pilfill

void fill_polygon(const double* poly, int n, int h, int w, uint8_t* out) {
    using namespace pilfill;
    if (n < 2) return;
    std::vector<Edge> edges;
    edges.reserve(n);
    int gymin = h - 1, gymax = 0;
    for (int i = 0; i < n; i++) {
        int j = (i + 1) % n;
        int x0 = (int)poly[2 * i], y0 = (int)poly[2 * i + 1];
        int x1 = (int)poly[2 * j], y1 = (int)poly[2 * j + 1];
        gymin = std::min(gymin, std::min(y0, y1));
        gymax = std::max(gymax, std::max(y0, y1));
        if (y0 == y1) {
            hline(out, h, w, std::min(x0, x1), y0, std::max(x0, x1));
            continue;
        }
        Edge e;
        e.x0 = x0;
        e.y0 = y0;
        e.ymin = std::min(y0, y1);
        e.ymax = std::max(y0, y1);
        e.dx = (float)(x1 - x0) / (float)(y1 - y0);
        edges.push_back(e);
    }
    if (edges.empty()) return;
    gymin = std::max(gymin, 0);
    gymax = std::min(gymax, h);

    std::vector<float> xx(edges.size() * 2);
    for (int y = gymin; y <= gymax; y++) {
        int j = 0;
        for (size_t i = 0; i < edges.size(); i++) {
            const Edge& cur = edges[i];
            if (!(y >= cur.ymin && y <= cur.ymax)) continue;
            xx[j++] = cross_at(cur, y);
            if (y == cur.ymax && y < gymax) {
                // Edge ends here: duplicate the crossing to keep parity.
                xx[j] = xx[j - 1];
                j++;
            } else if (cur.dx != 0.0f && j % 2 == 0 &&
                       std::roundf(xx[j - 1]) == xx[j - 1]) {
                // Connect discontiguous corners.
                for (size_t k = 0; k < i; k++) {
                    const Edge& other = edges[k];
                    if ((cur.dx > 0 && other.dx <= 0) ||
                        (cur.dx < 0 && other.dx >= 0)) {
                        continue;
                    }
                    if (!((y == cur.ymin || y == cur.ymax) &&
                          (y == other.ymin || y == other.ymax))) {
                        continue;
                    }
                    if (xx[j - 1] == cross_at(other, y)) {
                        int offset = (y == gymax) ? -1 : 1;
                        float a = cross_at(cur, y + offset);
                        float b = cross_at(other, y + offset);
                        float v;
                        bool widens;
                        if (y == cur.ymax) {
                            if (cur.dx > 0) {
                                v = std::max(a, b) + 1.0f;
                                widens = v < xx[j - 1];
                            } else {
                                v = std::min(a, b) - 1.0f;
                                widens = v > xx[j - 1];
                            }
                        } else {
                            if (cur.dx > 0) {
                                v = std::min(a, b) - 1.0f;
                                widens = v > xx[j - 1];
                            } else {
                                v = std::max(a, b) + 1.0f;
                                widens = v < xx[j - 1];
                            }
                        }
                        if (widens && (int)k < j) xx[k] = v;
                        break;
                    }
                }
            }
        }
        std::sort(xx.begin(), xx.begin() + j);
        for (int s = 0; s + 1 < j; s += 2) {
            hline(out, h, w, round_up_half(xx[s]), y, round_down_half(xx[s + 1]));
        }
    }
}

// -------------------------------------------------- convex clip area
// Area of intersection of polygon a (na verts) clipped by CONVEX polygon b.
double convex_clip_area(const double* a, int na, const double* b, int nb) {
    std::vector<Pt> subject(na), clip(nb);
    for (int i = 0; i < na; i++) subject[i] = {a[2 * i], a[2 * i + 1]};
    for (int i = 0; i < nb; i++) clip[i] = {b[2 * i], b[2 * i + 1]};
    if (polygon_area_signed(a, na) < 0) std::reverse(subject.begin(), subject.end());
    if (polygon_area_signed(b, nb) < 0) std::reverse(clip.begin(), clip.end());

    std::vector<Pt> output = subject;
    for (int i = 0; i < (int)clip.size() && !output.empty(); i++) {
        Pt A = clip[i], B = clip[(i + 1) % clip.size()];
        double ex = B.x - A.x, ey = B.y - A.y;
        std::vector<Pt> input;
        input.swap(output);
        int m = (int)input.size();
        for (int k = 0; k < m; k++) {
            const Pt &cur = input[k], &nxt = input[(k + 1) % m];
            double cin = ex * (cur.y - A.y) - ey * (cur.x - A.x);
            double nin = ex * (nxt.y - A.y) - ey * (nxt.x - A.x);
            bool c_in = cin >= -1e-9, n_in = nin >= -1e-9;
            auto isect = [&]() {
                double dx = nxt.x - cur.x, dy = nxt.y - cur.y;
                double denom = ex * dy - ey * dx;
                if (std::fabs(denom) < 1e-15) return nxt;
                double t = (ex * (A.y - cur.y) - ey * (A.x - cur.x)) / denom;
                return Pt{cur.x + t * dx, cur.y + t * dy};
            };
            if (c_in) {
                output.push_back(cur);
                if (!n_in) output.push_back(isect());
            } else if (n_in) {
                output.push_back(isect());
            }
        }
    }
    if (output.size() < 3) return 0.0;
    double area = 0.0;
    int m = (int)output.size();
    for (int i = 0; i < m; i++) {
        int j = (i + 1) % m;
        area += output[i].x * output[j].y - output[j].x * output[i].y;
    }
    return std::fabs(0.5 * area);
}

}  // extern "C"
