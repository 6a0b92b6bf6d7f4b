// Host geometry core of the serving path's postprocess: 8-connected
// component labeling, minimum-area rotated rectangles and mitre polygon
// offsets (the first-party replacements for cv2.findContours/minAreaRect
// and the GEOS parallel offset). Loaded through ctypes by ../native.py,
// which builds it with g++ at first use; ../components.py and
// ../polygon.py hold the numpy versions of the same functions.
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

}  // extern "C"
