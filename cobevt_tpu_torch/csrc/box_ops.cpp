// Host box kernels of the LiDAR post-processing (C ABI, loaded via ctypes).
//
// The port's copy of the JAX package's native/box_ops.cpp, unchanged below
// this comment: the Fast-RCNN axis-aligned IoU with the +1 convention
// (bbox_overlaps, bbox_intersections; reference box_overlaps.pyx :17, :59),
// a rotated-rectangle IoU by Sutherland-Hodgman clipping (rotated_iou) and
// greedy rotated NMS over every candidate (nms_rotated).  These run on the
// CPU: target assignment at data time, decoding and AP after a forward.
//
// Build: cobevt_tpu_torch/utils/native_ops.py compiles this file with g++
// at first use into cobevt_tpu_torch/_build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Fast-RCNN style AABB IoU with the legacy +1 pixel convention.
void bbox_overlaps(const float* boxes, int64_t n,
                   const float* query, int64_t k,
                   float* out) {
    #pragma omp parallel for if (n * k > 16384)
    for (int64_t j = 0; j < k; ++j) {
        const float qx1 = query[j * 4 + 0];
        const float qy1 = query[j * 4 + 1];
        const float qx2 = query[j * 4 + 2];
        const float qy2 = query[j * 4 + 3];
        const float q_area = (qx2 - qx1 + 1.f) * (qy2 - qy1 + 1.f);
        for (int64_t i = 0; i < n; ++i) {
            const float* b = boxes + i * 4;
            const float iw = std::min(b[2], qx2) - std::max(b[0], qx1) + 1.f;
            float v = 0.f;
            if (iw > 0.f) {
                const float ih =
                    std::min(b[3], qy2) - std::max(b[1], qy1) + 1.f;
                if (ih > 0.f) {
                    const float ua = (b[2] - b[0] + 1.f) *
                                     (b[3] - b[1] + 1.f) +
                                     q_area - iw * ih;
                    v = iw * ih / ua;
                }
            }
            out[i * k + j] = v;
        }
    }
}

// Intersection area normalized by the query box area.
void bbox_intersections(const float* boxes, int64_t n,
                        const float* query, int64_t k,
                        float* out) {
    for (int64_t j = 0; j < k; ++j) {
        const float qx1 = query[j * 4 + 0];
        const float qy1 = query[j * 4 + 1];
        const float qx2 = query[j * 4 + 2];
        const float qy2 = query[j * 4 + 3];
        const float q_area = (qx2 - qx1 + 1.f) * (qy2 - qy1 + 1.f);
        for (int64_t i = 0; i < n; ++i) {
            const float* b = boxes + i * 4;
            const float iw = std::min(b[2], qx2) - std::max(b[0], qx1) + 1.f;
            float v = 0.f;
            if (iw > 0.f) {
                const float ih =
                    std::min(b[3], qy2) - std::max(b[1], qy1) + 1.f;
                if (ih > 0.f) v = iw * ih / q_area;
            }
            out[i * k + j] = v;
        }
    }
}

namespace {

struct Pt { double x, y; };

double polygon_area(const Pt* p, int n) {
    double a = 0;
    for (int i = 0; i < n; ++i) {
        const Pt& u = p[i];
        const Pt& v = p[(i + 1) % n];
        a += u.x * v.y - v.x * u.y;
    }
    return std::fabs(a) * 0.5;
}

// Intersection area of two convex quads via Sutherland–Hodgman.
double quad_intersection_area(const double* qa, const double* qb) {
    Pt poly[16], next[16];
    int n = 4;
    for (int i = 0; i < 4; ++i) poly[i] = {qa[2 * i], qa[2 * i + 1]};

    // orientation of the clip quad
    double cross = (qb[2] - qb[0]) * (qb[5] - qb[3]) -
                   (qb[3] - qb[1]) * (qb[4] - qb[2]);
    double ccw = cross >= 0 ? 1.0 : -1.0;

    for (int e = 0; e < 4 && n >= 3; ++e) {
        const Pt a = {qb[2 * e], qb[2 * e + 1]};
        const Pt b = {qb[2 * ((e + 1) % 4)], qb[2 * ((e + 1) % 4) + 1]};
        const double ex = b.x - a.x, ey = b.y - a.y;
        int m = 0;
        for (int i = 0; i < n; ++i) {
            const Pt cur = poly[i];
            const Pt nx = poly[(i + 1) % n];
            const double sc = (ex * (cur.y - a.y) - ey * (cur.x - a.x)) * ccw;
            const double sn = (ex * (nx.y - a.y) - ey * (nx.x - a.x)) * ccw;
            if (sc >= 0) next[m++] = cur;
            if ((sc >= 0) != (sn >= 0)) {
                const double t = sc / (sc - sn);
                next[m++] = {cur.x + t * (nx.x - cur.x),
                             cur.y + t * (nx.y - cur.y)};
            }
        }
        n = m;
        std::memcpy(poly, next, sizeof(Pt) * n);
    }
    if (n < 3) return 0.0;
    return polygon_area(poly, n);
}

}  // namespace

// Pairwise rotated-rectangle IoU: corners (n, 4, 2) x (k, 4, 2) doubles.
void rotated_iou(const double* a, int64_t n,
                 const double* b, int64_t k,
                 double* out) {
    #pragma omp parallel for if (n * k > 1024)
    for (int64_t i = 0; i < n; ++i) {
        Pt pa[4];
        for (int t = 0; t < 4; ++t)
            pa[t] = {a[i * 8 + 2 * t], a[i * 8 + 2 * t + 1]};
        const double area_a = polygon_area(pa, 4);
        for (int64_t j = 0; j < k; ++j) {
            Pt pb[4];
            for (int t = 0; t < 4; ++t)
                pb[t] = {b[j * 8 + 2 * t], b[j * 8 + 2 * t + 1]};
            const double area_b = polygon_area(pb, 4);
            const double inter =
                quad_intersection_area(a + i * 8, b + j * 8);
            const double uni = area_a + area_b - inter;
            out[i * k + j] = uni > 1e-12 ? inter / uni : 0.0;
        }
    }
}

// Greedy rotated NMS over pre-sorted-by-score corner boxes.
// keep_out must hold n int64; returns the number kept.
int64_t nms_rotated(const double* corners, const double* scores,
                    int64_t n, double threshold, int64_t* keep_out) {
    // argsort scores descending
    int64_t* order = new int64_t[n];
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order, order + n, [&](int64_t x, int64_t y) {
        return scores[x] > scores[y];
    });
    bool* alive = new bool[n];
    std::fill(alive, alive + n, true);
    int64_t kept = 0;
    for (int64_t oi = 0; oi < n; ++oi) {
        if (!alive[oi]) continue;
        const int64_t i = order[oi];
        keep_out[kept++] = i;
        Pt pa[4];
        for (int t = 0; t < 4; ++t)
            pa[t] = {corners[i * 8 + 2 * t], corners[i * 8 + 2 * t + 1]};
        const double area_i = polygon_area(pa, 4);
        for (int64_t oj = oi + 1; oj < n; ++oj) {
            if (!alive[oj]) continue;
            const int64_t j = order[oj];
            Pt pb[4];
            for (int t = 0; t < 4; ++t)
                pb[t] = {corners[j * 8 + 2 * t],
                         corners[j * 8 + 2 * t + 1]};
            const double inter = quad_intersection_area(
                corners + i * 8, corners + j * 8);
            const double uni = area_i + polygon_area(pb, 4) - inter;
            const double iou = uni > 1e-12 ? inter / uni : 0.0;
            if (iou > threshold) alive[oj] = false;
        }
    }
    delete[] order;
    delete[] alive;
    return kept;
}

}  // extern "C"
