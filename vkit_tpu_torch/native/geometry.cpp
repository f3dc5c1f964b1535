// First-party native geometry kernels (ctypes C ABI).
//
// Host-side replacements for the native libraries the reference leans on:
// cv2.fillPoly (vkit/element/polygon.py:75), cv2.findContours
// (vkit/element/mask.py:667) and scipy labeling. Semantics are bit-exact
// with vkit_tpu/geometry/_numpy_impl.py (the pure-python fallback), which
// the test suite pins against cv2.
//
// Build: g++ -O3 -shared -fPIC geometry.cpp -o libvkitgeom.so
#include <algorithm>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// numpy rounds half-to-even; std::nearbyint honors FE_TONEAREST which is
// round-half-even by default.
inline long long round_even(double v) { return (long long)std::nearbyint(v); }

inline void draw_line(uint8_t* mask, int height, int width,
                      long long x0, long long y0, long long x1, long long y1) {
    long long dx = std::llabs(x1 - x0);
    long long dy = std::llabs(y1 - y0);
    long long steps = dx > dy ? dx : dy;
    if (steps == 0) {
        if (y0 >= 0 && y0 < height && x0 >= 0 && x0 < width) {
            mask[y0 * width + x0] = 1;
        }
        return;
    }
    for (long long i = 0; i <= steps; ++i) {
        double t = (double)i / (double)steps;
        long long x = round_even((double)x0 + t * (double)(x1 - x0));
        long long y = round_even((double)y0 + t * (double)(y1 - y0));
        if (y >= 0 && y < height && x >= 0 && x < width) {
            mask[y * width + x] = 1;
        }
    }
}

// Moore neighborhood, matching _numpy_impl._MOORE ((dx, dy) order).
const int MOORE_DX[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int MOORE_DY[8] = {0, 1, 1, 1, 0, -1, -1, -1};

}  // namespace

extern "C" {

// Rasterize one polygon into a caller-zeroed uint8 (height, width) mask.
// points_xy: n_points (x, y) float64 pairs. cv2.fillPoly-compatible
// (scanline even-odd interior + Bresenham-style outline).
void vg_fill_poly(const double* points_xy, int n_points,
                  int height, int width, uint8_t* out) {
    if (n_points < 2 || height <= 0 || width <= 0) return;

    std::vector<double> xs(n_points), ys(n_points);
    double y_min_f = 1e300, y_max_f = -1e300;
    for (int i = 0; i < n_points; ++i) {
        xs[i] = (double)round_even(points_xy[2 * i]);
        ys[i] = (double)round_even(points_xy[2 * i + 1]);
        if (ys[i] < y_min_f) y_min_f = ys[i];
        if (ys[i] > y_max_f) y_max_f = ys[i];
    }

    long long y_min = (long long)std::floor(y_min_f);
    long long y_max = (long long)std::ceil(y_max_f);
    if (y_min < 0) y_min = 0;
    if (y_max > height - 1) y_max = height - 1;

    std::vector<double> row_xs;
    for (long long y = y_min; y <= y_max; ++y) {
        row_xs.clear();
        double yd = (double)y;
        for (int i = 0; i < n_points; ++i) {
            int j = (i + 1) % n_points;
            double ey0 = ys[i], ey1 = ys[j];
            if (ey0 == ey1) continue;
            double lo = ey0 < ey1 ? ey0 : ey1;
            double hi = ey0 < ey1 ? ey1 : ey0;
            // Half-open [lo, hi) rule: no double-counted vertices.
            if (yd >= lo && yd < hi) {
                double t = (yd - ey0) / (ey1 - ey0);
                row_xs.push_back(xs[i] + t * (xs[j] - xs[i]));
            }
        }
        std::sort(row_xs.begin(), row_xs.end());
        for (size_t k = 0; k + 1 < row_xs.size(); k += 2) {
            long long left = (long long)std::ceil(row_xs[k]);
            long long right = (long long)std::floor(row_xs[k + 1]);
            if (left < 0) left = 0;
            if (right > width - 1) right = width - 1;
            for (long long x = left; x <= right; ++x) {
                out[y * width + x] = 1;
            }
        }
    }

    for (int i = 0; i < n_points; ++i) {
        int j = (i + 1) % n_points;
        draw_line(out, height, width,
                  (long long)xs[i], (long long)ys[i],
                  (long long)xs[j], (long long)ys[j]);
    }
}

// Backward maps for a lattice warp: for each dst cell quad (K cells,
// corners pre-rounded like the host path), scanline-fill the quad with
// the SAME rule as vg_fill_poly and write the cell's inverse-homography
// source coordinates into map_x / map_y (+ coverage).  This is the hot
// per-cell loop of WarpPlan.backward_maps moved to C++ (~100x the Python
// per-cell version on production canvases).
void vg_lattice_backward_maps(
    const double* quads_xy,   // K * 4 * 2 (x, y), clockwise from up-left
    const double* inv_mats,   // K * 9 row-major 3x3
    int n_cells,
    int height, int width,
    float* map_y, float* map_x, uint8_t* covered) {
    std::vector<uint8_t> local;
    for (int c = 0; c < n_cells; ++c) {
        const double* quad = quads_xy + c * 8;
        double x_min = 1e300, x_max = -1e300, y_min = 1e300, y_max = -1e300;
        for (int i = 0; i < 4; ++i) {
            double x = quad[2 * i], y = quad[2 * i + 1];
            if (x < x_min) x_min = x;
            if (x > x_max) x_max = x;
            if (y < y_min) y_min = y;
            if (y > y_max) y_max = y;
        }
        long long x0 = (long long)std::floor(x_min); if (x0 < 0) x0 = 0;
        long long y0 = (long long)std::floor(y_min); if (y0 < 0) y0 = 0;
        long long x1 = (long long)std::ceil(x_max);
        if (x1 > width - 1) x1 = width - 1;
        long long y1 = (long long)std::ceil(y_max);
        if (y1 > height - 1) y1 = height - 1;
        if (x1 < x0 || y1 < y0) continue;
        int lh = (int)(y1 - y0 + 1);
        int lw = (int)(x1 - x0 + 1);
        local.assign((size_t)lh * lw, 0);
        double shifted[8];
        for (int i = 0; i < 4; ++i) {
            shifted[2 * i] = quad[2 * i] - (double)x0;
            shifted[2 * i + 1] = quad[2 * i + 1] - (double)y0;
        }
        vg_fill_poly(shifted, 4, lh, lw, local.data());

        const double* m = inv_mats + c * 9;
        for (int ly = 0; ly < lh; ++ly) {
            const uint8_t* row = local.data() + (size_t)ly * lw;
            long long dy = y0 + ly;
            for (int lx = 0; lx < lw; ++lx) {
                if (!row[lx]) continue;
                long long dx = x0 + lx;
                double w = m[6] * (double)dx + m[7] * (double)dy + m[8];
                if (w == 0.0) continue;
                double sx = (m[0] * (double)dx + m[1] * (double)dy + m[2]) / w;
                double sy = (m[3] * (double)dx + m[4] * (double)dy + m[5]) / w;
                size_t off = (size_t)dy * width + dx;
                map_x[off] = (float)sx;
                map_y[off] = (float)sy;
                covered[off] = 1;
            }
        }
    }
}

// Backward-map values at NODE coordinates only: like
// vg_lattice_backward_maps but the inverse homography runs just at the
// covered node pixels (the coarse warp planner needs ~1/64th of the
// pixels; the full-resolution divide per covered pixel dominated its
// host cost).  node_ys / node_xs: sorted int32 coordinate arrays.
// out_y/out_x/covered: (n_ys, n_xs) row-major, caller-zeroed.
void vg_lattice_node_maps(
    const double* quads_xy,   // K * 4 * 2 (x, y), clockwise from up-left
    const double* inv_mats,   // K * 9 row-major 3x3
    int n_cells,
    int height, int width,
    const int32_t* node_ys, int n_ys,
    const int32_t* node_xs, int n_xs,
    float* out_y, float* out_x, uint8_t* covered) {
    std::vector<uint8_t> local;
    for (int c = 0; c < n_cells; ++c) {
        const double* quad = quads_xy + c * 8;
        double x_min = 1e300, x_max = -1e300, y_min = 1e300, y_max = -1e300;
        for (int i = 0; i < 4; ++i) {
            double x = quad[2 * i], y = quad[2 * i + 1];
            if (x < x_min) x_min = x;
            if (x > x_max) x_max = x;
            if (y < y_min) y_min = y;
            if (y > y_max) y_max = y;
        }
        long long x0 = (long long)std::floor(x_min); if (x0 < 0) x0 = 0;
        long long y0 = (long long)std::floor(y_min); if (y0 < 0) y0 = 0;
        long long x1 = (long long)std::ceil(x_max);
        if (x1 > width - 1) x1 = width - 1;
        long long y1 = (long long)std::ceil(y_max);
        if (y1 > height - 1) y1 = height - 1;
        if (x1 < x0 || y1 < y0) continue;

        // Node index ranges intersecting the cell bbox (lower bounds).
        int iy0 = (int)(std::lower_bound(node_ys, node_ys + n_ys, (int32_t)y0)
                        - node_ys);
        int ix0 = (int)(std::lower_bound(node_xs, node_xs + n_xs, (int32_t)x0)
                        - node_xs);
        if (iy0 >= n_ys || ix0 >= n_xs) continue;
        if (node_ys[iy0] > y1 || node_xs[ix0] > x1) continue;

        int lh = (int)(y1 - y0 + 1);
        int lw = (int)(x1 - x0 + 1);
        local.assign((size_t)lh * lw, 0);
        double shifted[8];
        for (int i = 0; i < 4; ++i) {
            shifted[2 * i] = quad[2 * i] - (double)x0;
            shifted[2 * i + 1] = quad[2 * i + 1] - (double)y0;
        }
        vg_fill_poly(shifted, 4, lh, lw, local.data());

        const double* m = inv_mats + c * 9;
        for (int iy = iy0; iy < n_ys && node_ys[iy] <= y1; ++iy) {
            long long dy = node_ys[iy];
            const uint8_t* row = local.data() + (size_t)(dy - y0) * lw;
            for (int ix = ix0; ix < n_xs && node_xs[ix] <= x1; ++ix) {
                long long dx = node_xs[ix];
                if (!row[dx - x0]) continue;
                double w = m[6] * (double)dx + m[7] * (double)dy + m[8];
                if (w == 0.0) continue;
                double sx = (m[0] * (double)dx + m[1] * (double)dy + m[2]) / w;
                double sy = (m[3] * (double)dx + m[4] * (double)dy + m[5]) / w;
                size_t off = (size_t)iy * n_xs + ix;
                out_x[off] = (float)sx;
                out_y[off] = (float)sy;
                covered[off] = 1;
            }
        }
    }
}

// Repair uncovered dst pixels of a lattice backward map by linear
// extension of the covered data — the C++ form of the repair loop in
// vkit_tpu/mechanism/batched.py plan_backward_maps (same arithmetic,
// float64 in-place).  Smooth extensions keep the two-pass tap budget
// small; extended pixels are gated by the active mask downstream.
void vg_repair_backward_maps(
    double* map_y, double* map_x, const uint8_t* cov,
    int rows, int cols) {
    if (rows <= 0 || cols <= 0) return;
    std::vector<int> covered_rows;
    covered_rows.reserve(rows);
    std::vector<uint8_t> row_full(rows, 0);
    for (int y = 0; y < rows; ++y) {
        const uint8_t* c = cov + (size_t)y * cols;
        int any = 0, all = 1;
        for (int x = 0; x < cols; ++x) {
            if (c[x]) any = 1; else all = 0;
        }
        if (any) covered_rows.push_back(y);
        row_full[y] = (uint8_t)(any && all);
    }

    for (int y : covered_rows) {
        if (row_full[y]) continue;
        const uint8_t* c = cov + (size_t)y * cols;
        double* mx = map_x + (size_t)y * cols;
        double* my = map_y + (size_t)y * cols;
        int first = -1, last = -1, count = 0;
        for (int x = 0; x < cols; ++x) {
            if (c[x]) {
                if (first < 0) first = x;
                last = x;
                ++count;
            }
        }
        if (first < 0) continue;
        if (last - first + 1 != count) {
            // Interior holes (rare): interpolate across each gap.
            int prev = first;
            for (int x = first + 1; x <= last; ++x) {
                if (!c[x]) continue;
                if (x > prev + 1) {
                    double span = (double)(x - prev);
                    for (int g = prev + 1; g < x; ++g) {
                        double t = (double)(g - prev) / span;
                        mx[g] = mx[prev] + t * (mx[x] - mx[prev]);
                        my[g] = my[prev] + t * (my[x] - my[prev]);
                    }
                }
                prev = x;
            }
        }
        // Extend with the LOCAL slope at each edge (an 8-px window), not
        // the full-row average: a curved row extended at its tangent stays
        // shape-consistent with its neighbours, which keeps the two-pass
        // tap budget small near canvas borders.
        int dl = last - first;
        if (dl > 8) dl = 8;
        if (dl > 0) {
            double sxl = (mx[first + dl] - mx[first]) / (double)dl;
            double syl = (my[first + dl] - my[first]) / (double)dl;
            double sxr = (mx[last] - mx[last - dl]) / (double)dl;
            double syr = (my[last] - my[last - dl]) / (double)dl;
            for (int x = 0; x < first; ++x) {
                double d = (double)(x - first);
                mx[x] = mx[first] + d * sxl;
                my[x] = my[first] + d * syl;
            }
            for (int x = last + 1; x < cols; ++x) {
                double d = (double)(x - last);
                mx[x] = mx[last] + d * sxr;
                my[x] = my[last] + d * syr;
            }
        } else {
            for (int x = 0; x < first; ++x) {
                double d = (double)(x - first);
                mx[x] = mx[first] + d;
                my[x] = my[first];
            }
            for (int x = last + 1; x < cols; ++x) {
                double d = (double)(x - last);
                mx[x] = mx[last] + d;
                my[x] = my[last];
            }
        }
    }

    if (covered_rows.empty() || (int)covered_rows.size() == rows) return;
    int top = covered_rows.front(), bottom = covered_rows.back();
    // Vertical steps from LOCAL 8-row windows at each edge (see above).
    int dv = bottom - top;
    if (dv > 8) dv = 8;
    std::vector<double> step_y_t(cols, 1.0), step_x_t(cols, 0.0);
    std::vector<double> step_y_b(cols, 1.0), step_x_b(cols, 0.0);
    if (dv > 0) {
        double inv = 1.0 / (double)dv;
        for (int x = 0; x < cols; ++x) {
            step_y_t[x] = (map_y[(size_t)(top + dv) * cols + x]
                           - map_y[(size_t)top * cols + x]) * inv;
            step_x_t[x] = (map_x[(size_t)(top + dv) * cols + x]
                           - map_x[(size_t)top * cols + x]) * inv;
            step_y_b[x] = (map_y[(size_t)bottom * cols + x]
                           - map_y[(size_t)(bottom - dv) * cols + x]) * inv;
            step_x_b[x] = (map_x[(size_t)bottom * cols + x]
                           - map_x[(size_t)(bottom - dv) * cols + x]) * inv;
        }
    }
    auto extend_row = [&](int y, int y0, const std::vector<double>& sy,
                          const std::vector<double>& sx) {
        double d = (double)(y - y0);
        double* my = map_y + (size_t)y * cols;
        double* mx = map_x + (size_t)y * cols;
        const double* ry = map_y + (size_t)y0 * cols;
        const double* rx = map_x + (size_t)y0 * cols;
        for (int x = 0; x < cols; ++x) {
            my[x] = ry[x] + d * sy[x];
            mx[x] = rx[x] + d * sx[x];
        }
    };
    for (int y = 0; y < top; ++y) extend_row(y, top, step_y_t, step_x_t);
    for (int y = bottom + 1; y < rows; ++y)
        extend_row(y, bottom, step_y_b, step_x_b);
    // Interior rows with no coverage (rare): nearest covered row
    // (ties resolve to the earlier row, matching np.argmin).
    size_t ci = 0;
    for (int y = top + 1; y < bottom; ++y) {
        const uint8_t* c = cov + (size_t)y * cols;
        int any = 0;
        for (int x = 0; x < cols; ++x) {
            if (c[x]) { any = 1; break; }
        }
        if (any) continue;
        while (ci + 1 < covered_rows.size() && covered_rows[ci + 1] < y) ++ci;
        int y0 = covered_rows[ci];
        if (ci + 1 < covered_rows.size()) {
            int y1 = covered_rows[ci + 1];
            if (std::abs(y1 - y) < std::abs(y - y0)) y0 = y1;
        }
        extend_row(y, y0,
                   y0 - top <= bottom - y0 ? step_y_t : step_y_b,
                   y0 - top <= bottom - y0 ? step_x_t : step_x_b);
    }
}

// 8-connected component labeling, labels assigned in raster order of each
// component's first pixel (1-based; 0 = background). Returns the number of
// components. labels: caller-allocated int32 (height * width).
int vg_label8(const uint8_t* mask, int height, int width, int32_t* labels) {
    const long long total = (long long)height * width;
    std::memset(labels, 0, sizeof(int32_t) * total);
    int num = 0;
    std::vector<long long> stack;
    for (long long start = 0; start < total; ++start) {
        if (!mask[start] || labels[start]) continue;
        ++num;
        stack.clear();
        stack.push_back(start);
        labels[start] = num;
        while (!stack.empty()) {
            long long p = stack.back();
            stack.pop_back();
            long long py = p / width, px = p % width;
            for (int d = 0; d < 8; ++d) {
                long long ny = py + MOORE_DY[d];
                long long nx = px + MOORE_DX[d];
                if (ny < 0 || ny >= height || nx < 0 || nx >= width) continue;
                long long q = ny * width + nx;
                if (mask[q] && !labels[q]) {
                    labels[q] = num;
                    stack.push_back(q);
                }
            }
        }
    }
    return num;
}

// Moore-neighbor boundary trace of component `comp` within `labels`,
// starting at its raster-order first pixel (start_y, start_x).  Writes up
// to cap (x, y) float64 pairs; returns the point count, or -1 on overflow.
int vg_trace_boundary(const int32_t* labels, int height, int width,
                      int comp, int start_y, int start_x,
                      double* out_xy, long long cap) {
    long long count = 0;
    auto push = [&](long long x, long long y) -> bool {
        if (count >= cap) return false;
        out_xy[2 * count] = (double)x;
        out_xy[2 * count + 1] = (double)y;
        ++count;
        return true;
    };
    if (!push(start_x, start_y)) return -1;

    int prev_dir = 4;  // came from the West
    long long cy = start_y, cx = start_x;
    int first_ny = -1, first_nx = -1, first_d = -1;
    const long long hard_limit = 4LL * height * width;

    while (true) {
        bool found = false;
        int start_dir = (prev_dir + 1) % 8;
        for (int k = 0; k < 8; ++k) {
            int d = (start_dir + k) % 8;
            long long ny = cy + MOORE_DY[d];
            long long nx = cx + MOORE_DX[d];
            if (ny < 0 || ny >= height || nx < 0 || nx >= width) continue;
            if (labels[ny * width + nx] != comp) continue;
            if (first_d < 0) {
                first_ny = (int)ny;
                first_nx = (int)nx;
                first_d = d;
            } else if (cy == start_y && cx == start_x
                       && ny == first_ny && nx == first_nx && d == first_d) {
                return (int)(count - 1);  // full cycle; drop re-entry point
            }
            cy = ny;
            cx = nx;
            if (!push(cx, cy)) return -1;
            prev_dir = (d + 4) % 8;
            found = true;
            break;
        }
        if (!found) return (int)count;  // isolated pixel
        if (count > hard_limit) return -2;
    }
}

// Bilinear backward-map remap on float32 (H, W, C), cv2 BORDER_CONSTANT
// semantics (each out-of-range tap contributes the border value).  Single
// pass, no temporaries — the numpy formulation allocates ~20 full-page
// arrays, which is pathological on fault-slow hosts.
void vg_remap_f32(
    const float* src, int height, int width, int channels,
    const float* map_y, const float* map_x, int out_h, int out_w,
    const float* border, float* out) {
    const long long row_len = (long long)width * channels;
    for (long long p = 0; p < (long long)out_h * out_w; ++p) {
        float my = map_y[p];
        float mx = map_x[p];
        // NaN or far-out-of-range coords resolve to all-border taps; the
        // clamp also keeps the float->int cast below well-defined.
        if (std::isnan(my) || std::isnan(mx)) {
            my = -2.0f;
            mx = -2.0f;
        }
        my = std::min(std::max(my, -2.0f), (float)height + 1.0f);
        mx = std::min(std::max(mx, -2.0f), (float)width + 1.0f);
        const float y0f = std::floor(my);
        const float x0f = std::floor(mx);
        const float wy = my - y0f;
        const float wx = mx - x0f;
        const long long y0 = (long long)y0f;
        const long long x0 = (long long)x0f;
        float* dst = out + p * channels;
        const float iwy = 1.0f - wy;
        const float iwx = 1.0f - wx;
        const long long ys[4] = {y0, y0, y0 + 1, y0 + 1};
        const long long xs[4] = {x0, x0 + 1, x0, x0 + 1};
        for (int ch = 0; ch < channels; ++ch) {
            float v[4];
            for (int t = 0; t < 4; ++t) {
                if (ys[t] >= 0 && ys[t] < height && xs[t] >= 0 && xs[t] < width) {
                    v[t] = src[ys[t] * row_len + xs[t] * channels + ch];
                } else {
                    v[t] = border[ch];
                }
            }
            // Same multiply/add order as the numpy formulation (bit parity).
            dst[ch] = ((v[0] * iwy) * iwx) + ((v[1] * iwy) * wx)
                + ((v[2] * wy) * iwx) + ((v[3] * wy) * wx);
        }
    }
}

// Separable tap-based resize on float32 (H, W, C): the Python side supplies
// the OpenCV-exact tap indices/weights (ops/resize_taps.build_resize_taps);
// this applies them in two passes.  tmp: caller scratch (h_out * w * c).
void vg_resize_f32(
    const float* src, int height, int width, int channels,
    const int32_t* idx_r, const float* w_r, int taps_r, int h_out,
    const int32_t* idx_c, const float* w_c, int taps_c, int w_out,
    float* tmp, float* out) {
    const long long row_len = (long long)width * channels;

    // Rows: tmp[i, :] = sum_t w_r[i, t] * src[idx_r[i, t], :].
    for (int i = 0; i < h_out; ++i) {
        float* dst_row = tmp + (long long)i * row_len;
        for (long long k = 0; k < row_len; ++k) dst_row[k] = 0.0f;
        for (int t = 0; t < taps_r; ++t) {
            const float wv = w_r[i * taps_r + t];
            if (wv == 0.0f) continue;
            const float* src_row =
                src + (long long)idx_r[i * taps_r + t] * row_len;
            for (long long k = 0; k < row_len; ++k) {
                dst_row[k] += wv * src_row[k];
            }
        }
    }

    // Columns: out[i, j, :] = sum_t w_c[j, t] * tmp[i, idx_c[j, t], :].
    const long long out_row_len = (long long)w_out * channels;
    for (int i = 0; i < h_out; ++i) {
        const float* src_row = tmp + (long long)i * row_len;
        float* dst_row = out + (long long)i * out_row_len;
        for (int j = 0; j < w_out; ++j) {
            for (int c = 0; c < channels; ++c) {
                float acc = 0.0f;
                for (int t = 0; t < taps_c; ++t) {
                    acc += w_c[j * taps_c + t]
                        * src_row[(long long)idx_c[j * taps_c + t] * channels + c];
                }
                dst_row[(long long)j * channels + c] = acc;
            }
        }
    }
}


// ---------------------------------------------------------------------------
// vg_cell_mats: per-cell lattice homographies in one pass.
//
// Mirrors the numpy pipeline in mechanism/distortion/warp_plan.py
// _cell_mats (closed-form rect->quad from ops/warp.py rect_to_quad_mats,
// corner-mapping validation, projective inverse).  Source cells are
// axis-aligned rects; rects: K * 4 (x_left, y_top, x_right, y_bottom);
// dst quads: K * 8 (x, y clockwise from up-left).  Outputs: fwd / inv
// K * 9 row-major; bad: bit0 = forward needs the linear-solver fallback,
// bit1 = inverse does.  Same arithmetic order as the numpy path (build
// with -ffp-contract=off) so results match the fallback bit-for-bit on
// well-conditioned cells.
void vg_cell_mats(
    const double* rects,
    const double* dst_quads,
    int n_cells,
    double* fwd_out, double* inv_out, uint8_t* bad_out) {
    for (int c = 0; c < n_cells; ++c) {
        const double* q = dst_quads + c * 8;
        const double x0 = q[0], y0 = q[1];
        const double x1 = q[2], y1 = q[3];
        const double x2 = q[4], y2 = q[5];
        const double x3 = q[6], y3 = q[7];

        const double sx = x0 - x1 + x2 - x3;
        const double sy = y0 - y1 + y2 - y3;
        const double dx1 = x1 - x2, dy1 = y1 - y2;
        const double dx2 = x3 - x2, dy2 = y3 - y2;
        double den = dx1 * dy2 - dx2 * dy1;
        if (std::fabs(den) < 1e-12) den = 1e-12;
        const double g = (sx * dy2 - dx2 * sy) / den;
        const double h = (dx1 * sy - sx * dy1) / den;

        double hu[9] = {
            x1 - x0 + g * x1, x3 - x0 + h * x3, x0,
            y1 - y0 + g * y1, y3 - y0 + h * y3, y0,
            g, h, 1.0,
        };
        const double rl = rects[c * 4 + 0], rt = rects[c * 4 + 1];
        const double rr = rects[c * 4 + 2], rb = rects[c * 4 + 3];
        double w = rr - rl; if (w < 1e-12) w = 1e-12;
        double hg = rb - rt; if (hg < 1e-12) hg = 1e-12;
        // Pre-compose with rect -> unit square (scale + translate), then
        // normalize so H[2][2] = 1 like the linear solver.
        const double s00 = 1.0 / w, s02 = -rl / w;
        const double s11 = 1.0 / hg, s12 = -rt / hg;
        double m[9];
        m[0] = hu[0] * s00;
        m[1] = hu[1] * s11;
        m[2] = hu[0] * s02 + hu[1] * s12 + hu[2];
        m[3] = hu[3] * s00;
        m[4] = hu[4] * s11;
        m[5] = hu[3] * s02 + hu[4] * s12 + hu[5];
        m[6] = hu[6] * s00;
        m[7] = hu[7] * s11;
        m[8] = hu[6] * s02 + hu[7] * s12 + hu[8];
        const double nrm = m[8];
        for (int i = 0; i < 9; ++i) m[i] /= nrm;

        uint8_t bad = 0;
        for (int i = 0; i < 9; ++i) {
            if (!std::isfinite(m[i])) { bad |= 1; break; }
        }
        if (!bad) {
            // Corner-mapping validation: the closed form loses precision
            // on near-degenerate rounded cells.
            const double cx[4] = {rl, rr, rr, rl};
            const double cy[4] = {rt, rt, rb, rb};
            double err = 0.0;
            for (int k = 0; k < 4; ++k) {
                const double wp = m[6] * cx[k] + m[7] * cy[k] + m[8];
                const double xp = (m[0] * cx[k] + m[1] * cy[k] + m[2]) / wp;
                const double yp = (m[3] * cx[k] + m[4] * cy[k] + m[5]) / wp;
                const double ex = std::fabs(xp - q[2 * k]);
                const double ey = std::fabs(yp - q[2 * k + 1]);
                if (ex > err) err = ex;
                if (ey > err) err = ey;
            }
            if (!(err <= 1e-6)) bad |= 1;
        }
        for (int i = 0; i < 9; ++i) fwd_out[c * 9 + i] = m[i];

        // Projective inverse via adjugate / det; consumers divide by w,
        // so no normalization (warp_plan.py:135-147 semantics).
        const double det =
            m[0] * (m[4] * m[8] - m[5] * m[7])
            - m[1] * (m[3] * m[8] - m[5] * m[6])
            + m[2] * (m[3] * m[7] - m[4] * m[6]);
        double* inv = inv_out + c * 9;
        if (!std::isfinite(det) || std::fabs(det) <= 1e-12) {
            bad |= 2;
            for (int i = 0; i < 9; ++i) inv[i] = (i % 4 == 0) ? 1.0 : 0.0;
        } else {
            const double id = 1.0 / det;
            inv[0] = (m[4] * m[8] - m[5] * m[7]) * id;
            inv[1] = (m[2] * m[7] - m[1] * m[8]) * id;
            inv[2] = (m[1] * m[5] - m[2] * m[4]) * id;
            inv[3] = (m[5] * m[6] - m[3] * m[8]) * id;
            inv[4] = (m[0] * m[8] - m[2] * m[6]) * id;
            inv[5] = (m[2] * m[3] - m[0] * m[5]) * id;
            inv[6] = (m[3] * m[7] - m[4] * m[6]) * id;
            inv[7] = (m[1] * m[6] - m[0] * m[7]) * id;
            inv[8] = (m[0] * m[4] - m[1] * m[3]) * id;
            for (int i = 0; i < 9; ++i) {
                if (!std::isfinite(inv[i])) { bad |= 2; break; }
            }
        }
        bad_out[c] = bad;
    }
}

}  // extern "C"

