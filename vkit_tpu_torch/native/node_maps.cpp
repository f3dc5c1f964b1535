// Coarse node maps of lattice warp plans, decided at the node pixels alone
// (ctypes C ABI; built into one library with geometry.cpp).
//
// geometry.cpp's vg_lattice_node_maps rasterises every lattice cell with
// vg_fill_poly over the cell's bounding box, then reads that raster at the
// one node or so inside it.  vg_lattice_node_maps_batch decides the same
// fill rule at each node pixel instead: the node row's scanline spans
// (its edge crossings, computed once per cell and node row), then the
// outline steps of draw_line for the edges whose bounding box holds the
// node.  The arithmetic is vg_fill_poly's, step for step, so the covered
// nodes and their values are bit-identical; a later cell overwrites an
// earlier one, as there.  The node repair that follows is the C++ twin of
// _repair_node_maps (vkit_tpu/mechanism/batched.py): float64 on the
// float32-rounded node values, in numpy's order of operations, with
// np.interp's rule.
//
// Build with -ffp-contract=off (native/__init__.py): a fused multiply-add
// would change the last bit of the values.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// numpy rounds half-to-even; std::nearbyint honors FE_TONEAREST which is
// round-half-even by default (as geometry.cpp).
inline long long round_even(double v) { return (long long)std::nearbyint(v); }

// Whether geometry.cpp's draw_line(x0, y0, x1, y1) sets the pixel
// (px, py), which lies inside its mask.  Its steps stay within the
// segment's bounding box, so a pixel outside that box is never set.
bool on_outline(long long x0, long long y0, long long x1, long long y1,
                long long px, long long py) {
    if (px < std::min(x0, x1) || px > std::max(x0, x1)
        || py < std::min(y0, y1) || py > std::max(y0, y1)) {
        return false;
    }
    long long dx = std::llabs(x1 - x0);
    long long dy = std::llabs(y1 - y0);
    long long steps = dx > dy ? dx : dy;
    if (steps == 0) return true;  // the box is the one pixel
    for (long long i = 0; i <= steps; ++i) {
        double t = (double)i / (double)steps;
        long long x = round_even((double)x0 + t * (double)(x1 - x0));
        long long y = round_even((double)y0 + t * (double)(y1 - y0));
        if (x == px && y == py) return true;
    }
    return false;
}

// One lattice plan's covered nodes and their inverse-homography values:
// what vg_lattice_node_maps writes for the same cells, without a raster.
// lattice: (lat_rows, lat_cols, 2) int64 xy of the dst lattice, whose cell
// (r, k) is the quad (r, k), (r, k + 1), (r + 1, k + 1), (r + 1, k);
// inv_mats: one row-major 3x3 a cell; out_y / out_x / covered:
// (n_ys, n_xs), caller-zeroed.
void lattice_nodes(
    const int64_t* lattice, int lat_rows, int lat_cols,
    const double* inv_mats, int height, int width,
    const int32_t* node_ys, int n_ys, const int32_t* node_xs, int n_xs,
    float* out_y, float* out_x, uint8_t* covered) {
    const int cell_cols = lat_cols - 1;
    const int n_cells = (lat_rows - 1) * cell_cols;
    for (int c = 0; c < n_cells; ++c) {
        const int64_t* up = lattice + ((size_t)(c / cell_cols) * lat_cols
                                       + c % cell_cols) * 2;
        const int64_t* down = up + (size_t)lat_cols * 2;
        const double quad[8] = {
            (double)up[0], (double)up[1], (double)up[2], (double)up[3],
            (double)down[2], (double)down[3], (double)down[0],
            (double)down[1],
        };
        // The cell's clipped bounding box and its nodes, as
        // vg_lattice_node_maps finds them.
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
        int iy0 = (int)(std::lower_bound(node_ys, node_ys + n_ys, (int32_t)y0)
                        - node_ys);
        int ix0 = (int)(std::lower_bound(node_xs, node_xs + n_xs, (int32_t)x0)
                        - node_xs);
        if (iy0 >= n_ys || ix0 >= n_xs) continue;
        if (node_ys[iy0] > y1 || node_xs[ix0] > x1) continue;

        // vg_fill_poly's vertices on the cell's local raster, whose origin
        // is (x0, y0) and which holds every node tested below: the
        // clipping of its rows and spans to the raster leaves them alone.
        double vx[4], vy[4];
        for (int i = 0; i < 4; ++i) {
            vx[i] = (double)round_even(quad[2 * i] - (double)x0);
            vy[i] = (double)round_even(quad[2 * i + 1] - (double)y0);
        }

        const double* m = inv_mats + (size_t)c * 9;
        for (int iy = iy0; iy < n_ys && node_ys[iy] <= y1; ++iy) {
            const long long dy = node_ys[iy];
            const long long ly = dy - y0;
            // The row's edge crossings: half-open [lo, hi) rule, sorted.
            // (A row outside the vertices' rows crosses no edge.)
            double row_xs[4];
            int n_cross = 0;
            const double yd = (double)ly;
            for (int i = 0; i < 4; ++i) {
                int j = (i + 1) % 4;
                double ey0 = vy[i], ey1 = vy[j];
                if (ey0 == ey1) continue;
                double lo = ey0 < ey1 ? ey0 : ey1;
                double hi = ey0 < ey1 ? ey1 : ey0;
                if (yd >= lo && yd < hi) {
                    double t = (yd - ey0) / (ey1 - ey0);
                    row_xs[n_cross++] = vx[i] + t * (vx[j] - vx[i]);
                }
            }
            std::sort(row_xs, row_xs + n_cross);
            for (int ix = ix0; ix < n_xs && node_xs[ix] <= x1; ++ix) {
                const long long dx = node_xs[ix];
                const long long lx = dx - x0;
                bool hit = false;
                for (int k = 0; k + 1 < n_cross && !hit; k += 2) {
                    hit = (long long)std::ceil(row_xs[k]) <= lx
                        && lx <= (long long)std::floor(row_xs[k + 1]);
                }
                for (int i = 0; i < 4 && !hit; ++i) {
                    int j = (i + 1) % 4;
                    hit = on_outline((long long)vx[i], (long long)vy[i],
                                     (long long)vx[j], (long long)vy[j],
                                     lx, ly);
                }
                if (!hit) continue;
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

// np.interp(x, xp, fp) with its default left and right values (fp[0],
// fp[n - 1]): x and xp strictly increasing, n >= 2.
void interp(const double* x, int n_x, const double* xp, const double* fp,
            int n, double* out) {
    int j = 0;
    for (int i = 0; i < n_x; ++i) {
        const double xv = x[i];
        if (xv > xp[n - 1]) {
            out[i] = fp[n - 1];
        } else if (xv < xp[0]) {
            out[i] = fp[0];
        } else {
            while (j + 1 < n && xp[j + 1] <= xv) ++j;
            if (j == n - 1 || xp[j] == xv) {
                out[i] = fp[j];
            } else {
                const double slope = (fp[j + 1] - fp[j]) / (xp[j + 1] - xp[j]);
                double r = slope * (xv - xp[j]) + fp[j];
                if (std::isnan(r)) {
                    r = slope * (xv - xp[j + 1]) + fp[j + 1];
                    if (std::isnan(r) && fp[j] == fp[j + 1]) r = fp[j];
                }
                out[i] = r;
            }
        }
    }
}

struct RepairScratch {
    std::vector<int> rows, first, last, count;
    std::vector<double> xp, fp, out, sy_t, sx_t, sy_b, sx_b;
};

// _repair_node_maps in place on (rows, cols) float64 node maps: gap rows
// by np.interp, then the LOCAL-slope extension of partial rows, then of
// the top and bottom rows, then uncovered interior rows from the nearest
// covered row (ties to the earlier one, as np.argmin).
void repair_nodes(double* cy, double* cx, const uint8_t* cov,
                  int rows, int cols, const double* ys_f, const double* xs_f,
                  RepairScratch& s) {
    s.rows.clear(); s.first.clear(); s.last.clear(); s.count.clear();
    for (int r = 0; r < rows; ++r) {
        const uint8_t* c = cov + (size_t)r * cols;
        int first = -1, last = -1, count = 0;
        for (int x = 0; x < cols; ++x) {
            if (c[x]) {
                if (first < 0) first = x;
                last = x;
                ++count;
            }
        }
        if (count) {
            s.rows.push_back(r);
            s.first.push_back(first);
            s.last.push_back(last);
            s.count.push_back(count);
        }
    }
    const int n_cov = (int)s.rows.size();
    if (n_cov == 0) return;

    s.xp.resize(cols); s.fp.resize(cols); s.out.resize(cols);
    for (int i = 0; i < n_cov; ++i) {
        if (s.count[i] == s.last[i] - s.first[i] + 1) continue;
        const int r = s.rows[i];
        const uint8_t* c = cov + (size_t)r * cols;
        for (double* row : {cx + (size_t)r * cols, cy + (size_t)r * cols}) {
            int n = 0;
            for (int x = 0; x < cols; ++x) {
                if (!c[x]) continue;
                s.xp[n] = xs_f[x];
                s.fp[n] = row[x];
                ++n;
            }
            interp(xs_f, cols, s.xp.data(), s.fp.data(), n, s.out.data());
            std::memcpy(row, s.out.data(), sizeof(double) * cols);
        }
    }

    for (int i = 0; i < n_cov; ++i) {
        const int pf = s.first[i], pl = s.last[i];
        if (!(pf > 0 || pl < cols - 1)) continue;
        double* rx = cx + (size_t)s.rows[i] * cols;
        double* ry = cy + (size_t)s.rows[i] * cols;
        const int f1 = std::min(pf + 1, pl);
        const int l1 = std::max(pl - 1, pf);
        const double gl = std::max(xs_f[f1] - xs_f[pf], 1.0);
        const double gr = std::max(xs_f[pl] - xs_f[l1], 1.0);
        double sxl = (rx[f1] - rx[pf]) / gl;
        double syl = (ry[f1] - ry[pf]) / gl;
        double sxr = (rx[pl] - rx[l1]) / gr;
        double syr = (ry[pl] - ry[l1]) / gr;
        if (pl == pf) {
            sxl = sxr = 1.0;
            syl = syr = 0.0;
        }
        for (int x = 0; x < pf; ++x) {
            const double d = xs_f[x] - xs_f[pf];
            rx[x] = rx[pf] + d * sxl;
            ry[x] = ry[pf] + d * syl;
        }
        for (int x = pl + 1; x < cols; ++x) {
            const double d = xs_f[x] - xs_f[pl];
            rx[x] = rx[pl] + d * sxr;
            ry[x] = ry[pl] + d * syr;
        }
    }

    if (n_cov == rows) return;
    const int top = s.rows.front(), bottom = s.rows.back();
    const int t1 = std::min(top + 1, bottom);
    const int b1 = std::max(bottom - 1, top);
    const double gt = std::max(ys_f[t1] - ys_f[top], 1.0);
    const double gb = std::max(ys_f[bottom] - ys_f[b1], 1.0);
    s.sy_t.resize(cols); s.sx_t.resize(cols);
    s.sy_b.resize(cols); s.sx_b.resize(cols);
    for (int x = 0; x < cols; ++x) {
        if (bottom == top) {
            s.sy_t[x] = s.sy_b[x] = 1.0;
            s.sx_t[x] = s.sx_b[x] = 0.0;
            continue;
        }
        s.sy_t[x] = (cy[(size_t)t1 * cols + x] - cy[(size_t)top * cols + x])
            / gt;
        s.sx_t[x] = (cx[(size_t)t1 * cols + x] - cx[(size_t)top * cols + x])
            / gt;
        s.sy_b[x] = (cy[(size_t)bottom * cols + x]
                     - cy[(size_t)b1 * cols + x]) / gb;
        s.sx_b[x] = (cx[(size_t)bottom * cols + x]
                     - cx[(size_t)b1 * cols + x]) / gb;
    }
    auto extend_row = [&](int r, int r0, bool near_top) {
        const double d = ys_f[r] - ys_f[r0];
        const double* sy = near_top ? s.sy_t.data() : s.sy_b.data();
        const double* sx = near_top ? s.sx_t.data() : s.sx_b.data();
        double* ry = cy + (size_t)r * cols;
        double* rx = cx + (size_t)r * cols;
        const double* y0 = cy + (size_t)r0 * cols;
        const double* x0 = cx + (size_t)r0 * cols;
        for (int x = 0; x < cols; ++x) {
            ry[x] = y0[x] + d * sy[x];
            rx[x] = x0[x] + d * sx[x];
        }
    };
    for (int r = 0; r < top; ++r) extend_row(r, top, true);
    for (int r = bottom + 1; r < rows; ++r) extend_row(r, bottom, false);
    int k = 0;
    for (int r = top + 1; r < bottom; ++r) {
        while (k + 1 < n_cov && s.rows[k + 1] <= r) ++k;
        if (s.rows[k] == r) continue;
        int r0 = s.rows[k];
        if (k + 1 < n_cov && s.rows[k + 1] - r < r - r0) r0 = s.rows[k + 1];
        extend_row(r, r0, (r0 - top) <= (bottom - r0));
    }
}

}  // namespace

extern "C" {

// Coarse node maps of n_samples lattice plans in one pass: for sample s,
// its dst lattice lattices[s] ((lattice_shapes[2s], lattice_shapes[2s+1],
// 2) int64 xy), its cells' inverse homographies inv_mats[s] (one
// row-major 3x3 a cell, in the lattice's cell order) and its dst shape
// (dst_shapes[2s], dst_shapes[2s+1]); node_ys / node_xs: sorted int32
// node coordinates, shared.  Writes row out_rows[s] of out_y / out_x
// ((rows, n_ys, n_xs) float32): the node values, 0 where no cell covers a
// node, then, if repair, repaired.  covered: NULL, or (n_samples, n_ys,
// n_xs) uint8 that receives each sample's node coverage.
void vg_lattice_node_maps_batch(
    int n_samples,
    const int64_t* const* lattices, const int32_t* lattice_shapes,
    const double* const* inv_mats, const int32_t* dst_shapes,
    const int32_t* node_ys, int n_ys, const int32_t* node_xs, int n_xs,
    const int64_t* out_rows, int repair,
    float* out_y, float* out_x, uint8_t* covered) {
    const size_t plane = (size_t)n_ys * n_xs;
    std::vector<uint8_t> cov_buf(plane);
    std::vector<double> work_y(plane), work_x(plane);
    std::vector<double> ys_f(n_ys), xs_f(n_xs);
    for (int i = 0; i < n_ys; ++i) ys_f[i] = (double)node_ys[i];
    for (int i = 0; i < n_xs; ++i) xs_f[i] = (double)node_xs[i];
    RepairScratch scratch;
    for (int s = 0; s < n_samples; ++s) {
        float* oy = out_y + (size_t)out_rows[s] * plane;
        float* ox = out_x + (size_t)out_rows[s] * plane;
        uint8_t* cov = covered ? covered + (size_t)s * plane : cov_buf.data();
        std::fill(oy, oy + plane, 0.0f);
        std::fill(ox, ox + plane, 0.0f);
        std::memset(cov, 0, plane);
        lattice_nodes(lattices[s], lattice_shapes[2 * s],
                      lattice_shapes[2 * s + 1], inv_mats[s],
                      dst_shapes[2 * s], dst_shapes[2 * s + 1],
                      node_ys, n_ys, node_xs, n_xs, oy, ox, cov);
        if (!repair) continue;
        for (size_t i = 0; i < plane; ++i) {
            work_y[i] = (double)oy[i];
            work_x[i] = (double)ox[i];
        }
        repair_nodes(work_y.data(), work_x.data(), cov, n_ys, n_xs,
                     ys_f.data(), xs_f.data(), scratch);
        for (size_t i = 0; i < plane; ++i) {
            oy[i] = (float)work_y[i];
            ox[i] = (float)work_x[i];
        }
    }
}

}  // extern "C"
