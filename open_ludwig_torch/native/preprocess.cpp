// Native host preprocessing of open_ludwig_torch: the port's own copy of
// open_ludwig_tpu/native/preprocess.cpp, built by native/__init__.py into
// build/native/.  One difference: the Bouzidi ray cast writes its maps over
// the geometry's reach only (bouzidi_box), not over the whole grid; every
// value it writes is the same.
//
// The reference does its host-side preprocessing with Julia @threads loops
// (reference: src/domain_generation.jl:81, src/bouzidi_setup.jl:100); here the
// two hot loops — SAT shell voxelization and Bouzidi ray casting — are plain
// C++ invoked through ctypes, with the vectorized numpy implementations as
// behavioural reference and fallback.
//
// Build: g++ -O3 -march=native -shared -fPIC -o build/native/libpreprocess_<hash>.so
//        open_ludwig_torch/native/preprocess.cpp
//
// Conventions match domain/voxelize.py and domain/bouzidi.py:
//   - cell centers at (g + 0.5) * dx, 0-based integer grids
//   - SAT box half-size 0.75*dx with 1.001 tolerance, 3 slab axes + 9 edge
//     cross axes (the triangle-normal axis is intentionally omitted, like the
//     reference's test)
//   - Bouzidi: Moller-Trumbore with eps 1e-9 along normalized directions,
//     q = t / (dx*|c|) in (0, 1], nearest hit per (cell, direction)

#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>

namespace {

struct V3 {
    double x, y, z;
};

inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// SAT triangle/AABB overlap: slab axes + 9 edge-cross axes, half size h.
bool sat_overlap(const V3 t[3], double h) {
    double minx = std::min({t[0].x, t[1].x, t[2].x});
    double maxx = std::max({t[0].x, t[1].x, t[2].x});
    if (minx > h || maxx < -h) return false;
    double miny = std::min({t[0].y, t[1].y, t[2].y});
    double maxy = std::max({t[0].y, t[1].y, t[2].y});
    if (miny > h || maxy < -h) return false;
    double minz = std::min({t[0].z, t[1].z, t[2].z});
    double maxz = std::max({t[0].z, t[1].z, t[2].z});
    if (minz > h || maxz < -h) return false;

    const V3 f[3] = {sub(t[1], t[0]), sub(t[2], t[1]), sub(t[0], t[2])};
    for (int j = 0; j < 3; ++j) {
        const V3 &e = f[j];
        const V3 axes[3] = {{0, -e.z, e.y}, {e.z, 0, -e.x}, {-e.y, e.x, 0}};
        for (int i = 0; i < 3; ++i) {
            const V3 &ax = axes[i];
            double len2 = dot(ax, ax);
            if (len2 < 1e-10) continue;
            double p0 = dot(t[0], ax), p1 = dot(t[1], ax), p2 = dot(t[2], ax);
            double r = h * (std::fabs(ax.x) + std::fabs(ax.y) + std::fabs(ax.z));
            double lo = std::min({p0, p1, p2}), hi = std::max({p0, p1, p2});
            if (lo > r || hi < -r) return false;
        }
    }
    return true;
}

// The cells a triangle's rays can reach: centers (g + 0.5) * dx within the
// triangle's box widened by reach, clipped to [clip_lo, clip_hi].  The box
// and the ray cast both take it from here, so they round alike.
inline void reach_cells(const double *v, double dx, double reach,
                        const int64_t clip_lo[3], const int64_t clip_hi[3],
                        int64_t lo[3], int64_t hi[3]) {
    for (int a = 0; a < 3; ++a) {
        double mn = std::min({v[a], v[3 + a], v[6 + a]}) - reach;
        double mx = std::max({v[a], v[3 + a], v[6 + a]}) + reach;
        lo[a] = (int64_t)std::floor(mn / dx - 0.5) + 1;
        hi[a] = (int64_t)std::floor(mx / dx - 0.5);
        lo[a] = std::max<int64_t>(lo[a], clip_lo[a]);
        hi[a] = std::min<int64_t>(hi[a], clip_hi[a]);
    }
}

inline double bouzidi_reach(double dx) { return dx * std::sqrt(3.0) * 1.0000001; }

}  // namespace

extern "C" {

// verts: (n_tri, 3, 3) float64 in domain coordinates; out: (X*Y*Z) uint8
void voxelize_sat(const double *verts, int64_t n_tri, double dx,
                  int64_t X, int64_t Y, int64_t Z, uint8_t *out) {
    const double h = 0.75 * dx * 1.001;
    for (int64_t t = 0; t < n_tri; ++t) {
        const double *v = verts + t * 9;
        V3 tri[3] = {{v[0], v[1], v[2]}, {v[3], v[4], v[5]}, {v[6], v[7], v[8]}};
        double mn[3], mx[3];
        for (int a = 0; a < 3; ++a) {
            double c0 = (&tri[0].x)[a], c1 = (&tri[1].x)[a], c2 = (&tri[2].x)[a];
            mn[a] = std::min({c0, c1, c2});
            mx[a] = std::max({c0, c1, c2});
        }
        // candidate cells: center (g+0.5)dx within [mn-h, mx+h]
        int64_t lo[3], hi[3], dims[3] = {X, Y, Z};
        for (int a = 0; a < 3; ++a) {
            lo[a] = (int64_t)std::floor((mn[a] - h) / dx - 0.5) + 1;
            hi[a] = (int64_t)std::floor((mx[a] + h) / dx - 0.5);
            lo[a] = std::max<int64_t>(lo[a], 0);
            hi[a] = std::min<int64_t>(hi[a], dims[a] - 1);
        }
        for (int64_t gx = lo[0]; gx <= hi[0]; ++gx)
            for (int64_t gy = lo[1]; gy <= hi[1]; ++gy)
                for (int64_t gz = lo[2]; gz <= hi[2]; ++gz) {
                    uint8_t *cell = out + (gx * Y + gy) * Z + gz;
                    if (*cell) continue;
                    V3 c = {(gx + 0.5) * dx, (gy + 0.5) * dx, (gz + 0.5) * dx};
                    V3 tt[3] = {sub(tri[0], c), sub(tri[1], c), sub(tri[2], c)};
                    if (sat_overlap(tt, h)) *cell = 1;
                }
    }
}

// The geometry's reach on an X x Y x Z grid: the union of the cells every
// triangle's rays can reach.  box_out: lower corner (3) then extent (3); an
// extent of 0 on every axis when no triangle reaches the grid.
void bouzidi_box(const double *verts, int64_t n_tri, double dx,
                 int64_t X, int64_t Y, int64_t Z, int64_t *box_out) {
    const double reach = bouzidi_reach(dx);
    const int64_t clip_lo[3] = {0, 0, 0}, clip_hi[3] = {X - 1, Y - 1, Z - 1};
    int64_t blo[3] = {X, Y, Z}, bhi[3] = {-1, -1, -1};
    for (int64_t t = 0; t < n_tri; ++t) {
        int64_t lo[3], hi[3];
        reach_cells(verts + t * 9, dx, reach, clip_lo, clip_hi, lo, hi);
        if (lo[0] > hi[0] || lo[1] > hi[1] || lo[2] > hi[2]) continue;
        for (int a = 0; a < 3; ++a) {
            blo[a] = std::min(blo[a], lo[a]);
            bhi[a] = std::max(bhi[a], hi[a]);
        }
    }
    const bool empty = bhi[0] < 0;
    for (int a = 0; a < 3; ++a) {
        box_out[a] = empty ? 0 : blo[a];
        box_out[3 + a] = empty ? 0 : bhi[a] - blo[a] + 1;
    }
}

// Bouzidi ray cast over a box of the grid (lower corner box[0:3], extent
// box[3:6], as bouzidi_box gives it).  verts as above; cell origins stay in
// the grid's coordinates; q_out: (EX*EY*EZ, 27) float32 initialized to 0;
// tri_out: (EX*EY*EZ, 27) int32 initialized to -1, both indexed in the box.
void bouzidi_raycast(const double *verts, int64_t n_tri, double dx,
                     const int64_t *box, float *q_out, int32_t *tri_out) {
    const double eps = 1e-9;
    const double reach = bouzidi_reach(dx);
    const int64_t clip_lo[3] = {box[0], box[1], box[2]};
    const int64_t clip_hi[3] = {box[0] + box[3] - 1, box[1] + box[4] - 1,
                                box[2] + box[5] - 1};
    const int64_t EY = box[4], EZ = box[5];
    // direction table, k = (cx+1) + 3(cy+1) + 9(cz+1)
    double dirs[27][3];
    double norms[27];
    for (int k = 0; k < 27; ++k) {
        int cx = k % 3 - 1, cy = (k / 3) % 3 - 1, cz = k / 9 - 1;
        double n = std::sqrt(double(cx * cx + cy * cy + cz * cz));
        norms[k] = n;
        if (n > 0) {
            dirs[k][0] = cx / n;
            dirs[k][1] = cy / n;
            dirs[k][2] = cz / n;
        } else {
            dirs[k][0] = dirs[k][1] = dirs[k][2] = 0;
        }
    }
    for (int64_t t = 0; t < n_tri; ++t) {
        const double *v = verts + t * 9;
        V3 v0 = {v[0], v[1], v[2]}, v1 = {v[3], v[4], v[5]}, v2 = {v[6], v[7], v[8]};
        V3 e1 = sub(v1, v0), e2 = sub(v2, v0);
        int64_t lo[3], hi[3];
        reach_cells(v, dx, reach, clip_lo, clip_hi, lo, hi);
        for (int64_t gx = lo[0]; gx <= hi[0]; ++gx)
            for (int64_t gy = lo[1]; gy <= hi[1]; ++gy)
                for (int64_t gz = lo[2]; gz <= hi[2]; ++gz) {
                    V3 o = {(gx + 0.5) * dx, (gy + 0.5) * dx, (gz + 0.5) * dx};
                    V3 s = sub(o, v0);
                    V3 qv = cross(s, e1);
                    int64_t cell = ((gx - box[0]) * EY + (gy - box[1])) * EZ + (gz - box[2]);
                    for (int k = 0; k < 27; ++k) {
                        if (k == 13) continue;
                        V3 d = {dirs[k][0], dirs[k][1], dirs[k][2]};
                        V3 hvec = cross(d, e2);
                        double a = dot(e1, hvec);
                        if (std::fabs(a) < eps) continue;
                        double fi = 1.0 / a;
                        double u = fi * dot(s, hvec);
                        if (u < 0.0 || u > 1.0) continue;
                        double vv = fi * dot(d, qv);
                        if (vv < 0.0 || u + vv > 1.0) continue;
                        double tt = fi * dot(e2, qv);
                        if (tt <= eps) continue;
                        double q = tt / (dx * norms[k]);
                        if (q <= 0.0 || q > 1.0) continue;
                        float *qc = q_out + cell * 27 + k;
                        if (*qc == 0.0f || q < *qc) {
                            *qc = (float)q;
                            tri_out[cell * 27 + k] = (int32_t)t;
                        }
                    }
                }
    }
}

}  // extern "C"
