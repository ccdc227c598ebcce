// Exact mesh-level collision oracle.
//
// Native ground-truth checker replacing the reference's MATLAB
// SurfaceIntersection mesh test (`simulator/utility/geometry/
// SurfaceIntersection.m`, used by `arm_world_static.m:246-264` for post-hoc
// collision validation).  The robot link meshes (triangles in link frame)
// are tested against axis-aligned box obstacles after being posed by the
// forward-kinematics rotations/translations computed on device.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).  The hot loop
// is the Akenine-Moller triangle/AABB separating-axis test, OpenMP-parallel
// over (config x link).
//
// Built at first use by armour_tpu_torch/collision/mesh_oracle.py
// (g++ -O3 -fopenmp -shared -fPIC) into armour_tpu_torch/build/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    double x, y, z;
};

inline Vec3 sub(const Vec3& a, const Vec3& b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline Vec3 cross(const Vec3& a, const Vec3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(const Vec3& a, const Vec3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

inline void minmax3(double a, double b, double c, double& mn, double& mx) {
    mn = a < b ? (a < c ? a : c) : (b < c ? b : c);
    mx = a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// Akenine-Moller triangle vs centered AABB (half extents h)
bool tri_aabb_overlap(const Vec3& v0, const Vec3& v1, const Vec3& v2, const Vec3& h) {
    // 1. AABB face normals
    double mn, mx;
    minmax3(v0.x, v1.x, v2.x, mn, mx);
    if (mn > h.x || mx < -h.x) return false;
    minmax3(v0.y, v1.y, v2.y, mn, mx);
    if (mn > h.y || mx < -h.y) return false;
    minmax3(v0.z, v1.z, v2.z, mn, mx);
    if (mn > h.z || mx < -h.z) return false;

    // 2. triangle plane
    Vec3 e0 = sub(v1, v0), e1 = sub(v2, v1), e2 = sub(v0, v2);
    Vec3 n = cross(e0, e1);
    double d = dot(n, v0);
    double r = h.x * std::fabs(n.x) + h.y * std::fabs(n.y) + h.z * std::fabs(n.z);
    if (std::fabs(d) > r) return false;

    // 3. nine cross-product axes
    const Vec3* edges[3] = {&e0, &e1, &e2};
    const Vec3* verts[3] = {&v0, &v1, &v2};
    for (int i = 0; i < 3; i++) {
        const Vec3& e = *edges[i];
        // axis = cross(x-axis, e) etc.
        const double axes[3][3] = {
            {0.0, -e.z, e.y},
            {e.z, 0.0, -e.x},
            {-e.y, e.x, 0.0},
        };
        for (int a = 0; a < 3; a++) {
            Vec3 ax = {axes[a][0], axes[a][1], axes[a][2]};
            double p0 = dot(ax, *verts[0]);
            double p1 = dot(ax, *verts[1]);
            double p2 = dot(ax, *verts[2]);
            double pmin, pmax;
            minmax3(p0, p1, p2, pmin, pmax);
            double rr = h.x * std::fabs(ax.x) + h.y * std::fabs(ax.y) + h.z * std::fabs(ax.z);
            if (pmin > rr || pmax < -rr) return false;
        }
    }
    return true;
}

struct Mesh {
    std::vector<Vec3> verts;  // 3 per triangle
    Vec3 bb_c{0, 0, 0};       // local-frame bounding box (broad phase)
    Vec3 bb_h{0, 0, 0};
};

std::vector<Mesh> g_meshes;

// Broad phase: exact OBB (link bbox posed by R) vs centered AABB SAT over
// the 15 candidate axes.  Real STL link meshes run ~10k triangles; without
// this pre-filter every (config x link x obstacle) would stream them all.
bool obb_aabb_overlap(const double* R, const Vec3& c, const Vec3& hb, const Vec3& ha) {
    // world axes (AABB face normals)
    for (int a = 0; a < 3; a++) {
        double d = a == 0 ? c.x : (a == 1 ? c.y : c.z);
        double rb = std::fabs(R[a * 3 + 0]) * hb.x + std::fabs(R[a * 3 + 1]) * hb.y +
                    std::fabs(R[a * 3 + 2]) * hb.z;
        double ra = a == 0 ? ha.x : (a == 1 ? ha.y : ha.z);
        if (std::fabs(d) > rb + ra) return false;
    }
    // OBB axes
    for (int a = 0; a < 3; a++) {
        Vec3 ax = {R[0 * 3 + a], R[1 * 3 + a], R[2 * 3 + a]};
        double d = dot(ax, c);
        double rb = a == 0 ? hb.x : (a == 1 ? hb.y : hb.z);
        double ra = ha.x * std::fabs(ax.x) + ha.y * std::fabs(ax.y) + ha.z * std::fabs(ax.z);
        if (std::fabs(d) > rb + ra) return false;
    }
    // 9 cross products world_i x obb_j
    for (int i = 0; i < 3; i++) {
        Vec3 wi = {i == 0 ? 1.0 : 0.0, i == 1 ? 1.0 : 0.0, i == 2 ? 1.0 : 0.0};
        for (int j = 0; j < 3; j++) {
            Vec3 oj = {R[0 * 3 + j], R[1 * 3 + j], R[2 * 3 + j]};
            Vec3 ax = cross(wi, oj);
            double n = std::sqrt(dot(ax, ax));
            if (n < 1e-12) continue;
            double d = std::fabs(dot(ax, c));
            double ra = ha.x * std::fabs(ax.x) + ha.y * std::fabs(ax.y) + ha.z * std::fabs(ax.z);
            Vec3 axl = {dot(ax, {R[0], R[3], R[6]}), dot(ax, {R[1], R[4], R[7]}),
                        dot(ax, {R[2], R[5], R[8]})};
            double rb = hb.x * std::fabs(axl.x) + hb.y * std::fabs(axl.y) + hb.z * std::fabs(axl.z);
            if (d > ra + rb) return false;
        }
    }
    return true;
}

}  // namespace

extern "C" {

// Register link meshes: for each of n_links, tri_counts[i] triangles with 9
// doubles each (v0 v1 v2), concatenated in `tris`.
void mesh_oracle_set_meshes(int n_links, const int64_t* tri_counts, const double* tris) {
    g_meshes.assign(n_links, Mesh{});
    const double* p = tris;
    for (int i = 0; i < n_links; i++) {
        g_meshes[i].verts.resize(tri_counts[i] * 3);
        Vec3 mn = {1e30, 1e30, 1e30}, mx = {-1e30, -1e30, -1e30};
        for (int64_t t = 0; t < tri_counts[i] * 3; t++) {
            Vec3 v = {p[0], p[1], p[2]};
            g_meshes[i].verts[t] = v;
            mn = {v.x < mn.x ? v.x : mn.x, v.y < mn.y ? v.y : mn.y, v.z < mn.z ? v.z : mn.z};
            mx = {v.x > mx.x ? v.x : mx.x, v.y > mx.y ? v.y : mx.y, v.z > mx.z ? v.z : mx.z};
            p += 3;
        }
        g_meshes[i].bb_c = {(mn.x + mx.x) / 2, (mn.y + mx.y) / 2, (mn.z + mx.z) / 2};
        g_meshes[i].bb_h = {(mx.x - mn.x) / 2, (mx.y - mn.y) / 2, (mx.z - mn.z) / 2};
    }
}

// Check n_cfg configurations:
//   R:   (n_cfg, n_links, 3, 3) row-major world rotations
//   pos: (n_cfg, n_links, 3) world positions
//   obs: (n_obs, 6) = center xyz, half extents xyz
// out: (n_cfg,) uint8, 1 if any link mesh intersects any obstacle
void mesh_oracle_check(int64_t n_cfg, int n_links, const double* R, const double* pos,
                       int n_obs, const double* obs, uint8_t* out) {
#pragma omp parallel for schedule(dynamic)
    for (int64_t c = 0; c < n_cfg; c++) {
        uint8_t hit = 0;
        for (int l = 0; l < n_links && !hit; l++) {
            const double* Rc = R + ((c * n_links) + l) * 9;
            const double* pc = pos + ((c * n_links) + l) * 3;
            const Mesh& m = g_meshes[l];
            for (int o = 0; o < n_obs && !hit; o++) {
                const double* ob = obs + o * 6;
                Vec3 h = {ob[3], ob[4], ob[5]};
                // broad phase: posed link bounding box vs obstacle
                Vec3 bc = {
                    Rc[0] * m.bb_c.x + Rc[1] * m.bb_c.y + Rc[2] * m.bb_c.z + pc[0] - ob[0],
                    Rc[3] * m.bb_c.x + Rc[4] * m.bb_c.y + Rc[5] * m.bb_c.z + pc[1] - ob[1],
                    Rc[6] * m.bb_c.x + Rc[7] * m.bb_c.y + Rc[8] * m.bb_c.z + pc[2] - ob[2],
                };
                if (!obb_aabb_overlap(Rc, bc, m.bb_h, h)) continue;
                for (size_t t = 0; t + 2 < m.verts.size(); t += 3) {
                    Vec3 w[3];
                    for (int v = 0; v < 3; v++) {
                        const Vec3& lv = m.verts[t + v];
                        w[v] = {
                            Rc[0] * lv.x + Rc[1] * lv.y + Rc[2] * lv.z + pc[0] - ob[0],
                            Rc[3] * lv.x + Rc[4] * lv.y + Rc[5] * lv.z + pc[1] - ob[1],
                            Rc[6] * lv.x + Rc[7] * lv.y + Rc[8] * lv.z + pc[2] - ob[2],
                        };
                    }
                    if (tri_aabb_overlap(w[0], w[1], w[2], h)) {
                        hit = 1;
                        break;
                    }
                }
            }
        }
        out[c] = hit;
    }
}

}  // extern "C"
