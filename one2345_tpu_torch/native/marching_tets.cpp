// Native isosurface extraction (marching tetrahedra) for the mesh-export
// hot path — replaces the reference's PyMCubes C++ dependency
// (sparse_neus_renderer.py:932) with an in-tree implementation.
//
// Contract matches one2345_tpu/recon/mesh_extract.py::marching_tetrahedra:
// 6-tet decomposition around the 0-6 cube diagonal, vertices deduplicated
// per grid edge, triangles oriented along the field gradient.
//
// Build: see one2345_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};

// cube corners (same numbering as mesh_extract._CORNERS)
const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

// per-case triangle table; edges index pairs of tet vertices
// edge ids: 0:ab 1:ac 2:ad 3:bc 4:bd 5:cd
const int EDGE_V[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

struct TetCase {
    int n_tris;
    int tris[2][3];  // edge ids
};

const TetCase TET_TABLE[16] = {
    {0, {{0, 0, 0}, {0, 0, 0}}},                 // 0000
    {1, {{0, 1, 2}, {0, 0, 0}}},                 // a
    {1, {{0, 3, 4}, {0, 0, 0}}},                 // b
    {2, {{1, 2, 4}, {1, 4, 3}}},                 // ab
    {1, {{1, 3, 5}, {0, 0, 0}}},                 // c
    {2, {{0, 2, 5}, {0, 5, 3}}},                 // ac
    {2, {{0, 4, 5}, {0, 5, 1}}},                 // bc
    {1, {{2, 4, 5}, {0, 0, 0}}},                 // abc
    {1, {{2, 4, 5}, {0, 0, 0}}},                 // d
    {2, {{0, 1, 5}, {0, 5, 4}}},                 // ad
    {2, {{0, 3, 5}, {0, 5, 2}}},                 // bd
    {1, {{1, 3, 5}, {0, 0, 0}}},                 // abd
    {2, {{1, 3, 4}, {1, 4, 2}}},                 // cd
    {1, {{0, 3, 4}, {0, 0, 0}}},                 // acd
    {1, {{0, 1, 2}, {0, 0, 0}}},                 // bcd
    {0, {{0, 0, 0}, {0, 0, 0}}},                 // abcd
};

inline int64_t vid(int x, int y, int z, int Y, int Z) {
    return (static_cast<int64_t>(x) * Y + y) * Z + z;
}

}  // namespace

extern "C" {

// Shared implementation: extract triangles from the given cube set.
// `cubes`/`n_cubes` select cubes by linear id over the (X-1, Y-1, Z-1)
// cube lattice in C order (matching np.flatnonzero of the active mask);
// cubes == nullptr scans the full lattice.
static int marching_tets_impl(const float* field, int X, int Y, int Z,
                              float threshold, const int64_t* cubes,
                              int64_t n_cubes, float** out_verts,
                              int32_t** out_faces, int64_t* n_verts,
                              int64_t* n_faces) {
    auto F = [&](int x, int y, int z) -> float {
        return field[(static_cast<int64_t>(x) * Y + y) * Z + z];
    };

    std::unordered_map<uint64_t, int32_t> edge_map;
    std::vector<float> verts;
    std::vector<int32_t> faces;
    edge_map.reserve(1 << 16);

    auto edge_vertex = [&](int64_t ga, int64_t gb, float va, float vb) -> int32_t {
        int64_t lo = ga < gb ? ga : gb;
        int64_t hi = ga < gb ? gb : ga;
        uint64_t key =
            (static_cast<uint64_t>(lo) << 32) | static_cast<uint32_t>(hi);
        auto it = edge_map.find(key);
        if (it != edge_map.end()) return it->second;
        // unflatten
        auto unflat = [&](int64_t id, int* c) {
            c[2] = static_cast<int>(id % Z);
            c[1] = static_cast<int>((id / Z) % Y);
            c[0] = static_cast<int>(id / (static_cast<int64_t>(Y) * Z));
        };
        int ca[3], cb[3];
        unflat(lo, ca);
        unflat(hi, cb);
        float flo = F(ca[0], ca[1], ca[2]);
        float fhi = F(cb[0], cb[1], cb[2]);
        float d = fhi - flo;
        float t = std::fabs(d) < 1e-12f ? 0.5f : (threshold - flo) / d;
        t = t < 0.f ? 0.f : (t > 1.f ? 1.f : t);
        int32_t idx = static_cast<int32_t>(verts.size() / 3);
        verts.push_back(ca[0] + t * (cb[0] - ca[0]));
        verts.push_back(ca[1] + t * (cb[1] - ca[1]));
        verts.push_back(ca[2] + t * (cb[2] - ca[2]));
        edge_map.emplace(key, idx);
        return idx;
    };

    auto process_cube = [&](int x, int y, int z) {
        float cv[8];
        int64_t cid[8];
        int inside = 0;
        for (int c = 0; c < 8; ++c) {
            int cx = x + CORNERS[c][0];
            int cy = y + CORNERS[c][1];
            int cz = z + CORNERS[c][2];
            cv[c] = F(cx, cy, cz);
            cid[c] = vid(cx, cy, cz, Y, Z);
            if (cv[c] > threshold) ++inside;
        }
        if (inside == 0 || inside == 8) return;
        for (int t = 0; t < 6; ++t) {
            const int* tv = TETS[t];
            int code = 0;
            for (int k = 0; k < 4; ++k)
                if (cv[tv[k]] > threshold) code |= 1 << k;
            const TetCase& tc = TET_TABLE[code];
            for (int r = 0; r < tc.n_tris; ++r) {
                int32_t tri[3];
                bool degenerate = false;
                for (int e = 0; e < 3; ++e) {
                    int eid = tc.tris[r][e];
                    int a = tv[EDGE_V[eid][0]];
                    int b = tv[EDGE_V[eid][1]];
                    tri[e] = edge_vertex(cid[a], cid[b], cv[a], cv[b]);
                }
                if (tri[0] == tri[1] || tri[1] == tri[2] ||
                    tri[0] == tri[2])
                    degenerate = true;
                if (!degenerate) {
                    faces.push_back(tri[0]);
                    faces.push_back(tri[1]);
                    faces.push_back(tri[2]);
                }
            }
        }
    };

    if (cubes != nullptr) {
        const int64_t CY = Y - 1, CZ = Z - 1;
        for (int64_t i = 0; i < n_cubes; ++i) {
            int64_t id = cubes[i];
            int z = static_cast<int>(id % CZ);
            int y = static_cast<int>((id / CZ) % CY);
            int x = static_cast<int>(id / (CY * CZ));
            process_cube(x, y, z);
        }
    } else {
        for (int x = 0; x < X - 1; ++x)
            for (int y = 0; y < Y - 1; ++y)
                for (int z = 0; z < Z - 1; ++z) process_cube(x, y, z);
    }

    // orient triangles along the field gradient (outward for occupancy)
    int64_t nf = static_cast<int64_t>(faces.size() / 3);
    for (int64_t i = 0; i < nf; ++i) {
        int32_t* f3 = &faces[i * 3];
        const float* p0 = &verts[f3[0] * 3];
        const float* p1 = &verts[f3[1] * 3];
        const float* p2 = &verts[f3[2] * 3];
        float cx = (p0[0] + p1[0] + p2[0]) / 3.f;
        float cy = (p0[1] + p1[1] + p2[1]) / 3.f;
        float cz = (p0[2] + p1[2] + p2[2]) / 3.f;
        int ix = static_cast<int>(cx + 0.5f);
        int iy = static_cast<int>(cy + 0.5f);
        int iz = static_cast<int>(cz + 0.5f);
        ix = ix < 1 ? 1 : (ix > X - 2 ? X - 2 : ix);
        iy = iy < 1 ? 1 : (iy > Y - 2 ? Y - 2 : iy);
        iz = iz < 1 ? 1 : (iz > Z - 2 ? Z - 2 : iz);
        float gx = (F(ix + 1, iy, iz) - F(ix - 1, iy, iz)) * 0.5f;
        float gy = (F(ix, iy + 1, iz) - F(ix, iy - 1, iz)) * 0.5f;
        float gz = (F(ix, iy, iz + 1) - F(ix, iy, iz - 1)) * 0.5f;
        float e1x = p1[0] - p0[0], e1y = p1[1] - p0[1], e1z = p1[2] - p0[2];
        float e2x = p2[0] - p0[0], e2y = p2[1] - p0[1], e2z = p2[2] - p0[2];
        float nx = e1y * e2z - e1z * e2y;
        float ny = e1z * e2x - e1x * e2z;
        float nz = e1x * e2y - e1y * e2x;
        if (nx * gx + ny * gy + nz * gz < 0.f) {
            int32_t tmp = f3[1];
            f3[1] = f3[2];
            f3[2] = tmp;
        }
    }

    *n_verts = static_cast<int64_t>(verts.size() / 3);
    *n_faces = nf;
    *out_verts = static_cast<float*>(std::malloc(verts.size() * sizeof(float)));
    *out_faces =
        static_cast<int32_t*>(std::malloc(faces.size() * sizeof(int32_t)));
    if ((verts.size() && !*out_verts) || (faces.size() && !*out_faces)) {
        std::free(*out_verts);
        std::free(*out_faces);
        return 1;  // allocation failure -> caller falls back to numpy
    }
    if (verts.size())
        std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
    if (faces.size())
        std::memcpy(*out_faces, faces.data(), faces.size() * sizeof(int32_t));
    return 0;
}

// Returns 0 on success. Caller frees via free_mesh.
int marching_tetrahedra_cpp(const float* field, int X, int Y, int Z,
                            float threshold, float** out_verts,
                            int32_t** out_faces, int64_t* n_verts,
                            int64_t* n_faces) {
    return marching_tets_impl(field, X, Y, Z, threshold, nullptr, 0,
                              out_verts, out_faces, n_verts, n_faces);
}

// Sparse variant: only the listed cubes are visited (linear ids over the
// (X-1)x(Y-1)x(Z-1) cube lattice, C order).  The sparse field fetch
// already knows the sign-crossing cube set, so the full-lattice scan
// (16.6M cubes at 256^3 vs ~100-200k active) is skipped entirely.
int marching_tetrahedra_sparse_cpp(const float* field, int X, int Y, int Z,
                                   float threshold, const int64_t* cubes,
                                   int64_t n_cubes, float** out_verts,
                                   int32_t** out_faces, int64_t* n_verts,
                                   int64_t* n_faces) {
    return marching_tets_impl(field, X, Y, Z, threshold, cubes, n_cubes,
                              out_verts, out_faces, n_verts, n_faces);
}

void free_mesh(float* verts, int32_t* faces) {
    std::free(verts);
    std::free(faces);
}

// Sign-plane analysis for the sparse field fetch: unpack the little-endian
// packed sign bits into `inside` (R^3 bytes, caller-allocated) and emit
//   - active cube ids: cubes whose 8 corners disagree, linear over the
//     (R-1)^3 cube lattice in C order,
//   - needed voxel ids: every corner of an active cube, sorted ascending,
// exactly matching the numpy reference (unpackbits + 8-shift counting +
// flatnonzero) in recon/pipeline.py::_fetch_field_sparse.
int sign_plane_analyze_cpp(const uint8_t* bits, int R, uint8_t* inside,
                           int64_t** out_cubes, int64_t* n_cubes,
                           int64_t** out_needed, int64_t* n_needed) {
    const int64_t N = static_cast<int64_t>(R) * R * R;
    for (int64_t i = 0; i < N; ++i)
        inside[i] = (bits[i >> 3] >> (i & 7)) & 1;

    const int C = R - 1;
    std::vector<int64_t> cubes;
    std::vector<uint8_t> needed(N, 0);
    const int64_t RR = static_cast<int64_t>(R) * R;
    for (int x = 0; x < C; ++x) {
        const uint8_t* px = inside + static_cast<int64_t>(x) * RR;
        for (int y = 0; y < C; ++y) {
            const uint8_t* p00 = px + static_cast<int64_t>(y) * R;
            const uint8_t* p01 = p00 + R;        // y+1
            const uint8_t* p10 = p00 + RR;       // x+1
            const uint8_t* p11 = p10 + R;        // x+1, y+1
            for (int z = 0; z < C; ++z) {
                int s = p00[z] + p00[z + 1] + p01[z] + p01[z + 1] +
                        p10[z] + p10[z + 1] + p11[z] + p11[z + 1];
                if (s == 0 || s == 8) continue;
                cubes.push_back((static_cast<int64_t>(x) * C + y) * C + z);
                const int64_t base = static_cast<int64_t>(x) * RR +
                                     static_cast<int64_t>(y) * R + z;
                needed[base] = needed[base + 1] = 1;
                needed[base + R] = needed[base + R + 1] = 1;
                needed[base + RR] = needed[base + RR + 1] = 1;
                needed[base + RR + R] = needed[base + RR + R + 1] = 1;
            }
        }
    }
    std::vector<int64_t> nidx;
    nidx.reserve(cubes.size() * 4);
    for (int64_t i = 0; i < N; ++i)
        if (needed[i]) nidx.push_back(i);

    *n_cubes = static_cast<int64_t>(cubes.size());
    *n_needed = static_cast<int64_t>(nidx.size());
    *out_cubes =
        static_cast<int64_t*>(std::malloc(cubes.size() * sizeof(int64_t)));
    *out_needed =
        static_cast<int64_t*>(std::malloc(nidx.size() * sizeof(int64_t)));
    if ((cubes.size() && !*out_cubes) || (nidx.size() && !*out_needed)) {
        std::free(*out_cubes);
        std::free(*out_needed);
        return 1;  // allocation failure -> caller falls back to numpy
    }
    if (cubes.size())
        std::memcpy(*out_cubes, cubes.data(), cubes.size() * sizeof(int64_t));
    if (nidx.size())
        std::memcpy(*out_needed, nidx.data(), nidx.size() * sizeof(int64_t));
    return 0;
}

void free_idx(int64_t* a, int64_t* b) {
    std::free(a);
    std::free(b);
}

}  // extern "C"
