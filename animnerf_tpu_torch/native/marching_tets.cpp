// Isosurface extraction via marching tetrahedra.
//
// The port's copy of the JAX package's native/marching_tets.cpp (the
// replacement of the reference's PyMCubes dependency), built into the
// port's host library by animnerf_tpu_torch/utils/host_lib.py. Each grid
// cube is split into 6 tetrahedra; each tetrahedron contributes 0-2
// triangles where the scalar field crosses the isovalue, with vertices
// linearly interpolated along crossing edges. Equivalent isosurface to
// marching cubes (slightly denser triangulation), but needs no 256-entry
// case tables, so the whole kernel is self-contained and auditable.
//
// C ABI (ctypes):
//   int mt_run(const float* field, int nx, int ny, int nz, float iso,
//              float** out_verts, long long* out_nverts,
//              int** out_tris,   long long* out_ntris);
//   void mt_free(void* p);
//
// Vertices are emitted in grid-index coordinates (i, j, k) like PyMCubes,
// so the caller applies the same grid->world mapping the reference uses
// (cli/extract_mesh.py::grid_to_world). Shared vertices are merged via an
// edge-key hash so the mesh is watertight.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};

// The 6-tetrahedra decomposition of a cube (corner indices 0..7, where
// corner c = (i + (c&1), j + ((c>>1)&1), k + ((c>>2)&1))).
static const int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 3, 6}, {0, 3, 2, 6},
    {0, 2, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

inline uint64_t edge_key(uint32_t a, uint32_t b) {
    if (a > b) std::swap(a, b);
    return (static_cast<uint64_t>(a) << 32) | b;
}

}  // namespace

extern "C" {

int mt_run(const float* field, int nx, int ny, int nz, float iso,
           float** out_verts, long long* out_nverts,
           int** out_tris, long long* out_ntris) {
    if (!field || nx < 2 || ny < 2 || nz < 2) return -1;

    const int64_t sy = nz;          // stride of j in the (nx, ny, nz) array
    const int64_t sx = (int64_t)ny * nz;  // stride of i

    std::vector<float> verts;
    std::vector<int> tris;
    std::unordered_map<uint64_t, int> edge_to_vert;
    verts.reserve(1 << 16);
    tris.reserve(1 << 16);
    edge_to_vert.reserve(1 << 16);

    auto corner_pos = [&](int i, int j, int k, int c, int* p) {
        p[0] = i + (c & 1);
        p[1] = j + ((c >> 1) & 1);
        p[2] = k + ((c >> 2) & 1);
    };

    auto vert_on_edge = [&](const int* pa, const int* pb, float va,
                            float vb) -> int {
        uint32_t ia = (uint32_t)(pa[0] * sx + pa[1] * sy + pa[2]);
        uint32_t ib = (uint32_t)(pb[0] * sx + pb[1] * sy + pb[2]);
        uint64_t key = edge_key(ia, ib);
        auto it = edge_to_vert.find(key);
        if (it != edge_to_vert.end()) return it->second;
        float denom = vb - va;
        float t = denom != 0.0f ? (iso - va) / denom : 0.5f;
        if (t < 0.0f) t = 0.0f;
        if (t > 1.0f) t = 1.0f;
        int id = (int)(verts.size() / 3);
        verts.push_back(pa[0] + t * (pb[0] - pa[0]));
        verts.push_back(pa[1] + t * (pb[1] - pa[1]));
        verts.push_back(pa[2] + t * (pb[2] - pa[2]));
        edge_to_vert.emplace(key, id);
        return id;
    };

    int pos[4][3];
    float val[4];

    for (int i = 0; i < nx - 1; ++i) {
        for (int j = 0; j < ny - 1; ++j) {
            const float* base = field + i * sx + j * sy;
            for (int k = 0; k < nz - 1; ++k) {
                // quick reject: all 8 corners on one side
                float c000 = base[k], c100 = base[sx + k];
                float c010 = base[sy + k], c110 = base[sx + sy + k];
                float c001 = base[k + 1], c101 = base[sx + k + 1];
                float c011 = base[sy + k + 1], c111 = base[sx + sy + k + 1];
                float cv[8] = {c000, c100, c010, c110,
                               c001, c101, c011, c111};
                bool any_lo = false, any_hi = false;
                for (float v : cv) {
                    any_lo |= (v < iso);
                    any_hi |= (v >= iso);
                }
                if (!any_lo || !any_hi) continue;

                for (const auto& tet : kTets) {
                    int mask = 0;
                    for (int t = 0; t < 4; ++t) {
                        corner_pos(i, j, k, tet[t], pos[t]);
                        val[t] = cv[tet[t]];
                        if (val[t] < iso) mask |= (1 << t);
                    }
                    if (mask == 0 || mask == 15) continue;

                    // indices of inside (below iso) and outside corners
                    int in[4], out[4], ni = 0, no = 0;
                    for (int t = 0; t < 4; ++t) {
                        if (mask & (1 << t)) in[ni++] = t;
                        else out[no++] = t;
                    }

                    if (ni == 1) {  // one tri, oriented away from inside
                        int a = vert_on_edge(pos[in[0]], pos[out[0]],
                                             val[in[0]], val[out[0]]);
                        int b = vert_on_edge(pos[in[0]], pos[out[1]],
                                             val[in[0]], val[out[1]]);
                        int c = vert_on_edge(pos[in[0]], pos[out[2]],
                                             val[in[0]], val[out[2]]);
                        tris.push_back(a); tris.push_back(b); tris.push_back(c);
                    } else if (ni == 3) {
                        int a = vert_on_edge(pos[out[0]], pos[in[0]],
                                             val[out[0]], val[in[0]]);
                        int b = vert_on_edge(pos[out[0]], pos[in[1]],
                                             val[out[0]], val[in[1]]);
                        int c = vert_on_edge(pos[out[0]], pos[in[2]],
                                             val[out[0]], val[in[2]]);
                        tris.push_back(a); tris.push_back(c); tris.push_back(b);
                    } else {  // ni == 2: quad -> two tris
                        int a = vert_on_edge(pos[in[0]], pos[out[0]],
                                             val[in[0]], val[out[0]]);
                        int b = vert_on_edge(pos[in[0]], pos[out[1]],
                                             val[in[0]], val[out[1]]);
                        int c = vert_on_edge(pos[in[1]], pos[out[1]],
                                             val[in[1]], val[out[1]]);
                        int d = vert_on_edge(pos[in[1]], pos[out[0]],
                                             val[in[1]], val[out[0]]);
                        tris.push_back(a); tris.push_back(b); tris.push_back(c);
                        tris.push_back(a); tris.push_back(c); tris.push_back(d);
                    }
                }
            }
        }
    }

    *out_nverts = (long long)(verts.size() / 3);
    *out_ntris = (long long)(tris.size() / 3);
    float* vbuf = (float*)std::malloc(verts.size() * sizeof(float));
    int* tbuf = (int*)std::malloc(tris.size() * sizeof(int));
    if ((!vbuf && !verts.empty()) || (!tbuf && !tris.empty())) {
        std::free(vbuf);
        std::free(tbuf);
        return -2;
    }
    if (!verts.empty()) std::memcpy(vbuf, verts.data(), verts.size() * sizeof(float));
    if (!tris.empty()) std::memcpy(tbuf, tris.data(), tris.size() * sizeof(int));
    *out_verts = vbuf;
    *out_tris = tbuf;
    return 0;
}

void mt_free(void* p) { std::free(p); }

}  // extern "C"
