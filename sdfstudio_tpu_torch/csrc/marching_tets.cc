// Marching tetrahedra for the port's mesh extraction: the port's own copy of
// sst_marching_tets and sst_free from native/sst_native.cc:30-254 (the same
// tables, edge-keyed vertex dedup and output), so the port and the JAX
// package extract the same mesh from the same grid. Host code, built by g++
// into a plain-C shared library and bound with ctypes
// (sdfstudio_tpu_torch/utils/host_build.py). Buffers returned to Python are
// malloc'ed here and released with sst_free.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

void sst_free(void *p) { free(p); }

// 6-tet decomposition of the cube around the 0-7 main diagonal (one tet per
// edge path 0 -> a -> b -> 7); matching face diagonals lie on opposite cube
// faces, so neighbouring cubes and blocks tile without cracks.
static const int TETS[6][4] = {
    {0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
    {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7},
};
// cube corner c sits at (c&1, (c>>1)&1, (c>>2)&1)
static const int TET_EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
// case -> up to 2 triangles of tet-edge ids (-1 padded); bit i set = v_i < level
static const int TET_TRIS[16][2][3] = {
    {{-1, -1, -1}, {-1, -1, -1}},  // 0
    {{0, 1, 2}, {-1, -1, -1}},     // 1
    {{0, 4, 3}, {-1, -1, -1}},     // 2
    {{1, 4, 3}, {1, 2, 4}},        // 3
    {{1, 3, 5}, {-1, -1, -1}},     // 4
    {{0, 3, 5}, {0, 5, 2}},        // 5
    {{0, 4, 5}, {0, 5, 1}},        // 6
    {{2, 4, 5}, {-1, -1, -1}},     // 7
    {{2, 5, 4}, {-1, -1, -1}},     // 8
    {{0, 1, 5}, {0, 5, 4}},        // 9
    {{0, 5, 3}, {0, 2, 5}},        // 10
    {{1, 5, 3}, {-1, -1, -1}},     // 11
    {{1, 3, 4}, {1, 4, 2}},        // 12
    {{0, 3, 4}, {-1, -1, -1}},     // 13
    {{0, 2, 1}, {-1, -1, -1}},     // 14
    {{-1, -1, -1}, {-1, -1, -1}},  // 15
};

struct PairHash {
    size_t operator()(uint64_t k) const {
        // splitmix64
        k += 0x9e3779b97f4a7c15ULL;
        k = (k ^ (k >> 30)) * 0xbf58476d1ce4e5b9ULL;
        k = (k ^ (k >> 27)) * 0x94d049bb133111ebULL;
        return (size_t)(k ^ (k >> 31));
    }
};

// grid: [nx, ny, nz] C-order float32. Outputs malloc'ed verts [nv,3] f32 and
// faces [nf,3] int64.
int sst_marching_tets(const float *grid, int64_t nx, int64_t ny, int64_t nz,
                      float level, const float *origin, const float *spacing,
                      float **out_verts, int64_t *out_nv, int64_t **out_faces,
                      int64_t *out_nf) {
    *out_verts = nullptr;
    *out_faces = nullptr;
    *out_nv = 0;
    *out_nf = 0;
    if (nx < 2 || ny < 2 || nz < 2) return 0;

    std::vector<float> verts;
    std::vector<int64_t> faces;
    // edge key (packed global corner ids) -> vertex index
    std::unordered_map<uint64_t, int32_t, PairHash> edge_vert;
    edge_vert.reserve(1 << 16);

    const int64_t syz = ny * nz;
    auto gid = [&](int64_t x, int64_t y, int64_t z) { return x * syz + y * nz + z; };

    float cvals[8];
    int64_t cids[8];
    float cpos[8][3];

    for (int64_t x = 0; x + 1 < nx; ++x) {
        for (int64_t y = 0; y + 1 < ny; ++y) {
            const float *col0 = grid + x * syz + y * nz;
            const float *col1 = grid + x * syz + (y + 1) * nz;
            const float *col2 = grid + (x + 1) * syz + y * nz;
            const float *col3 = grid + (x + 1) * syz + (y + 1) * nz;
            for (int64_t z = 0; z + 1 < nz; ++z) {
                // corner order: bit0=x, bit1=y, bit2=z
                cvals[0] = col0[z];
                cvals[1] = col2[z];
                cvals[2] = col1[z];
                cvals[3] = col3[z];
                cvals[4] = col0[z + 1];
                cvals[5] = col2[z + 1];
                cvals[6] = col1[z + 1];
                cvals[7] = col3[z + 1];
                float vmin = cvals[0], vmax = cvals[0];
                for (int c = 1; c < 8; ++c) {
                    vmin = std::min(vmin, cvals[c]);
                    vmax = std::max(vmax, cvals[c]);
                }
                if (!(vmin < level && vmax >= level)) continue;

                for (int c = 0; c < 8; ++c) {
                    int64_t cx = x + (c & 1), cy = y + ((c >> 1) & 1), cz = z + ((c >> 2) & 1);
                    cids[c] = gid(cx, cy, cz);
                    cpos[c][0] = (float)cx;
                    cpos[c][1] = (float)cy;
                    cpos[c][2] = (float)cz;
                }

                for (int t = 0; t < 6; ++t) {
                    const int *tet = TETS[t];
                    int tcase = 0;
                    for (int v = 0; v < 4; ++v)
                        if (cvals[tet[v]] < level) tcase |= 1 << v;
                    if (tcase == 0 || tcase == 15) continue;

                    // vertex index on each of the 6 tet edges (lazily created)
                    int32_t ev[6];
                    for (int e = 0; e < 6; ++e) ev[e] = -1;
                    for (int k = 0; k < 2; ++k) {
                        const int *tri = TET_TRIS[tcase][k];
                        if (tri[0] < 0) continue;
                        int32_t idx[3];
                        for (int j = 0; j < 3; ++j) {
                            int e = tri[j];
                            if (ev[e] < 0) {
                                int a = tet[TET_EDGES[e][0]], b = tet[TET_EDGES[e][1]];
                                int64_t ga = cids[a], gb = cids[b];
                                uint64_t key = ga < gb
                                                   ? ((uint64_t)ga << 32) | (uint64_t)gb
                                                   : ((uint64_t)gb << 32) | (uint64_t)ga;
                                auto it = edge_vert.find(key);
                                if (it != edge_vert.end()) {
                                    ev[e] = it->second;
                                } else {
                                    float va = cvals[a], vb = cvals[b];
                                    float denom = vb - va;
                                    float tt = std::fabs(denom) > 1e-12f
                                                   ? (level - va) / denom
                                                   : 0.5f;
                                    tt = std::min(1.0f, std::max(0.0f, tt));
                                    int32_t vi = (int32_t)(verts.size() / 3);
                                    for (int d = 0; d < 3; ++d) {
                                        float p = cpos[a][d] + tt * (cpos[b][d] - cpos[a][d]);
                                        verts.push_back(p * spacing[d] + origin[d]);
                                    }
                                    edge_vert.emplace(key, vi);
                                    ev[e] = vi;
                                }
                            }
                            idx[j] = ev[e];
                        }
                        // drop degenerate (two edge crossings merged) triangles
                        if (idx[0] == idx[1] || idx[1] == idx[2] || idx[0] == idx[2]) continue;
                        faces.push_back(idx[0]);
                        faces.push_back(idx[1]);
                        faces.push_back(idx[2]);
                    }
                }
            }
        }
    }

    *out_nv = (int64_t)(verts.size() / 3);
    *out_nf = (int64_t)(faces.size() / 3);
    if (*out_nv) {
        *out_verts = (float *)malloc(verts.size() * sizeof(float));
        memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
    }
    if (*out_nf) {
        *out_faces = (int64_t *)malloc(faces.size() * sizeof(int64_t));
        memcpy(*out_faces, faces.data(), faces.size() * sizeof(int64_t));
    }
    return 0;
}

}  // extern "C"
