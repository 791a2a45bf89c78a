// Native mesh graph builder.
//
// The TPU-native runtime counterpart of the reference's DMPlex/PyOP2
// topology construction (SURVEY.md section 2.9): builds the facet tables
// (unique edges, side assignment, cell->facet maps) for large unstructured
// meshes in C++.  Exposed through a plain C ABI and loaded with ctypes
// (no pybind11 in this image); `mesh/mesh2d.py` uses it when available and
// falls back to the vectorised numpy path otherwise.
//
// Build:  cc -O3 -shared -fPIC -o libmeshbuild.so meshbuild.cpp
#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

extern "C" {

// Builds facet tables for a triangle mesh.
//
// Inputs:
//   nc          number of cells
//   nv          number of vertices
//   cells       (nc*3) vertex indices, CCW
// Outputs (caller-allocated, sized as noted; nf_out receives the facet
// count, facet arrays are filled up to nf <= 3*nc):
//   cell_facets (nc*3)  facet id of local facet k (edge opposite vertex k)
//   cell_sides  (nc*3)  0 if the cell is the facet's side-0 owner
//   facet_cells (3*nc*2)
//   facet_local (3*nc*2)
//   facet_verts (3*nc*2) side-0 traversal (a -> b)
//   facet_bnd   (3*nc)   1 if boundary facet
// Returns 0 on success.
int build_facets(int64_t nc, int64_t nv, const int32_t* cells,
                 int32_t* cell_facets, int32_t* cell_sides,
                 int32_t* facet_cells, int32_t* facet_local,
                 int32_t* facet_verts, int32_t* facet_bnd,
                 int64_t* nf_out) {
    std::unordered_map<int64_t, int32_t> edge_id;
    edge_id.reserve(static_cast<size_t>(nc) * 2);
    int32_t nf = 0;
    for (int64_t c = 0; c < nc; ++c) {
        const int32_t* v = cells + 3 * c;
        for (int lf = 0; lf < 3; ++lf) {
            int32_t a = v[(lf + 1) % 3];
            int32_t b = v[(lf + 2) % 3];
            int64_t lo = a < b ? a : b;
            int64_t hi = a < b ? b : a;
            int64_t key = lo * nv + hi;
            auto it = edge_id.find(key);
            int32_t f;
            int32_t side;
            if (it == edge_id.end()) {
                f = nf++;
                edge_id.emplace(key, f);
                side = 0;
                facet_cells[2 * f + 0] = static_cast<int32_t>(c);
                facet_local[2 * f + 0] = lf;
                facet_verts[2 * f + 0] = a;
                facet_verts[2 * f + 1] = b;
                // provisional: mirror side-1 until a partner shows up
                facet_cells[2 * f + 1] = static_cast<int32_t>(c);
                facet_local[2 * f + 1] = lf;
                facet_bnd[f] = 1;
            } else {
                f = it->second;
                side = 1;
                facet_cells[2 * f + 1] = static_cast<int32_t>(c);
                facet_local[2 * f + 1] = lf;
                facet_bnd[f] = 0;
            }
            cell_facets[3 * c + lf] = f;
            cell_sides[3 * c + lf] = side;
        }
    }
    *nf_out = nf;
    return 0;
}

}  // extern "C"
