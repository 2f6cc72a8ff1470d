// stormx_torch host runtime: the serial graph work NumPy cannot vectorize.
//
// Copy of the reverse Cuthill–McKee entry of stormx/_native/hostrt.cpp (the
// only one this package needs), so the port builds its own library and
// imports nothing of the JAX package.  Plain C ABI, loaded via ctypes.
// Graphs arrive as CSR adjacency: row_ptr int64[n+1], cols int64[nnz],
// symmetric, no self-loops (the Python wrapper canonicalizes).

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Reverse Cuthill–McKee.  Matches stormx_torch.parallel.partition.rcm_order
// bit-for-bit: seeds visited in stable degree order; BFS neighbors visited
// in CSR order stable-sorted by degree; result reversed.
// Returns 0 on success.  out_perm[new] = old.
int stormx_rcm_order(int64_t n, const int64_t* row_ptr, const int64_t* cols,
                     int64_t* out_perm) {
  if (n < 0) return 1;
  std::vector<int64_t> deg(n);
  for (int64_t u = 0; u < n; ++u) deg[u] = row_ptr[u + 1] - row_ptr[u];

  std::vector<int64_t> by_degree(n);
  std::iota(by_degree.begin(), by_degree.end(), 0);
  std::stable_sort(by_degree.begin(), by_degree.end(),
                   [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });

  std::vector<uint8_t> visited(n, 0);
  std::vector<int64_t> result(n);
  std::vector<int64_t> nbrs;
  int64_t pos = 0;
  for (int64_t s = 0; s < n; ++s) {
    const int64_t seed = by_degree[s];
    if (visited[seed]) continue;
    visited[seed] = 1;
    result[pos++] = seed;
    int64_t head = pos - 1;
    while (head < pos) {
      const int64_t u = result[head++];
      nbrs.clear();
      for (int64_t j = row_ptr[u]; j < row_ptr[u + 1]; ++j) {
        const int64_t v = cols[j];
        if (!visited[v]) nbrs.push_back(v);
      }
      std::stable_sort(nbrs.begin(), nbrs.end(),
                       [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });
      for (const int64_t v : nbrs) {
        visited[v] = 1;
        result[pos++] = v;
      }
    }
  }
  for (int64_t i = 0; i < n; ++i) out_perm[i] = result[n - 1 - i];
  return 0;
}

}  // extern "C"
