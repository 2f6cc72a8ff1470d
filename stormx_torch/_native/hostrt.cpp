// stormx_torch host runtime: the serial graph work NumPy cannot vectorize.
//
// Copies of the reverse Cuthill–McKee, ILU(0) and IC(0) entries of
// stormx/_native/hostrt.cpp (the ones this package needs), so the port
// builds its own library and imports nothing of the JAX package.  Plain C
// ABI, loaded via ctypes.  Graphs arrive as CSR adjacency: row_ptr
// int64[n+1], cols int64[nnz], symmetric, no self-loops (the Python wrapper
// canonicalizes).

#include <algorithm>
#include <cmath>
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

// ILU(0): LU restricted to the sparsity pattern of A (IKJ form).  Matches
// stormx_torch.precond.factorized.ilu0_factorize bit-for-bit: rows processed
// ascending, each row's lower entries in ascending column order (rows need
// not be pre-sorted), updates applied in the stored order of the pivot row
// (each target slot is touched once per pivot, so that order is
// bit-irrelevant but identical anyway).  lu[] holds A's values on entry and
// the factor on exit (strict lower = L with unit diagonal, diag+upper = U).
// Returns 0 on success, 1 on a missing diagonal, 2 on a zero pivot.
int stormx_ilu0(int64_t n, const int64_t* row_ptr, const int64_t* cols,
                double* lu) {
  std::vector<int64_t> diag(n, -1);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t k = row_ptr[i]; k < row_ptr[i + 1]; ++k)
      if (cols[k] == i) diag[i] = k;
  for (int64_t i = 0; i < n; ++i)
    if (diag[i] < 0) return 1;

  std::vector<int64_t> pos(n, -1);  // col -> slot of the CURRENT row i
  std::vector<int64_t> sorted_slots;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = row_ptr[i], hi = row_ptr[i + 1];
    for (int64_t k = lo; k < hi; ++k) pos[cols[k]] = k;
    sorted_slots.clear();
    for (int64_t k = lo; k < hi; ++k)
      if (cols[k] < i) sorted_slots.push_back(k);
    std::sort(sorted_slots.begin(), sorted_slots.end(),
              [&](int64_t a, int64_t b) { return cols[a] < cols[b]; });
    for (const int64_t kij : sorted_slots) {
      const int64_t j = cols[kij];
      const double piv = lu[diag[j]];
      if (piv == 0.0) {
        for (int64_t k = lo; k < hi; ++k) pos[cols[k]] = -1;
        return 2;
      }
      const double lik = lu[kij] / piv;
      lu[kij] = lik;
      for (int64_t kjm = row_ptr[j]; kjm < row_ptr[j + 1]; ++kjm) {
        const int64_t m = cols[kjm];
        if (m <= j) continue;
        const int64_t kim = pos[m];
        if (kim >= 0) lu[kim] -= lik * lu[kjm];
      }
    }
    for (int64_t k = lo; k < hi; ++k) pos[cols[k]] = -1;
  }
  return 0;
}

// IC(0): A ≈ L·Lᵀ with L on lower(A)'s pattern.  The caller passes the
// LOWER triangle of A in CSR with ascending columns per row (diagonal
// last); l_vals holds a's lower values on entry, L on exit.  Matches
// stormx_torch.precond.factorized.ic0_factorize bit-for-bit: rows ascending,
// columns ascending, the sparse row-dot accumulated in ascending column
// order (a two-pointer merge — the Python iterates row i's L entries
// ascending and skips misses, the same order).  Returns 0 on success, 1 if
// a row's last lower entry is not the diagonal, -(i+1) on a non-positive
// pivot at row i.
int stormx_ic0(int64_t n, const int64_t* l_ptr, const int64_t* l_cols,
               double* l_vals) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = l_ptr[i], hi = l_ptr[i + 1];
    if (hi <= lo || l_cols[hi - 1] != i) return 1;
    for (int64_t k = lo; k < hi; ++k) {
      const int64_t j = l_cols[k];
      if (j < i) {
        // l[i,j] = (a[i,j] - Σ_{jj<j} l[i,jj]·l[j,jj]) / l[j,j]
        double s = l_vals[k];
        int64_t ki = lo;                 // row i entries so far (cols < j)
        int64_t kj = l_ptr[j];           // row j entries (cols < j excl diag)
        const int64_t kj_end = l_ptr[j + 1] - 1;  // diag j is last
        while (ki < k && kj < kj_end) {
          const int64_t ci = l_cols[ki], cj = l_cols[kj];
          if (ci == cj) {
            s -= l_vals[ki] * l_vals[kj];
            ++ki;
            ++kj;
          } else if (ci < cj) {
            ++ki;
          } else {
            ++kj;
          }
        }
        l_vals[k] = s / l_vals[kj_end];
      } else {
        // diagonal: l[i,i] = sqrt(a[i,i] - Σ l[i,jj]²); the squared sum
        // accumulates ascending starting from 0 and is subtracted ONCE
        // (bit-matches the Python `aii - sum(v*v ...)`)
        double sq = 0.0;
        for (int64_t ki = lo; ki < k; ++ki) sq += l_vals[ki] * l_vals[ki];
        const double s = l_vals[k] - sq;
        if (!(s > 0.0)) return -static_cast<int>(i + 1);
        l_vals[k] = std::sqrt(s);
      }
    }
  }
  return 0;
}

}  // extern "C"
