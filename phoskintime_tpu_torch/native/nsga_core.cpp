// Host GA bookkeeping kernels (C ABI, loaded with ctypes): the port's own
// copy of the two entries of phoskintime_tpu/native/nsga_core.cpp that the
// U-NSGA-III survival uses, so that the port never imports the JAX package.
//
// The device evaluates populations; the host runs the NSGA machinery. At
// production population sizes (10k+ candidates, the north-star ensemble)
// numpy's O(n^2) dominance matrix costs gigabytes and seconds a
// generation; these do the same work cache-tight and allocation-light.
//
//   nd_sort:    fast non-dominated sort (Deb 2002) -> rank per solution
//   associate:  NSGA-III reference-direction association (niche + distance)
//
// Built on first use by phoskintime_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC nsga_core.cpp -o <build dir>/libnsga_core_<key>.so

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Non-dominated sort. F: (n, m) objectives row-major. rank_out: (n,) int32.
// Returns the number of fronts.
int nd_sort(const double* F, int n, int m, int32_t* rank_out) {
    std::vector<int32_t> n_dom(n, 0);           // # solutions dominating i
    std::vector<std::vector<int32_t>> dominates(n);

    for (int i = 0; i < n; ++i) {
        const double* fi = F + (size_t)i * m;
        for (int j = i + 1; j < n; ++j) {
            const double* fj = F + (size_t)j * m;
            bool i_le = true, i_lt = false, j_le = true, j_lt = false;
            for (int k = 0; k < m; ++k) {
                if (fi[k] > fj[k]) { i_le = false; j_lt = true; }
                else if (fi[k] < fj[k]) { j_le = false; i_lt = true; }
                if (!i_le && !j_le) break;
            }
            if (i_le && i_lt) {                  // i dominates j
                dominates[i].push_back(j);
                ++n_dom[j];
            } else if (j_le && j_lt) {           // j dominates i
                dominates[j].push_back(i);
                ++n_dom[i];
            }
        }
    }

    std::vector<int32_t> current;
    current.reserve(n);
    for (int i = 0; i < n; ++i) {
        rank_out[i] = -1;
        if (n_dom[i] == 0) current.push_back(i);
    }

    int rank = 0;
    int assigned = 0;
    while (!current.empty()) {
        std::vector<int32_t> next;
        for (int32_t i : current) {
            rank_out[i] = rank;
            ++assigned;
            for (int32_t j : dominates[i]) {
                if (--n_dom[j] == 0) next.push_back(j);
            }
        }
        current.swap(next);
        ++rank;
    }
    // numerical-tie safety net: anything unassigned goes in a final front
    if (assigned < n) {
        for (int i = 0; i < n; ++i)
            if (rank_out[i] < 0) rank_out[i] = rank;
        ++rank;
    }
    return rank;
}

// NSGA-III association: normalized objectives Fn (n, m), unit reference
// directions U (r, m). niche_out (n,) int32, dist_out (n,) double.
void associate(const double* Fn, int n, int m, const double* U, int r,
               int32_t* niche_out, double* dist_out) {
    for (int i = 0; i < n; ++i) {
        const double* f = Fn + (size_t)i * m;
        double norm2 = 0.0;
        for (int k = 0; k < m; ++k) norm2 += f[k] * f[k];
        double best = 1e300;
        int32_t best_j = 0;
        for (int j = 0; j < r; ++j) {
            const double* u = U + (size_t)j * m;
            double proj = 0.0;
            for (int k = 0; k < m; ++k) proj += f[k] * u[k];
            double d2 = norm2 - proj * proj;
            if (d2 < best) { best = d2; best_j = j; }
        }
        niche_out[i] = best_j;
        dist_out[i] = best > 0 ? std::sqrt(best) : 0.0;
    }
}

}  // extern "C"
