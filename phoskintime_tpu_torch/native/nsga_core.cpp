// Host GA bookkeeping kernels (C ABI, loaded with ctypes): the port's own
// copy of phoskintime_tpu/native/nsga_core.cpp, so that the port never
// imports the JAX package.
//
// The device evaluates populations; the host runs the NSGA machinery. At
// production population sizes (10k+ candidates, the north-star ensemble)
// numpy's O(n^2) dominance matrix costs gigabytes and seconds a
// generation; these do the same work cache-tight and allocation-light.
//
//   nd_sort:          fast non-dominated sort (Deb 2002) -> rank per solution
//   crowding:         NSGA-II crowding distance within one front
//   associate:        NSGA-III reference-direction association (niche + distance)
//   hv3d_contrib:     leave-one-out 3-objective hypervolume contributions
//   hv3d_one_contrib: the exclusive hypervolume of one point (SMS-EMOA's
//                     lazy-greedy refresh)
//
// Built on first use by phoskintime_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC nsga_core.cpp -o <build dir>/libnsga_core_<key>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <map>
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

// Crowding distance for the subset `idx` (size k) of F (n, m): boundary
// members of each objective get 1e300, interior members accumulate
// (next - prev) / span. The sort is stable, as numpy's, so ties order by
// position in idx.
void crowding(const double* F, int n, int m, const int32_t* idx, int k,
              double* dist_out) {
    const double INF = 1e300;
    for (int i = 0; i < k; ++i) dist_out[i] = 0.0;
    if (k <= 2) {
        for (int i = 0; i < k; ++i) dist_out[i] = INF;
        return;
    }
    std::vector<int32_t> order(k);
    for (int obj = 0; obj < m; ++obj) {
        for (int i = 0; i < k; ++i) order[i] = i;
        std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
            return F[(size_t)idx[a] * m + obj] < F[(size_t)idx[b] * m + obj];
        });
        double lo = F[(size_t)idx[order[0]] * m + obj];
        double hi = F[(size_t)idx[order[k - 1]] * m + obj];
        double span = hi - lo;
        dist_out[order[0]] = INF;
        dist_out[order[k - 1]] = INF;
        if (span <= 0) continue;
        for (int i = 1; i < k - 1; ++i) {
            double below = F[(size_t)idx[order[i - 1]] * m + obj];
            double above = F[(size_t)idx[order[i + 1]] * m + obj];
            if (dist_out[order[i]] < INF)
                dist_out[order[i]] += (above - below) / span;
        }
    }
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

// ---------------------------------------------------------------------------
// 3-objective hypervolume contributions (SMS-EMOA survival)
// ---------------------------------------------------------------------------

// Exact hypervolume of the points listed in idx (minimization, ref box),
// via a z-sweep with an incrementally-maintained 2D staircase whose area
// is updated in O(log n + removed) per insertion.
static double hv3d_of(const double* F, const std::vector<int32_t>& idx,
                      const double* ref) {
    std::vector<int32_t> pts;
    pts.reserve(idx.size());
    for (int32_t i : idx) {
        const double* f = F + (size_t)i * 3;
        if (f[0] < ref[0] && f[1] < ref[1] && f[2] < ref[2]) pts.push_back(i);
    }
    if (pts.empty()) return 0.0;
    std::sort(pts.begin(), pts.end(), [&](int32_t a, int32_t b) {
        return F[(size_t)a * 3 + 2] < F[(size_t)b * 3 + 2];
    });

    // staircase: x -> y, x ascending, y strictly descending
    std::map<double, double> st;
    double area = 0.0, vol = 0.0;
    double z_prev = F[(size_t)pts[0] * 3 + 2];
    for (int32_t i : pts) {
        const double* f = F + (size_t)i * 3;
        double x = f[0], y = f[1], z = f[2];
        vol += area * (z - z_prev);
        z_prev = z;

        // dominated in 2D by an existing staircase point?
        auto it = st.lower_bound(x);            // first x' >= x
        double y_up = ref[1];
        if (it != st.begin()) y_up = std::prev(it)->second;
        if (y_up <= y) continue;                // dominated by an x' < x
        if (it != st.end() && it->first == x && it->second <= y)
            continue;                           // dominated at equal x
        // remove points dominated by (x, y): x'' >= x with y'' >= y
        double y_cut = y_up;                    // y above the removed block
        while (it != st.end() && it->second >= y) {
            double xr = it->first, yr = it->second;
            area -= (y_cut - yr) * (ref[0] - xr);
            y_cut = yr;
            it = st.erase(it);
        }
        // successor's term shrinks: its upper y becomes the new point's y
        if (it != st.end()) {
            // no area change needed for the successor itself: its term is
            // (y_above - y_s)(rx - x_s) where y_above was y_cut, now y
            double xs = it->first, ys = it->second;
            area -= (y_cut - ys) * (ref[0] - xs);
            area += (y - ys) * (ref[0] - xs);
        }
        area += (y_up - y) * (ref[0] - x);
        st[x] = y;
    }
    vol += area * (ref[2] - z_prev);
    return vol;
}

extern "C" {

// Leave-one-out hypervolume contributions of F (n, 3) w.r.t. ref (3,).
// out (n,). O(n^2 log n) total.
void hv3d_contrib(const double* F, int n, const double* ref, double* out) {
    if (n <= 0) return;  // vector(n-1) would throw across the C boundary
    std::vector<int32_t> all(n);
    for (int i = 0; i < n; ++i) all[i] = i;
    double total = hv3d_of(F, all, ref);
    std::vector<int32_t> sub(n - 1);
    for (int i = 0; i < n; ++i) {
        int k = 0;
        for (int j = 0; j < n; ++j)
            if (j != i) sub[k++] = j;
        out[i] = total - hv3d_of(F, sub, ref);
    }
}

// Exclusive hypervolume of point i alone (its leave-one-out contribution),
// O(n log n): contribution_i = vol(box(F_i, ref)) - HV({max(F_i, F_j)}_{j!=i})
// — the part of i's dominated box covered by any other point is exactly the
// hypervolume of the componentwise maxima clipped into that box.
double hv3d_one_contrib(const double* F, int n, int i, const double* ref) {
    const double* fi = F + (size_t)i * 3;
    if (!(fi[0] < ref[0] && fi[1] < ref[1] && fi[2] < ref[2])) return 0.0;
    double box = (ref[0] - fi[0]) * (ref[1] - fi[1]) * (ref[2] - fi[2]);
    std::vector<double> Q;
    Q.reserve((size_t)(n - 1) * 3);
    for (int j = 0; j < n; ++j) {
        if (j == i) continue;
        const double* fj = F + (size_t)j * 3;
        Q.push_back(std::max(fi[0], fj[0]));
        Q.push_back(std::max(fi[1], fj[1]));
        Q.push_back(std::max(fi[2], fj[2]));
    }
    int m = (int)(Q.size() / 3);
    std::vector<int32_t> all(m);
    for (int k = 0; k < m; ++k) all[k] = k;
    return box - hv3d_of(Q.data(), all, ref);
}

}  // extern "C"
