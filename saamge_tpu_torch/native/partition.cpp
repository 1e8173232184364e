// Multilevel k-way graph partitioner (METIS replacement for agglomeration).
//
// The reference partitions the element dual graph with METIS K-way
// (part.cpp:120-204, METIS_PartGraphKway at part.cpp:170) with vertex
// weights and a contiguity option.  This is a from-scratch multilevel
// implementation of the same scheme:
//   1. coarsening by heavy-edge matching (vertex/edge weights folded),
//   2. initial partitioning of the coarsest graph by recursive bisection
//      (BFS growing from a pseudo-peripheral seed + boundary refinement),
//   3. uncoarsening with greedy k-way boundary refinement under a balance
//      constraint, plus a forced-balance pass.
// Connectivity post-fixing (splitting disconnected parts) stays in Python
// (topology/part.py connected_components), mirroring the reference's
// connectedComponents post-pass.
//
// C API (ctypes):
//   int64_t saamge_partition_kway(
//       int64_t n, const int64_t* xadj, const int64_t* adjncy,
//       const double* vwgt /*nullable*/, const double* adjwgt /*nullable*/,
//       int64_t nparts, double imbalance, uint64_t seed, int64_t* part_out);
// Returns the edge cut (>= 0) on success, -1 on error.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

using std::size_t;
using i64 = std::int64_t;

struct Graph {
    i64 n = 0;
    std::vector<i64> xadj;     // n+1
    std::vector<i64> adjncy;   // nnz
    std::vector<double> adjwgt;
    std::vector<double> vwgt;
    // mapping to the finer graph (for uncoarsening)
    std::vector<i64> fine_to_coarse;
};

// ----------------------------------------------------------------- coarsening

Graph coarsen(const Graph& g, std::mt19937_64& rng) {
    Graph cg;
    const i64 n = g.n;
    std::vector<i64> match(n, -1);
    std::vector<i64> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::shuffle(order.begin(), order.end(), rng);

    // heavy-edge matching
    for (i64 oi = 0; oi < n; ++oi) {
        const i64 v = order[oi];
        if (match[v] >= 0) continue;
        i64 best = -1;
        double bestw = -1.0;
        for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
            const i64 u = g.adjncy[e];
            if (u == v || match[u] >= 0) continue;
            const double w = g.adjwgt[e];
            if (w > bestw) { bestw = w; best = u; }
        }
        if (best >= 0) { match[v] = best; match[best] = v; }
        else match[v] = v;
    }

    // number coarse vertices
    std::vector<i64>& f2c = cg.fine_to_coarse;
    f2c.assign(n, -1);
    i64 cn = 0;
    for (i64 v = 0; v < n; ++v) {
        if (f2c[v] >= 0) continue;
        const i64 u = match[v];
        f2c[v] = cn;
        if (u != v) f2c[u] = cn;
        ++cn;
    }
    cg.n = cn;
    cg.vwgt.assign(cn, 0.0);
    for (i64 v = 0; v < n; ++v) cg.vwgt[f2c[v]] += g.vwgt[v];

    // build coarse adjacency by accumulating per coarse vertex
    cg.xadj.assign(cn + 1, 0);
    std::vector<std::pair<i64, double>> buf;
    std::vector<std::vector<std::pair<i64, double>>> rows(cn);
    for (i64 v = 0; v < n; ++v) {
        const i64 cv = f2c[v];
        for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
            const i64 cu = f2c[g.adjncy[e]];
            if (cu == cv) continue;
            rows[cv].push_back({cu, g.adjwgt[e]});
        }
    }
    for (i64 cv = 0; cv < cn; ++cv) {
        auto& r = rows[cv];
        std::sort(r.begin(), r.end());
        i64 m = 0;
        for (size_t k = 0; k < r.size(); ++k) {
            if (m > 0 && cg.adjncy[cg.xadj[cv] + m - 1] == r[k].first) {
                cg.adjwgt.back() += r[k].second;
            } else {
                cg.adjncy.push_back(r[k].first);
                cg.adjwgt.push_back(r[k].second);
                ++m;
            }
        }
        cg.xadj[cv + 1] = (i64)cg.adjncy.size();
    }
    return cg;
}

// ------------------------------------------------------------------ bisection

// BFS-grow a region of target weight from a pseudo-peripheral seed within
// `mask` (vertices of the current sub-problem); side[] gets 0/1.
void grow_bisection(const Graph& g, const std::vector<i64>& verts,
                    double target0, std::vector<int>& side,
                    std::mt19937_64& rng) {
    const i64 n = g.n;
    std::vector<char> in(n, 0);
    for (i64 v : verts) in[v] = 1;
    for (i64 v : verts) side[v] = 1;

    // pseudo-peripheral: BFS from random vertex, take farthest
    i64 seed = verts[rng() % verts.size()];
    for (int rep = 0; rep < 2; ++rep) {
        std::vector<char> seen(n, 0);
        std::queue<i64> q;
        q.push(seed); seen[seed] = 1;
        i64 last = seed;
        while (!q.empty()) {
            const i64 v = q.front(); q.pop();
            last = v;
            for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
                const i64 u = g.adjncy[e];
                if (in[u] && !seen[u]) { seen[u] = 1; q.push(u); }
            }
        }
        seed = last;
    }

    double w = 0.0;
    std::vector<char> seen(n, 0);
    std::queue<i64> q;
    q.push(seed); seen[seed] = 1;
    while (!q.empty() && w < target0) {
        const i64 v = q.front(); q.pop();
        side[v] = 0;
        w += g.vwgt[v];
        for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
            const i64 u = g.adjncy[e];
            if (in[u] && !seen[u]) { seen[u] = 1; q.push(u); }
        }
    }
    // if BFS exhausted inside a disconnected region, sweep leftovers
    if (w < target0) {
        for (i64 v : verts) {
            if (w >= target0) break;
            if (side[v] == 1 && !seen[v]) { side[v] = 0; w += g.vwgt[v]; }
        }
    }
}

// greedy boundary refinement of a bisection restricted to `verts`
void refine_bisection(const Graph& g, const std::vector<i64>& verts,
                      std::vector<int>& side, double target0,
                      double imbalance, int passes) {
    const i64 n = g.n;
    std::vector<char> in(n, 0);
    for (i64 v : verts) in[v] = 1;
    double w0 = 0.0, wtot = 0.0;
    for (i64 v : verts) {
        wtot += g.vwgt[v];
        if (side[v] == 0) w0 += g.vwgt[v];
    }
    const double lo = target0 / imbalance, hi = target0 * imbalance;
    for (int pass = 0; pass < passes; ++pass) {
        i64 moved = 0;
        for (i64 v : verts) {
            double same = 0.0, other = 0.0;
            for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
                const i64 u = g.adjncy[e];
                if (!in[u]) continue;
                if (side[u] == side[v]) same += g.adjwgt[e];
                else other += g.adjwgt[e];
            }
            if (other <= same) continue;
            const double nw0 = side[v] == 0 ? w0 - g.vwgt[v]
                                            : w0 + g.vwgt[v];
            if (nw0 < lo || nw0 > hi) continue;
            side[v] = 1 - side[v];
            w0 = nw0;
            ++moved;
        }
        if (!moved) break;
    }
}

void partition_recursive(const Graph& g, const std::vector<i64>& verts,
                         i64 k, i64 base, std::vector<i64>& part,
                         double imbalance, std::mt19937_64& rng) {
    if (k <= 1 || verts.empty()) {
        for (i64 v : verts) part[v] = base;
        return;
    }
    const i64 k0 = k / 2;
    double wtot = 0.0;
    for (i64 v : verts) wtot += g.vwgt[v];
    const double target0 = wtot * (double)k0 / (double)k;
    std::vector<int> side(g.n, -1);
    grow_bisection(g, verts, target0, side, rng);
    refine_bisection(g, verts, side, target0, imbalance, 8);
    std::vector<i64> v0, v1;
    for (i64 v : verts) (side[v] == 0 ? v0 : v1).push_back(v);
    partition_recursive(g, v0, k0, base, part, imbalance, rng);
    partition_recursive(g, v1, k - k0, base + k0, part, imbalance, rng);
}

// ------------------------------------------------------- k-way refinement

double part_weights(const Graph& g, const std::vector<i64>& part, i64 nparts,
                    std::vector<double>& pw) {
    pw.assign(nparts, 0.0);
    double tot = 0.0;
    for (i64 v = 0; v < g.n; ++v) { pw[part[v]] += g.vwgt[v]; tot += g.vwgt[v]; }
    return tot;
}

void refine_kway(const Graph& g, std::vector<i64>& part, i64 nparts,
                 double imbalance, int passes) {
    std::vector<double> pw;
    const double tot = part_weights(g, part, nparts, pw);
    const double maxw = imbalance * tot / (double)nparts;
    std::vector<double> conn(nparts, 0.0);
    std::vector<i64> touched;
    for (int pass = 0; pass < passes; ++pass) {
        i64 moved = 0;
        for (i64 v = 0; v < g.n; ++v) {
            const i64 p = part[v];
            bool boundary = false;
            for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e)
                if (part[g.adjncy[e]] != p) { boundary = true; break; }
            if (!boundary) continue;
            touched.clear();
            for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
                const i64 q = part[g.adjncy[e]];
                if (conn[q] == 0.0) touched.push_back(q);
                conn[q] += g.adjwgt[e];
            }
            const double internal = conn[p];
            i64 best = -1;
            double bestgain = 0.0;
            for (i64 q : touched) {
                if (q == p) continue;
                const double gain = conn[q] - internal;
                const bool fits = pw[q] + g.vwgt[v] <= maxw;
                // strictly positive gain, or zero-gain move that improves
                // balance from an overweight part
                if (fits && (gain > bestgain ||
                             (gain == bestgain && best < 0 && gain >= 0.0 &&
                              pw[p] > maxw))) {
                    best = q; bestgain = gain;
                }
            }
            for (i64 q : touched) conn[q] = 0.0;
            if (best >= 0 && pw[p] - g.vwgt[v] > 0.0) {
                part[v] = best;
                pw[best] += g.vwgt[v];
                pw[p] -= g.vwgt[v];
                ++moved;
            }
        }
        if (!moved) break;
    }
}

// push vertices out of overweight parts onto their lightest neighbor part
void force_balance(const Graph& g, std::vector<i64>& part, i64 nparts,
                   double imbalance) {
    std::vector<double> pw;
    const double tot = part_weights(g, part, nparts, pw);
    const double maxw = imbalance * tot / (double)nparts;
    for (int round = 0; round < 64; ++round) {
        bool any_over = false;
        i64 moved = 0;
        for (i64 v = 0; v < g.n; ++v) {
            const i64 p = part[v];
            if (pw[p] <= maxw) continue;
            any_over = true;
            i64 best = -1;
            double bw = 1e300;
            for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
                const i64 q = part[g.adjncy[e]];
                if (q != p && pw[q] < bw) { bw = pw[q]; best = q; }
            }
            if (best >= 0 && pw[best] + g.vwgt[v] <= maxw) {
                part[v] = best;
                pw[best] += g.vwgt[v];
                pw[p] -= g.vwgt[v];
                ++moved;
            }
        }
        if (!any_over || !moved) break;
    }
}

// dissolve parts much smaller than the target size: each vertex of a tiny
// part moves to its most-connected other part (tiny AEs give useless local
// eigenproblems and inflate the coarse space)
void merge_small_parts(const Graph& g, std::vector<i64>& part, i64 nparts,
                       double min_frac) {
    std::vector<double> pw;
    const double tot = part_weights(g, part, nparts, pw);
    const double minw = min_frac * tot / (double)nparts;
    std::vector<char> tiny(nparts, 0);
    bool any = false;
    for (i64 p = 0; p < nparts; ++p)
        if (pw[p] > 0.0 && pw[p] < minw) { tiny[p] = 1; any = true; }
    if (!any) return;
    std::vector<double> conn(nparts, 0.0);
    std::vector<i64> touched;
    for (int round = 0; round < 8; ++round) {
        i64 moved = 0;
        for (i64 v = 0; v < g.n; ++v) {
            const i64 p = part[v];
            if (!tiny[p]) continue;
            touched.clear();
            for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e) {
                const i64 q = part[g.adjncy[e]];
                if (conn[q] == 0.0) touched.push_back(q);
                conn[q] += g.adjwgt[e];
            }
            i64 best = -1;
            double bw = 0.0;
            for (i64 q : touched)
                if (!tiny[q] && conn[q] > bw) { bw = conn[q]; best = q; }
            for (i64 q : touched) conn[q] = 0.0;
            if (best >= 0) {
                part[v] = best;
                pw[best] += g.vwgt[v];
                pw[p] -= g.vwgt[v];
                ++moved;
            }
        }
        if (!moved) break;
    }
}

double edge_cut(const Graph& g, const std::vector<i64>& part) {
    double cut = 0.0;
    for (i64 v = 0; v < g.n; ++v)
        for (i64 e = g.xadj[v]; e < g.xadj[v + 1]; ++e)
            if (part[g.adjncy[e]] != part[v]) cut += g.adjwgt[e];
    return cut / 2.0;
}

}  // namespace

extern "C" {

std::int64_t saamge_partition_kway(
        std::int64_t n, const std::int64_t* xadj, const std::int64_t* adjncy,
        const double* vwgt, const double* adjwgt,
        std::int64_t nparts, double imbalance, std::uint64_t seed,
        std::int64_t* part_out) {
    if (n <= 0 || nparts <= 0 || !xadj || !adjncy || !part_out) return -1;
    if (nparts == 1 || n == 1) {
        for (i64 v = 0; v < n; ++v) part_out[v] = 0;
        return 0;
    }
    if (imbalance < 1.01) imbalance = 1.01;

    Graph g;
    g.n = n;
    g.xadj.assign(xadj, xadj + n + 1);
    g.adjncy.assign(adjncy, adjncy + xadj[n]);
    g.vwgt.resize(n);
    if (vwgt) std::copy(vwgt, vwgt + n, g.vwgt.begin());
    else std::fill(g.vwgt.begin(), g.vwgt.end(), 1.0);
    g.adjwgt.resize(xadj[n]);
    if (adjwgt) std::copy(adjwgt, adjwgt + xadj[n], g.adjwgt.begin());
    else std::fill(g.adjwgt.begin(), g.adjwgt.end(), 1.0);

    std::mt19937_64 rng(seed);

    // coarsening ladder (shared across restarts)
    std::vector<Graph> ladder;
    ladder.push_back(std::move(g));
    const i64 coarse_target = std::max<i64>(8 * nparts, 128);
    while (ladder.back().n > coarse_target) {
        Graph cg = coarsen(ladder.back(), rng);
        if (cg.n >= ladder.back().n * 95 / 100) break;  // stalled
        ladder.push_back(std::move(cg));
    }

    // multi-restart: initial partitions are cheap on the coarsest graph;
    // keep the uncoarsened result with the smallest edge cut
    const int RESTARTS = 3;
    std::vector<i64> best;
    double best_cut = 1e300;
    for (int rs = 0; rs < RESTARTS; ++rs) {
        Graph& cg = ladder.back();
        std::vector<i64> part(cg.n, 0);
        std::vector<i64> all(cg.n);
        std::iota(all.begin(), all.end(), 0);
        partition_recursive(cg, all, nparts, 0, part, imbalance, rng);
        refine_kway(cg, part, nparts, imbalance, 8);
        force_balance(cg, part, nparts, imbalance);

        for (size_t lev = ladder.size() - 1; lev > 0; --lev) {
            const Graph& fine = ladder[lev - 1];
            const std::vector<i64>& f2c = ladder[lev].fine_to_coarse;
            std::vector<i64> fpart(fine.n);
            for (i64 v = 0; v < fine.n; ++v) fpart[v] = part[f2c[v]];
            part.swap(fpart);
            refine_kway(fine, part, nparts, imbalance, 6);
            force_balance(fine, part, nparts, imbalance);
        }
        merge_small_parts(ladder.front(), part, nparts, 0.25);
        const double cut = edge_cut(ladder.front(), part);
        if (cut < best_cut) { best_cut = cut; best.swap(part); }
    }

    std::copy(best.begin(), best.end(), part_out);
    return (std::int64_t)(best_cut + 0.5);
}

}  // extern "C"
