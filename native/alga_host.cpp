// alga_host — native host-side graph engine for the alga_tpu assembler.
//
// The reference assembler's host runtime is C++ (graph surgery under striped
// locks, pointer-chasing walks); this library is its native-performance
// counterpart in the JAX framework: the device (JAX/XLA) finds and
// verifies overlap candidates, and this engine runs the sequential
// graph-simplification / contraction / contig-walk passes whose semantics
// were locked down (byte-identical output) against the reference via the
// Python twin implementations in alga_tpu/graph/{simplify,contract}.py and
// alga_tpu/contig/walk.py — which remain as differential-test oracles.
//
// Reference provenance for each pass is cited at the function level
// (file:line refers to /root/reference).
//
// Build: make -C native   (g++ -O3 -shared -fPIC)
// Binding: ctypes (alga_tpu/native.py).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <queue>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

using std::pair;
using std::vector;

namespace {

// Static range split (reference P1, e.g. Graph.cpp:348-364): thread t gets
// [t*blk, (t+1)*blk); the calling thread takes block 0.  Unlike the
// reference's hand-rolled fan-outs this is a helper, but the split shape is
// the same.
int resolve_threads(int threads) {
    int T = threads > 0 ? threads : (int)std::thread::hardware_concurrency();
    return T < 1 ? 1 : T;
}

// test hook: force every parallel section to execute sequentially (same
// `threads` value, so the WorkloadManager coverage quirks are unchanged) —
// lets the parity suite assert parallel == sequential execution bit-for-bit
bool force_seq() { return getenv("ALGA_NATIVE_SEQ") != nullptr; }

template <class F>
void parallel_ranges(int64_t n, int threads, F&& job, int64_t min_par = 2048) {
    int T = resolve_threads(threads);
    if ((int64_t)T > n) T = (int)(n > 0 ? n : 1);
    if (force_seq() || T == 1 || n < min_par) {
        job(0, 0, n);
        return;
    }
    int64_t blk = (n + T - 1) / T;
    vector<std::thread> ths;
    for (int t = 1; t < T; t++) {
        int64_t a = (int64_t)t * blk, b = std::min(n, (int64_t)(t + 1) * blk);
        if (a < b) ths.emplace_back(job, t, a, b);
    }
    job(0, 0, std::min(n, blk));
    for (auto& th : ths) th.join();
}

struct Adj {
    // per-node adjacency (dst, offset); mutation semantics replicate
    // reference Graph (src/DataStructures/Graph.cpp)
    int n;
    vector<vector<pair<int, int>>> out;

    void init(int n_, int64_t ne, const int32_t* src, const int32_t* dst,
              const int32_t* off) {
        n = n_;
        out.assign(n, {});
        for (int64_t e = 0; e < ne; e++) out[src[e]].push_back({dst[e], off[e]});
    }

    // ref Graph::removeDirectedEdge (Graph.cpp:96-119): back-to-front swap-pop
    bool remove_edge(int a, int b) {
        auto& la = out[a];
        bool removed = false;
        int p = (int)la.size() - 1;
        for (int i = (int)la.size() - 1; i >= 0; i--) {
            if (la[i].first == b) {
                std::swap(la[i], la[p]);
                la.pop_back();
                p--;
                removed = true;
            }
        }
        return removed;
    }

    // ref Graph::sortEdgesByIncreasingOffset (Graph.cpp:584-614) — the
    // reference fans these per-node passes over THREADS (P1); each node's
    // list is independent, so the parallel result is identical
    void sort_by_offset(int threads = 0);

    // per-node neighbor-ascending order: the canonical layout after
    // retainOnlySmallestOffset and after every reverseGraphInPlace round
    // trip — the layout the reference's dangling loop iterates
    void sort_by_neighbor(int threads = 0);

    // ref Graph::retainOnlySmallestOffset (Graph.cpp:348-387)
    void retain_min_offset(int threads = 0);

    int64_t num_edges() const {
        int64_t t = 0;
        for (auto& la : out) t += (int64_t)la.size();
        return t;
    }

    int64_t dump(int32_t* src, int32_t* dst, int32_t* off) const {
        int64_t e = 0;
        for (int a = 0; a < n; a++)
            for (auto& pr : out[a]) {
                src[e] = a; dst[e] = pr.first; off[e] = pr.second; e++;
            }
        return e;
    }

    Adj reversed() const {
        Adj r; r.n = n; r.out.assign(n, {});
        for (int a = 0; a < n; a++)
            for (auto& pr : out[a]) r.out[pr.first].push_back({a, pr.second});
        return r;
    }
};

void Adj::sort_by_offset(int threads) {
    parallel_ranges(n, threads, [&](int, int64_t a, int64_t b) {
        for (int64_t i = a; i < b; i++)
            std::sort(out[i].begin(), out[i].end(),
                      [](const pair<int,int>& p, const pair<int,int>& q) {
                if (p.second != q.second) return p.second < q.second;
                return p.first < q.first;
            });
    });
}

void Adj::sort_by_neighbor(int threads) {
    parallel_ranges(n, threads, [&](int, int64_t a, int64_t b) {
        for (int64_t i = a; i < b; i++)
            std::sort(out[i].begin(), out[i].end());
    });
}

void Adj::retain_min_offset(int threads) {
    parallel_ranges(n, threads, [&](int, int64_t a, int64_t b) {
        for (int64_t i = a; i < b; i++) {
            auto& la = out[i];
            std::sort(la.begin(), la.end());
            vector<pair<int,int>> nn;
            size_t p = 0;
            while (p < la.size()) {
                nn.push_back(la[p]);
                p++;
                while (p < la.size() && la[p-1].first == la[p].first) p++;
            }
            la.swap(nn);
        }
    });
}

// ---------------------------------------------------------------------------
// cutNonAndWeaklyMetricTriangles (ref GraphSimplifier.cpp:228-348):
// two-phase — collect (node id asc, slot asc) on the frozen graph, then
// remove.  Collection is thread-parallel over contiguous node ranges
// (ref :284 runs per-node jobs in parallel); per-range lists concatenate in
// range order, so the removal order is identical to the sequential pass —
// schedule-independent, unlike the reference.
vector<vector<pair<int,int>>> collect_triangles(const Adj& g,
                                                int max_offset, int threads) {
    int T = resolve_threads(threads);
    vector<vector<pair<int,int>>> bufs(T);
    parallel_ranges(g.n, T, [&](int t, int64_t a, int64_t b) {
        auto& out = bufs[t];
        std::unordered_map<int,int> dst;
        for (int64_t i = a; i < b; i++) {
            dst.clear();
            for (auto& e1 : g.out[i]) {
                for (auto& e2 : g.out[e1.first]) {
                    int bb = e2.first, w = e1.second + e2.second;
                    auto it = dst.find(bb);
                    if (it == dst.end() || w < it->second) dst[bb] = w;
                }
            }
            for (auto& e : g.out[i]) {
                if (e.second > max_offset) continue;
                auto it = dst.find(e.first);
                if (it != dst.end() && it->second == e.second)
                    out.push_back({(int)i, e.first});
            }
        }
    });
    return bufs;
}

int64_t cut_triangles(Adj& g, int max_offset, int threads) {
    auto bufs = collect_triangles(g, max_offset, threads);
    int64_t removed = 0;
    for (auto& buf : bufs) {
        removed += (int64_t)buf.size();
        for (auto& pr : buf) g.remove_edge(pr.first, pr.second);
    }
    return removed;
}

// tryToRemoveShortPathsMST (ref GraphSimplifier.cpp:431-518), seeds id-asc.
// Visited/kept bookkeeping uses local hash sets (the touched region is a
// small bounded neighborhood) so concurrent pops on disjoint regions share
// no scratch.
void mst_pop(Adj& g, int beg, int max_offset) {
    vector<pair<pair<int,int>,int>> edges;
    vector<int> neigh{beg};
    std::unordered_map<int,int> dst;
    dst[beg] = 0;
    std::unordered_set<int> was;
    for (size_t i = 0; i < neigh.size(); i++) {
        int a = neigh[i];
        if (was.count(a) || dst[a] > max_offset) continue;
        was.insert(a);
        for (auto& pr : g.out[a]) {
            int b = pr.first, offset = pr.second;
            auto it = dst.find(b);
            if (it != dst.end() && it->second < dst[a] + offset) continue;
            dst[b] = dst[a] + offset;
            edges.push_back({{a, b}, offset});
            neigh.push_back(b);
        }
    }
    for (auto& e : edges) g.remove_edge(e.first.first, e.first.second);
    std::sort(edges.begin(), edges.end(), [](const auto& a, const auto& b) {
        if (a.second != b.second) return a.second < b.second;
        return a.first < b.first;
    });
    was.clear();
    for (auto& e : edges) {
        if (was.count(e.first.second)) continue;
        g.out[e.first.first].push_back({e.first.second, e.second});
        was.insert(e.first.second);
    }
}

// Conservative superset of the nodes mst_pop(beg) can read or mutate, on
// the CURRENT graph: every node within true shortest-path distance
// max_offset of beg, plus their out-neighbors.  Because a pop only removes
// edges (re-adds are a subset of removals), later graphs are edge-subsets
// of earlier ones, so a footprint computed up front stays a superset for
// the whole pass — the basis for running seeds with disjoint footprints in
// parallel while reproducing the sequential (seed-id-ascending) semantics
// exactly.  (The reference runs these seeds racily under node locks,
// GraphSimplifier.cpp:375-396 — ours is deterministic.)
void mst_footprint(const Adj& g, int beg, int max_offset,
                   vector<int>& out_nodes) {
    std::unordered_map<int,int> d;
    std::priority_queue<pair<int,int>, vector<pair<int,int>>,
                        std::greater<pair<int,int>>> pq;
    d[beg] = 0;
    pq.push({0, beg});
    std::unordered_set<int> foot;
    foot.insert(beg);
    while (!pq.empty()) {
        auto top = pq.top(); pq.pop();
        int dd = top.first, a = top.second;
        auto it = d.find(a);
        if (it == d.end() || dd > it->second) continue;
        if (dd > max_offset) continue;
        foot.insert(a);
        for (auto& pr : g.out[a]) {
            foot.insert(pr.first);
            int nd = dd + pr.second;
            auto jt = d.find(pr.first);
            if (jt == d.end() || nd < jt->second) {
                d[pr.first] = nd;
                pq.push({nd, pr.first});
            }
        }
    }
    out_nodes.assign(foot.begin(), foot.end());
}

// removeShortParallelPaths (ref GraphSimplifier.cpp:351-518): seeds are
// nodes with outdeg >= 2 within the WorkloadManager coverage (blocks=50*T,
// ref :375).  Parallel execution in waves: seeds whose footprints are
// disjoint run concurrently; a seed sharing any node with an earlier seed
// is deferred to a later wave, so every conflicting pair executes in seed
// order — bit-identical to the sequential pass (parity-tested in
// tests/test_native.py).
void mst_pass(Adj& g, int64_t nseeds_range, int max_offset, int threads) {
    vector<int> seed_ids;
    for (int64_t beg = 0; beg < nseeds_range; beg++)
        if (g.out[beg].size() >= 2) seed_ids.push_back((int)beg);
    int64_t ns = (int64_t)seed_ids.size();
    if (ns == 0) return;
    if (force_seq() || resolve_threads(threads) == 1 || ns < 64) {
        for (int beg : seed_ids)
            if (g.out[beg].size() >= 2) mst_pop(g, beg, max_offset);
        return;
    }
    vector<vector<int>> foot(ns);
    parallel_ranges(ns, threads, [&](int, int64_t a, int64_t b) {
        for (int64_t i = a; i < b; i++)
            mst_footprint(g, seed_ids[i], max_offset, foot[i]);
    }, 64);
    // wave layering: wave(j) = 1 + max wave of earlier seeds sharing a node
    vector<int> node_wave(g.n, -1);
    vector<int> wave(ns, 0);
    int maxw = 0;
    for (int64_t i = 0; i < ns; i++) {
        int w = 0;
        for (int v : foot[i]) w = std::max(w, node_wave[v] + 1);
        wave[i] = w;
        if (w > maxw) maxw = w;
        for (int v : foot[i]) node_wave[v] = w;
    }
    vector<vector<int>> byw(maxw + 1);
    for (int64_t i = 0; i < ns; i++) byw[wave[i]].push_back(seed_ids[i]);
    for (auto& ws : byw) {
        parallel_ranges((int64_t)ws.size(), threads,
                        [&](int, int64_t a, int64_t b) {
            for (int64_t i = a; i < b; i++) {
                int beg = ws[i];
                if (g.out[beg].size() >= 2) mst_pop(g, beg, max_offset);
            }
        }, 64);
    }
}

// removeDanglingBranchesFromNode (ref GraphSimplifier.cpp:725-808)
void dangling_from_seed(const Adj& g, int seed, int max_offset,
                        vector<pair<int,int>>& edges_out) {
    vector<pair<int,int>> branch_ends;
    std::unordered_map<int,int> par;
    std::unordered_set<int> was;
    par[seed] = seed;
    for (auto& pr : g.out[seed]) {
        int v = pr.first;
        par[v] = seed;               // unconditional overwrite (ref :739)
        was.insert(v);
        int offset = pr.second;
        while (g.out[v].size() == 1) {
            int son = g.out[v][0].first;
            if (was.count(son)) break;
            was.insert(son);
            par[son] = v;
            offset += g.out[v][0].second;
            v = son;
            if (offset > max_offset) break;
        }
        if (g.out[v].empty() && offset <= max_offset)
            branch_ends.push_back({offset, v});
    }
    std::sort(branch_ends.begin(), branch_ends.end());
    int div = (branch_ends.size() == g.out[seed].size()) ? 1 : 0;
    for (int i = 0; i < (int)branch_ends.size() - div; i++) {
        int v = branch_ends[i].second;
        while (v != seed) {
            edges_out.push_back({par[v], v});
            v = par[v];
        }
    }
}

// WorkloadManager::parallelBlockExecution coverage quirk
// (ref WorkloadManager.cpp:12-43): returns the processed PREFIX length of
// [0, count) — the last item is dropped whenever the clamped block count
// divides count-1, and a single-item range is skipped entirely.
int64_t workload_covered(int64_t count, int64_t blocks) {
    if (count <= 0) return 0;
    int64_t n0 = count - 1;
    int64_t b = blocks < 1 ? 1 : blocks;
    if (b > n0) b = n0;
    if (b == 0) return 0;
    int64_t w = (n0 + b - 1) / b;
    return std::min(b * w - 1, n0) + 1;
}

// `rev` is the maintained reverse graph (same edge set, flipped): removals
// are mirrored into it so the dangling loop never rebuilds a reversal —
// the reference reverses the whole graph in place twice per iteration
// (GraphSimplifier.cpp:811-820); edge-set-wise the two are identical and
// every pass re-canonicalizes adjacency order before reading it.
int64_t remove_dangling(Adj& g, Adj& rev, int max_offset, int threads) {
    // bug-compatible reference semantics (GraphSimplifier.cpp:577-723):
    // neighbor-ascending adjacency, WorkloadManager seed coverage
    // (blocks=10*T, ref :641), collected edges sort+unique'd then
    // std::random_shuffle'd with the never-seeded glibc rand() stream
    // (ref :677) and truncated by the removal WorkloadManager coverage
    // (blocks=3*T, ref :679).  Seed collection is read-only on the frozen
    // graph and thread-parallel; the sort+unique below canonicalizes the
    // merged list, so the per-thread collection order is irrelevant.
    g.sort_by_neighbor();
    int64_t seeds = workload_covered(g.n, 10LL * threads);
    int T = resolve_threads(threads);
    vector<vector<pair<int,int>>> bufs(T);
    parallel_ranges(seeds, threads, [&](int t, int64_t a, int64_t b) {
        for (int64_t seed = a; seed < b; seed++)
            if (g.out[seed].size() >= 2)
                dangling_from_seed(g, (int)seed, max_offset, bufs[t]);
    });
    vector<pair<int,int>> to_remove;
    for (auto& buf : bufs)
        to_remove.insert(to_remove.end(), buf.begin(), buf.end());
    std::sort(to_remove.begin(), to_remove.end());
    to_remove.erase(std::unique(to_remove.begin(), to_remove.end()), to_remove.end());
    // libstdc++ std::random_shuffle (bits/stl_algo.h): rand() % (i+1)
    for (size_t i = 1; i < to_remove.size(); i++)
        std::swap(to_remove[i], to_remove[rand() % (i + 1)]);
    int64_t keep = workload_covered((int64_t)to_remove.size(), 3LL * threads);
    int64_t removed = 0;
    for (int64_t i = 0; i < keep; i++)
        if (g.remove_edge(to_remove[i].first, to_remove[i].second)) {
            rev.remove_edge(to_remove[i].second, to_remove[i].first);
            removed++;
        }
    return removed;
}

void mark_isolated(const Adj& g, uint8_t* valid) {
    vector<char> has(g.n, 0);
    for (int a = 0; a < g.n; a++) {
        if (!g.out[a].empty()) has[a] = 1;
        for (auto& pr : g.out[a]) has[pr.first] = 1;
    }
    for (int a = 0; a < g.n; a++)
        if (!has[a]) valid[a] = 0;
}

double avg_read_length(int n, const int32_t* lengths, const uint8_t* valid) {
    double s = 0; int64_t c = 0;
    for (int i = 0; i < n; i++)
        if (valid[i]) { s += lengths[i]; c++; }
    return c ? s / c : 0.0;
}

}  // namespace

extern "C" {

// simplifyGraphOld (ref GraphSimplifier.cpp:85-226, GCPS default path).
// valid[] is updated in place at the reference's removeIsolatedReads points.
// Returns number of surviving edges written to out_* (capacity = ne).
int64_t alga_simplify_graph_old(
    int32_t n, int64_t ne, const int32_t* src, const int32_t* dst,
    const int32_t* off, uint8_t* valid, const int32_t* read_lengths,
    int32_t mopp, int32_t modb, int32_t threads,
    int32_t* out_src, int32_t* out_dst, int32_t* out_off) {
    // the reference's rand() stream: never seeded (= seed 1), consumed
    // only by the dangling-removal shuffles
    srand(1);
    Adj g;
    g.init(n, ne, src, dst, off);
    g.sort_by_offset();

    cut_triangles(g, mopp, threads);
    mark_isolated(g, valid);
    double avg = avg_read_length(n, read_lengths, valid);

    // each sequential pass starts from freshly (offset, dst)-sorted
    // adjacency — matching the Python twin's canonicalization (which is
    // byte-parity-validated against the reference)
    int mopp_scaled = (int)((double)(mopp * avg) / (float)100);
    g.sort_by_offset();
    // seed coverage: WorkloadManager blocks=50*T (ref :375)
    mst_pass(g, workload_covered(n, 50LL * threads), mopp_scaled, threads);
    mark_isolated(g, valid);
    g.retain_min_offset();

    int modb_scaled = (int)((double)(modb * avg) / (float)100);
    int iterations = 0;
    {
        Adj rev = g.reversed();     // maintained incrementally from here on
        while (true) {
            int64_t removed = remove_dangling(g, rev, modb_scaled, threads);
            // upper branches = the same pass on the reverse graph
            // (ref :811-820), removals mirrored back
            removed += remove_dangling(rev, g, modb_scaled, threads);
            iterations++;
            if (removed == 0) break;
            if (iterations >= 16 && removed <= 30) break;  // ref :212-214
        }
    }
    mark_isolated(g, valid);
    // canonical (src, offset, dst) exit order — twin-parity with the Python
    // path (see simplify.simplify_graph_old), matching the reference's
    // immediate post-simplifier sort (retainOnlySmallestOffset, main.cpp:416)
    g.sort_by_offset();
    return g.dump(out_src, out_dst, out_off);
}

// removeShortParallelPaths alone (ref GraphSimplifier.cpp:351-518), for
// orchestrators that run the other passes elsewhere (the sharded device
// simplifier keeps triangles/retain/dangling on the mesh and calls this
// for the one pointer-surgery pass that stays on the host).  Input edges
// must already be in the caller's canonical order; output is the exact
// post-pass adjacency dump in (src, offset, dst) sorted order.
// Apply an explicit pop plan (the mesh-discovered wave order of
// parallel/sharded_simplify.mst_pass_sharded): the host does only the
// O(changes) edge surgery, in C (VERDICT r4 item 9).
int64_t alga_mst_pops(
    int32_t n, int64_t ne, const int32_t* src, const int32_t* dst,
    const int32_t* off, const int32_t* seeds, int64_t ns,
    int32_t mopp_scaled,
    int32_t* out_src, int32_t* out_dst, int32_t* out_off) {
    Adj g;
    g.init(n, ne, src, dst, off);
    g.sort_by_offset();
    for (int64_t i = 0; i < ns; i++) {
        int beg = seeds[i];
        if (g.out[beg].size() >= 2) mst_pop(g, beg, mopp_scaled);
    }
    g.sort_by_offset();
    return g.dump(out_src, out_dst, out_off);
}

int64_t alga_mst_pass(
    int32_t n, int64_t ne, const int32_t* src, const int32_t* dst,
    const int32_t* off, int32_t mopp_scaled, int32_t threads,
    int32_t* out_src, int32_t* out_dst, int32_t* out_off) {
    Adj g;
    g.init(n, ne, src, dst, off);
    g.sort_by_offset();
    mst_pass(g, workload_covered(n, 50LL * threads), mopp_scaled, threads);
    g.sort_by_offset();
    return g.dump(out_src, out_dst, out_off);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Contraction + contig walk (ref Graph::contractPath Graph.cpp:390-469,
// GraphSimplifier::{simplifyGraph,contractPathNodes} GraphSimplifier.cpp:
// 49-82,823-958, ContigCreatorSinglePath.cpp)

namespace {

struct CGraph {
    Adj g;
    // cedges[a][c] = interior hops [(n1,w1),...,(c,wk)]
    vector<std::unordered_map<int, vector<pair<int,int>>>> ced;

    void init_from(Adj&& a) {
        g = std::move(a);
        ced.assign(g.n, {});
    }

    int find_weight(int a, int b) const {
        for (auto& pr : g.out[a]) if (pr.first == b) return pr.second;
        return -1;
    }
    bool contains_edge(int a, int b) const { return find_weight(a, b) >= 0; }
    bool contains_edge_ge(int a, int b, int t) const {
        for (auto& pr : g.out[a]) if (pr.first == b && pr.second >= t) return true;
        return false;
    }
    bool remove_edge(int a, int b) {
        ced[a].erase(b);                    // ref Graph.cpp:98-102
        return g.remove_edge(a, b);
    }
    void add_edge_min(int a, int b, int offset) {   // ref Graph.cpp:53-71
        if (a == b) return;
        for (auto& pr : g.out[a])
            if (pr.first == b) { if (offset < pr.second) pr.second = offset; return; }
        g.out[a].push_back({b, offset});
    }
    vector<pair<int,int>> path(int a, int b) const {  // ref Graph.cpp:486-497
        auto it = ced[a].find(b);
        if (it != ced[a].end() && !it->second.empty()) return it->second;
        int w = find_weight(a, b);
        if (w >= 0) return {{b, w}};
        return {};
    }

    bool contract_path(int a, int b, int c, int threshold) {  // ref :390-469
        if (a == c) return false;
        if (g.out[b].size() != 1) return false;
        int wab = find_weight(a, b);
        if (wab < 0) return false;
        int wbc = g.out[b][0].second;
        int wabc = wab + wbc;
        bool exists_ac = contains_edge(a, c);
        if (exists_ac && wabc >= threshold) return false;
        if (contains_edge_ge(a, c, threshold)) return false;

        vector<pair<int,int>> path_ab, path_bc;
        {
            auto it = ced[a].find(b);
            if (it != ced[a].end() && !it->second.empty()) { path_ab = std::move(it->second); ced[a].erase(it); }
            else path_ab = {{b, wab}};
        }
        {
            auto it = ced[b].find(c);
            if (it != ced[b].end() && !it->second.empty()) { path_bc = std::move(it->second); ced[b].erase(it); }
            else path_bc = {{c, wbc}};
        }
        remove_edge(a, c);
        path_ab.insert(path_ab.end(), path_bc.begin(), path_bc.end());
        ced[a][c] = std::move(path_ab);
        remove_edge(a, b);
        g.out[b].clear();                   // clearNode (ref Graph.cpp:197-207)
        ced[b].clear();
        add_edge_min(a, c, wabc);
        return true;
    }

    int64_t contract_path_nodes(int threshold) {   // ref GS.cpp:910-958
        vector<char> path_node(g.n, 0);
        {
            vector<int64_t> indeg(g.n, 0);
            for (int a = 0; a < g.n; a++)
                for (auto& pr : g.out[a]) indeg[pr.first]++;
            for (int a = 0; a < g.n; a++)
                path_node[a] = (indeg[a] == 1 && g.out[a].size() == 1);
        }
        int64_t done = 0;
        for (int i = 0; i < g.n; i++) {
            if (path_node[i]) continue;
            size_t j = 0;
            while (j < g.out[i].size()) {
                int b = g.out[i][j].first;
                if (!path_node[b] || g.out[b].size() != 1) { j++; continue; }
                int c = g.out[b][0].first;
                if (i == c) { j++; continue; }
                if (contract_path(i, b, c, threshold)) done++;   // retry slot j
                else j++;
            }
        }
        return done;
    }
};

}  // namespace

extern "C" {

// Contraction stage + contig walk.  Inputs: post-simplifier edges.
// Outputs (preallocated by caller):
//   ctg_indptr  int64[max_contigs+1]
//   ctg_reads   int32[cap_reads]
//   ctg_offs    int32[cap_reads]   (first entry of each contig = -1)
// Returns number of contigs (or -1 if capacity exceeded).
// Paired-end reliable predecessors: paired_offset int8[n] (0/1/2 as in
// Global::pairedReadOffset); pass use_paired=0 for unpaired input.
int64_t alga_contract_and_walk(
    int32_t n, int64_t ne, const int32_t* src, const int32_t* dst,
    const int32_t* off, const uint8_t* valid, const int32_t* read_lengths,
    int32_t mopp, int32_t min_output_length,
    int32_t use_paired, const int8_t* paired_offset, double avg_read_len,
    int32_t min_paired_connections, int32_t max_insert_size,
    int64_t max_contigs, int64_t cap_reads,
    int64_t* ctg_indptr, int32_t* ctg_reads, int32_t* ctg_offs,
    int32_t threads) {

    CGraph cg;
    {
        Adj a;
        a.init(n, ne, src, dst, off);
        cg.init_from(std::move(a));
    }

    // ref main.cpp:412-419 + :429
    for (int x = 0; x < 2; x++) {
        cg.g.retain_min_offset();
        while (true) {   // simplifyGraph (ref GS.cpp:49-82)
            {   // triangles on the contracted graph: parallel collection,
                // sequential removal in node-id order (same as cut_triangles
                // but routed through cg.remove_edge to erase contracted
                // paths, ref Graph.cpp:98-102)
                auto bufs = collect_triangles(cg.g, mopp, threads);
                for (auto& buf : bufs)
                    for (auto& pr : buf) cg.remove_edge(pr.first, pr.second);
            }
            if (cg.contract_path_nodes(mopp) == 0) break;
        }
    }
    cg.g.retain_min_offset();

    // --- reliable predecessors (ref ContigCreatorSinglePath.cpp:268-415) ---
    // read-only on the contracted graph; parallel over node ranges with
    // per-thread maps (key sets are disjoint — one key per node a), merged
    // after the join (reference runs this under P1, CCSP.cpp:292-300)
    std::unordered_map<int, std::unordered_set<int>> reliable;
    if (use_paired) {
        int min_edge_len = (int)avg_read_len * 2;
        Adj grev = cg.g.reversed();
        int T = resolve_threads(threads);
        vector<std::unordered_map<int, std::unordered_set<int>>> rel_bufs(T);
        parallel_ranges(n, threads, [&](int t, int64_t a0, int64_t a1) {
            auto& rel = rel_bufs[t];
            for (int64_t a = a0; a < a1; a++) {
                if (grev.out[a].empty()) continue;
                if (!(cg.g.out[a].size() == 1
                      && cg.g.out[a][0].second >= min_edge_len
                      && grev.out[a].size() >= 1)) continue;
                int b = cg.g.out[a][0].first;
                auto edge_ab = cg.path((int)a, b);
                std::unordered_set<int> beg_of_ab;
                {
                    int d = 0;
                    for (auto& pr : edge_ab) {
                        if (d > max_insert_size) break;
                        d += pr.second;
                        beg_of_ab.insert(pr.first);
                    }
                }
                for (auto& pd : grev.out[a]) {
                    if (pd.second < min_edge_len) continue;
                    auto edge_da = cg.path(pd.first, (int)a);
                    int d = 0, cnt = 0;
                    for (auto it = edge_da.rbegin(); it != edge_da.rend(); ++it) {
                        if (d > max_insert_size) break;
                        d += it->second;
                        int x = it->first;
                        int8_t po = paired_offset[x];
                        int paired = x + (po == 1 ? 2 : po == 2 ? -2 : 0);
                        int paired_rc = paired ^ 1;
                        if (beg_of_ab.count(paired) || beg_of_ab.count(paired_rc)) cnt++;
                    }
                    if (cnt >= min_paired_connections)
                        rel[(int)a].insert(pd.first);
                }
            }
        });
        for (auto& rel : rel_bufs)
            for (auto& kv : rel) reliable[kv.first] = std::move(kv.second);
    }

    // --- walk (ref ContigCreatorSinglePath.cpp:21-210) ---------------------
    // read-only on cg + reliable; parallel over contiguous seed ranges with
    // per-thread buffers concatenated in range order, so contig order is
    // identical to the sequential walk (ref walks via futures per node
    // range, CCSP.cpp:60-100 — same split shape)
    struct WalkBuf {
        vector<int64_t> sizes;           // reads per emitted contig
        vector<pair<int,int>> reads;     // flattened (read, offset)
    };
    int T = resolve_threads(threads);
    vector<WalkBuf> wbufs(T);
    parallel_ranges(n, threads, [&](int t, int64_t b0, int64_t b1) {
        auto& wb = wbufs[t];
        for (int64_t beg = b0; beg < b1; beg++) {
            if (!valid[beg] || cg.g.out[beg].empty()) continue;
            for (auto& e0 : cg.g.out[beg]) {
                vector<pair<int,int>> reads_in;   // (read, offset)
                reads_in.push_back({(int)beg, -1});
                std::unordered_set<int> was{(int)beg};
                int predecessor = (int)beg;
                int p = e0.first;
                int64_t length_so_far = 0;
                auto expand = [&](int a, int b) {
                    for (auto& hop : cg.path(a, b)) {
                        reads_in.push_back(hop);
                        length_so_far += hop.second;
                    }
                };
                expand((int)beg, p);
                was.insert(p);

                auto candidates = [&](int pred, int node) -> const vector<pair<int,int>>* {
                    auto it = reliable.find(node);
                    if (it != reliable.end() && it->second.count(pred))
                        return &cg.g.out[node];
                    return nullptr;
                };

                auto cands = candidates(predecessor, p);
                size_t can_be_next = cands ? cands->size() : 0;
                if (can_be_next == 1) {
                    int nxt = (*cands)[0].first;
                    expand(p, nxt);
                    predecessor = p; p = nxt;
                }
                while (can_be_next == 1) {
                    was.insert(p);
                    cands = candidates(predecessor, p);
                    can_be_next = cands ? cands->size() : 0;
                    if (can_be_next == 1) {
                        int nxt = (*cands)[0].first;
                        expand(p, nxt);
                        predecessor = p; p = nxt;
                    }
                    if (p == -1 || was.count(p)) break;
                }
                int64_t total_len = length_so_far + read_lengths[p];
                if (total_len >= min_output_length) {
                    wb.sizes.push_back((int64_t)reads_in.size());
                    wb.reads.insert(wb.reads.end(), reads_in.begin(),
                                    reads_in.end());
                }
            }
        }
    });

    int64_t nc = 0;
    int64_t rpos = 0;
    ctg_indptr[0] = 0;
    for (auto& wb : wbufs) {
        size_t rp = 0;
        for (int64_t sz : wb.sizes) {
            if (nc >= max_contigs || rpos + sz > cap_reads) return -1;
            for (int64_t j = 0; j < sz; j++, rp++) {
                ctg_reads[rpos] = wb.reads[rp].first;
                ctg_offs[rpos] = wb.reads[rp].second;
                rpos++;
            }
            ctg_indptr[++nc] = rpos;
        }
    }
    return nc;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Per-column consensus voting (ref Contig::correctSnipsInContig,
// src/DataStructures/Contig.cpp:33-92): majority per column (ties -> lowest
// base code), then trim both ends while support <= 3.

extern "C" {

// Packed-store variant: reads bases straight from the 2-bit packed words
// (16 bases/uint32, little-endian pairs — ref Read.cpp:40-68) so the
// caller never materializes the uint8[N, L] code matrix (the reference
// streams per-read at ~25 B/100 bp, ref Read.cpp:40-68; this keeps the
// rebuild's consensus at the same memory footprint).
void alga_consensus_packed(
    int64_t n_contigs, const int64_t* ctg_indptr,
    const int32_t* ctg_reads, const int32_t* ctg_offs,
    const uint32_t* packed, int64_t words, const int32_t* read_lengths,
    const int64_t* ctg_col_base,
    int32_t coverage_thr,
    uint8_t* out_bases, int64_t* out_begin, int64_t* out_end,
    int32_t nthreads) {

    auto job = [&](int /*t*/, int64_t c0, int64_t c1) {
        std::vector<int32_t> counts;
        for (int64_t c = c0; c < c1; c++) {
            int64_t col0 = ctg_col_base[c];
            int64_t ncols = ctg_col_base[c + 1] - col0;
            counts.assign((size_t)ncols * 4, 0);
            int64_t start = 0;
            for (int64_t e = ctg_indptr[c]; e < ctg_indptr[c + 1]; e++) {
                int32_t rid = ctg_reads[e];
                int32_t off = ctg_offs[e];
                if (e > ctg_indptr[c]) start += off;
                const uint32_t* row = packed + (int64_t)rid * words;
                int64_t l = read_lengths[rid];
                if (start + l > ncols) l = ncols - start;
                int32_t* cc = counts.data() + (size_t)start * 4;
                for (int64_t j = 0; j < l; j++) {
                    uint32_t b = (row[j >> 4] >> (2 * (j & 15))) & 3u;
                    cc[j * 4 + b]++;
                }
            }
            int64_t p = 0, q = ncols - 1;
            for (int64_t j = 0; j < ncols; j++) {
                const int32_t* cj = counts.data() + (size_t)j * 4;
                int best = 0;
                for (int b = 1; b < 4; b++) if (cj[b] > cj[best]) best = b;
                out_bases[col0 + j] = (uint8_t)best;
            }
            auto freq = [&](int64_t j) {
                const int32_t* cj = counts.data() + (size_t)j * 4;
                int32_t m = cj[0];
                for (int b = 1; b < 4; b++) if (cj[b] > m) m = cj[b];
                return m;
            };
            while (p <= q && freq(p) <= coverage_thr) p++;
            while (p <= q && freq(q) <= coverage_thr) q--;
            out_begin[c] = p;
            out_end[c] = q + 1;
        }
    };
    parallel_ranges(n_contigs, nthreads, job, 64);
}

// contigs given as flattened read lists; codes is the unpacked base matrix.
// Outputs, per contig: out_begin/out_end (kept column range, begin>end if
// empty) and the winning base codes written into out_bases at the contig's
// column base offsets (caller slices).
void alga_consensus(
    int64_t n_contigs, const int64_t* ctg_indptr,
    const int32_t* ctg_reads, const int32_t* ctg_offs,
    const uint8_t* codes, int64_t codes_stride, const int32_t* read_lengths,
    const int64_t* ctg_col_base,       // [n_contigs+1] column offsets
    int32_t coverage_thr,
    uint8_t* out_bases,                // [total_columns]
    int64_t* out_begin, int64_t* out_end) {

    int64_t total_cols = ctg_col_base[n_contigs];
    std::vector<int32_t> counts;       // per contig, reused
    for (int64_t c = 0; c < n_contigs; c++) {
        int64_t col0 = ctg_col_base[c];
        int64_t ncols = ctg_col_base[c + 1] - col0;
        counts.assign((size_t)ncols * 4, 0);
        int64_t start = 0;
        for (int64_t e = ctg_indptr[c]; e < ctg_indptr[c + 1]; e++) {
            int32_t rid = ctg_reads[e];
            int32_t off = ctg_offs[e];
            if (e > ctg_indptr[c]) start += off;
            const uint8_t* row = codes + (int64_t)rid * codes_stride;
            int64_t l = read_lengths[rid];
            if (start + l > ncols) l = ncols - start;
            int32_t* cc = counts.data() + (size_t)start * 4;
            for (int64_t j = 0; j < l; j++) cc[j * 4 + row[j]]++;
        }
        // majority + trim
        int64_t p = 0, q = ncols - 1;
        for (int64_t j = 0; j < ncols; j++) {
            const int32_t* cj = counts.data() + (size_t)j * 4;
            int best = 0;
            for (int b = 1; b < 4; b++) if (cj[b] > cj[best]) best = b;
            out_bases[col0 + j] = (uint8_t)best;
        }
        auto freq = [&](int64_t j) {
            const int32_t* cj = counts.data() + (size_t)j * 4;
            int32_t m = cj[0];
            for (int b = 1; b < 4; b++) if (cj[b] > m) m = cj[b];
            return m;
        };
        while (p <= q && freq(p) <= coverage_thr) p++;
        while (p <= q && freq(q) <= coverage_thr) q--;
        out_begin[c] = p;
        out_end[c] = q + 1;
    }
    (void)total_cols;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// GCPS graph assembly from the device join's match list (the order-free
// reformulation of ref GraphCreatorPrefSuf.cpp:73-488; semantics identical
// to alga_tpu/graph/prefsuf.py::build_gcps_graph, which is the oracle):
//   1. regime-1 ring survivors: per source, last `soes` matches with
//      ell < rsoe in (ell, dst) arrival order;
//   2. per (src, dst) pair the max-ell instance wins;
//   3. an edge (A->C, offA) is removed iff some regime-2 match (B->C, offB)
//      with a later (ell, src) stamp dominates it:
//        offB > 0, offA >= offB, A != B, lenB + (offA-offB) - lenA >= 0,
//        A[offA-offB : offA] == B[0 : offB]   (packed 2-bit compare).

namespace {

// A[a_start + t] == B[t] for t < len, on 2-bit packed rows (16 bases/word)
inline bool packed_substr_eq(const uint32_t* pa, const uint32_t* pb,
                             int64_t words, int a_start, int len) {
    if (len <= 0) return true;
    int sw = a_start >> 4;
    int sb = (a_start & 15) * 2;
    int w = 0;
    int remaining = len;
    while (remaining > 0) {
        uint32_t lo = (sw + w < words) ? pa[sw + w] : 0u;
        uint32_t hi = (sw + w + 1 < words) ? pa[sw + w + 1] : 0u;
        uint32_t a_word = sb ? ((lo >> sb) | (hi << (32 - sb))) : lo;
        uint32_t b_word = (w < words) ? pb[w] : 0u;
        uint32_t diff = a_word ^ b_word;
        int take = remaining >= 16 ? 16 : remaining;
        uint32_t mask = take >= 16 ? 0xFFFFFFFFu : ((1u << (take * 2)) - 1u);
        if (diff & mask) return false;
        remaining -= take;
        w++;
    }
    return true;
}

struct MatchRec { int32_t src, dst, ell; };

// 2-way parallel sort (split + std::sort halves + inplace_merge): the
// flagship config sorts 51M match records four times in gcps_from_matches
// — single-threaded std::sort left a core idle for ~20s.
template <typename T, typename Cmp>
static void par_sort(std::vector<T>& v, Cmp cmp) {
    size_t n = v.size();
    if (force_seq() || n < (1 << 16)) {
        std::sort(v.begin(), v.end(), cmp);
        return;
    }
    size_t mid = n / 2;
    std::thread th([&] { std::sort(v.begin(), v.begin() + mid, cmp); });
    std::sort(v.begin() + mid, v.end(), cmp);
    th.join();
    std::inplace_merge(v.begin(), v.begin() + mid, v.end(), cmp);
}

}  // namespace

extern "C" {

int64_t alga_gcps_from_matches(
    int32_t n, int64_t nm, const int32_t* msrc, const int32_t* mdst,
    const int32_t* mell,
    const uint32_t* packed, int64_t words, const int32_t* lengths,
    int32_t rsoe, int32_t soes,
    int32_t* out_src, int32_t* out_dst, int32_t* out_off,
    int64_t* out_domination_checks) {
    int64_t dom_checks = 0;

    // --- regime split ------------------------------------------------------
    std::vector<MatchRec> r1, r2;
    r1.reserve(nm / 4);
    r2.reserve(nm);
    for (int64_t i = 0; i < nm; i++) {
        if (mell[i] < rsoe) r1.push_back({msrc[i], mdst[i], mell[i]});
        else r2.push_back({msrc[i], mdst[i], mell[i]});
    }

    // regime-1 ring: sort (src, ell, dst); keep last `soes` per src
    par_sort(r1, [](const MatchRec& a, const MatchRec& b) {
        if (a.src != b.src) return a.src < b.src;
        if (a.ell != b.ell) return a.ell < b.ell;
        return a.dst < b.dst;
    });
    std::vector<MatchRec> inst;
    inst.reserve(r1.size() / 2 + r2.size());
    {
        size_t i = 0;
        while (i < r1.size()) {
            size_t j = i;
            while (j < r1.size() && r1[j].src == r1[i].src) j++;
            size_t from = (j - i > (size_t)soes) ? j - soes : i;
            for (size_t t = from; t < j; t++) inst.push_back(r1[t]);
            i = j;
        }
    }
    for (auto& m : r2) inst.push_back(m);

    // --- per-pair max-ell --------------------------------------------------
    par_sort(inst, [](const MatchRec& a, const MatchRec& b) {
        if (a.src != b.src) return a.src < b.src;
        if (a.dst != b.dst) return a.dst < b.dst;
        return a.ell < b.ell;
    });
    std::vector<MatchRec> pairs;
    pairs.reserve(inst.size());
    for (size_t i = 0; i < inst.size(); i++) {
        if (i + 1 == inst.size() || inst[i].src != inst[i + 1].src
            || inst[i].dst != inst[i + 1].dst)
            pairs.push_back(inst[i]);
    }

    // --- domination pruning ------------------------------------------------
    // removers = ALL regime-2 matches grouped by dst, sorted (dst, ell, src)
    par_sort(r2, [](const MatchRec& a, const MatchRec& b) {
        if (a.dst != b.dst) return a.dst < b.dst;
        if (a.ell != b.ell) return a.ell < b.ell;
        return a.src < b.src;
    });
    // pairs grouped by dst too
    par_sort(pairs, [](const MatchRec& a, const MatchRec& b) {
        if (a.dst != b.dst) return a.dst < b.dst;
        return a.src < b.src;
    });

    int64_t e = 0;
    size_t rp = 0;
    for (size_t i = 0; i < pairs.size(); i++) {
        int32_t C = pairs[i].dst;
        while (rp < r2.size() && r2[rp].dst < C) rp++;
        size_t r_end = rp;
        while (r_end < r2.size() && r2[r_end].dst == C) r_end++;

        const MatchRec& a = pairs[i];
        int32_t lenA = lengths[a.src];
        int32_t offA = lenA - a.ell;
        // telemetry parity with the device path's exp_total: every
        // (pair, same-dst remover) combination counts as one check
        dom_checks += (int64_t)(r_end - rp);
        bool removed = false;
        for (size_t r = rp; r < r_end && !removed; r++) {
            const MatchRec& b = r2[r];
            bool later = (b.ell > a.ell) || (b.ell == a.ell && b.src > a.src);
            if (!later || b.src == a.src) continue;
            int32_t lenB = lengths[b.src];
            int32_t offB = lenB - b.ell;
            if (offB <= 0 || offA < offB) continue;
            if (lenB + (offA - offB) - lenA < 0) continue;
            if (packed_substr_eq(packed + (int64_t)a.src * words,
                                 packed + (int64_t)b.src * words,
                                 words, offA - offB, offB))
                removed = true;
        }
        if (!removed) {
            out_src[e] = a.src;
            out_dst[e] = a.dst;
            out_off[e] = offA;
            e++;
        }
    }
    if (out_domination_checks) *out_domination_checks = dom_checks;
    return e;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Read preprocessing + 2-bit packing (ref src/IO/InputReader.cpp:272-391):
// the reference preprocesses each read inline while T threads stride the
// input file — trim (ref :298-303), N filter (ref :317-336), short-tandem-
// repeat drop via KMP MinPeriod (ref :341-353, MyUtils.h:160-171) — then
// packs into Bitset words (Read.cpp:40-68) and appends the reverse
// complement (ref :363-377).  Here the whole per-read chain is fused into
// one multithreaded pass from the raw ASCII byte matrix straight to the
// interleaved [rc, fwd] packed-word rows of the SeqBatch; the Python twin
// (alga_tpu/io/fastx.py::preprocess_reads + packing) remains the
// differential-test oracle.

#include <thread>

extern "C" {

// raw: uint8[m, lpad] ASCII; fwd output row of read i = out_base + out_step*i,
// its reverse complement at that row - 1.  out_packed: uint32[nrows, wpad]
// (zero-initialized by caller), out_lengths int32[nrows], out_dropped
// uint8[nrows].  Only used when remove_n is true (the N-randomization path
// stays in Python where the RNG lives).
void alga_preprocess_pack(
    const uint8_t* raw, int64_t m, int64_t lpad, const int64_t* raw_lens,
    int32_t trim_left, int32_t trim_right, int32_t rna,
    int32_t str_period,
    int64_t out_base, int64_t out_step, int64_t wpad,
    uint32_t* out_packed, int32_t* out_lengths, uint8_t* out_dropped,
    int32_t nthreads) {

    // byte -> 2-bit code (uppercase only, everything else 0 = 'A', matching
    // fastx.preprocess_reads' LUT; ref Params::getNukl Params.cpp:110-167)
    uint8_t lut[256];
    memset(lut, 0, sizeof lut);
    lut['C'] = 1; lut['G'] = 2; lut['T'] = 3;

    auto job = [&](int64_t i0, int64_t i1) {
        vector<uint8_t> codes((size_t)lpad);
        for (int64_t i = i0; i < i1; i++) {
            int64_t len = raw_lens[i];
            bool do_trim = len >= (int64_t)trim_left + trim_right + 10;
            const uint8_t* s = raw + i * lpad + (do_trim ? trim_left : 0);
            int64_t L = do_trim ? len - trim_left - trim_right : len;

            bool has_n = false;
            for (int64_t j = 0; j < L; j++) {
                uint8_t b = s[j];
                if (rna && b == 'U') b = 'T';
                if (b == 'N') has_n = true;
                codes[j] = lut[b];
            }

            bool dropped = has_n;
            if (!dropped) {
                // min word period <= str_period (degenerate: len <= p)
                for (int32_t p = 1; p <= str_period; p++) {
                    if (p >= L) { dropped = true; break; }
                    int64_t j = 0;
                    while (j < L - p && codes[j] == codes[j + p]) j++;
                    if (j == L - p) { dropped = true; break; }
                }
            }

            int64_t r_fwd = out_base + out_step * i;
            int64_t r_rc = r_fwd - 1;
            out_lengths[r_fwd] = (int32_t)L;
            out_lengths[r_rc] = (int32_t)L;
            out_dropped[r_fwd] = dropped ? 1 : 0;
            out_dropped[r_rc] = dropped ? 1 : 0;

            uint32_t* pf = out_packed + r_fwd * wpad;
            uint32_t* pr = out_packed + r_rc * wpad;
            uint32_t wf = 0, wr = 0;
            for (int64_t j = 0; j < L; j++) {
                wf |= (uint32_t)codes[j] << (2 * (j & 15));
                wr |= (uint32_t)(codes[L - 1 - j] ^ 3) << (2 * (j & 15));
                if ((j & 15) == 15) {
                    pf[j >> 4] = wf;
                    pr[j >> 4] = wr;
                    wf = wr = 0;
                }
            }
            if (L & 15) {
                pf[L >> 4] = wf;
                pr[L >> 4] = wr;
            }
        }
    };

    int T = nthreads > 0 ? nthreads
                         : (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if (T == 1 || m < 4096) {
        job(0, m);
        return;
    }
    vector<std::thread> ths;
    int64_t blk = (m + T - 1) / T;
    for (int t = 1; t < T; t++) {
        int64_t a = t * blk, b = std::min(m, (t + 1) * blk);
        if (a < b) ths.emplace_back(job, a, b);
    }
    job(0, std::min(m, blk));
    for (auto& th : ths) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Parallel FASTX ingest (ref src/IO/InputReader.cpp:272-391): the reference
// opens the input file once per thread and lets thread t parse records
// congruent to t mod T.  Here the whole file is one host buffer and T
// threads scan disjoint line-aligned byte ranges in exactly TWO passes:
//
//   scan: each chunk counts its lines/records and the max sequence length
//         in ONE pass — FASTQ (whose sequence lines are global line index
//         4k+1) counts records and maxlen under all 4 possible chunk
//         phases simultaneously, and the right phase is selected after the
//         cross-chunk line-count prefix sum; per-chunk prefixes are
//         returned as metadata.
//   fill: with the metadata, each chunk writes its sequences straight into
//         the dense byte matrix — no per-record heap allocation.
//
// The Python twin (fastx.read_sequences, a single-threaded line loop
// materializing list[str]) remains the differential oracle.
//
// fmt: 0 = MY_INPUT (one sequence per line), 1 = FASTA ('>' headers,
// multi-line records), 2 = FASTQ (4-line records).  Sequence bytes on each
// line are cut at the first ' ' or '\r' (the twin's
// line.strip().split(" ")[0]).

namespace {

// effective sequence length of line [p, q): cut at first ' ' or '\r'
static inline int64_t fx_cut_len(const uint8_t* buf, int64_t p, int64_t q) {
    const void* sp = memchr(buf + p, ' ', (size_t)(q - p));
    const void* cr = memchr(buf + p, '\r', (size_t)(q - p));
    int64_t e = q;
    if (sp && (const uint8_t*)sp - buf < e) e = (const uint8_t*)sp - buf;
    if (cr && (const uint8_t*)cr - buf < e) e = (const uint8_t*)cr - buf;
    return e - p;
}

static inline int64_t fx_line_end(const uint8_t* buf, int64_t size,
                                  int64_t p) {
    const void* nl = memchr(buf + p, '\n', (size_t)(size - p));
    return nl ? (const uint8_t*)nl - buf : size;
}

static vector<int64_t> fx_chunk_starts(const uint8_t* buf, int64_t size,
                                       int T) {
    vector<int64_t> starts;
    starts.push_back(0);
    for (int t = 1; t < T; t++) {
        int64_t p = size * t / T;
        const void* nl = memchr(buf + p, '\n', (size_t)(size - p));
        int64_t s = nl ? (const uint8_t*)nl - buf + 1 : size;
        if (s > starts.back() && s < size) starts.push_back(s);
    }
    return starts;
}

// FASTA record walk shared by scan and fill: calls fn(line_begin, cut_len)
// for each sequence line of the run starting at rp; returns true if the
// run has >= 1 line (twin emits a record even if all lines are empty).
template <class F>
static inline bool fx_fasta_run(const uint8_t* buf, int64_t size,
                                int64_t rp, F&& fn) {
    bool any = false;
    while (rp < size) {
        int64_t rq = fx_line_end(buf, size, rp);
        if (rq > rp && buf[rp] == '>') break;
        any = true;
        fn(rp, fx_cut_len(buf, rp, rq));
        rp = rq + 1;
    }
    return any;
}

struct FxScan {
    int64_t lines = 0;
    int64_t recs[4] = {0, 0, 0, 0};     // per chunk phase (FASTQ); [0] else
    int64_t maxlen[4] = {0, 0, 0, 0};
};

static FxScan fx_scan_chunk(const uint8_t* buf, int64_t size, int fmt,
                            int64_t begin, int64_t end, bool first_chunk) {
    FxScan o;
    int64_t p = begin;
    if (fmt == 2) {  // FASTQ: bucket by local line index mod 4
        while (p < end) {
            int64_t q = fx_line_end(buf, size, p);
            int b = (int)(o.lines & 3);
            o.recs[b]++;
            int64_t l = fx_cut_len(buf, p, q);
            if (l > o.maxlen[b]) o.maxlen[b] = l;
            o.lines++;
            p = q + 1;
        }
    } else if (fmt == 0) {
        while (p < end) {
            int64_t q = fx_line_end(buf, size, p);
            int64_t l = fx_cut_len(buf, p, q);
            if (l > 0) {
                o.recs[0]++;
                if (l > o.maxlen[0]) o.maxlen[0] = l;
            }
            o.lines++;
            p = q + 1;
        }
    } else {  // FASTA: '>' lines starting in-chunk own the following run
        bool lead = first_chunk;
        while (p < end) {
            int64_t q = fx_line_end(buf, size, p);
            bool hdr = q > p && buf[p] == '>';
            if (hdr || (lead && p == 0 && !hdr)) {
                int64_t rp = hdr ? q + 1 : 0;
                int64_t rl = 0;
                bool any = fx_fasta_run(buf, size, rp,
                                        [&](int64_t, int64_t l) { rl += l; });
                if (any) {
                    o.recs[0]++;
                    if (rl > o.maxlen[0]) o.maxlen[0] = rl;
                }
            }
            lead = false;
            o.lines++;
            p = q + 1;
        }
    }
    return o;
}

// Fill records in [rec_lo, rec_hi) only; output row = rec - rec_lo.  The
// per-process range fill of the multi-host ingest (each process parses the
// whole byte range it scans anyway but WRITES only its own records).
static void fx_fill_chunk(const uint8_t* buf, int64_t size, int fmt,
                          int64_t begin, int64_t end, int64_t lines_before,
                          int64_t recs_before, bool first_chunk,
                          int64_t lpad, uint8_t* out, int64_t* out_lens,
                          int64_t rec_lo, int64_t rec_hi) {
    int64_t p = begin;
    int64_t rec = recs_before;
    auto write = [&](int64_t l, const uint8_t* src) {
        if (rec >= rec_lo && rec < rec_hi) {
            if (l > lpad) l = lpad;
            memcpy(out + (rec - rec_lo) * lpad, src, (size_t)l);
            out_lens[rec - rec_lo] = l;
        }
        rec++;
    };
    if (fmt == 2) {
        int64_t line = lines_before;
        while (p < end) {
            int64_t q = fx_line_end(buf, size, p);
            if ((line & 3) == 1 && rec < rec_hi)
                write(fx_cut_len(buf, p, q), buf + p);
            line++;
            p = q + 1;
        }
    } else if (fmt == 0) {
        while (p < end) {
            int64_t q = fx_line_end(buf, size, p);
            int64_t l = fx_cut_len(buf, p, q);
            if (l > 0 && rec < rec_hi) write(l, buf + p);
            else if (l > 0) rec++;
            p = q + 1;
        }
    } else {
        bool lead = first_chunk;
        while (p < end) {
            int64_t q = fx_line_end(buf, size, p);
            bool hdr = q > p && buf[p] == '>';
            if (hdr || (lead && p == 0 && !hdr)) {
                int64_t rp = hdr ? q + 1 : 0;
                int64_t rl = 0;
                bool in_range = rec >= rec_lo && rec < rec_hi;
                bool any = fx_fasta_run(
                    buf, size, rp, [&](int64_t lp, int64_t l) {
                        if (rl + l > lpad) l = lpad - rl;
                        if (l > 0 && in_range)
                            memcpy(out + (rec - rec_lo) * lpad + rl,
                                   buf + lp, (size_t)l);
                        rl += l;
                    });
                if (any) {
                    if (in_range) out_lens[rec - rec_lo] = rl;
                    rec++;
                }
            }
            lead = false;
            p = q + 1;
        }
    }
}

static int fx_threads(int64_t size, int32_t nthreads) {
    int T = nthreads > 0 ? (int)nthreads
                         : (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if (size < (1 << 20)) T = 1;
    return T;
}

}  // namespace

extern "C" {

// Pass 1: one parallel scan.  Returns record count; sets *out_maxlen and
// fills out_meta (int64[3 * nchunks_cap]: begin, lines_before, recs_before
// per chunk) + *out_nchunks for reuse by alga_fastx_fill.  nchunks_cap
// must be >= the thread count used (pass >= hardware_concurrency).
int64_t alga_fastx_scan(const uint8_t* buf, int64_t size, int32_t fmt,
                        int64_t* out_maxlen, int64_t* out_meta,
                        int64_t nchunks_cap, int64_t* out_nchunks,
                        int32_t nthreads) {
    int T = fx_threads(size, nthreads);
    auto starts = fx_chunk_starts(buf, size, T);
    int C = (int)starts.size();
    if (C > nchunks_cap) C = (int)nchunks_cap;   // never happens in binding
    vector<FxScan> sc(C);
    {
        vector<std::thread> ths;
        auto job = [&](int i) {
            int64_t end = i + 1 < C ? starts[i + 1] : size;
            sc[i] = fx_scan_chunk(buf, size, fmt, starts[i], end, i == 0);
        };
        for (int i = 1; i < C; i++) ths.emplace_back(job, i);
        job(0);
        for (auto& t : ths) t.join();
    }
    int64_t recs = 0, maxlen = 0, lines = 0;
    for (int i = 0; i < C; i++) {
        out_meta[3 * i] = starts[i];
        out_meta[3 * i + 1] = lines;
        out_meta[3 * i + 2] = recs;
        if (fmt == 2) {
            // seq lines are global index 4k+1: with this chunk starting at
            // global line `lines`, the local bucket is (1 - lines) mod 4
            int b = (int)(((1 - lines) % 4 + 4) % 4);
            recs += sc[i].recs[b];
            if (sc[i].maxlen[b] > maxlen) maxlen = sc[i].maxlen[b];
        } else {
            recs += sc[i].recs[0];
            if (sc[i].maxlen[0] > maxlen) maxlen = sc[i].maxlen[0];
        }
        lines += sc[i].lines;
    }
    *out_maxlen = maxlen;
    *out_nchunks = C;
    return recs;
}

// Pass 2: parallel fill of uint8[rec_hi - rec_lo, lpad] (zero-initialized
// by caller) + lengths int64[rec_hi - rec_lo], using the metadata from
// alga_fastx_scan.  [rec_lo, rec_hi) selects a record range — the whole
// file for single-host ingest, this process's slice for multi-host.
void alga_fastx_fill_range(const uint8_t* buf, int64_t size, int32_t fmt,
                           int64_t lpad, uint8_t* out, int64_t* out_lens,
                           int64_t rec_lo, int64_t rec_hi,
                           const int64_t* meta, int64_t nchunks) {
    int C = (int)nchunks;
    vector<std::thread> ths;
    auto job = [&](int i) {
        int64_t end = i + 1 < C ? meta[3 * (i + 1)] : size;
        fx_fill_chunk(buf, size, fmt, meta[3 * i], end, meta[3 * i + 1],
                      meta[3 * i + 2], i == 0, lpad, out, out_lens,
                      rec_lo, rec_hi);
    };
    for (int i = 1; i < C; i++) ths.emplace_back(job, i);
    job(0);
    for (auto& t : ths) t.join();
}

void alga_fastx_fill(const uint8_t* buf, int64_t size, int32_t fmt,
                     int64_t lpad, uint8_t* out, int64_t* out_lens,
                     int64_t n, const int64_t* meta, int64_t nchunks) {
    alga_fastx_fill_range(buf, size, fmt, lpad, out, out_lens, 0, n,
                          meta, nchunks);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PKB branch-marker replay (ref GraphCreatorPairwiseKmerBranch.cpp:16-98):
// the sequential per-run loop that walks candidate pairs of an equal-hash
// k-mer run in canonical order, skipping pairs already reachable through
// edges known so far (the `branchMarkers` Bitset matrix, ref :20-27,67-83)
// and adding min-offset edges.  Alignment verdicts arrive precomputed
// (pair_can — the device ACLER/ACLCS batch), so this is pure bookkeeping:
// a dynamic bitset closure per run + adjacency lookups against the sorted
// base-key array and an overlay hash map.  Semantics identical to
// alga_tpu/graph/supplement.py::_replay_runs (the Python oracle).

extern "C" {

// Returns the number of overlay entries written to out_keys/out_offs
// (capacity must be >= p_in + npairs).  Overlay min-merge semantics match
// SupplementAdj.add_min; get_offset = min(base, overlay) when both exist.
int64_t alga_pkb_replay(
    int64_t nrec, const int32_t* rid_s,
    int64_t npairs, const int32_t* pj, const int32_t* off_all,
    const uint8_t* ok, const uint8_t* can,
    const int64_t* cum,                      // [nrec + 1]
    int64_t nruns, const int64_t* starts, const int64_t* ends,
    int64_t n,                               // node count (key = a*n + b)
    const int64_t* base_keys, const int32_t* base_offs, int64_t nbase,
    const int64_t* in_keys, const int32_t* in_offs, int64_t nin,
    int64_t* out_keys, int32_t* out_offs) {

    std::unordered_map<int64_t, int32_t> overlay;
    overlay.reserve((size_t)(nin + npairs / 4));
    for (int64_t i = 0; i < nin; i++) overlay[in_keys[i]] = in_offs[i];

    const int32_t NONE = INT32_MIN;
    auto get_offset = [&](int64_t a, int64_t b) -> int32_t {
        int64_t k = a * n + b;
        int32_t cur = NONE;
        auto it = overlay.find(k);
        if (it != overlay.end()) cur = it->second;
        const int64_t* lo = std::lower_bound(base_keys, base_keys + nbase, k);
        if (lo != base_keys + nbase && *lo == k) {
            int32_t base = base_offs[lo - base_keys];
            return (cur == NONE || base < cur) ? base : cur;
        }
        return cur;
    };
    auto add_min = [&](int64_t a, int64_t b, int32_t o) {
        int64_t k = a * n + b;
        auto it = overlay.find(k);
        if (it == overlay.end() || o < it->second) overlay[k] = o;
    };

    std::vector<uint64_t> reach;   // (run_len x blocks) bitset, reused
    for (int64_t r = 0; r < nruns; r++) {
        int64_t s = starts[r], e = ends[r];
        if (cum[e] == cum[s]) continue;
        int64_t len = e - s;
        int64_t blocks = (len + 63) >> 6;
        reach.assign((size_t)(len * blocks), 0);
        for (int64_t gi = e - 1; gi >= s; gi--) {
            int64_t p0 = cum[gi], p1 = cum[gi + 1];
            if (p0 == p1) continue;
            int64_t i_local = gi - s;
            uint64_t* ri = reach.data() + i_local * blocks;
            int64_t id1 = rid_s[gi];
            for (int64_t idx = p0; idx < p1; idx++) {
                if (!ok[idx]) continue;
                int64_t j_local = (int64_t)pj[idx] - s;
                if ((ri[j_local >> 6] >> (j_local & 63)) & 1) continue;
                int64_t id2 = rid_s[pj[idx]];
                int32_t o = off_all[idx];
                int32_t cur = get_offset(id1, id2);
                if (cur == NONE || cur > o) {
                    if (can[idx]) {
                        add_min(id1, id2, o);
                        cur = o;
                    }
                }
                if (cur != NONE) {
                    ri[j_local >> 6] |= 1ull << (j_local & 63);
                    const uint64_t* rj = reach.data() + j_local * blocks;
                    for (int64_t b = 0; b < blocks; b++) ri[b] |= rj[b];
                }
            }
        }
    }

    int64_t m = 0;
    for (auto& kv : overlay) {
        out_keys[m] = kv.first;
        out_offs[m] = kv.second;
        m++;
    }
    return m;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Read-corrector fix-up pass (ref src/Corrector/ReadCorrector.cpp:188-294,
// applyCorrectionToRead): the per-read sequential rolling-hash loop with
// spectrum lookups, parallel over reads (each read is independent; the
// spectrum is frozen — as in the reference, which builds the frequency map
// once, ReadCorrector.cpp:96-157, then corrects).  The spectrum arrives as
// (big-hash, small-mer) pairs sorted lexicographically — candidate
// iteration order (small-mer ascending) matches the Python twin's dict
// insertion order (alga_tpu/corrector.py::_correct_one, the oracle).

extern "C" {

int64_t alga_correct_pass(
    uint8_t* codes, int64_t n, int64_t lpad, const int64_t* lengths,
    const uint8_t* valid, const int64_t* sb, const int64_t* ss,
    int64_t npairs, int32_t nthreads) {

    const int SMALLC = 5, BIGC = 30;
    const int64_t MAXH = 1000000000000000003LL;   // ref Params.cpp:721
    const int64_t SMALL_POW = 256;                // 4^(SMALL-1)
    int64_t BIG_POW = 1;                          // 4^(BIG-1)
    for (int i = 0; i < BIGC - 1; i++) BIG_POW *= 4;

    auto correct_row = [&](int64_t r) -> bool {
        int64_t len = lengths[r];
        if (!valid[r] || len < SMALLC + BIGC) return false;
        uint8_t* row = codes + r * lpad;
        bool changed = false;

        int64_t sH = 0;
        for (int i = 0; i < SMALLC; i++) sH = (sH << 2) + row[i];
        int64_t bH = 0;
        for (int i = SMALLC; i < SMALLC + BIGC; i++) {
            bH = (bH << 2) + row[i];
            while (bH >= MAXH) bH -= MAXH;
        }
        int64_t p = SMALLC, q = SMALLC + BIGC;

        auto correct_local = [&](int64_t pp, int64_t sHv) -> int64_t {
            const int64_t* lo = std::lower_bound(sb, sb + npairs, bH);
            if (lo == sb + npairs || *lo != bH) return sHv;
            const int64_t* hi = std::upper_bound(lo, sb + npairs, bH);
            int64_t i0 = lo - sb, i1 = hi - sb;
            if (std::binary_search(ss + i0, ss + i1, sHv)) return sHv;
            int64_t closest = -1;
            int min_dst = 1 << 30;
            for (int64_t t = i0; t < i1; t++) {
                int64_t smer = ss[t];
                int dst = 0;
                bool same_b = true;
                for (int i = 0; i < SMALLC; i++) {
                    int sp = (int)((smer >> (2 * i)) & 3);
                    // mer bit-pair i vs READ position pp-SMALL+i — the
                    // reference's reversed-window comparison quirk
                    // (ref :231-247), write-back at pp-1-i (ref :263)
                    int rp = row[pp - SMALLC + i];
                    if (sp != rp) {
                        dst++;
                        if ((i == 0 || i == SMALLC - 1) && pp > SMALLC) {
                            same_b = false;
                            break;
                        }
                    }
                }
                if (same_b && dst < min_dst) {
                    min_dst = dst;
                    closest = smer;
                }
            }
            if (min_dst > 1 || closest < 0) return sHv;   // MAX_SNPS = 1
            for (int i = 0; i < SMALLC; i++)
                row[pp - 1 - i] = (uint8_t)((closest >> (2 * i)) & 3);
            changed = true;
            return closest;
        };

        sH = correct_local(p, sH);
        while (q < len) {
            sH = ((sH - SMALL_POW * row[p - SMALLC]) << 2) + row[p];
            bH -= BIG_POW * row[q - BIGC];
            if (bH < 0) {
                // (bH + 2^64) mod M: the reference's signed/unsigned quirk
                // (ReadCorrector.cpp:280 — LL bH, ULL modulus)
                bH = (int64_t)((uint64_t)bH % (uint64_t)MAXH);
            }
            bH = (bH << 2) + row[q];
            while (bH >= MAXH) bH -= MAXH;
            p++;
            q++;
            sH = correct_local(p, sH);
        }
        return changed;
    };

    int T = nthreads > 0 ? nthreads
                         : (int)std::thread::hardware_concurrency();
    if (T < 1) T = 1;
    if (n < 4096) T = 1;
    vector<int64_t> counts(T, 0);
    auto job = [&](int t, int64_t a, int64_t b) {
        int64_t c = 0;
        for (int64_t r = a; r < b; r++)
            if (correct_row(r)) c++;
        counts[t] = c;
    };
    if (T == 1) {
        job(0, 0, n);
    } else {
        vector<std::thread> ths;
        int64_t blk = (n + T - 1) / T;
        for (int t = 1; t < T; t++) {
            int64_t a = t * blk, b = std::min(n, (t + 1) * blk);
            if (a < b) ths.emplace_back(job, t, a, b);
        }
        job(0, 0, std::min(n, blk));
        for (auto& th : ths) th.join();
    }
    int64_t total = 0;
    for (auto c : counts) total += c;
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// hash-join range lookup for the GCPS candidate join (replaces the numpy
// searchsorted probes in alga_tpu/graph/prefsuf.py::find_exact_overlaps —
// binary search over a few-million-key table is cache-miss bound at
// ~600 ns/probe; an open-addressed table probes at ~60 ns.  Semantics
// twin: lo = searchsorted(table, key, 'left'), cnt = #equal keys, for a
// SORTED table).  Ref hot loop being replaced: the per-bucket probe of
// GraphCreatorPrefSuf::nextPrefSufIterationJobAddEdges
// (src/GraphCreators/GraphCreatorPrefSuf.cpp:356-488).

namespace joinx {

static inline uint64_t mix64(uint64_t x) {
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return x ^ (x >> 31);
}

}  // namespace joinx

extern "C" {

// table_keys: SORTED uint64[nt]; probe_keys uint64[np]; outputs int64[np].
void alga_join_ranges(const uint64_t* table_keys, int64_t nt,
                      const uint64_t* probe_keys, int64_t np_,
                      int64_t* lo_out, int64_t* cnt_out, int threads) {
    if (nt == 0) {
        for (int64_t i = 0; i < np_; i++) { lo_out[i] = 0; cnt_out[i] = 0; }
        return;
    }
    // distinct runs of the sorted table
    int64_t ndist = 0;
    for (int64_t i = 0; i < nt; i++)
        if (i == 0 || table_keys[i] != table_keys[i - 1]) ndist++;

    uint64_t cap = 1;
    while (cap < (uint64_t)ndist * 2) cap <<= 1;
    const uint64_t mask = cap - 1;
    const uint64_t EMPTY = ~0ull;
    std::vector<uint64_t> slot_key(cap, EMPTY);
    std::vector<int64_t> slot_lo(cap), slot_cnt(cap);

    // EMPTY doubles as a legal key value; a run of key==~0ull (necessarily
    // the LAST run of the sorted table) gets a dedicated fallback entry so
    // lookup semantics exactly match searchsorted (ADVICE r3)
    int64_t empty_lo = 0, empty_cnt = 0;

    for (int64_t i = 0; i < nt;) {
        int64_t j = i;
        while (j < nt && table_keys[j] == table_keys[i]) j++;
        uint64_t k = table_keys[i];
        if (k == EMPTY) {
            empty_lo = i;
            empty_cnt = j - i;
        } else {
            uint64_t h = joinx::mix64(k) & mask;
            while (slot_key[h] != EMPTY) h = (h + 1) & mask;
            slot_key[h] = k;
            slot_lo[h] = i;
            slot_cnt[h] = j - i;
        }
        i = j;
    }

    parallel_ranges(np_, threads, [&](int, int64_t a, int64_t b) {
        for (int64_t i = a; i < b; i++) {
            uint64_t k = probe_keys[i];
            int64_t lo = 0, cnt = 0;
            if (k == EMPTY) {
                lo = empty_lo;
                cnt = empty_cnt;
            } else {
                uint64_t h = joinx::mix64(k) & mask;
                while (slot_key[h] != EMPTY) {
                    if (slot_key[h] == k) {
                        lo = slot_lo[h];
                        cnt = slot_cnt[h];
                        break;
                    }
                    h = (h + 1) & mask;
                }
            }
            lo_out[i] = lo;
            cnt_out[i] = cnt;
        }
    });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// rolling window-hash (native twin of ops/hashes.np_window_kmer_keys +
// combine_keys: h(p) = sum_j c[p+j] * A^(k-1-j) mod 2^32 for both A1/A2,
// combined key = h1 << 32 | h2).  Replaces the jax-CPU scan / numpy
// closed form on host paths (~10x: one multiply-add pass per base).
// Padded positions hash over zero codes — bit-identical to the numpy
// twin even where the caller's valid mask is false.

extern "C" {

void alga_window_hash(const uint8_t* codes, int64_t n, int64_t lpad,
                      int32_t k, int32_t nw, uint32_t a1, uint32_t a2,
                      uint64_t* out, int threads) {
    // A^(k-1)
    uint32_t ak1 = 1, ak2 = 1;
    for (int32_t i = 0; i < k - 1; i++) { ak1 *= a1; ak2 *= a2; }

    parallel_ranges(n, threads, [&](int, int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; r++) {
            const uint8_t* c = codes + r * lpad;
            uint64_t* o = out + r * nw;
            auto at = [&](int64_t i) -> uint32_t {
                return i < lpad ? (uint32_t)c[i] : 0u;
            };
            uint32_t h1 = 0, h2 = 0;
            for (int32_t j = 0; j < k; j++) {
                h1 = h1 * a1 + at(j);
                h2 = h2 * a2 + at(j);
            }
            o[0] = ((uint64_t)h1 << 32) | h2;
            for (int32_t p = 1; p < nw; p++) {
                uint32_t cp = at(p - 1);
                h1 = (h1 - cp * ak1) * a1 + at(p - 1 + k);
                h2 = (h2 - cp * ak2) * a2 + at(p - 1 + k);
                o[p] = ((uint64_t)h1 << 32) | h2;
            }
        }
    }, 64);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// fused GCPS candidate join + packed verification (native twin of the
// probe/expand/verify loop of prefsuf.find_exact_overlaps): for every
// valid window (read B, position p) whose key equals a prefix key run,
// emit (B, C, ell=len_B-p) for each table read C with B != C and
// len_C >= ell and packed-exact equality of B[p:p+ell] vs C[0:ell].
// Replaces the numpy nonzero/repeat/ragged-arange/substr_equal chain
// (the expansion materialized ~8 candidate arrays per chunk).
// Ref hot loop: GraphCreatorPrefSuf::nextPrefSufIterationJobAddEdges
// (src/GraphCreators/GraphCreatorPrefSuf.cpp:356-488).

namespace gcpsjoin {

// Interleaved open-addressed table: ONE 16-byte slot (key, lo<<20|cnt)
// per entry so a probe touches a single cache line, plus an explicit
// prefetch hook — the 16M-config join is DRAM-latency-bound (348M
// probes into a table far beyond LLC; separate key/lo/cnt arrays cost
// 2-3 misses per probe and measured 73s host-side).
struct HashTable2 {
    struct Slot { uint64_t key; uint64_t val; };
    std::vector<Slot> slot;
    uint64_t mask = 0;
    int64_t empty_lo = -1, empty_cnt = 0;
    static constexpr uint64_t CNT_BITS = 24;   // run length < 2^24
    static constexpr uint64_t CNT_MASK = (1ull << CNT_BITS) - 1;

    void build(const uint64_t* tkeys, int64_t nt) {
        int64_t ndist = 0;
        for (int64_t i = 0; i < nt; i++)
            if (i == 0 || tkeys[i] != tkeys[i - 1]) ndist++;
        uint64_t cap = 1;
        while (cap < (uint64_t)ndist * 2 + 2) cap <<= 1;
        mask = cap - 1;
        slot.assign(cap, Slot{~0ull, 0});
        for (int64_t i = 0; i < nt;) {
            int64_t j = i;
            while (j < nt && tkeys[j] == tkeys[i]) j++;
            if (tkeys[i] == ~0ull) {
                empty_lo = i;
                empty_cnt = j - i;
            } else {
                uint64_t h = joinx::mix64(tkeys[i]) & mask;
                while (slot[h].key != ~0ull) h = (h + 1) & mask;
                slot[h].key = tkeys[i];
                slot[h].val = ((uint64_t)i << CNT_BITS) | (uint64_t)(j - i);
            }
            i = j;
        }
    }

    inline void prefetch(uint64_t k) const {
        __builtin_prefetch(&slot[joinx::mix64(k) & mask], 0, 1);
    }

    inline bool find(uint64_t k, int64_t& l, int64_t& c) const {
        if (k == ~0ull) {
            if (empty_lo < 0) return false;
            l = empty_lo;
            c = empty_cnt;
            return true;
        }
        uint64_t h = joinx::mix64(k) & mask;
        while (true) {
            const Slot& s = slot[h];
            if (s.key == k) {
                l = (int64_t)(s.val >> CNT_BITS);
                c = (int64_t)(s.val & CNT_MASK);
                return true;
            }
            if (s.key == ~0ull) return false;
            h = (h + 1) & mask;
        }
    }
};

struct HashTable {
    std::vector<uint64_t> key;
    std::vector<int64_t> lo, cnt;
    uint64_t mask = 0;
    // dedicated fallback for key == ~0ull, which doubles as the empty-slot
    // sentinel (ADVICE r3): the sorted build puts it in the last run
    int64_t empty_lo = -1, empty_cnt = 0;

    void build(const uint64_t* tkeys, int64_t nt) {
        int64_t ndist = 0;
        for (int64_t i = 0; i < nt; i++)
            if (i == 0 || tkeys[i] != tkeys[i - 1]) ndist++;
        uint64_t cap = 1;
        while (cap < (uint64_t)ndist * 2 + 2) cap <<= 1;
        mask = cap - 1;
        key.assign(cap, ~0ull);
        lo.assign(cap, 0);
        cnt.assign(cap, 0);
        for (int64_t i = 0; i < nt;) {
            int64_t j = i;
            while (j < nt && tkeys[j] == tkeys[i]) j++;
            if (tkeys[i] == ~0ull) {
                empty_lo = i;
                empty_cnt = j - i;
            } else {
                uint64_t h = joinx::mix64(tkeys[i]) & mask;
                while (key[h] != ~0ull) h = (h + 1) & mask;
                key[h] = tkeys[i];
                lo[h] = i;
                cnt[h] = j - i;
            }
            i = j;
        }
    }

    inline bool find(uint64_t k, int64_t& l, int64_t& c) const {
        if (k == ~0ull) {
            if (empty_lo < 0) return false;
            l = empty_lo;
            c = empty_cnt;
            return true;
        }
        uint64_t h = joinx::mix64(k) & mask;
        while (key[h] != ~0ull) {
            if (key[h] == k) { l = lo[h]; c = cnt[h]; return true; }
            h = (h + 1) & mask;
        }
        return false;
    }
};

// exact equality of B's bases [p, p+ell) vs C's bases [0, ell) on the
// 2-bit packed rows (little-endian fields; rows zero-padded past length)
static inline bool substr_eq(const uint32_t* rb, const uint32_t* rc,
                             int64_t W, int64_t p, int64_t ell) {
    int64_t wshift = p >> 4;
    uint32_t bs = (uint32_t)((p & 15) * 2);
    int64_t wfull = ell >> 4;
    uint32_t rem = (uint32_t)((ell & 15) * 2);
    auto bword = [&](int64_t w) -> uint32_t {
        uint32_t lo = (w + wshift < W) ? rb[w + wshift] : 0u;
        if (bs == 0) return lo;
        uint32_t hi = (w + wshift + 1 < W) ? rb[w + wshift + 1] : 0u;
        return (lo >> bs) | (hi << (32 - bs));
    };
    for (int64_t w = 0; w < wfull; w++)
        if (bword(w) != rc[w]) return false;
    if (rem) {
        uint32_t m = (1u << rem) - 1;
        if (((bword(wfull) ^ rc[wfull]) & m) != 0) return false;
    }
    return true;
}

}  // namespace gcpsjoin

extern "C" {

int64_t alga_gcps_join_verify(
    const uint64_t* keys, int64_t n, int64_t nw,
    const int64_t* lengths, const uint8_t* af,
    int32_t k, int32_t cap,
    const uint64_t* tkeys, const int32_t* tids, int64_t nt,
    const uint32_t* packed, int64_t W,
    int32_t* out_src, int32_t* out_dst, int32_t* out_ell, int64_t out_cap,
    int threads, int64_t* out_candidates) {

    gcpsjoin::HashTable ht;
    ht.build(tkeys, nt);

    int T = resolve_threads(threads);
    if (force_seq() || n < 4096) T = 1;
    std::vector<std::vector<int32_t>> bufs(T);   // (B, C, ell) triples
    std::vector<int64_t> cand(T, 0);             // join candidates per thread
    std::vector<std::thread> ths;
    int64_t blk = (n + T - 1) / T;

    auto job = [&](int t) {
        int64_t lo_r = t * blk, hi_r = std::min(n, (t + 1) * blk);
        auto& out = bufs[t];
        int64_t ncand = 0;
        for (int64_t B = lo_r; B < hi_r; B++) {
            if (!af[B]) continue;
            int64_t lenB = lengths[B];
            int64_t p_end = std::min((int64_t)nw - 1, lenB - k);
            int64_t p_beg = std::max((int64_t)0, lenB - cap);
            const uint64_t* krow = keys + B * nw;
            const uint32_t* rb = packed + B * W;
            for (int64_t p = p_beg; p <= p_end; p++) {
                int64_t tl, tc;
                if (!ht.find(krow[p], tl, tc)) continue;
                ncand += tc;   // telemetry parity: raw join candidates
                int64_t ell = lenB - p;
                for (int64_t j = tl; j < tl + tc; j++) {
                    int32_t C = tids[j];
                    if (C == B || lengths[C] < ell) continue;
                    if (!gcpsjoin::substr_eq(rb, packed + (int64_t)C * W,
                                             W, p, ell)) continue;
                    out.push_back((int32_t)B);
                    out.push_back(C);
                    out.push_back((int32_t)ell);
                }
            }
        }
        cand[t] = ncand;
    };
    if (T == 1) {
        job(0);
    } else {
        for (int t = 0; t < T; t++) ths.emplace_back(job, t);
        for (auto& th : ths) th.join();
    }

    if (out_candidates) {
        int64_t c = 0;
        for (auto v : cand) c += v;
        *out_candidates = c;
    }
    int64_t total = 0;
    for (auto& b : bufs) total += (int64_t)b.size() / 3;
    if (total > out_cap) return total;     // caller re-calls with room
    int64_t w = 0;
    for (auto& b : bufs)                    // thread order == row order
        for (size_t i = 0; i < b.size(); i += 3) {
            out_src[w] = b[i];
            out_dst[w] = b[i + 1];
            out_ell[w] = b[i + 2];
            w++;
        }
    return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// LI minimizer k-mer extraction (native twin of graph/supplement.li_kmers;
// ref src/DataStructures/Read.cpp:145-226 getLIKmers): per read and per
// position interval, the window whose priority-remapped sequence is
// lexicographically smallest, keyed as a (hi, lo) uint64 pair — hi = the
// first min(k, 32) remapped bases read big-endian base-4, lo = the rest.
// Rolling update per window: strip the top digit, shift, append — exact
// (hi < 4^32 <= 2^64, no wrap-around ambiguity).  The numpy implementation
// runs ~35 full-matrix u64 passes per rotation and dominates the error
// path's supplement phase; this is one streaming pass per read.

extern "C" {

// packed: uint32[n, W] 2-bit rows; ids int64[m] reads to process (each with
// lengths[ids] >= k); out arrays sized sum(min(intervals, nwin_i)) by the
// caller (exact).  Outputs in (read, interval) order — callers re-sort
// canonically, only the multiset matters (see li_kmers docstring).
void alga_li_kmers(const uint32_t* packed, int64_t W, const int32_t* lengths,
                   const int64_t* ids, int64_t m,
                   const uint8_t* priorities, int32_t k, int32_t intervals,
                   const int64_t* out_base,
                   int64_t* out_id, int64_t* out_ind,
                   uint64_t* out_hi, uint64_t* out_lo, int threads) {
    const int hi_len = k < 32 ? k : 32;
    const int lo_len = k - hi_len;
    // 4^(hi_len-1), 4^(lo_len-1) for the top-digit strip
    uint64_t top_hi = 1, top_lo = 1;
    for (int i = 0; i < hi_len - 1; i++) top_hi *= 4;
    for (int i = 0; i < lo_len - 1; i++) top_lo *= 4;

    parallel_ranges(m, threads, [&](int, int64_t a, int64_t b) {
        std::vector<uint8_t> rc;
        for (int64_t t = a; t < b; t++) {
            int64_t rid = ids[t];
            int L = lengths[rid];
            int nwin = L - k + 1;
            if (nwin <= 0) continue;
            rc.resize(L);
            const uint32_t* row = packed + rid * W;
            for (int p = 0; p < L; p++)
                rc[p] = priorities[(row[p >> 4] >> (2 * (p & 15))) & 3];

            // initial window digits
            uint64_t hi = 0, lo = 0;
            for (int j = 0; j < hi_len; j++) hi = hi * 4 + rc[j];
            for (int j = hi_len; j < k; j++) lo = lo * 4 + rc[j];

            int il = (nwin + intervals - 1) / intervals;  // ceil (ref :180)
            int64_t ob = out_base[t];
            int emitted = 0;
            uint64_t best_hi = ~0ull, best_lo = ~0ull;
            int best_p = -1;
            int iv_end = il < nwin ? il : nwin;
            for (int p = 0; p < nwin; p++) {
                if (p > 0) {
                    // roll: strip rc[p-1] from hi, append rc[p+hi_len-1];
                    // strip rc[p-1+hi_len] from lo, append rc[p+k-1]
                    hi = (hi - (uint64_t)rc[p - 1] * top_hi) * 4
                         + rc[p + hi_len - 1];
                    if (lo_len > 0)
                        lo = (lo - (uint64_t)rc[p - 1 + hi_len] * top_lo) * 4
                             + rc[p + k - 1];
                }
                if (hi < best_hi || (hi == best_hi && lo < best_lo)) {
                    best_hi = hi;
                    best_lo = lo;
                    best_p = p;   // strict '<' keeps the FIRST minimum
                }
                if (p + 1 == iv_end) {
                    out_id[ob + emitted] = rid;
                    out_ind[ob + emitted] = best_p;
                    out_hi[ob + emitted] = best_hi;
                    out_lo[ob + emitted] = best_lo;
                    emitted++;
                    best_hi = best_lo = ~0ull;
                    best_p = -1;
                    iv_end = iv_end + il < nwin ? iv_end + il : nwin;
                }
            }
        }
    }, 256);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched ACLER verification on the packed store (native twin of
// ops/align._np_ach_chunk in its ACLER-only configuration; ref
// AlignmentControllerLowErrorRate.cpp:15-48 + the ACH guards,
// ACHybrid.cpp:49-62).  Mismatch counting is a popcount over the XOR of
// the funnel-shifted packed streams; the front same-ends check keeps the
// reference's bit-range quirk (bits [0, 2*sel] INCLUSIVE — the low bit of
// base `sel` participates, ref ACLER.cpp:42-45), the back check is
// base-granular over the top `sel` bases of the overlap.

extern "C" {

void alga_acler_batch(const uint32_t* packed, int64_t W,
                      const int32_t* lengths,
                      const int64_t* r1, const int64_t* r2,
                      const int64_t* offsets, int64_t m,
                      int32_t moc, int32_t min_off,
                      int32_t min_overlap_area,
                      int32_t min_low_err, int32_t sel,
                      uint8_t* out, int threads) {
    parallel_ranges(m, threads, [&](int, int64_t a, int64_t b) {
        for (int64_t t = a; t < b; t++) {
            out[t] = 0;
            int64_t off = offsets[t];
            int32_t len1 = lengths[r1[t]];
            int32_t len2 = lengths[r2[t]];
            if (100 * off > (int64_t)moc * len1) continue;
            // ACH guard parity with _np_ach_chunk: offsets below the
            // configured minimum (default 0) are rejected; negative
            // offsets additionally break the funnel-shift word math
            if (off < min_off || off < 0) continue;
            int64_t ov = (len1 < len2 + off ? len1 : len2 + off) - off;
            if (ov < min_overlap_area) continue;
            if (len2 + off - len1 < 0) continue;

            const uint32_t* pa = packed + r1[t] * W;
            const uint32_t* pb = packed + r2[t] * W;
            int64_t sw = off >> 4;
            uint32_t sb = (uint32_t)((off & 15) * 2);
            int64_t bitdiff = 0;
            bool front_bad = false, back_bad = false;
            int64_t words = (ov + 15) / 16;
            for (int64_t w = 0; w < words; w++) {
                uint32_t lo = (sw + w) < W ? pa[sw + w] : 0u;
                uint32_t hi = (sw + w + 1) < W ? pa[sw + w + 1] : 0u;
                uint32_t av = sb ? ((lo >> sb) | (hi << (32 - sb))) : lo;
                uint32_t x = av ^ pb[w];
                int64_t rem = ov - 16 * w;
                uint32_t mask = rem >= 16 ? 0xFFFFFFFFu
                                          : ((1u << (rem * 2)) - 1u);
                x &= mask;
                bitdiff += __builtin_popcount(x);
                if (w == 0 && (x & ((1u << (2 * sel + 1)) - 1u)))
                    front_bad = true;
                // back window: bases [ov - sel, ov)
                int64_t lo_base = ov - sel;
                int64_t wb0 = 16 * w;
                if (wb0 + 16 > lo_base) {
                    int64_t first = lo_base > wb0 ? lo_base - wb0 : 0;
                    uint32_t bm = first >= 16 ? 0u
                        : (0xFFFFFFFFu << (first * 2));
                    if (x & bm & mask) back_bad = true;
                }
            }
            if (front_bad || back_bad) continue;
            int64_t seq_overlap = (2 * ov - bitdiff) >> 1;
            if (100 * seq_overlap >= (int64_t)min_low_err * ov) out[t] = 1;
        }
    }, 1024);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Reference-graph stream scan (ref Graph::deserializeGraph layout,
// Graph.cpp:220-266): record-start positions in the int32 stream.  The
// recurrence start[i+1] = start[i] + 2 + 2*deg[i] is data-dependent, so
// numpy can't vectorize it; this loop makes an 8M-edge load sub-second.

extern "C" {

// One-pass reference-format stream assembly from unsorted edge arrays:
// record i starts at 1 + 2*i + 2*indptr[i] (counting sort by src; the
// per-node edge order is not normative, ref re-sorts on use).  Returns
// the stream length in int32 words.
int64_t alga_graph_pack(int64_t n, int64_t m, const int32_t* src,
                        const int32_t* dst, const int32_t* off,
                        int64_t* indptr /* n+1 zeroed */, int32_t* out) {
    for (int64_t e = 0; e < m; e++) indptr[src[e] + 1]++;
    for (int64_t i = 0; i < n; i++) indptr[i + 1] += indptr[i];
    out[0] = (int32_t)(uint32_t)n;
    for (int64_t i = 0; i < n; i++) {
        int64_t base = 1 + 2 * i + 2 * indptr[i];
        out[base] = (int32_t)i;
        out[base + 1] = (int32_t)(indptr[i + 1] - indptr[i]);
    }
    // indptr doubles as the per-node write cursor
    for (int64_t e = 0; e < m; e++) {
        int64_t i = src[e];
        int64_t p = 3 + 2 * i + 2 * indptr[i]++;
        out[p] = dst[e];
        out[p + 1] = off[e];
    }
    return 1 + 2 * n + 2 * m;
}

// One-pass edge-array extraction from a reference-format stream.
int64_t alga_graph_unpack(const int32_t* data, int64_t len, int64_t n,
                          int32_t* src, int32_t* dst, int32_t* off) {
    int64_t p = 1, e = 0;
    for (int64_t i = 0; i < n; i++) {
        if (p + 2 > len) return -1;
        int32_t id = data[p];
        int64_t deg = data[p + 1];
        p += 2;
        if (deg < 0 || p + 2 * deg > len) return -1;
        for (int64_t k = 0; k < deg; k++) {
            src[e] = id;
            dst[e] = data[p];
            off[e] = data[p + 1];
            p += 2;
            e++;
        }
    }
    return e;
}

int64_t alga_graph_record_starts(const int32_t* data, int64_t len,
                                 int64_t n, int64_t* starts) {
    int64_t p = 1;
    for (int64_t i = 0; i < n; i++) {
        if (p + 2 > len) return -1;
        starts[i] = p;
        p += 2 + 2 * (int64_t)data[p + 1];
        if (p > len) return -1;
    }
    return p;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Round-5 host hot-path rework (920k-config shave, VERDICT r5 item 1c):
//  * join-verify with INLINE rolling window hashes read straight from the
//    2-bit packed store — removes the uint8 codes unpack AND the
//    uint64[n, nw] window-key materialization (231 MB of traffic at the
//    920k config) from the host GCPS;
//  * prefix keys (window 0) from packed, the only table the join needs;
//  * native prefix/duplicate marking (field-reversed big-endian keys +
//    2-way parallel stable merge sort + adjacent-LCP scan), twin of
//    io/fastx.mark_prefix_reads;
//  * libstdc++ std::sort on contig lengths (the ACTUAL introsort the
//    reference runs — the Python replica exists as the oracle).

extern "C" {

static inline uint32_t alga_base_at(const uint32_t* rb, int64_t W, int64_t i) {
    return (i >> 4) < W ? (rb[i >> 4] >> ((i & 15) * 2)) & 3u : 0u;
}

void alga_prefix_keys(const uint32_t* packed, int64_t W, const int64_t* ids,
                      int64_t nids, int32_t k, uint32_t a1, uint32_t a2,
                      uint64_t* out, int threads) {
    parallel_ranges(nids, threads, [&](int, int64_t lo, int64_t hi) {
        for (int64_t t = lo; t < hi; t++) {
            const uint32_t* rb = packed + ids[t] * W;
            uint32_t h1 = 0, h2 = 0;
            for (int32_t j = 0; j < k; j++) {
                uint32_t c = alga_base_at(rb, W, j);
                h1 = h1 * a1 + c;
                h2 = h2 * a2 + c;
            }
            out[t] = ((uint64_t)h1 << 32) | h2;
        }
    }, 1024);
}

int64_t alga_gcps_join_verify_packed(
    int64_t n, int64_t nw,
    const int64_t* lengths, const uint8_t* af,
    int32_t k, int32_t cap, uint32_t a1, uint32_t a2,
    const uint64_t* tkeys, const int32_t* tids, int64_t nt,
    const uint32_t* packed, int64_t W,
    int32_t* out_src, int32_t* out_dst, int32_t* out_ell, int64_t out_cap,
    int threads, int64_t* out_candidates) {

    uint32_t ak1 = 1, ak2 = 1;
    for (int32_t i = 0; i < k - 1; i++) { ak1 *= a1; ak2 *= a2; }

    int T = resolve_threads(threads);
    if (force_seq() || n < 4096) T = 1;

    // ---- partitioned path (DRAM-latency fix for multi-million-read runs):
    // the single open-addressed table is far beyond LLC at 7M+ entries and
    // every probe is a dependent cache miss (measured 63s of the 16M
    // config's GCPS).  Partition the table by the top hash bits so each
    // partition is LLC/L2-resident, bucket each row-chunk's probes by
    // partition (sequential-bandwidth scatter), then probe partition-major.
    // Emission order is restored EXACTLY (B asc, window asc, table-run asc)
    // by sorting each thread's matches on a (B, p, j) sequence key, so the
    // result is bit-identical to the single-table path.
    bool partitioned = (n >= (1 << 20)) && (n < (1ll << 27))
                       && nt < (1ll << 27) && nw <= 1024;
    if (const char* e = getenv("ALGA_JOIN_PART"))
        partitioned = partitioned && e[0] != '0';

    if (!partitioned) {
        gcpsjoin::HashTable2 ht;
        ht.build(tkeys, nt);
        std::vector<std::vector<int32_t>> bufs(T);
        std::vector<int64_t> cand(T, 0);
        std::vector<std::thread> ths;
        int64_t blk = (n + T - 1) / T;
        auto job = [&](int t) {
            int64_t lo_r = t * blk, hi_r = std::min(n, (t + 1) * blk);
            auto& out = bufs[t];
            int64_t ncand = 0;
            std::vector<uint64_t> keybuf(1024);
            for (int64_t B = lo_r; B < hi_r; B++) {
                if (!af[B]) continue;
                int64_t lenB = lengths[B];
                int64_t p_end = std::min((int64_t)nw - 1, lenB - k);
                int64_t p_beg = std::max((int64_t)0, lenB - cap);
                if (p_beg > p_end) continue;
                const uint32_t* rb = packed + B * W;
                int64_t nwin = p_end - p_beg + 1;
                if ((int64_t)keybuf.size() < nwin) keybuf.resize(nwin);
                uint32_t h1 = 0, h2 = 0;
                for (int64_t j = p_beg; j < p_beg + k; j++) {
                    uint32_t c = alga_base_at(rb, W, j);
                    h1 = h1 * a1 + c;
                    h2 = h2 * a2 + c;
                }
                const int64_t D = 8;
                for (int64_t t2 = 0; t2 < nwin; t2++) {
                    uint64_t keyv = ((uint64_t)h1 << 32) | h2;
                    keybuf[t2] = keyv;
                    if (t2 < D) ht.prefetch(keyv);
                    int64_t p = p_beg + t2;
                    uint32_t cp = alga_base_at(rb, W, p);
                    uint32_t cn = alga_base_at(rb, W, p + k);
                    h1 = (h1 - cp * ak1) * a1 + cn;
                    h2 = (h2 - cp * ak2) * a2 + cn;
                }
                for (int64_t t2 = 0; t2 < nwin; t2++) {
                    if (t2 + D < nwin) ht.prefetch(keybuf[t2 + D]);
                    int64_t p = p_beg + t2;
                    int64_t tl, tc;
                    if (ht.find(keybuf[t2], tl, tc)) {
                        ncand += tc;
                        int64_t ell = lenB - p;
                        for (int64_t j = tl; j < tl + tc; j++) {
                            int32_t C = tids[j];
                            if (C == B || lengths[C] < ell) continue;
                            if (!gcpsjoin::substr_eq(
                                    rb, packed + (int64_t)C * W, W, p, ell))
                                continue;
                            out.push_back((int32_t)B);
                            out.push_back(C);
                            out.push_back((int32_t)ell);
                        }
                    }
                }
            }
            cand[t] = ncand;
        };
        if (T == 1) job(0);
        else {
            for (int t = 0; t < T; t++) ths.emplace_back(job, t);
            for (auto& th : ths) th.join();
        }
        if (out_candidates) {
            int64_t c = 0;
            for (auto v : cand) c += v;
            *out_candidates = c;
        }
        int64_t total = 0;
        for (auto& b : bufs) total += (int64_t)b.size() / 3;
        if (total > out_cap) return total;
        int64_t w = 0;
        for (auto& b : bufs)
            for (size_t i = 0; i < b.size(); i += 3) {
                out_src[w] = b[i];
                out_dst[w] = b[i + 1];
                out_ell[w] = b[i + 2];
                w++;
            }
        return total;
    }

    // partition count: keep each partition's table ~1-2 MB (L2-resident)
    constexpr int PB = 8;                 // 256 partitions
    constexpr int NP = 1 << PB;
    struct Part {
        std::vector<uint64_t> key;        // distinct keys of this partition
        std::vector<uint64_t> val;        // lo << 24 | cnt
        std::vector<gcpsjoin::HashTable2::Slot> slot;
        uint64_t mask = 0;
        int64_t empty_lo = -1, empty_cnt = 0;
        void build() {
            uint64_t capp = 1;
            while (capp < key.size() * 2 + 2) capp <<= 1;
            mask = capp - 1;
            slot.assign(capp, {~0ull, 0});
            for (size_t i = 0; i < key.size(); i++) {
                uint64_t h = joinx::mix64(key[i]) & mask;
                while (slot[h].key != ~0ull) h = (h + 1) & mask;
                slot[h] = {key[i], val[i]};
            }
        }
        inline bool find(uint64_t kk, int64_t& l, int64_t& c) const {
            if (kk == ~0ull) {
                if (empty_lo < 0) return false;
                l = empty_lo; c = empty_cnt; return true;
            }
            uint64_t h = joinx::mix64(kk) & mask;
            while (true) {
                const auto& sl = slot[h];
                if (sl.key == kk) {
                    l = (int64_t)(sl.val >> 24);
                    c = (int64_t)(sl.val & 0xFFFFFF);
                    return true;
                }
                if (sl.key == ~0ull) return false;
                h = (h + 1) & mask;
            }
        }
    };
    std::vector<Part> parts(NP);
    for (int64_t i = 0; i < nt;) {
        int64_t j = i;
        while (j < nt && tkeys[j] == tkeys[i]) j++;
        uint64_t kk = tkeys[i];
        int pi = (int)(joinx::mix64(kk) >> (64 - PB));
        if (kk == ~0ull) {
            parts[pi].empty_lo = i;
            parts[pi].empty_cnt = j - i;
        } else {
            parts[pi].key.push_back(kk);
            parts[pi].val.push_back(((uint64_t)i << 24) | (uint64_t)(j - i));
        }
        i = j;
    }
    for (auto& pp : parts) pp.build();

    struct MatchRec4 { uint64_t seq; int32_t B, C, ell, pad; };
    std::vector<std::vector<MatchRec4>> bufs(T);
    std::vector<int64_t> cand(T, 0);
    std::vector<std::thread> ths;
    int64_t blk = (n + T - 1) / T;

    auto job = [&](int t) {
        int64_t lo_r = t * blk, hi_r = std::min(n, (t + 1) * blk);
        auto& out = bufs[t];
        int64_t ncand = 0;
        // probe buffers: (key, B<<10|p) per partition
        struct Probe { uint64_t key; uint64_t bp; };
        std::vector<std::vector<Probe>> pb(NP);
        struct Hit { int64_t tl, tc; int32_t B, p; };
        std::vector<Hit> hits;
        const int64_t CHUNK_PROBES = 4 << 20;
        int64_t B = lo_r;
        while (B < hi_r) {
            for (auto& v : pb) v.clear();
            int64_t acc = 0;
            int64_t Bend = B;
            while (Bend < hi_r && acc < CHUNK_PROBES) {
                if (af[Bend]) acc += std::max((int64_t)0,
                    std::min((int64_t)nw - 1, lengths[Bend] - k)
                    - std::max((int64_t)0, lengths[Bend] - cap) + 1);
                Bend++;
            }
            // pass 1: roll + scatter probes
            for (int64_t Bi = B; Bi < Bend; Bi++) {
                if (!af[Bi]) continue;
                int64_t lenB = lengths[Bi];
                int64_t p_end = std::min((int64_t)nw - 1, lenB - k);
                int64_t p_beg = std::max((int64_t)0, lenB - cap);
                if (p_beg > p_end) continue;
                const uint32_t* rb = packed + Bi * W;
                uint32_t h1 = 0, h2 = 0;
                for (int64_t j = p_beg; j < p_beg + k; j++) {
                    uint32_t c = alga_base_at(rb, W, j);
                    h1 = h1 * a1 + c;
                    h2 = h2 * a2 + c;
                }
                for (int64_t p = p_beg; p <= p_end; p++) {
                    uint64_t keyv = ((uint64_t)h1 << 32) | h2;
                    int pi = (int)(joinx::mix64(keyv) >> (64 - PB));
                    pb[pi].push_back({keyv,
                        ((uint64_t)Bi << 10) | (uint64_t)p});
                    uint32_t cp = alga_base_at(rb, W, p);
                    uint32_t cn = alga_base_at(rb, W, p + k);
                    h1 = (h1 - cp * ak1) * a1 + cn;
                    h2 = (h2 - cp * ak2) * a2 + cn;
                }
            }
            // pass 2: partition-major probe, then verify hits with row
            // prefetch (the C-row fetches are the remaining random stream)
            for (int pi = 0; pi < NP; pi++) {
                const auto& pp = parts[pi];
                hits.clear();
                for (const auto& pr : pb[pi]) {
                    int64_t tl, tc;
                    if (pp.find(pr.key, tl, tc)) {
                        ncand += tc;
                        hits.push_back({tl, tc,
                            (int32_t)(pr.bp >> 10),
                            (int32_t)(pr.bp & 1023)});
                    }
                }
                const int64_t D = 8;
                int64_t nh = (int64_t)hits.size();
                for (int64_t hI = 0; hI < nh; hI++) {
                    if (hI + D < nh) {
                        const Hit& hn = hits[hI + D];
                        __builtin_prefetch(
                            packed + (int64_t)tids[hn.tl] * W, 0, 1);
                    }
                    const Hit& h = hits[hI];
                    int64_t lenB = lengths[h.B];
                    int64_t ell = lenB - h.p;
                    const uint32_t* rb = packed + (int64_t)h.B * W;
                    for (int64_t j = h.tl; j < h.tl + h.tc; j++) {
                        int32_t C = tids[j];
                        if (C == h.B || lengths[C] < ell) continue;
                        if (!gcpsjoin::substr_eq(
                                rb, packed + (int64_t)C * W, W, h.p, ell))
                            continue;
                        out.push_back({((uint64_t)h.B << 37)
                                       | ((uint64_t)h.p << 27)
                                       | (uint64_t)j,
                                       h.B, C, (int32_t)ell, 0});
                    }
                }
            }
            B = Bend;
        }
        // restore the exact single-table emission order (B, p, j)
        std::sort(out.begin(), out.end(),
                  [](const MatchRec4& x, const MatchRec4& y) {
                      return x.seq < y.seq;
                  });
        cand[t] = ncand;
    };
    if (T == 1) job(0);
    else {
        for (int t = 0; t < T; t++) ths.emplace_back(job, t);
        for (auto& th : ths) th.join();
    }

    if (out_candidates) {
        int64_t c = 0;
        for (auto v : cand) c += v;
        *out_candidates = c;
    }
    int64_t total = 0;
    for (auto& b : bufs) total += (int64_t)b.size();
    if (total > out_cap) return total;
    int64_t w = 0;
    for (auto& b : bufs)                  // thread order == B order
        for (const auto& m : b) {
            out_src[w] = m.B;
            out_dst[w] = m.C;
            out_ell[w] = m.ell;
            w++;
        }
    return total;
}

}  // extern "C"

extern "C" {

// Native twin of io/fastx.mark_prefix_reads (ref ReadPreprocess::
// getPrefixReads, mode PREF_READS_ALL_PREFIX_READS): field-reversed
// packed words give base-lexicographic numeric order; sort valid rows,
// adjacent-scan for prefix containment.  out_rm[t] = row t is a
// duplicate/prefix of its successor; out_rm_rc[t] = additionally a
// STRICT prefix (its revcomp is a proper suffix -> also removed).
void alga_mark_prefix(const uint32_t* packed, int64_t W,
                      const int64_t* ids, const int64_t* lengths,
                      int64_t nv, uint8_t* out_rm, uint8_t* out_rm_rc,
                      int threads) {
    if (nv == 0) return;
    // field-reversed key matrix (base 0 in the most significant 2 bits)
    std::vector<uint32_t> rev((size_t)nv * W);
    parallel_ranges(nv, threads, [&](int, int64_t lo, int64_t hi) {
        for (int64_t t = lo; t < hi; t++) {
            const uint32_t* rb = packed + ids[t] * W;
            uint32_t* o = rev.data() + t * W;
            for (int64_t w = 0; w < W; w++) {
                uint32_t x = rb[w];
                x = ((x & 0x33333333u) << 2) | ((x >> 2) & 0x33333333u);
                x = ((x & 0x0F0F0F0Fu) << 4) | ((x >> 4) & 0x0F0F0F0Fu);
                x = ((x & 0x00FF00FFu) << 8) | ((x >> 8) & 0x00FF00FFu);
                o[w] = (x << 16) | (x >> 16);
            }
        }
    }, 1024);

    auto cmp = [&](int64_t a, int64_t b) {
        const uint32_t* ka = rev.data() + a * W;
        const uint32_t* kb = rev.data() + b * W;
        for (int64_t w = 0; w < W; w++)
            if (ka[w] != kb[w]) return ka[w] < kb[w];
        if (lengths[a] != lengths[b]) return lengths[a] < lengths[b];
        return a < b;                     // strict total order == stable
    };
    std::vector<int64_t> ord(nv);
    for (int64_t i = 0; i < nv; i++) ord[i] = i;
    int T = resolve_threads(threads);
    if (force_seq() || nv < (1 << 16) || T < 2) {
        std::sort(ord.begin(), ord.end(), cmp);
    } else {
        int64_t mid = nv / 2;
        std::thread th([&] {
            std::sort(ord.begin(), ord.begin() + mid, cmp); });
        std::sort(ord.begin() + mid, ord.end(), cmp);
        th.join();
        std::inplace_merge(ord.begin(), ord.begin() + mid, ord.end(), cmp);
    }

    parallel_ranges(nv - 1, threads, [&](int, int64_t lo, int64_t hi) {
        for (int64_t t = lo; t < hi; t++) {
            int64_t a = ord[t], b = ord[t + 1];
            const uint32_t* ka = rev.data() + a * W;
            const uint32_t* kb = rev.data() + b * W;
            int64_t fm = 16 * W;          // content-equal up to padding
            for (int64_t w = 0; w < W; w++) {
                uint32_t x = ka[w] ^ kb[w];
                if (x) { fm = 16 * w + __builtin_clz(x) / 2; break; }
            }
            if (fm >= lengths[a]) {
                out_rm[t] = 1;
                if (lengths[a] < lengths[b]) out_rm_rc[t] = 1;
            }
        }
    }, 4096);
    // flags are positional over the SORTED order; the caller maps
    // ord[t] back to ids — emit the permutation through out-of-band?
    // Simpler: rewrite flags in place to row-indexed.
    std::vector<uint8_t> rm((size_t)nv, 0), rmrc((size_t)nv, 0);
    for (int64_t t = 0; t + 1 < nv; t++) {
        if (out_rm[t]) rm[ord[t]] = 1;
        if (out_rm_rc[t]) rmrc[ord[t]] = 1;
    }
    std::memcpy(out_rm, rm.data(), nv);
    std::memcpy(out_rm_rc, rmrc.data(), nv);
}

// libstdc++ std::sort permutation of indices by key desc (the ACTUAL
// introsort the reference runs on contig lengths; the Python replica
// utils/libstdcxx_sort.py is the oracle).
void alga_sort_len_desc(int64_t n, const int64_t* keys, int32_t* idx) {
    for (int64_t i = 0; i < n; i++) idx[i] = (int32_t)i;
    std::sort(idx, idx + n,
              [&](int32_t a, int32_t b) { return keys[a] > keys[b]; });
}

}  // extern "C"

extern "C" {

// Ragged string packing: ACGT bytes (concatenated) -> 2-bit packed rows.
// Avoids the padded [n, max_len] byte/code matrices of the python
// pack_strings (251 MB at the flagship trim pass).
void alga_pack_ragged(const uint8_t* bytes, const int64_t* offsets,
                      int64_t n, int64_t W, uint32_t* out, int threads) {
    static uint8_t lut[256];
    lut[(unsigned char)'C'] = 1; lut[(unsigned char)'G'] = 2;
    lut[(unsigned char)'T'] = 3;
    lut[(unsigned char)'c'] = 1; lut[(unsigned char)'g'] = 2;
    lut[(unsigned char)'t'] = 3;
    parallel_ranges(n, threads, [&](int, int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; r++) {
            const uint8_t* s = bytes + offsets[r];
            int64_t len = offsets[r + 1] - offsets[r];
            uint32_t* o = out + r * W;
            for (int64_t w = 0; w < W; w++) o[w] = 0;
            for (int64_t i = 0; i < len; i++)
                o[i >> 4] |= (uint32_t)lut[s[i]] << ((i & 15) * 2);
        }
    }, 256);
}

}  // extern "C"

extern "C" {

// Stable 3-key u64 sort permutation (np.lexsort((rest, lo, hi)) twin):
// the supplement's dominant sort — 2-way parallel over 32-byte recs.
void alga_sort3_u64(const uint64_t* hi, const uint64_t* lo,
                    const uint64_t* rest, int64_t n, int64_t* order,
                    int threads) {
    struct Rec { uint64_t hi, lo, rest; int64_t idx; };
    std::vector<Rec> v(n);
    parallel_ranges(n, threads, [&](int, int64_t a, int64_t b) {
        for (int64_t i = a; i < b; i++) v[i] = {hi[i], lo[i], rest[i], i};
    }, 4096);
    auto cmp = [](const Rec& x, const Rec& y) {
        if (x.hi != y.hi) return x.hi < y.hi;
        if (x.lo != y.lo) return x.lo < y.lo;
        if (x.rest != y.rest) return x.rest < y.rest;
        return x.idx < y.idx;             // strict total == stable
    };
    int T = resolve_threads(threads);
    if (force_seq() || n < (1 << 16) || T < 2) {
        std::sort(v.begin(), v.end(), cmp);
    } else {
        int64_t mid = n / 2;
        std::thread th([&] { std::sort(v.begin(), v.begin() + mid, cmp); });
        std::sort(v.begin() + mid, v.end(), cmp);
        th.join();
        std::inplace_merge(v.begin(), v.begin() + mid, v.end(), cmp);
    }
    for (int64_t i = 0; i < n; i++) order[i] = v[i].idx;
}

}  // extern "C"

extern "C" {

// Supplement candidate-pair emission (twin of supplement._gen_candidate_
// pairs; ref PKB.cpp:33-62): for each record i of a run, every later
// record j up to the reference's monotone break
// 100*(ind_i - ind_j) > MOC*len_i, with the static `continue` guards
// evaluated into `ok`.  Layout: i asc, j asc, grouped per i — the
// contract _replay_runs relies on.  mode 0 counts, mode 1 fills.
int64_t alga_pkb_pairgen(
    const int64_t* rid_s, const int64_t* ind_s, int64_t nrec,
    const int64_t* starts, const int64_t* ends, int64_t nruns,
    const int64_t* lens,
    int32_t moc, int32_t min_off, int32_t min_ovl,
    const uint8_t* af, const uint8_t* at,
    int32_t mode, int64_t* pi, int64_t* pj, uint8_t* ok, int threads) {
    std::vector<int64_t> run_counts(nruns, 0);
    parallel_ranges(nruns, threads, [&](int, int64_t a, int64_t b) {
        for (int64_t r = a; r < b; r++) {
            int64_t c = 0;
            for (int64_t i = starts[r]; i < ends[r]; i++) {
                if (!af[rid_s[i]]) continue;
                int64_t lim = (int64_t)moc * lens[rid_s[i]];
                for (int64_t j = i + 1; j < ends[r]; j++) {
                    if (100 * (ind_s[i] - ind_s[j]) > lim) break;
                    c++;
                }
            }
            run_counts[r] = c;
        }
    }, 64);
    int64_t total = 0;
    for (auto c : run_counts) total += c;
    if (mode == 0) return total;

    std::vector<int64_t> run_base(nruns + 1, 0);
    for (int64_t r = 0; r < nruns; r++)
        run_base[r + 1] = run_base[r] + run_counts[r];
    parallel_ranges(nruns, threads, [&](int, int64_t a, int64_t b) {
        for (int64_t r = a; r < b; r++) {
            int64_t w = run_base[r];
            for (int64_t i = starts[r]; i < ends[r]; i++) {
                int64_t id1 = rid_s[i];
                if (!af[id1]) continue;
                int64_t len1 = lens[id1];
                int64_t lim = (int64_t)moc * len1;
                for (int64_t j = i + 1; j < ends[r]; j++) {
                    int64_t off = ind_s[i] - ind_s[j];
                    if (100 * off > lim) break;
                    int64_t id2 = rid_s[j];
                    int64_t len2 = lens[id2];
                    int64_t ovl = (len1 < len2 + off ? len1 : len2 + off)
                                  - off;
                    pi[w] = i;
                    pj[w] = j;
                    ok[w] = (at[id2] && id1 != id2 && off >= min_off
                             && ovl >= min_ovl
                             && len2 + off - len1 >= 0) ? 1 : 0;
                    w++;
                }
            }
        }
    }, 64);
    return total;
}

}  // extern "C"
