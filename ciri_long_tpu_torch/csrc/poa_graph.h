// The host graph code of collapse's POA rounds: the partial-order graph,
// its rank-space flattening for csrc/poa_align.cu, the fuse of one alignment
// and the heaviest-bundle consensus, and ``Rounds``, one
// ops/poa.py::poa_consensus_many call's jobs advanced a round at a time.
//
// The port's own copy of native/poacore.cpp:273-470 (``Graph``, the fuse and
// the consensus of ``py_poa_all``), itself byte-exact to the Python graph of
// ops/poa.py (``_Graph``, ``_fuse``, ``_consensus``): edge lists keep
// insertion order (the Python dicts' order, on which the alignment's ties
// and the consensus walk depend), the topological order is the same LIFO
// stack, and nodes of one alignment column share one ring.  The round
// structure is that of ciri_long_tpu/ops/poa.py::poa_consensus_many's
// device branch (:393-485): each job's graph starts as the backbone of its
// first non-empty sequence; each round flattens every job that still has a
// sequence to fuse, aligns them all in one launch and fuses each; the
// consensus is taken when every queue is empty.
//
// No CUDA and no Python here, so the CPU tests build this header with g++
// behind a small C shim (tests/test_torch_poa_graph.py).  No static mutable
// state: concurrent callers each own their ``Rounds``.

#pragma once

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace poa_graph {

struct Graph {
    std::vector<uint8_t> base;
    std::vector<int32_t> ring_id;
    std::vector<std::vector<int32_t>> rings;
    std::vector<std::vector<std::pair<int32_t, int32_t>>> in_e, out_e;
    std::vector<int32_t> support;

    int32_t new_node(uint8_t b) {
        const int32_t v = static_cast<int32_t>(base.size());
        base.push_back(b);
        ring_id.push_back(static_cast<int32_t>(rings.size()));
        rings.push_back({v});
        in_e.emplace_back();
        out_e.emplace_back();
        support.push_back(0);
        return v;
    }

    // weight += 1 on edge p -> v, appended in insertion order when new
    void add_edge(int32_t p, int32_t v) {
        bump(in_e[v], p);
        bump(out_e[p], v);
    }

    // Python topo_order: a stack seeded with the zero-indegree ids in
    // ascending order, popped LIFO, successors pushed in out-edge order.
    void topo(std::vector<int32_t>& order) const {
        const int64_t nn = static_cast<int64_t>(base.size());
        std::vector<int32_t> indeg(nn);
        std::vector<int32_t> stack;
        for (int64_t v = 0; v < nn; ++v) {
            indeg[v] = static_cast<int32_t>(in_e[v].size());
            if (indeg[v] == 0) stack.push_back(static_cast<int32_t>(v));
        }
        order.clear();
        order.reserve(nn);
        while (!stack.empty()) {
            const int32_t v = stack.back();
            stack.pop_back();
            order.push_back(v);
            for (const auto& kv : out_e[v]) {
                if (--indeg[kv.first] == 0) stack.push_back(kv.first);
            }
        }
    }

  private:
    static void bump(std::vector<std::pair<int32_t, int32_t>>& edges,
                     int32_t to) {
        for (auto& kv : edges) {
            if (kv.first == to) {
                ++kv.second;
                return;
            }
        }
        edges.push_back({to, 1});
    }
};

// The graph of one sequence: a chain of its bases, each supported once.
inline void backbone(Graph& g, const uint8_t* seq, int64_t n) {
    int32_t prev = -1;
    for (int64_t t = 0; t < n; ++t) {
        const int32_t cur = g.new_node(seq[t]);
        ++g.support[cur];
        if (prev >= 0) g.add_edge(prev, cur);
        prev = cur;
    }
}

// Rank-space CSR of ``g`` (ops/poa.py::_flatten_graph): ``order`` gets the
// topological order (all V nodes); ``bases`` gets V codes and ``offs`` V+1
// offsets into ``preds``, absolute (the first is preds.size() on entry);
// ``preds`` gets each node's predecessors as rank + 1 in insertion order,
// [0] (the virtual source row) for a node without any.  Returns the longest
// list.
inline int32_t flatten(const Graph& g, std::vector<int32_t>& order,
                       std::vector<int32_t>& rank, uint8_t* bases,
                       int32_t* offs, std::vector<int32_t>& preds) {
    g.topo(order);
    const int64_t V = static_cast<int64_t>(order.size());
    rank.assign(g.base.size(), 0);
    for (int64_t i = 0; i < V; ++i) rank[order[i]] = static_cast<int32_t>(i);
    int32_t widest = 0;
    offs[0] = static_cast<int32_t>(preds.size());
    for (int64_t i = 0; i < V; ++i) {
        const int32_t v = order[i];
        bases[i] = g.base[v];
        if (g.in_e[v].empty()) {
            preds.push_back(0);
        } else {
            for (const auto& kv : g.in_e[v])
                preds.push_back(rank[kv.first] + 1);
        }
        const int32_t deg = static_cast<int32_t>(
            g.in_e[v].empty() ? 1 : g.in_e[v].size());
        if (deg > widest) widest = deg;
        offs[i + 1] = static_cast<int32_t>(preds.size());
    }
    return widest;
}

// Fuse one alignment (ops/poa.py::_fuse): ``pairs`` holds ``npairs``
// (rank | -1, pos | -1) pairs in forward order, ranks of ``order``.  A
// matched column reuses the node, or a ring partner with the sequence's
// base, or adds one to the ring; an inserted base gets a new node.
inline void fuse(Graph& g, const std::vector<int32_t>& order,
                 const uint8_t* seq, const int32_t* pairs, int64_t npairs) {
    int32_t prev = -1;
    for (int64_t k = 0; k < npairs; ++k) {
        const int32_t r = pairs[2 * k];
        const int32_t jp = pairs[2 * k + 1];
        if (jp < 0) continue;  // graph node skipped, no sequence base
        const uint8_t b = seq[jp];
        const int32_t node = r >= 0 ? order[r] : -1;
        int32_t cur;
        if (node >= 0 && g.base[node] == b) {
            cur = node;
        } else if (node >= 0) {
            cur = -1;
            for (const int32_t r2 : g.rings[g.ring_id[node]]) {
                if (g.base[r2] == b) {
                    cur = r2;
                    break;
                }
            }
            if (cur < 0) {
                cur = g.new_node(b);
                g.rings[g.ring_id[node]].push_back(cur);
                g.ring_id[cur] = g.ring_id[node];
            }
        } else {
            cur = g.new_node(b);
        }
        ++g.support[cur];
        if (prev >= 0) g.add_edge(prev, cur);
        prev = cur;
    }
}

// Heaviest-bundle consensus (ops/poa.py::_consensus): each edge adds
// 2w - 1, ties by the support summed along the path, the end node the first
// maximum of (weight, its support) in topological order.
inline void consensus(const Graph& g, std::vector<uint8_t>& out) {
    out.clear();
    if (g.base.empty()) return;
    std::vector<int32_t> order;
    g.topo(order);
    std::vector<std::pair<int64_t, int64_t>> best(g.base.size(), {0, 0});
    std::vector<int32_t> back(g.base.size(), -1);
    for (const int32_t v : order) {
        for (const auto& kv : g.in_e[v]) {
            const int32_t p = kv.first;
            const std::pair<int64_t, int64_t> cand{
                best[p].first + 2 * static_cast<int64_t>(kv.second) - 1,
                best[p].second + g.support[p]};
            if (cand > best[v]) {
                best[v] = cand;
                back[v] = p;
            }
        }
    }
    int32_t end = -1;
    std::pair<int64_t, int64_t> bk{INT64_MIN, INT64_MIN};
    for (const int32_t v : order) {
        const std::pair<int64_t, int64_t> key{
            best[v].first, static_cast<int64_t>(g.support[v])};
        if (key > bk) {
            bk = key;
            end = v;
        }
    }
    for (int32_t v = end; v >= 0; v = back[v]) out.push_back(g.base[v]);
    std::reverse(out.begin(), out.end());
}

// A poa_consensus_many call's jobs, advanced a round at a time.  A round's
// launch takes the batch layout of ops/poa_batch.py::batch_arrays: job b's
// nodes in row b of bases [B, vmax], its CSR offsets in row b of
// offs [B, vmax + 1] (absolute into ``preds``, the last one repeated past
// its V + 1), its sequence in row b of seqs [B, nmax] (5 past its end), its
// sizes in nv and ns [B]; its pairs end row b of aln [B, vmax + nmax + 1, 2].
struct Rounds {
    struct Job {
        std::vector<std::pair<const uint8_t*, int64_t>> seqs;  // non-empty
        size_t cursor = 0;      // the next sequence to fuse
        Graph g;
        std::vector<int32_t> order;   // the last pack's topological order
    };
    std::vector<Job> jobs;

    // the last pack: the jobs in it and the launch's inputs
    std::vector<int32_t> pending;
    std::vector<uint8_t> bases, seqs;
    std::vector<int32_t> offs, preds, nv, ns;
    int64_t cells = 0;        // sum of (V + 1) * (n + 1) over the jobs
    int32_t nmax = 0;         // the longest sequence
    int32_t vmax = 0;         // the largest graph
    int32_t widest = 0;       // the longest predecessor list

    // ``counts[t]`` sequences of ``lens`` a job, their codes concatenated
    // in ``codes``.  Each job with a non-empty sequence starts as the
    // backbone of the first.
    Rounds(const uint8_t* codes, const int32_t* lens, const int32_t* counts,
           int njobs)
        : jobs(njobs) {
        int64_t s = 0, off = 0;
        for (int t = 0; t < njobs; ++t) {
            for (int32_t k = 0; k < counts[t]; ++k, ++s) {
                if (lens[s] > 0)
                    jobs[t].seqs.push_back({codes + off, lens[s]});
                off += lens[s];
            }
            if (!jobs[t].seqs.empty()) {
                backbone(jobs[t].g, jobs[t].seqs[0].first,
                         jobs[t].seqs[0].second);
                jobs[t].cursor = 1;
            }
        }
    }

    // Flatten every job with a sequence left to fuse into one launch's
    // inputs; returns their number (0 when every queue is empty).
    int pack() {
        pending.clear();
        preds.clear();
        nv.clear();
        ns.clear();
        cells = 0;
        nmax = vmax = widest = 0;
        for (int t = 0; t < static_cast<int>(jobs.size()); ++t) {
            const Job& job = jobs[t];
            if (job.cursor >= job.seqs.size()) continue;
            const auto V = static_cast<int32_t>(job.g.base.size());
            const auto n = static_cast<int32_t>(job.seqs[job.cursor].second);
            nv.push_back(V);
            ns.push_back(n);
            cells += (static_cast<int64_t>(V) + 1) * (n + 1);
            nmax = std::max(nmax, n);
            vmax = std::max(vmax, V);
            pending.push_back(t);
        }
        const int64_t B = static_cast<int64_t>(pending.size());
        bases.assign(B * vmax, 0);
        offs.assign(B * (vmax + 1), 0);
        seqs.assign(B * nmax, 5);
        for (int64_t b = 0; b < B; ++b) {
            Job& job = jobs[pending[b]];
            int32_t* row = &offs[b * (vmax + 1)];
            widest = std::max(widest, flatten(job.g, job.order, rank_,
                                              &bases[b * vmax], row, preds));
            std::fill(row + nv[b] + 1, row + vmax + 1, row[nv[b]]);
            const auto& sq = job.seqs[job.cursor];
            std::copy(sq.first, sq.first + sq.second,
                      seqs.begin() + b * nmax);
        }
        return static_cast<int>(B);
    }

    // The last pack's inputs as int32, one after another: bases, offs,
    // preds, seqs, nv, ns (ops/poa.py::poa_launch_inputs splits them).
    void copy_inputs(int32_t* out) const {
        out = std::copy(bases.begin(), bases.end(), out);
        out = std::copy(offs.begin(), offs.end(), out);
        out = std::copy(preds.begin(), preds.end(), out);
        out = std::copy(seqs.begin(), seqs.end(), out);
        out = std::copy(nv.begin(), nv.end(), out);
        std::copy(ns.begin(), ns.end(), out);
    }

    // Fuse the last pack's alignments: job b's ``acnt[b]`` pairs end row b
    // of ``aln`` ((rank, pos) int32 pairs in forward order, rows of
    // vmax + nmax + 1 pairs).
    void fuse_all(const int32_t* aln, const int32_t* acnt) {
        const int64_t cap = static_cast<int64_t>(vmax) + nmax + 1;
        for (size_t b = 0; b < pending.size(); ++b) {
            Job& job = jobs[pending[b]];
            const int64_t first =
                static_cast<int64_t>(b + 1) * cap - acnt[b];
            fuse(job.g, job.order, job.seqs[job.cursor].first,
                 aln + 2 * first, acnt[b]);
            ++job.cursor;
        }
    }

  private:
    std::vector<int32_t> rank_;
};

}  // namespace poa_graph
