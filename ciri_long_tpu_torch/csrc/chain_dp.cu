// Colinear chaining of minimizer anchors and greedy chain extraction, for
// Hopper.
//
// Replaces the XLA device program ciri_long_tpu/ops/chain.py::_chain_dp
// (the windowed DP as a lax.scan over anchors) and ::chain_extract_batch
// (the greedy extraction as a while_loop state machine, vmapped over rows;
// ROADMAP X2).  The rows are ragged: row b holds anchors offs[b] ..
// offs[b+1]-1 of the concatenated (r, q, ctg) arrays, r contig-local, sorted
// by (r, q) as models/aligner.py::_anchors gives them.
//
// Contract: f and pre equal native/chaincore.cpp::py_chain's, bit for bit:
//   alpha = min(dq, dr, k)
//   skip  = 0.1 * max(0, dq - 2k)
//   pen   = dr >= dq ? lg + skip : (0.5*g + 0.5*lg) + skip   (g = |dr - dq|)
//   cand  = (f[j] + alpha) - pen        over j in [max(0, i - 64), i) with
//           0 < dr <= max_gap_r, 0 < dq <= max_gap_q and the same contig
//   f[i]  = max(k, cand), pre[i] = the smallest j of the largest cand when it
//           beats k, else -1
// in float64, with lg = log2(g + 1) from a table the host fills with
// std::log2 (chain_log2_table), the libm call whose values the native core
// uses.  Every add, subtract and multiply is an explicit round-to-nearest
// intrinsic, so nvcc contracts nothing into an FMA; pen_of takes the max in
// int32 and 0.5*g + 0.5*lg as 0.5*(g + lg), bit-equal.  The native core is
// built by g++ under -march=native, whose only contractions there are
// 2.0*k and 0.5*g, both exact.  dr and dq are taken in contig-local int32:
// a candidate shares its contig, so they equal the global differences.
//
// Extraction equals ops/chain.py::backtrack_chains on (f, pre): candidates
// f >= min_score in descending f, ties by ascending index (np.argsort(-f,
// kind='stable')); each unused candidate walks its predecessors while they
// are unused, marking them; a path of >= min_anchors anchors is a chain
// (its anchors get the chain's id), a shorter one keeps its anchors
// consumed; the walk ends at max_chains chains.  Outputs: cid int8 per
// anchor (-1 none), scores [R, max_chains] float64 (the start's f), nch [R].
//
// Design:
//   chain_dp_kernel       one warp a row, serial over its anchors, every
//                         lane holding the same f of the step before.
//                         Only the newest candidate j = i - 1 of step i
//                         needs the f the step before just made, so the
//                         serial path of a step is that candidate's two
//                         float64 adds, one compare with the best of the
//                         older window (j <= i - 2, known a step earlier,
//                         already set against k) and the selects; no warp
//                         collective sits between two steps' f.  The
//                         older window is reduced by pushes: lane l owns
//                         the steps t = l and l + 32 (mod 64) ahead of the
//                         current one and keeps, for each, the largest
//                         cand (f[j] + alpha) - pen over the j pushed so
//                         far with the smallest j (a strict > as j rises);
//                         step i pushes its f into the 62 steps i + 2 ..
//                         i + 64 (the one reaching i + 64 starts it
//                         afresh), and the owner of step i + 1 broadcasts
//                         that step's best (read before step i's pushes,
//                         which do not touch it) and its newest
//                         candidate's alpha and pen.  The terms of every
//                         candidate (admissibility, alpha, the log2 entry,
//                         loaded only for an admissible pair) are loaded
//                         AHEAD steps before their push, where pen is
//                         formed, so a load from L2 has that long to
//                         arrive; the anchors of the owned steps come a
//                         chunk of 32 ahead.  Steps run in branch-free
//                         bodies of AHEAD (bitwise predicates, so that
//                         nvcc selects rather than branches on a compare);
//                         f and pre leave through the lanes a chunk at a
//                         time.  Bound: a row's steps are serial and rows
//                         run side by side, so a launch takes its longest
//                         row's steps; a step issues ~150 instructions
//                         (two candidates a lane, the broadcasts, the
//                         serial path) and a lone warp takes ~0.13 us for
//                         it on an H100, against csrc/op_rate.cu's serial
//                         step of ~0.018 us.
//   chain_extract_kernel  one block a row, no sort and no serial walk.
//                         The greedy's used set is always closed under
//                         pre (a walk marks the path from its candidate up
//                         to the first used anchor, above which all is
//                         used).  So anchor v is consumed by owner(v), the
//                         first candidate in greedy order whose path up
//                         the pre forest passes through v (the first of
//                         the candidates at or below v): no earlier
//                         candidate reaches v, nor any anchor between it
//                         and owner(v), so owner(v)'s walk starts and
//                         reaches v.  Hence a candidate c walks iff
//                         owner(c) = c, its path is the anchors it owns,
//                         it is a chain iff it owns >= min_anchors, and
//                         its id is the count of chains before it in
//                         greedy order (those past max_chains write
//                         nothing, as the serial loop never reaches
//                         them).  The block finds owner(v) in two
//                         doubling passes up the pre forest, each a few
//                         rounds of one block barrier: every v with
//                         ancestor a = anc[v] folds its value into a's by
//                         an atomic nobody waits for, then anc[v] =
//                         anc[anc[v]] (ping-pong rows), until no ancestor
//                         is left (ceil(log2(depth + 1)) rounds).  Pass 1
//                         takes top[v], the largest f (as an order-keeping
//                         64-bit key) of the candidates at or below v (f
//                         >= min_score); pass 2 the smallest index of
//                         those whose f is top[v], moving a value only
//                         between equal tops (every anchor on the path
//                         from such a candidate up to v has that top).
//                         After round t a value covers at least the
//                         candidates within 2^(t+1) - 1 steps below (it is
//                         folded in place: a value read early in a round
//                         is one of the round before, read late it covers
//                         more, and every value is one of a candidate
//                         below), so the passes end with own[v] =
//                         owner(v).  Then a count of each owner's anchors
//                         (shared atomics), the chains' list, their ids
//                         (a warp counts the chains before each one) and
//                         the ids written out.  Rows up to SMEM_ROW
//                         anchors keep the keys, owners, counts and
//                         ancestors in shared memory; a longer row (a
//                         single read's map is not truncated) keeps them
//                         in global scratch the wrapper gives it.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 64;                 // predecessors a step (CHAIN_WINDOW)
constexpr int DP_WARPS = 4;                // rows a block of the DP
constexpr int AHEAD = 8;                   // steps a candidate's terms lead
                                           // its push (divides 32)
constexpr int EXT_THREADS = 256;
constexpr int SMEM_ROW = 8192;             // longest row kept in smem
constexpr unsigned FULL = 0xffffffffu;
static_assert(WINDOW == 64, "two slots of a warp's lanes own a window");
static_assert(32 % AHEAD == 0, "a chunk starts at a queue entry 0");

// The f-independent terms of candidate j (anchor rj, qj, cj) of anchor t
// (rt, qt, ct), as loaded AHEAD steps before their push: the log2 entry
// (+inf when j is not admissible, so that pen and -cand are too), alpha,
// dq, and g = |dr - dq| when dr < dq, else -1.  pen_of forms pen at the
// push, so that the table's load has those steps to arrive before an
// instruction waits on it.
struct Term {
    double lgv;
    int alpha, dq, g;
};

__device__ __forceinline__ Term term_of(const double* __restrict__ lg, int rj,
                                        int qj, int cj, int rt, int qt,
                                        int ct, int k, int max_gap_r,
                                        int max_gap_q) {
    const int dr = rt - rj;
    const int dq = qt - qj;
    // 0 < dr <= max_gap_r, 0 < dq <= max_gap_q, one contig
    const bool ok = (static_cast<unsigned>(dr) - 1u <
                     static_cast<unsigned>(max_gap_r)) &
                    (static_cast<unsigned>(dq) - 1u <
                     static_cast<unsigned>(max_gap_q)) &
                    (cj == ct);
    Term t;
    t.lgv = INFINITY;
    if (ok) t.lgv = __ldg(lg + abs(dr - dq));
    t.alpha = min(min(dq, dr), k);
    t.dq = dq;
    t.g = dr < dq ? dq - dr : -1;
    return t;
}

// pen of a term, bit-equal to the native core's
//   skip = 0.1 * max(0.0, dq - 2.0 * k)
//   pen  = dr >= dq ? lg + skip : 0.5 * g + 0.5 * lg + skip
// with fewer float64 operations: dq - 2k and the max are exact in int32,
// and 0.5 * g + 0.5 * lg rounds as 0.5 * (g + lg) does (halving is exact
// and commutes with rounding; lg >= 1 here).  Each remaining add and
// multiply is an explicit round-to-nearest intrinsic.
__device__ __forceinline__ double pen_of(const Term& t, int two_k) {
    const double skip = __dmul_rn(
        0.1, static_cast<double>(max(t.dq, two_k) - two_k));
    const double half =
        __dmul_rn(0.5, __dadd_rn(static_cast<double>(t.g), t.lgv));
    return __dadd_rn(t.g < 0 ? t.lgv : half, skip);
}

__device__ __forceinline__ void load_anchor(const int* __restrict__ rr,
                                            const int* __restrict__ qq,
                                            const int* __restrict__ cc,
                                            int a, int n, int& r, int& q,
                                            int& c) {
    // past the row: a dummy no candidate admits (dr <= 0 from any anchor)
    r = a < n ? __ldg(rr + a) : 0;
    q = a < n ? __ldg(qq + a) : 0;
    c = a < n ? __ldg(cc + a) : 0;
}

// Step v of the terms' side, AHEAD steps before step v itself: lane
// (v & 31)'s slot (v >> 5) & 1 holds anchor v until now; it broadcasts it
// (the j of every candidate pushed at step v), takes its next step v + 64
// from the prefetched anchors, and every lane loads the terms of pair
// (v, t) for the step t each of its slots owns at step v.
struct Terms {
    int rt[2], qt[2], ct[2];       // the anchors of the owned steps
    int rp, qp, cp, rn, qn, cn;    // prefetched: this chunk's next, the next
};

// at the first step v of a chunk (v > 0): the prefetched anchors move up
__device__ __forceinline__ void next_chunk(Terms& st, int v, int lane, int n,
                                           const int* __restrict__ rr,
                                           const int* __restrict__ qq,
                                           const int* __restrict__ cc) {
    st.rp = st.rn;
    st.qp = st.qn;
    st.cp = st.cn;
    load_anchor(rr, qq, cc, v + 96 + lane, n, st.rn, st.qn, st.cn);
}

__device__ __forceinline__ void terms_step(
    Terms& st, int v, int lane, const double* __restrict__ lg, int k,
    int max_gap_r, int max_gap_q, Term* out) {
    const int src = v & 31;
    const int sv = (v >> 5) & 1;
    const int rj = __shfl_sync(FULL, sv ? st.rt[1] : st.rt[0], src);
    const int qj = __shfl_sync(FULL, sv ? st.qt[1] : st.qt[0], src);
    const int cj = __shfl_sync(FULL, sv ? st.ct[1] : st.ct[0], src);
#pragma unroll
    for (int s = 0; s < 2; ++s) {          // its slot moves to step v + 64
        const bool moves = (lane == src) & (sv == s);
        st.rt[s] = moves ? st.rp : st.rt[s];
        st.qt[s] = moves ? st.qp : st.qt[s];
        st.ct[s] = moves ? st.cp : st.ct[s];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
        out[s] = term_of(lg, rj, qj, cj, st.rt[s], st.qt[s], st.ct[s], k,
                         max_gap_r, max_gap_q);
}

__global__ void __launch_bounds__(DP_WARPS * 32)
chain_dp_kernel(const int64_t* __restrict__ offs, const int* __restrict__ r,
                const int* __restrict__ q, const int* __restrict__ ctg,
                int R, const double* __restrict__ lg, int k,
                int max_gap_r, int max_gap_q, double* __restrict__ f,
                int* __restrict__ pre) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * DP_WARPS + warp;
    if (row >= R) return;
    const int64_t base = offs[row];
    const int n = static_cast<int>(offs[row + 1] - base);
    const int* rr = r + base;
    const int* qq = q + base;
    const int* cc = ctg + base;
    double* fo = f + base;
    int* po = pre + base;
    const double kd = static_cast<double>(k);
    const int two_k = 2 * k;

    // slot s of lane l owns the steps t = l + 32 s (mod 64); before step 0
    // they are steps l and l + 32, and chunk c's resets take l + 32 (c + 2)
    Terms st;
#pragma unroll
    for (int s = 0; s < 2; ++s)
        load_anchor(rr, qq, cc, lane + 32 * s, n, st.rt[s], st.qt[s],
                    st.ct[s]);
    load_anchor(rr, qq, cc, lane + 64, n, st.rp, st.qp, st.cp);
    load_anchor(rr, qq, cc, lane + 96, n, st.rn, st.qn, st.cn);
    // the terms of steps i .. i + AHEAD - 1, queued by step mod AHEAD
    Term tq[AHEAD][2];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
        terms_step(st, u, lane, lg, k, max_gap_r, max_gap_q, tq[u]);

    // each slot's best so far (value, j) for the step it owns
    double bv[2] = {-INFINITY, -INFINITY};
    int bj[2] = {-1, -1};
    // step i's newest candidate's terms and its older window's best,
    // already set against k (k, -1 when nothing beats it)
    double al_c = 0.0, pe_c = INFINITY, old_v = kd, f_prev = 0.0;
    int old_j = -1;
    double f_out = 0.0;                    // f[i] and pre[i] in lane i & 31
    int p_out = -1;
    // bodies of AHEAD steps without a branch (steps past n run on the
    // dummies past the row and store nothing); a chunk of 32 steps starts
    // and ends at a body's edge
    int i0 = 0;
    for (; i0 < n; i0 += AHEAD) {
        const bool chunk_end = ((i0 + AHEAD) & 31) == 0;
        if (chunk_end)
            next_chunk(st, i0 + AHEAD, lane, n, rr, qq, cc);
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
            const int i = i0 + u;
            double pen[2];
#pragma unroll
            for (int s = 0; s < 2; ++s) pen[s] = pen_of(tq[u][s], two_k);
            // step i + 1's owner: its older window's best, read before
            // this step's pushes (complete since step i - 1; step i does
            // not push into it), and its newest candidate's terms
            const int src = (i + 1) & 31;
            const int s1 = ((i + 1) >> 5) & 1;
            const double bo = __shfl_sync(FULL, s1 ? bv[1] : bv[0], src);
            const int jo = __shfl_sync(FULL, s1 ? bj[1] : bj[0], src);
            const int al_n = __shfl_sync(
                FULL, s1 ? tq[u][1].alpha : tq[u][0].alpha, src);
            const double pe_n = __shfl_sync(FULL, s1 ? pen[1] : pen[0], src);
            // the serial path
            const double c = __dsub_rn(__dadd_rn(f_prev, al_c), pe_c);
            const bool take = c > old_v;
            const double fi = take ? c : old_v;
            const int pi = take ? i - 1 : old_j;
            f_prev = fi;
            const bool mine = lane == (i & 31);
            f_out = mine ? fi : f_out;
            p_out = mine ? pi : p_out;
            // push j = i into the steps each slot owns: t = i + d
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                const int d = (lane + 32 * s - i) & 63;
                const double cand = __dsub_rn(
                    __dadd_rn(fi, static_cast<double>(tq[u][s].alpha)),
                    pen[s]);
                // d == 0: its step was i, now i + 64.  Bitwise, so that
                // nvcc selects instead of branching on the compare
                const bool up = (d == 0) | ((d >= 2) & (cand > bv[s]));
                bv[s] = up ? cand : bv[s];
                bj[s] = up ? i : bj[s];
            }
            al_c = static_cast<double>(al_n);
            pe_c = pe_n;
            old_v = bo > kd ? bo : kd;
            old_j = bo > kd ? jo : -1;
            // the terms of step i + AHEAD take this step's queue entry
            terms_step(st, i + AHEAD, lane, lg, k, max_gap_r, max_gap_q,
                       tq[u]);
        }
        if (chunk_end) {
            const int a = i0 + AHEAD - 32 + lane;
            if (a < n) {
                fo[a] = f_out;
                po[a] = p_out;
            }
        }
    }
    if (i0 & 31) {                         // the last chunk, if partial
        const int a = (i0 & ~31) + lane;
        if (a < n) {
            fo[a] = f_out;
            po[a] = p_out;
        }
    }
}

// f as a 64-bit key whose unsigned order is f's (the sign bit flipped for
// f >= 0, every bit for f < 0); 0 is below every key of a number.
__device__ __forceinline__ unsigned long long f_key(double f) {
    const unsigned long long b =
        static_cast<unsigned long long>(__double_as_longlong(f));
    return b >> 63 ? ~b : b | (1ull << 63);
}

// One doubling pass over the pre forest: rounds until no anchor has an
// ancestor left, anc[v] = anc[anc[v]] each round (ping-pong rows, one block
// barrier a round), ``fold(v, a)`` folding v's value into its ancestor a
// (an atomic whose result no one waits for).  Returns the row the last
// round wrote, free for other use.
template <typename AncT, typename Fold>
__device__ __forceinline__ AncT* doubling(int n, AncT* anc_a, AncT* anc_b,
                                          bool any, Fold fold) {
    AncT* cur = anc_a;
    AncT* nxt = anc_b;
    any = __syncthreads_or(any);
    while (any) {
        any = false;
        for (int v = threadIdx.x; v < n; v += EXT_THREADS) {
            const int a = cur[v];
            int a2 = -1;
            if (a >= 0) {
                fold(v, a);
                a2 = cur[a];
            }
            nxt[v] = static_cast<AncT>(a2);
            any |= a2 >= 0;
        }
        any = __syncthreads_or(any);
        AncT* t = cur;
        cur = nxt;
        nxt = t;
    }
    return nxt;
}

// One row of n anchors: f and pre (the row's, global), the ancestor
// ping-pong rows anc_a / anc_b, the subtree keys ``top``, the owners
// ``own`` and counts ``cnt`` (n each).  Writes the row's cid, scores and
// nch.
template <typename AncT>
__device__ void extract_row(int n, const double* __restrict__ f,
                            const int* __restrict__ pre, AncT* anc_a,
                            AncT* anc_b, unsigned long long* top, int* own,
                            int* cnt, int* n_chains, double min_score,
                            int min_anchors, int max_chains,
                            int8_t* __restrict__ cid,
                            double* __restrict__ scores_row,
                            int* __restrict__ nch_row) {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    // pass 1: top[v] = the largest f key of the candidates at or below v
    bool any = false;
    for (int v = tid; v < n; v += EXT_THREADS) {
        const int p = pre[v];
        const double fv = f[v];
        anc_a[v] = static_cast<AncT>(p);
        top[v] = fv >= min_score ? f_key(fv) : 0ull;
        any |= p >= 0;
    }
    doubling(n, anc_a, anc_b, any, [&](int v, int a) {
        const unsigned long long k = top[v];
        if (k) atomicMax(top + a, k);
    });
    // pass 2: own[v] = the smallest index among the candidates at or below
    // v whose key is top[v]; the path from such a candidate up to v holds
    // top = top[v] all the way, so a value moves only between equal tops
    any = false;
    for (int v = tid; v < n; v += EXT_THREADS) {
        const int p = pre[v];
        const double fv = f[v];
        anc_a[v] = static_cast<AncT>(p);
        own[v] = fv >= min_score && f_key(fv) == top[v] ? v : INT_MAX;
        cnt[v] = 0;
        any |= p >= 0;
    }
    AncT* list = doubling(n, anc_a, anc_b, any, [&](int v, int a) {
        const int c = own[v];
        if (c != INT_MAX && top[v] == top[a]) atomicMin(own + a, c);
    });
    for (int v = tid; v < n; v += EXT_THREADS) {
        const int c = own[v];
        if (c != INT_MAX) atomicAdd(cnt + c, 1);
    }
    __syncthreads();
    // the chains: candidates that own themselves and >= min_anchors
    // anchors, listed in ``list``; cnt of every owner becomes -1 (no chain)
    // or -2 (a chain, its id set below)
    for (int c = tid; c < n; c += EXT_THREADS) {
        if (own[c] != c) continue;
        const bool chain = cnt[c] >= min_anchors;
        cnt[c] = chain ? -2 : -1;
        if (chain) list[atomicAdd(n_chains, 1)] = static_cast<AncT>(c);
    }
    __syncthreads();
    // a chain's id: the chains before it in greedy order (f descending,
    // index ascending), counted by a warp
    const int nc = *n_chains;
    for (int t = warp; t < nc; t += EXT_THREADS / 32) {
        const int c = list[t];
        const unsigned long long kc = top[c];
        int before = 0;
        for (int u = lane; u < nc; u += 32) {
            const int d = list[u];
            const unsigned long long kd = top[d];
            before += kd > kc || (kd == kc && d < c);
        }
        const int id = __reduce_add_sync(FULL, before);
        if (lane == 0) {
            cnt[c] = id < max_chains ? id : -1;
            if (id < max_chains) scores_row[id] = f[c];
        }
    }
    __syncthreads();
    for (int v = tid; v < n; v += EXT_THREADS) {
        const int c = own[v];
        cid[v] = static_cast<int8_t>(c != INT_MAX ? cnt[c] : -1);
    }
    if (tid == 0) *nch_row = min(nc, max_chains);
}

// goff[b]: row b's offset into the global scratch (at least its length),
// or -1 for a row that fits shared memory.  Dynamic shared memory: the
// subtree keys (8 bytes), owners and counts (4 each) and two ancestor
// rows (2 each) a slot, sized by the wrapper for the launch's longest
// shared-memory row.
__global__ void __launch_bounds__(EXT_THREADS)
chain_extract_kernel(const int64_t* __restrict__ offs,
                     const double* __restrict__ f, const int* __restrict__ pre,
                     int R, int cap, double min_score, int min_anchors,
                     int max_chains, const int64_t* __restrict__ goff,
                     int* gscratch, int8_t* __restrict__ cid,
                     double* __restrict__ scores, int* __restrict__ nch) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int n_chains;
    const int row = blockIdx.x;
    const int tid = threadIdx.x;
    const int64_t base = offs[row];
    const int n = static_cast<int>(offs[row + 1] - base);
    if (tid == 0) n_chains = 0;
    const int64_t g = goff[row];
    double* scores_row = scores + (int64_t)row * max_chains;
    if (g < 0) {
        unsigned long long* top = reinterpret_cast<unsigned long long*>(smem);
        int* own = reinterpret_cast<int*>(top + cap);
        int* cnt = own + cap;
        int16_t* anc_a = reinterpret_cast<int16_t*>(cnt + cap);
        int16_t* anc_b = anc_a + cap;
        extract_row<int16_t>(n, f + base, pre + base, anc_a, anc_b, top, own,
                             cnt, &n_chains, min_score, min_anchors,
                             max_chains, cid + base, scores_row, nch + row);
    } else {
        // six int rows of the row's slots: the keys (two ints a slot),
        // owners, counts and the ancestors twice
        int* s = gscratch + 6 * g;
        extract_row<int>(n, f + base, pre + base, s + 4 * n, s + 5 * n,
                         reinterpret_cast<unsigned long long*>(s), s + 2 * n,
                         s + 3 * n, &n_chains, min_score, min_anchors,
                         max_chains, cid + base, scores_row, nch + row);
    }
}

}  // namespace

// log2(g + 1) for g in [0, n), from the host's libm (std::log2): the table
// the DP kernel reads, filled into the caller's host buffer.
extern "C" void chain_log2_table(double* out, int n) {
    for (int g = 0; g < n; ++g)
        out[g] = std::log2(static_cast<double>(g) + 1.0);
}

// One warp a row; ``lg`` holds more than max(max_gap_r, max_gap_q) entries
// on the device, so every admissible g = |dr - dq| has its entry.  Launches
// on ``stream`` and returns cudaGetLastError().
extern "C" int chain_dp_launch(const void* offs, const void* r, const void* q,
                               const void* ctg, int R, const void* lg,
                               int k, int max_gap_r, int max_gap_q,
                               void* f, void* pre, void* stream) {
    if (R == 0) return 0;
    const int blocks = (R + DP_WARPS - 1) / DP_WARPS;
    chain_dp_kernel<<<blocks, DP_WARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(offs), static_cast<const int*>(r),
        static_cast<const int*>(q), static_cast<const int*>(ctg), R,
        static_cast<const double*>(lg), k, max_gap_r, max_gap_q,
        static_cast<double*>(f), static_cast<int*>(pre));
    return static_cast<int>(cudaGetLastError());
}

// One block a row; rows with goff[b] < 0 must hold at most ``cap`` anchors
// (a power of two up to SMEM_ROW, which ops/chain.py::SMEM_ROW mirrors),
// the others have 6 * (their slots) ints of ``gscratch`` from 6 * goff[b].
extern "C" int chain_extract_launch(const void* offs, const void* f,
                                    const void* pre, int R, int cap,
                                    double min_score, int min_anchors,
                                    int max_chains, const void* goff,
                                    void* gscratch, void* cid, void* scores,
                                    void* nch, void* stream) {
    if (R == 0) return 0;
    if (cap < 1 || cap > SMEM_ROW || (cap & (cap - 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = cap * 20;             // see chain_extract_kernel
    cudaError_t err = cudaFuncSetAttribute(
        chain_extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    chain_extract_kernel<<<R, EXT_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(offs), static_cast<const double*>(f),
        static_cast<const int*>(pre), R, cap, min_score, min_anchors,
        max_chains, static_cast<const int64_t*>(goff),
        static_cast<int*>(gscratch), static_cast<int8_t*>(cid),
        static_cast<double*>(scores), static_cast<int*>(nch));
    return static_cast<int>(cudaGetLastError());
}
