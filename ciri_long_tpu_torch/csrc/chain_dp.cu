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
//   chain_extract_kernel  one block a row.  Candidates are compacted into
//                         (f's bits, index) keys, bitonic-sorted by the
//                         block (f is >= k > 0, so its bits order as its
//                         value), then one thread walks the greedy over a
//                         shared-memory used mask and predecessor copy.
//                         Rows up to SMEM_ROW anchors keep everything in
//                         shared memory; a longer row (a single read's map
//                         is not truncated) sorts and walks in global
//                         scratch the wrapper gives it.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 64;                 // predecessors a step (CHAIN_WINDOW)
constexpr int DP_WARPS = 4;                // rows a block of the DP
constexpr int AHEAD = 8;                   // steps a candidate's terms lead
                                           // its push (divides 32)
constexpr int EXT_THREADS = 256;
constexpr int SMEM_ROW = 8192;             // longest row sorted in smem
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

// (key, index) before (key2, index2) in the greedy's order: descending f,
// ascending index
__device__ __forceinline__ bool before(uint64_t ka, uint32_t ia, uint64_t kb,
                                       uint32_t ib) {
    return ka > kb || (ka == kb && ia < ib);
}

template <typename IdxT, typename PreT>
__device__ void extract_row(int n, const double* __restrict__ fr,
                            uint64_t* key, IdxT* idx, const PreT* pre_w,
                            uint8_t* used, int8_t* cid_w, int* n_cand,
                            double min_score, int min_anchors, int max_chains,
                            double* scores_row, int* nch_row) {
    const int tid = threadIdx.x;
    for (int a = tid; a < n; a += EXT_THREADS) {
        const double fa = fr[a];
        if (fa >= min_score) {
            const int p = atomicAdd(n_cand, 1);
            key[p] = static_cast<uint64_t>(__double_as_longlong(fa));
            idx[p] = static_cast<IdxT>(a);
        }
    }
    __syncthreads();
    const int nc = *n_cand;
    int P = 1;
    while (P < nc) P <<= 1;
    for (int p = nc + tid; p < P; p += EXT_THREADS) {
        key[p] = 0;                        // +0.0: after every candidate
        idx[p] = static_cast<IdxT>(~0u);
    }
    __syncthreads();
    for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int p = tid; p < P; p += EXT_THREADS) {
                const int o = p ^ stride;
                if (o > p) {
                    const uint64_t kp = key[p], ko = key[o];
                    const uint32_t ip = static_cast<uint32_t>(idx[p]);
                    const uint32_t io = static_cast<uint32_t>(idx[o]);
                    const bool fwd = (p & size) == 0;
                    if (fwd ? before(ko, io, kp, ip) : before(kp, ip, ko, io)) {
                        key[p] = ko;
                        key[o] = kp;
                        idx[p] = static_cast<IdxT>(io);
                        idx[o] = static_cast<IdxT>(ip);
                    }
                }
            }
            __syncthreads();
        }
    }
    if (tid == 0) {
        int nch = 0;
        for (int t = 0; t < nc && nch < max_chains; ++t) {
            const int a = static_cast<int>(idx[t]);
            if (used[a]) continue;
            int plen = 0;
            for (int v = a; v >= 0 && !used[v]; v = pre_w[v]) {
                used[v] = 1;
                ++plen;
            }
            if (plen < min_anchors) continue;
            int v = a;
            for (int s = 0; s < plen; ++s) {
                cid_w[v] = static_cast<int8_t>(nch);
                v = pre_w[v];
            }
            scores_row[nch] = fr[a];
            ++nch;
        }
        *nch_row = nch;
    }
    __syncthreads();
}

// goff[b]: row b's offset into the global scratch (next power of two of
// its length a row), or -1 for a row that fits shared memory.  Dynamic
// shared memory: SMEM_ROW-capped keys (8 bytes), indices (2), predecessors
// (2), used (1) and ids (1) a slot, sized by the wrapper for the launch's
// longest shared-memory row.
__global__ void __launch_bounds__(EXT_THREADS)
chain_extract_kernel(const int64_t* __restrict__ offs,
                     const double* __restrict__ f, const int* __restrict__ pre,
                     int R, int cap, double min_score, int min_anchors,
                     int max_chains, const int64_t* __restrict__ goff,
                     uint64_t* gkey, int* gidx, uint8_t* gused,
                     int8_t* __restrict__ cid, double* __restrict__ scores,
                     int* __restrict__ nch) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int n_cand;
    const int row = blockIdx.x;
    const int tid = threadIdx.x;
    const int64_t base = offs[row];
    const int n = static_cast<int>(offs[row + 1] - base);
    if (tid == 0) n_cand = 0;
    const int64_t g = goff[row];
    if (g < 0) {
        uint64_t* key = reinterpret_cast<uint64_t*>(smem);
        uint16_t* idx = reinterpret_cast<uint16_t*>(key + cap);
        int16_t* pre_s = reinterpret_cast<int16_t*>(idx + cap);
        uint8_t* used = reinterpret_cast<uint8_t*>(pre_s + cap);
        int8_t* cid_s = reinterpret_cast<int8_t*>(used + cap);
        for (int a = tid; a < n; a += EXT_THREADS) {
            pre_s[a] = static_cast<int16_t>(pre[base + a]);
            used[a] = 0;
            cid_s[a] = -1;
        }
        __syncthreads();
        extract_row<uint16_t, int16_t>(
            n, f + base, key, idx, pre_s, used, cid_s, &n_cand, min_score,
            min_anchors, max_chains, scores + (int64_t)row * max_chains,
            nch + row);
        for (int a = tid; a < n; a += EXT_THREADS) cid[base + a] = cid_s[a];
    } else {
        uint8_t* used = gused + g;
        for (int a = tid; a < n; a += EXT_THREADS) {
            used[a] = 0;
            cid[base + a] = -1;
        }
        __syncthreads();
        extract_row<int, int>(n, f + base, gkey + g, gidx + g, pre + base,
                              used, cid + base, &n_cand, min_score,
                              min_anchors, max_chains,
                              scores + (int64_t)row * max_chains, nch + row);
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
// (a power of two up to SMEM_ROW, which ops/chain.py::SMEM_ROW mirrors).
extern "C" int chain_extract_launch(const void* offs, const void* f,
                                    const void* pre, int R, int cap,
                                    double min_score, int min_anchors,
                                    int max_chains, const void* goff,
                                    void* gkey, void* gidx, void* gused,
                                    void* cid, void* scores, void* nch,
                                    void* stream) {
    if (R == 0) return 0;
    if (cap < 1 || cap > SMEM_ROW || (cap & (cap - 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = cap * 14;             // see chain_extract_kernel
    cudaError_t err = cudaFuncSetAttribute(
        chain_extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    chain_extract_kernel<<<R, EXT_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(offs), static_cast<const double*>(f),
        static_cast<const int*>(pre), R, cap, min_score, min_anchors,
        max_chains, static_cast<const int64_t*>(goff),
        static_cast<uint64_t*>(gkey), static_cast<int*>(gidx),
        static_cast<uint8_t*>(gused), static_cast<int8_t*>(cid),
        static_cast<double*>(scores), static_cast<int*>(nch));
    return static_cast<int>(cudaGetLastError());
}
