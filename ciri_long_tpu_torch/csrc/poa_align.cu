// Sequence-to-graph alignment for collapse's POA consensus, for Hopper, and
// the host round loop that runs a poa_consensus_many call's rounds around it.
//
// Replaces the XLA device program of ciri_long_tpu/ops/poa_batch.py
// (``_align_one:39``, ``_align_one_win:194``, ``poa_align_batch:391``;
// ROADMAP X6), the twin of native/poacore.cpp::AlignCore:44.  Each job
// aligns a sequence seq[n] (codes 0-4) to a partial-order graph of V nodes
// in topological rank order, each with a base and a predecessor list in
// insertion order (CSR: ``offs``, ``preds`` as rank + 1, row 0 the virtual
// source; an empty list stands for [0]).  Two-piece affine gaps in overlap
// mode, scores (m, x, o1, e1, o2, e2).  Row 0 holds the sequence prefix as
// one two-piece gap.  Row i, columns j = 0..n:
//   F1[j]  = max_k max(F1[p_k][j] + e1, H[p_k][j] + o1)      (F2 alike)
//   M[j]   = max(H[p_0][j-1], .., H[p_np-1][j-1], H[0][j-1]) + s(j), the
//            first maximum's row kept (0: the source)        M[0] = NEG
//   Hpre   = max(M, F1, F2), Hpre[0] raised to 0 (free leading overhang)
//   E1[j]  = max_{k<j}(Hpre[k] - k e1) + o1 + (j-1) e1        (E2 alike)
//   H      = max(Hpre, E1, E2)
// and a direction word: case GAPSEQ if H is an E, else MATCH if H is M
// (with M's row), else GAPGRAPH if H is an F (with the row of the first
// predecessor whose max(F1 + e1, H + o1, F2 + e2, H + o2) is the largest),
// else STOP.  The end is the first maximum of H over column n, rows 0..V
// (free trailing overhang); the walk from it flushes to GAPSEQ at row 0 or
// after a stop and gives the score and the (rank | -1, pos | -1) pairs in
// forward order.  Every value and tie equals the JAX program's (int32
// throughout).
//
// A launch takes the batch layout of ops/poa_batch.py (JAX's): job b's
// nodes in row b of bases [B, Vmax], its CSR offsets in row b of
// offs [B, Vmax + 1], its codes in row b of seqs [B, nmax], its sizes in
// nv and ns [B]; its direction words are the b-th block of (Vmax + 1) rows
// of Wp = nmax + 1 rounded up to 8 words; its pairs end row b of
// aln [B, Vmax + nmax + 1, 2].
//
// Kernel design: one block per job, its warps pipelined over the graph's
// rows: warp w takes rows w + 1, w + 1 + K, ... (K warps), and sweeps each
// in chunks of 32 C columns, lane l on C consecutive columns of a chunk
// (C = 1-8 and K = 1-16 by the launch's longest sequence, the plan's).
// Row i takes chunk ch once row i - 1 has published chunk ch (a progress
// counter a warp in shared memory), so up to K rows are in flight, each a
// chunk behind the one before, and no block barrier stands in the row
// loop.  What a chunk reads is on chip:
//   - the job's bases, CSR offsets and lists, spill slots and sequence are
//     copied to shared memory before the row loop ("staged"; a graph too
//     large for that is read from global memory);
//   - each row publishes, per column, H and the two values its successors
//     need, V1 = max(F1 + e1, H + o1) and V2 = max(F2 + e2, H + o2), to a
//     ring of ``depth`` rows in dynamic shared memory (12 bytes a cell),
//     row r in slot r % depth; a predecessor up to ``depth`` rows back is
//     read from the ring;
//   - a predecessor's H left of a lane's run is a shuffle from the lane
//     before; for lane 0 the chunk before's lane 31 carries the diagonal
//     term itself (the first maximum over the predecessors of their H in
//     its last column), so no lane reads a column another lane writes;
//   - the source row is computed inline;
//   - a predecessor beyond the ring is read from a global spill copy, which
//     the kernel writes only for the rows the host flagged (some later row
//     reaches them from beyond the ring; ``sidx`` numbers them), so the
//     result is exact for any lookback.
// The E terms need the prefix maximum of g[k] = Hpre[k] - k e, one for each
// piece: a chunk's lanes by five shuffles, the chunks before by a carry in
// registers.  Why the ring is safe: row i waits for row i - 1's chunk ch,
// and row i - 1 waited for row i - 2's, so every row before i has done
// chunk ch when row i reads it.  Row i writes chunk ch of slot i % depth
// over row i - depth, whose readers are rows up to i: those before i have
// done chunk ch, and row i reads it before writing.  A chunk's writes are
// fenced (block scope) before its lane 0 publishes the counter, and a
// reader fences after its wait.
// The direction word is case << 30 | the predecessor's row, the only plane
// that reaches global memory; the walk reads one word a step.  Warp 0
// walks: each round every lane loads the current cell's word, lanes 1-15
// the 15 cells left of it in its row (a run of gaps in the sequence) and
// lanes 16-31 the cells a step after it in its first eight predecessors'
// rows, so a round's one trip to L2 serves the step and often the next.
// Lane 0 writes the pairs from the end of the job's slots back, so they
// lie in forward order.
//
// Bound: operations.  A cell does ~20 integer operations a predecessor;
// at the card's rate for this update (csrc/op_rate.cu, kind 3) they take
// longer than the 4-byte direction word a cell at 3.35 TB/s.  A job is one
// block, so a launch of one job is latency bound: a chunk costs a wait, a
// warp scan and shared-memory round trips, and the rows in flight overlap
// them; a walk step costs an L2 round trip.
//
// The row field of the word holds ranks below 2^30: the wrapper
// (ops/poa_batch.py::poa_align_batch_cuda) and the round loop refuse a
// larger graph.  Any in-degree is taken.
//
// poa_consensus_run is the host round loop: csrc/poa_graph.h's Rounds packs
// every pending job's graph (collapse's calls hold one job each), the
// round's plan (ring depth, spill rows) is made, the inputs go up, one
// launch aligns them all, the pairs come down and are fused, until every
// queue is empty; then the consensus.  It is called through ctypes (which
// releases the interpreter lock) from several threads at once: no static
// mutable state but the kernels' one-time shared-memory attribute, device
// buffers from cudaMallocAsync on the caller's stream, one stream per
// calling thread, and the wait for each round on a blocking-sync event, so
// a waiting thread yields its core instead of spinning.

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cuda_runtime.h>

#include "poa_graph.h"

namespace {

constexpr int NEG = -(1 << 28);
constexpr int LOW = -(1 << 30);       // below every prefix value
constexpr int MAX_WARPS = 16;
constexpr unsigned FULL = 0xffffffffu;
enum { STOP = 0, GAPSEQ = 1, MATCH = 2, GAPGRAPH = 3 };
constexpr int CASE_SHIFT = 30;
constexpr uint32_t ROW_MASK = (1u << CASE_SHIFT) - 1;
constexpr int MAX_ROW = (1 << CASE_SHIFT) - 1;
// dynamic shared memory a block takes at most: the card's 227 KB less a
// reserve for the static arrays
constexpr int SMEM_BYTES = 232448 - 1024;
constexpr int ROW_ALIGN = 8;          // words a ring or direction row pads to
constexpr int WALK_RUN = 16;          // lanes 0-15 of a walk round: one row
constexpr int PREDS = 4;              // predecessors a row keeps in registers

// warps a block at most for C columns a lane (8 columns take more
// registers)
__host__ __device__ constexpr int max_warps(int C) {
    return C == 8 ? 8 : MAX_WARPS;
}

struct Scores {
    int m, x, o1, e1, o2, e2;
};

// A launch's dynamic shared memory: the ring (depth rows of H, V1, V2,
// Wp ints each), then, when staged, offs, preds, sidx, bases and the
// sequence at these byte offsets.
struct Layout {
    int Wp, depth, staged;
    int offs_at, preds_at, sidx_at, bases_at, seq_at, bytes;
};

int64_t round16(int64_t x) { return (x + 15) / 16 * 16; }

Layout make_layout(int Vmax, int nmax, int emax, int depth) {
    Layout L{};
    L.Wp = (nmax + 1 + ROW_ALIGN - 1) / ROW_ALIGN * ROW_ALIGN;
    L.depth = depth;
    const int64_t ring = static_cast<int64_t>(depth) * 3 * L.Wp * 4;
    const int64_t preds_at = ring + round16(4 * (int64_t(Vmax) + 1));
    const int64_t sidx_at = preds_at + round16(4 * int64_t(emax));
    const int64_t bases_at = sidx_at + round16(4 * (int64_t(Vmax) + 1));
    const int64_t seq_at = bases_at + round16(Vmax);
    const int64_t end = seq_at + round16(nmax);
    L.staged = end <= SMEM_BYTES;
    if (L.staged) {
        L.offs_at = static_cast<int>(ring);
        L.preds_at = static_cast<int>(preds_at);
        L.sidx_at = static_cast<int>(sidx_at);
        L.bases_at = static_cast<int>(bases_at);
        L.seq_at = static_cast<int>(seq_at);
    }
    L.bytes = static_cast<int>(std::min<int64_t>(L.staged ? end : ring,
                                                 INT32_MAX));
    return L;
}

// H of the source row: the sequence's first j codes as one two-piece gap
__device__ __forceinline__ int source_h(int j, const Scores& s) {
    return j == 0 ? 0 : max(s.o1 + (j - 1) * s.e1, s.o2 + (j - 1) * s.e2);
}

// Where a chunk reads predecessor p of row i: its ring slot's offset, or
// -1 for the spill copy (the source row, p = 0, is computed inline).
__device__ __forceinline__ int pred_offset(int i, int p, int D, int Wp) {
    return p > 0 && i - p <= D ? (p % D) * 3 * Wp : -1;
}

// A fence at block scope: a chunk's writes before its counter, a reader's
// wait before its loads.
__device__ __forceinline__ void fence_cta() {
    asm volatile("fence.acq_rel.cta;" ::: "memory");
}

__device__ __forceinline__ long long clock_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// A lane's run of C words (16-byte aligned when C >= 4); ``cg`` loads
// around L1 (the spill rows, which other warps write)
template <int C, bool cg = false, typename T>
__device__ __forceinline__ void load_run(const T* p, T (&v)[C]) {
    if constexpr (C >= 4) {
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
            const int4* a = reinterpret_cast<const int4*>(p) + q;
            const int4 w = cg ? __ldcg(a) : *a;
            v[4 * q] = static_cast<T>(w.x);
            v[4 * q + 1] = static_cast<T>(w.y);
            v[4 * q + 2] = static_cast<T>(w.z);
            v[4 * q + 3] = static_cast<T>(w.w);
        }
    } else if constexpr (C == 2) {
        const int2* a = reinterpret_cast<const int2*>(p);
        const int2 w = cg ? __ldcg(a) : *a;
        v[0] = static_cast<T>(w.x);
        v[1] = static_cast<T>(w.y);
    } else {
        v[0] = cg ? __ldcg(p) : p[0];
    }
}

template <int C, typename T>
__device__ __forceinline__ void store_run(T* p, const T (&v)[C]) {
    if constexpr (C >= 4) {
#pragma unroll
        for (int q = 0; q < C / 4; ++q)
            reinterpret_cast<int4*>(p)[q] =
                make_int4(static_cast<int>(v[4 * q]),
                          static_cast<int>(v[4 * q + 1]),
                          static_cast<int>(v[4 * q + 2]),
                          static_cast<int>(v[4 * q + 3]));
    } else if constexpr (C == 2) {
        *reinterpret_cast<int2*>(p) =
            make_int2(static_cast<int>(v[0]), static_cast<int>(v[1]));
    } else {
        p[0] = v[0];
    }
}

template <int C>
__global__ void __launch_bounds__(32 * max_warps(C))
poa_align_kernel(Layout L, int Vmax, int nmax,
                 const uint8_t* __restrict__ bases,
                 const int32_t* __restrict__ offs,
                 const int32_t* __restrict__ preds,
                 const uint8_t* __restrict__ seqs,
                 const int32_t* __restrict__ nvs,
                 const int32_t* __restrict__ nss,
                 const int32_t* __restrict__ sidx, int* __restrict__ spill,
                 int spill_rows, uint32_t* __restrict__ dirs, Scores s,
                 int* __restrict__ score, int* __restrict__ acnt,
                 int* __restrict__ aln, long long* __restrict__ stamps) {
    constexpr int CHUNK = 32 * C;
    extern __shared__ int4 dyn[];
    int* const ring = reinterpret_cast<int*>(dyn);
    // each warp's progress: (row - 1) * chunks + the chunks of row done
    __shared__ long long done[MAX_WARPS];
    __shared__ int wbest[MAX_WARPS], wrow[MAX_WARPS];

    const int64_t job = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int T = blockDim.x, K = T >> 5;
    if (stamps && tid == 0) stamps[3 * job] = clock_ns();
    const int nv = nvs[job], n = nss[job], W = n + 1, Wp = L.Wp;
    const int D = L.depth, nch = (W + CHUNK - 1) / CHUNK;

    // the job's static inputs, staged in shared memory when they fit
    const int32_t* of = offs + job * (Vmax + 1);
    const int e0 = of[0];
    const int32_t* pr = preds + e0;
    const int32_t* si = sidx ? sidx + job * (Vmax + 1) : nullptr;
    const uint8_t* bs = bases + job * Vmax;
    const uint8_t* sq = seqs + job * nmax;
    if (L.staged) {
        char* base = reinterpret_cast<char*>(dyn);
        auto* of_s = reinterpret_cast<int32_t*>(base + L.offs_at);
        auto* pr_s = reinterpret_cast<int32_t*>(base + L.preds_at);
        auto* si_s = reinterpret_cast<int32_t*>(base + L.sidx_at);
        auto* bs_s = reinterpret_cast<uint8_t*>(base + L.bases_at);
        auto* sq_s = reinterpret_cast<uint8_t*>(base + L.seq_at);
        const int E = of[nv] - e0;
        for (int k = tid; k <= nv; k += T) of_s[k] = of[k];
        for (int k = tid; k < E; k += T) pr_s[k] = pr[k];
        if (si)
            for (int k = tid; k <= nv; k += T) si_s[k] = si[k];
        for (int k = tid; k < nv; k += T) bs_s[k] = bs[k];
        for (int k = tid; k < n; k += T) sq_s[k] = sq[k];
        of = of_s;
        pr = pr_s;
        if (si) si = si_s;
        bs = bs_s;
        sq = sq_s;
    }
    int* const spill_job = spill + job * spill_rows * 3 * int64_t(Wp);
    uint32_t* const dir_job = dirs + job * (Vmax + 1) * int64_t(Wp);
    if (tid < MAX_WARPS) done[tid] = 0;
    // this lane's first maximum of H over column n, its warp's rows
    int best = LOW, best_row = -1;
    __syncthreads();

    for (int i = warp + 1; i <= nv; i += K) {
        const int b = bs[i - 1];
        const int lo = of[i - 1] - e0, np = of[i] - e0 - lo;
        const int npe = np > 0 ? np : 1;
        const int sidx_i = si ? si[i] : -1;
        int* const slot_i = ring + (D > 0 ? i % D : 0) * 3 * Wp;
        // the first PREDS predecessors' rows and where their values lie
        int prow[PREDS], poff[PREDS];
#pragma unroll
        for (int k = 0; k < PREDS; ++k) {
            prow[k] = k < npe ? (np > 0 ? pr[lo + k] : 0) : 0;
            poff[k] = pred_offset(i, prow[k], D, Wp);
        }
        // row i - 1's warp, and its progress once it has done chunk ch
        const volatile long long* const before = done + (i + K - 2) % K;
        const long long wait0 = static_cast<long long>(i - 2) * nch + 1;
        uint32_t* const diri = dir_job + int64_t(i) * Wp;
        int carry1 = LOW, carry2 = LOW;    // g's maximum left of the chunk
        int mn = NEG, pmn = 0;             // lane 0's diagonal (see below)

        for (int ch = 0; ch < nch; ++ch) {
            const int c0 = ch * CHUNK + lane * C;
            const bool live = c0 < W;
            // before the wait, what no other warp writes: each column's
            // score against b, and H of the source row one column left
            int sc[C], hs[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int j = c0 + c;
                const int code = (j >= 1 && j <= n) ? sq[j - 1] : 5;
                sc[c] = code == b ? s.m : s.x;
                hs[c] = j > 0 ? source_h(j - 1, s) : NEG;
            }
            if (i > 1) {
                while (*before < wait0 + ch) {
                }
                fence_cta();
            }
            // pass A: the predecessors, in caller order; lane 31 also
            // keeps the first maximum of their H in its last column, the
            // diagonal term of the next chunk's first column
            int mrow[C], f1p[C], f2p[C], pm[C], pf[C];
            int mnext = NEG, pmnext = 0;
            auto visit = [&](int k, int p, int off) {
                int h[C], v1[C], v2[C];
                if (p == 0) {
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        h[c] = source_h(c0 + c, s);
                        v1[c] = max(NEG + s.e1, h[c] + s.o1);
                        v2[c] = max(NEG + s.e2, h[c] + s.o2);
                    }
                } else if (!live) {
#pragma unroll
                    for (int c = 0; c < C; ++c) h[c] = v1[c] = v2[c] = NEG;
                } else if (off >= 0) {
                    const int* src = ring + off + c0;
                    load_run<C>(src, h);
                    load_run<C>(src + Wp, v1);
                    load_run<C>(src + 2 * Wp, v2);
                } else {
                    const int* src = spill_job + int64_t(si[p]) * 3 * Wp + c0;
                    load_run<C, true>(src, h);
                    load_run<C, true>(src + Wp, v1);
                    load_run<C, true>(src + 2 * Wp, v2);
                }
                const int hl = __shfl_up_sync(FULL, h[C - 1], 1);
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const int hlc = c == 0 ? hl : h[c - 1];
                    if (k == 0) {
                        f1p[c] = v1[c];
                        f2p[c] = v2[c];
                        pf[c] = p;
                        mrow[c] = hlc;
                        pm[c] = p;
                    } else {
                        const int v = max(v1[c], v2[c]);
                        if (v > max(f1p[c], f2p[c])) pf[c] = p;
                        f1p[c] = max(f1p[c], v1[c]);
                        f2p[c] = max(f2p[c], v2[c]);
                        if (hlc > mrow[c]) {
                            mrow[c] = hlc;
                            pm[c] = p;
                        }
                    }
                }
                if (k == 0 || h[C - 1] > mnext) {
                    mnext = h[C - 1];
                    pmnext = p;
                }
            };
#pragma unroll
            for (int k = 0; k < PREDS; ++k)
                if (k < npe) visit(k, prow[k], poff[k]);
            for (int k = PREDS; k < npe; ++k) {
                const int p = pr[lo + k];
                visit(k, p, pred_offset(i, p, D, Wp));
            }
            if (lane == 0) {
                mrow[0] = mn;
                pm[0] = pmn;
            }
            // the source, the scores, Hpre and the run's maxima of g
            // (column 0, lane 0's of chunk 0, has no M and Hpre >= 0)
            int hpre[C];
            int g1 = LOW, g2 = LOW;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                if (hs[c] > mrow[c]) {
                    mrow[c] = hs[c];
                    pm[c] = 0;
                }
                mrow[c] += sc[c];
                if (c == 0 && c0 == 0) {
                    mrow[0] = NEG;
                    pm[0] = 0;
                }
                int hp = max(mrow[c], max(f1p[c], f2p[c]));
                if (c == 0 && c0 == 0) hp = max(hp, 0);
                hpre[c] = hp;
                const int j = c0 + c;
                g1 = max(g1, hp - j * s.e1);
                g2 = max(g2, hp - j * s.e2);
            }
            // scan: the prefix maxima of g over the lanes before, then the
            // chunks before
            int s1 = g1, s2 = g2;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const int u1 = __shfl_up_sync(FULL, s1, off);
                const int u2 = __shfl_up_sync(FULL, s2, off);
                if (lane >= off) {
                    s1 = max(s1, u1);
                    s2 = max(s2, u2);
                }
            }
            int m1 = __shfl_up_sync(FULL, s1, 1);
            int m2 = __shfl_up_sync(FULL, s2, 1);
            if (lane == 0) {
                m1 = LOW;
                m2 = LOW;
            }
            m1 = max(m1, carry1);
            m2 = max(m2, carry2);
            carry1 = max(carry1, __shfl_sync(FULL, s1, 31));
            carry2 = max(carry2, __shfl_sync(FULL, s2, 31));
            // pass B: E, H, the direction word and the values for the
            // successors
            uint32_t word[C];
            int hv[C], o1v[C], o2v[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                // column 0 has no E: LOW + o + (-1) e lies below its H >= 0
                const int j = c0 + c;
                const int hp = hpre[c];
                const int e1v = m1 + s.o1 + (j - 1) * s.e1;
                const int e2v = m2 + s.o2 + (j - 1) * s.e2;
                m1 = max(m1, hp - j * s.e1);
                m2 = max(m2, hp - j * s.e2);
                const int h = max(hp, max(e1v, e2v));
                const bool is_e = h == e1v || h == e2v;
                const bool is_m = h == mrow[c];
                const bool is_f = h == f1p[c] || h == f2p[c];
                const uint32_t cs = is_e ? GAPSEQ : is_m ? MATCH
                                  : is_f ? GAPGRAPH : STOP;
                const int row = is_m && !is_e ? pm[c] : pf[c];
                word[c] = cs << CASE_SHIFT | static_cast<uint32_t>(row);
                hv[c] = h;
                o1v[c] = max(f1p[c] + s.e1, h + s.o1);
                o2v[c] = max(f2p[c] + s.e2, h + s.o2);
            }
            if (ch == n / CHUNK) {             // the chunk of column n
#pragma unroll
                for (int c = 0; c < C; ++c)
                    if (c0 + c == n && hv[c] > best) {
                        best = hv[c];
                        best_row = i;
                    }
            }
            if (live) {
                store_run<C>(diri + c0, word);
                if (D > 0) {
                    store_run<C>(slot_i + c0, hv);
                    store_run<C>(slot_i + Wp + c0, o1v);
                    store_run<C>(slot_i + 2 * Wp + c0, o2v);
                }
                if (sidx_i >= 0) {
                    int* dst = spill_job + int64_t(sidx_i) * 3 * Wp + c0;
                    store_run<C>(dst, hv);
                    store_run<C>(dst + Wp, o1v);
                    store_run<C>(dst + 2 * Wp, o2v);
                }
            }
            mn = __shfl_sync(FULL, mnext, 31);
            pmn = __shfl_sync(FULL, pmnext, 31);
            // publish the chunk: every lane's writes, then the counter
            fence_cta();
            __syncwarp();
            if (lane == 0)
                *(volatile long long*)(done + warp) =
                    static_cast<long long>(i - 1) * nch + ch + 1;
        }
    }

    // the end: the first maximum of H over column n, rows 0..nv (the
    // source first; a warp's lane keeps its own rows' first maximum)
    if (n % CHUNK / C == lane) {
        wbest[warp] = best;
        wrow[warp] = best_row;
    }
    __syncthreads();
    if (stamps && tid == 0) stamps[3 * job + 1] = clock_ns();
    if (warp != 0) return;
    int end_score = source_h(n, s), end_row = 0;
    for (int w = 0; w < K; ++w) {
        if (wrow[w] >= 0 && (wbest[w] > end_score ||
                             (wbest[w] == end_score && wrow[w] < end_row))) {
            end_score = wbest[w];
            end_row = wrow[w];
        }
    }

    // the walk, warp 0; lane 0 writes the pairs from the end back
    const int cap = Vmax + nmax + 1;
    int* out = aln + 2 * job * cap;
    int i = end_row, j = n, t = 0;
    bool stopped = false;
    while (j > 0 && i > 0 && !stopped) {
        // this round's cells: lane 0 (i, j), lanes 1-15 (i, j - lane),
        // lanes 16-31 (p_k, j - 1) and (p_k, j) of predecessor k < 8
        const int lo = of[i - 1] - e0, np = of[i] - e0 - lo;
        int cr = i, cc = j - lane;
        if (lane >= WALK_RUN) {
            const int k = (lane - WALK_RUN) >> 1;
            cr = k < np ? pr[lo + k] : 0;
            cc = j - 1 + (lane & 1);
        }
        uint32_t cand = 0;
        if (lane > 0 && cr > 0 && cc > 0)
            cand = dir_job[int64_t(cr) * Wp + cc];
        uint32_t w = dir_job[int64_t(i) * Wp + j];
        for (;;) {
            const int cs = static_cast<int>(w >> CASE_SHIFT);
            if (cs == STOP) {
                stopped = true;
                break;
            }
            int pi = -1, pj = -1;
            if (cs == GAPSEQ) {
                pj = --j;
            } else {
                pi = i - 1;
                if (cs == MATCH) pj = --j;
                i = static_cast<int>(w & ROW_MASK);
            }
            ++t;
            if (lane == 0) {
                out[2 * (cap - t)] = pi;
                out[2 * (cap - t) + 1] = pj;
            }
            if (j == 0 || i == 0) break;
            const unsigned hit =
                __ballot_sync(FULL, lane > 0 && cr == i && cc == j);
            if (!hit) break;
            w = __shfl_sync(FULL, cand, __ffs(hit) - 1);
        }
    }
    // row 0 or a stop: the rest of the sequence as gaps
    for (int k = lane; k < j; k += 32) {
        out[2 * (cap - t - 1 - k)] = -1;
        out[2 * (cap - t - 1 - k) + 1] = j - 1 - k;
    }
    if (lane == 0) {
        score[job] = end_score;
        acnt[job] = t + j;
        if (stamps) stamps[3 * job + 2] = clock_ns();
    }
}

// The launch shape for rows of ``nmax`` + 1 columns: C columns a lane and
// the warps, one for each chunk of 32 C columns up to max_warps(C).
void launch_shape(int nmax, int& C, int& warps) {
    const int W = nmax + 1;
    C = W <= 512 ? 1 : W <= 1024 ? 2 : W <= 2048 ? 4 : 8;
    const int chunks = (W + 32 * C - 1) / (32 * C);
    warps = std::min(chunks, max_warps(C));
}

// The kernel's dynamic shared memory limit, raised once per instantiation
// (a function-local static: thread-safe, and the threads of the round loop
// launch at once).
template <int C>
cudaError_t allow_smem() {
    static const cudaError_t err = cudaFuncSetAttribute(
        poa_align_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    return err;
}

int launch(int B, int Vmax, int nmax, int C, int warps, int emax, int depth,
           const uint8_t* bases, const int32_t* offs, const int32_t* preds,
           const uint8_t* seqs, const int32_t* nv, const int32_t* ns,
           const int32_t* sidx, int* spill, int spill_rows, uint32_t* dir,
           const Scores& s, int* score, int* acnt, int* aln,
           long long* stamps, cudaStream_t st) {
    if (B <= 0) return 0;
    const Layout L = make_layout(Vmax, nmax, emax, depth);
    if ((C != 1 && C != 2 && C != 4 && C != 8) || warps < 1 ||
        warps > max_warps(C) || depth < 0 || L.bytes > SMEM_BYTES ||
        Vmax > MAX_ROW)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = C == 1 ? allow_smem<1>() : C == 2 ? allow_smem<2>()
                    : C == 4 ? allow_smem<4>() : allow_smem<8>();
    if (err != cudaSuccess) return static_cast<int>(err);
    auto kernel = C == 1 ? poa_align_kernel<1>
                : C == 2 ? poa_align_kernel<2>
                : C == 4 ? poa_align_kernel<4> : poa_align_kernel<8>;
    kernel<<<B, 32 * warps, L.bytes, st>>>(L, Vmax, nmax, bases, offs, preds,
                                           seqs, nv, ns, sidx, spill,
                                           spill_rows, dir, s, score, acnt,
                                           aln, stamps);
    return static_cast<int>(cudaGetLastError());
}

// A launch's plan on the host (ops/poa_batch.py::poa_plan is its twin):
// the ring depth, the longest job's list entries, and each row's spill
// slot (-1: none) in ``sidx`` [B, Vmax + 1]; returns the spill rows a job
// needs at most.  offs are absolute into preds, as Rounds::pack makes
// them.  The depth is the farthest lookback, within the room the staged
// inputs leave; a row is spilled when a successor reaches it from farther.
int plan_launch(int B, int Vmax, int nmax, const int32_t* offs,
                const int32_t* preds, const int32_t* nv, int& emax,
                int& depth, std::vector<int32_t>& sidx) {
    int look = 0;
    emax = 0;
    for (int b = 0; b < B; ++b) {
        const int32_t* of = offs + int64_t(b) * (Vmax + 1);
        emax = std::max(emax, of[nv[b]] - of[0]);
        for (int i = 1; i <= nv[b]; ++i)
            for (int e = of[i - 1]; e < of[i]; ++e)
                if (preds[e] > 0) look = std::max(look, i - preds[e]);
    }
    const Layout none = make_layout(Vmax, nmax, emax, 0);
    const int64_t row = int64_t(3) * none.Wp * 4;
    const int64_t room = none.staged ? SMEM_BYTES - none.bytes : SMEM_BYTES;
    depth = static_cast<int>(std::min<int64_t>(look, room / row));
    int most = 0;
    sidx.assign(int64_t(B) * (Vmax + 1), -1);
    for (int b = 0; b < B; ++b) {
        const int32_t* of = offs + int64_t(b) * (Vmax + 1);
        int32_t* row_slot = &sidx[int64_t(b) * (Vmax + 1)];
        for (int i = 1; i <= nv[b]; ++i)
            for (int e = of[i - 1]; e < of[i]; ++e)
                if (preds[e] > 0 && i - preds[e] > depth)
                    row_slot[preds[e]] = -2;
        int count = 0;
        for (int p = 0; p <= nv[b]; ++p)
            if (row_slot[p] == -2) row_slot[p] = count++;
        most = std::max(most, count);
    }
    return most;
}

// A device buffer that grows (stream-ordered) and never shrinks.
struct DeviceBuf {
    void* ptr = nullptr;
    size_t cap = 0;

    cudaError_t reserve(size_t bytes, cudaStream_t st) {
        if (bytes <= cap) return cudaSuccess;
        if (ptr) cudaFreeAsync(ptr, st);
        ptr = nullptr;
        cap = 0;
        const size_t want = bytes + bytes / 2;
        const cudaError_t err = cudaMallocAsync(&ptr, want, st);
        if (err == cudaSuccess) cap = want;
        return err;
    }

    void release(cudaStream_t st) {
        if (ptr) cudaFreeAsync(ptr, st);
        ptr = nullptr;
        cap = 0;
    }
};

template <typename T>
cudaError_t upload(DeviceBuf& buf, const std::vector<T>& v,
                   cudaStream_t st) {
    cudaError_t err = buf.reserve(v.size() * sizeof(T) + 16, st);
    if (err == cudaSuccess && !v.empty())
        err = cudaMemcpyAsync(buf.ptr, v.data(), v.size() * sizeof(T),
                              cudaMemcpyHostToDevice, st);
    return err;
}

}  // namespace

// Plain C entry point for ctypes: one launch over B jobs in the batch
// layout on device arrays: bases [B, Vmax] and seqs [B, nmax] uint8, offs
// [B, Vmax + 1] absolute into preds (int32), nv and ns int32 [B]; the plan
// of ops/poa_batch.py::poa_plan (C columns a lane, warps, the longest
// job's list entries, ring depth, sidx int32 [B, Vmax + 1] or null without
// spill rows, spill int32 of B spill_rows rows of 3 Wp); the direction
// words, uint32 of B (Vmax + 1) Wp; outputs score and acnt int32 [B] and
// aln int32 [B, Vmax + nmax + 1, 2]; stamps, int64 [B, 3] or null, gets
// each block's %globaltimer at its start, after its rows and after its
// walk.  Launches on ``stream`` and returns cudaGetLastError() (0 on
// success).
extern "C" int poa_align_launch(int B, int Vmax, int nmax, const void* bases,
                                const void* offs, const void* preds,
                                const void* seqs, const void* nv,
                                const void* ns, int C, int warps, int emax,
                                int depth, const void* sidx, void* spill,
                                int spill_rows, void* dir, int m, int x,
                                int o1, int e1, int o2, int e2, void* score,
                                void* acnt, void* aln, void* stamps,
                                void* stream) {
    const Scores s{m, x, o1, e1, o2, e2};
    return launch(B, Vmax, nmax, C, warps, emax, depth,
                  static_cast<const uint8_t*>(bases),
                  static_cast<const int32_t*>(offs),
                  static_cast<const int32_t*>(preds),
                  static_cast<const uint8_t*>(seqs),
                  static_cast<const int32_t*>(nv),
                  static_cast<const int32_t*>(ns),
                  static_cast<const int32_t*>(sidx), static_cast<int*>(spill),
                  spill_rows, static_cast<uint32_t*>(dir), s,
                  static_cast<int*>(score), static_cast<int*>(acnt),
                  static_cast<int*>(aln), static_cast<long long*>(stamps),
                  static_cast<cudaStream_t>(stream));
}

// The rounds of one ops/poa.py::poa_consensus_many call on the card.  Jobs:
// ``counts[t]`` sequences each, lengths ``lens``, codes concatenated in
// ``codes``.  Job t's consensus goes to ``cons`` at the offset of its first
// code in ``codes`` (a consensus is never longer than its job's codes), its
// length to cons_len[t] (0 for a job without a non-empty sequence).
// stats (int64 [9]) gets the launches, then the largest launch's (by cells)
// round, jobs, Vmax, nmax, predecessor entries, cells, ring depth and spill
// rows; device_ms (double [2]) the launches' summed device time and the
// largest's (CUDA events around each launch).  With ``kept``, round
// ``keep_round``'s inputs are copied there (int32: Rounds::copy_inputs;
// sized by an earlier run's stats of the same jobs).  phase_ns (double
// [6]) gets the steady-clock ns the loop spent in each phase, summed over
// rounds: pack, plan, upload, device_wait (the launch to the sync's
// return), download and fuse; with ``stamps`` (int64 [stamp_rounds, 7]), each of the first
// stamp_rounds rounds' phase boundaries (steady_clock, ns): the start of
// its pack, plan, upload, launch, download and fuse, and its end.  Returns
// 0, a cudaError, or -1 when a graph has more than MAX_ROW nodes, the
// direction word's row field.
extern "C" int poa_consensus_run(const void* codes, const void* lens,
                                 const void* counts, int njobs, int m, int x,
                                 int o1, int e1, int o2, int e2, void* stream,
                                 void* cons, void* cons_len, void* stats,
                                 void* device_ms, int keep_round,
                                 void* kept, void* phase_ns, void* stamps,
                                 int stamp_rounds) {
    const auto* code = static_cast<const uint8_t*>(codes);
    const auto* len = static_cast<const int32_t*>(lens);
    const auto* cnt = static_cast<const int32_t*>(counts);
    auto* out = static_cast<uint8_t*>(cons);
    auto* out_len = static_cast<int32_t*>(cons_len);
    auto* st_out = static_cast<int64_t*>(stats);
    auto* ms_out = static_cast<double*>(device_ms);
    const auto st = static_cast<cudaStream_t>(stream);
    const Scores s{m, x, o1, e1, o2, e2};
    for (int k = 0; k < 9; ++k) st_out[k] = 0;
    ms_out[0] = ms_out[1] = 0.0;
    auto* phase = static_cast<double*>(phase_ns);
    for (int k = 0; k < 6; ++k) phase[k] = 0.0;
    auto* stamp = static_cast<int64_t*>(stamps);
    const auto now = [] {
        return static_cast<int64_t>(
            std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now().time_since_epoch())
                .count());
    };
    // the phases of the round in flight: their start times, and the time
    // the last one ended
    int64_t marks[6];
    int64_t since = now();
    const auto mark = [&](int k) {
        const int64_t t = now();
        marks[k] = since;
        phase[k] += static_cast<double>(t - since);
        since = t;
    };

    poa_graph::Rounds rounds(code, len, cnt, njobs);
    DeviceBuf d_bases, d_offs, d_preds, d_seqs, d_nv, d_ns, d_sidx, d_spill,
        d_dir, d_score, d_acnt, d_aln;
    std::vector<int32_t> acnt, aln, sidx;
    cudaEvent_t start = nullptr, stop = nullptr, done = nullptr;
    cudaError_t err = cudaEventCreate(&start);
    if (err == cudaSuccess) err = cudaEventCreate(&stop);
    if (err == cudaSuccess)
        err = cudaEventCreateWithFlags(
            &done, cudaEventBlockingSync | cudaEventDisableTiming);
    int rc = 0;
    for (int64_t round = 0; err == cudaSuccess; ++round) {
        const int B = rounds.pack();
        if (B == 0) {
            mark(0);
            break;
        }
        if (rounds.vmax > MAX_ROW) {
            rc = -1;
            break;
        }
        if (kept && round == keep_round)
            rounds.copy_inputs(static_cast<int32_t*>(kept));
        mark(0);
        int C, warps, emax, depth;
        launch_shape(rounds.nmax, C, warps);
        const int spill_rows = plan_launch(
            B, rounds.vmax, rounds.nmax, rounds.offs.data(),
            rounds.preds.data(), rounds.nv.data(), emax, depth, sidx);
        const size_t Wp = make_layout(rounds.vmax, rounds.nmax, emax, 0).Wp;
        const size_t words = static_cast<size_t>(B) * (rounds.vmax + 1) * Wp;
        const size_t spill_ints = static_cast<size_t>(B) * spill_rows * 3 *
                                  Wp;
        const size_t pairs = static_cast<size_t>(B) *
                             (rounds.vmax + rounds.nmax + 1);
        mark(1);
        if ((err = upload(d_bases, rounds.bases, st)) != cudaSuccess ||
            (err = upload(d_offs, rounds.offs, st)) != cudaSuccess ||
            (err = upload(d_preds, rounds.preds, st)) != cudaSuccess ||
            (err = upload(d_seqs, rounds.seqs, st)) != cudaSuccess ||
            (err = upload(d_nv, rounds.nv, st)) != cudaSuccess ||
            (err = upload(d_ns, rounds.ns, st)) != cudaSuccess ||
            (spill_rows > 0 &&
             ((err = upload(d_sidx, sidx, st)) != cudaSuccess ||
              (err = d_spill.reserve(spill_ints * 4, st)) != cudaSuccess)) ||
            (err = d_dir.reserve(words * 4, st)) != cudaSuccess ||
            (err = d_score.reserve(B * 4, st)) != cudaSuccess ||
            (err = d_acnt.reserve(B * 4, st)) != cudaSuccess ||
            (err = d_aln.reserve(pairs * 8, st)) != cudaSuccess ||
            (err = cudaEventRecord(start, st)) != cudaSuccess)
            break;
        mark(2);
        rc = launch(B, rounds.vmax, rounds.nmax, C, warps, emax, depth,
                    static_cast<const uint8_t*>(d_bases.ptr),
                    static_cast<const int32_t*>(d_offs.ptr),
                    static_cast<const int32_t*>(d_preds.ptr),
                    static_cast<const uint8_t*>(d_seqs.ptr),
                    static_cast<const int32_t*>(d_nv.ptr),
                    static_cast<const int32_t*>(d_ns.ptr),
                    spill_rows > 0 ? static_cast<const int32_t*>(d_sidx.ptr)
                                   : nullptr,
                    static_cast<int*>(d_spill.ptr), spill_rows,
                    static_cast<uint32_t*>(d_dir.ptr), s,
                    static_cast<int*>(d_score.ptr),
                    static_cast<int*>(d_acnt.ptr),
                    static_cast<int*>(d_aln.ptr), nullptr, st);
        if (rc != 0) break;
        ++st_out[0];
        if ((err = cudaEventRecord(stop, st)) != cudaSuccess ||
            (err = cudaEventRecord(done, st)) != cudaSuccess ||
            (err = cudaEventSynchronize(done)) != cudaSuccess)
            break;
        mark(3);
        acnt.resize(B);
        aln.resize(2 * pairs);
        float ms = 0.f;
        // pageable copies return when done; the kernel has ended
        if ((err = cudaMemcpyAsync(acnt.data(), d_acnt.ptr, B * 4,
                                   cudaMemcpyDeviceToHost, st)) !=
                cudaSuccess ||
            (err = cudaMemcpyAsync(aln.data(), d_aln.ptr, pairs * 8,
                                   cudaMemcpyDeviceToHost, st)) !=
                cudaSuccess ||
            (err = cudaEventElapsedTime(&ms, start, stop)) != cudaSuccess)
            break;
        mark(4);
        ms_out[0] += ms;
        if (rounds.cells > st_out[6]) {
            st_out[1] = round;
            st_out[2] = B;
            st_out[3] = rounds.vmax;
            st_out[4] = rounds.nmax;
            st_out[5] = static_cast<int64_t>(rounds.preds.size());
            st_out[6] = rounds.cells;
            st_out[7] = depth;
            st_out[8] = spill_rows;
            ms_out[1] = ms;
        }
        rounds.fuse_all(aln.data(), acnt.data());
        mark(5);
        if (stamp && round < stamp_rounds) {
            int64_t* row = stamp + round * 7;
            for (int k = 0; k < 6; ++k) row[k] = marks[k];
            row[6] = since;
        }
    }
    for (DeviceBuf* buf : {&d_bases, &d_offs, &d_preds, &d_seqs, &d_nv,
                           &d_ns, &d_sidx, &d_spill, &d_dir, &d_score,
                           &d_acnt, &d_aln})
        buf->release(st);
    for (cudaEvent_t ev : {start, stop, done})
        if (ev) cudaEventDestroy(ev);
    if (rc == 0 && err != cudaSuccess) rc = static_cast<int>(err);
    if (rc != 0) return rc;

    std::vector<uint8_t> one;
    int64_t off = 0, si = 0;
    for (int t = 0; t < njobs; ++t) {
        poa_graph::consensus(rounds.jobs[t].g, one);
        for (size_t k = 0; k < one.size(); ++k) out[off + k] = one[k];
        out_len[t] = static_cast<int32_t>(one.size());
        for (int32_t k = 0; k < cnt[t]; ++k) off += len[si++];
    }
    return 0;
}
