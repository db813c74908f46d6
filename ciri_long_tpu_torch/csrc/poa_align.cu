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
//            first maximum's slot kept (np = the source)     M[0] = NEG
//   Hpre   = max(M, F1, F2), Hpre[0] raised to 0 (free leading overhang)
//   E1[j]  = max_{k<j}(Hpre[k] - k e1) + o1 + (j-1) e1        (E2 alike)
//   H      = max(Hpre, E1, E2)
// and a direction word: case GAPSEQ if H is an E, else MATCH if H is M
// (with M's slot), else GAPGRAPH if H is an F (with the first slot whose
// max(F1 + e1, H + o1, F2 + e2, H + o2) is the largest), else STOP.  The
// end is the first maximum of H over column n, rows 0..V (free trailing
// overhang); the walk from it flushes to GAPSEQ at row 0 or after a stop
// and gives the score and the (rank | -1, pos | -1) pairs in forward order.
// Every value and tie equals the JAX program's (int32 throughout).
//
// A launch takes the batch layout of ops/poa_batch.py (JAX's): job b's
// nodes in row b of bases [B, Vmax], its CSR offsets in row b of
// offs [B, Vmax + 1], its codes in row b of seqs [B, nmax], its sizes in
// nv and ns [B]; its planes are the b-th block of (Vmax + 1) (nmax + 1)
// cells, rows of n + 1; its pairs end row b of aln [B, Vmax + nmax + 1, 2].
//
// Kernel design: one block per job.  Its threads cover the columns, each a
// run of C consecutive columns (C = 1..8 by the launch's longest sequence,
// up to 256 threads; longer rows loop over tiles of 256 C columns).  Rows
// are walked in rank order; each row:
//   pass A  gathers the predecessors' H, F1 and F2 over the run (global
//           memory; H[p][j-1] of the run's own columns from registers) and
//           gives F1, F2, M with its slot, F's best slot and Hpre;
//   scan    the E terms need the prefix maximum of g[k] = Hpre[k] - k e,
//           one for each piece: a warp's lanes by five shuffles, the
//           warps through shared memory, the tiles before by a carry;
//   pass B  E1, E2, H and the direction word; H, F1, F2 and the word are
//           written to the job's planes, [V+1][n+1] in global memory.
// The thread holding column n keeps its first maximum; thread 0 then walks
// the direction planes and writes the pairs from the end of the job's slots
// back, so they lie in forward order.
//
// Bound: operations.  Of the planes only the 16-bit direction word has to
// reach memory for the walk (H, F1 and F2 of recent rows could stay on
// chip); a cell does ~25 integer operations a predecessor, and at the
// card's rate for this update (csrc/op_rate.cu, kind 3) they take longer
// than 2 bytes a cell at 3.35 TB/s.  In practice the launch is latency
// bound: a job is one block walking its rows one after another, two block
// barriers and a global round trip a row, and collapse's calls hold one
// job each.  A ring of recent rows in shared memory (consensus graphs have
// short back edges) is left for later.
//
// The direction word is case << 14 | slot; slots past 2^14 - 1 (in-degree
// 16 383 and more) cannot be stored, so the wrapper
// (ops/poa_batch.py::poa_align_batch_cuda) and the round loop refuse such a
// graph.
//
// poa_consensus_run is the host round loop: csrc/poa_graph.h's Rounds packs
// every pending job's graph (collapse's calls hold one job each), the
// inputs go up, one launch aligns them all, the pairs come down and are
// fused, until every queue is empty; then the consensus.  It is called through ctypes (which releases the interpreter
// lock) from several threads at once: no static mutable state, device
// buffers from cudaMallocAsync on the caller's stream, one stream per
// calling thread, and the wait for each round on a blocking-sync event, so
// a waiting thread yields its core instead of spinning.

#include <cstdint>
#include <cuda_runtime.h>

#include "poa_graph.h"

namespace {

constexpr int NEG = -(1 << 28);
constexpr int LOW = -(1 << 30);       // below every prefix value
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
enum { STOP = 0, GAPSEQ = 1, MATCH = 2, GAPGRAPH = 3 };
constexpr int SLOT_BITS = 14;
constexpr int MAX_SLOT = (1 << SLOT_BITS) - 1;

struct Scores {
    int m, x, o1, e1, o2, e2;
};

// H of the source row: the sequence's first j codes as one two-piece gap
__device__ __forceinline__ int source_h(int j, const Scores& s) {
    return j == 0 ? 0 : max(s.o1 + (j - 1) * s.e1, s.o2 + (j - 1) * s.e2);
}

template <int C>
__global__ void __launch_bounds__(MAX_THREADS)
poa_align_kernel(int Vmax, int nmax, const uint8_t* __restrict__ bases,
                 const int32_t* __restrict__ offs,
                 const int32_t* __restrict__ preds,
                 const uint8_t* __restrict__ seqs,
                 const int32_t* __restrict__ nvs,
                 const int32_t* __restrict__ nss, int* Hs, int* F1s,
                 int* F2s, uint16_t* dirs, Scores s,
                 int* __restrict__ score, int* __restrict__ acnt,
                 int* __restrict__ aln) {
    __shared__ int wmax[2][MAX_WARPS];
    __shared__ int end_row, end_score;

    const int64_t job = blockIdx.x;
    const int64_t cell0 = job * (Vmax + 1) * (nmax + 1);
    const int nv = nvs[job], n = nss[job];
    const int W = n + 1;
    int* H = Hs + cell0;
    int* F1 = F1s + cell0;
    int* F2 = F2s + cell0;
    uint16_t* dir = dirs + cell0;
    const uint8_t* bs = bases + job * Vmax;
    const int32_t* of = offs + job * (Vmax + 1);
    const uint8_t* sq = seqs + job * nmax;

    const int T = blockDim.x, span = T * C;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = T >> 5;

    for (int j = tid; j < W; j += T) {
        H[j] = source_h(j, s);
        F1[j] = NEG;
        F2[j] = NEG;
        dir[j] = 0;
    }
    const bool owns_n = (n % span) / C == tid;
    int best = source_h(n, s), best_row = 0;
    __syncthreads();

    for (int i = 1; i <= nv; ++i) {
        const int b = bs[i - 1];
        const int p_lo = of[i - 1];
        const int np = of[i] - p_lo;          // 0: the source stands in
        const int npe = np > 0 ? np : 1;
        int* Hi = H + (int64_t)i * W;
        int* F1i = F1 + (int64_t)i * W;
        int* F2i = F2 + (int64_t)i * W;
        uint16_t* diri = dir + (int64_t)i * W;
        int carry1 = LOW, carry2 = LOW;       // g's maximum left of the tile

        for (int t0 = 0; t0 < W; t0 += span) {
            const int c0 = t0 + tid * C;
            int hpre[C], mrow[C], f1p[C], f2p[C], fv[C], pm[C], pf[C];
            // pass A: the predecessors, in caller order
            for (int k = 0; k < npe; ++k) {
                const int64_t pr = np > 0 ? preds[p_lo + k] : 0;
                const int* Hp = H + pr * W;
                const int* F1r = F1 + pr * W;
                const int* F2r = F2 + pr * W;
                int hl = (c0 > 0 && c0 <= W) ? Hp[c0 - 1] : NEG;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const int j = c0 + c;
                    if (j >= W) continue;
                    const int h = Hp[j];
                    const int v1 = max(F1r[j] + s.e1, h + s.o1);
                    const int v2 = max(F2r[j] + s.e2, h + s.o2);
                    const int v = max(v1, v2);
                    if (k == 0) {
                        f1p[c] = v1;
                        f2p[c] = v2;
                        fv[c] = v;
                        pf[c] = 0;
                        mrow[c] = hl;
                        pm[c] = 0;
                    } else {
                        f1p[c] = max(f1p[c], v1);
                        f2p[c] = max(f2p[c], v2);
                        if (v > fv[c]) {
                            fv[c] = v;
                            pf[c] = k;
                        }
                        if (hl > mrow[c]) {
                            mrow[c] = hl;
                            pm[c] = k;
                        }
                    }
                    hl = h;
                }
            }
            // the source slot, the scores, Hpre and the run's maxima of g
            int g1 = LOW, g2 = LOW;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int j = c0 + c;
                if (j >= W) continue;
                if (j == 0) {
                    mrow[c] = NEG;
                    pm[c] = 0;
                } else {
                    const int hs = source_h(j - 1, s);
                    if (hs > mrow[c]) {
                        mrow[c] = hs;
                        pm[c] = npe;
                    }
                    mrow[c] += sq[j - 1] == b ? s.m : s.x;
                }
                int hp = max(mrow[c], max(f1p[c], f2p[c]));
                if (j == 0) hp = max(hp, 0);
                hpre[c] = hp;
                g1 = max(g1, hp - j * s.e1);
                g2 = max(g2, hp - j * s.e2);
            }
            // scan: the prefix maxima of g over the columns before the run
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
            if (lane == 31) {
                wmax[0][warp] = s1;
                wmax[1][warp] = s2;
            }
            int m1 = __shfl_up_sync(FULL, s1, 1);
            int m2 = __shfl_up_sync(FULL, s2, 1);
            if (lane == 0) {
                m1 = LOW;
                m2 = LOW;
            }
            __syncthreads();
            m1 = max(m1, carry1);
            m2 = max(m2, carry2);
            for (int w = 0; w < nwarps; ++w) {
                if (w < warp) {
                    m1 = max(m1, wmax[0][w]);
                    m2 = max(m2, wmax[1][w]);
                }
                carry1 = max(carry1, wmax[0][w]);
                carry2 = max(carry2, wmax[1][w]);
            }
            // pass B: E, H and the direction word
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int j = c0 + c;
                if (j >= W) continue;
                const int hp = hpre[c];
                int e1v = NEG, e2v = NEG;
                if (j > 0) {
                    e1v = m1 + s.o1 + (j - 1) * s.e1;
                    e2v = m2 + s.o2 + (j - 1) * s.e2;
                }
                m1 = max(m1, hp - j * s.e1);
                m2 = max(m2, hp - j * s.e2);
                const int h = max(hp, max(e1v, e2v));
                const bool is_e = h == e1v || h == e2v;
                const bool is_m = h == mrow[c];
                const bool is_f = h == f1p[c] || h == f2p[c];
                const int cs = is_e ? GAPSEQ : is_m ? MATCH
                             : is_f ? GAPGRAPH : STOP;
                const int slot = is_m && !is_e ? pm[c] : pf[c];
                Hi[j] = h;
                F1i[j] = f1p[c];
                F2i[j] = f2p[c];
                diri[j] = (uint16_t)((cs << SLOT_BITS) | slot);
                if (j == n && h > best) {
                    best = h;
                    best_row = i;
                }
            }
            __syncthreads();
        }
    }

    if (owns_n) {
        end_row = best_row;
        end_score = best;
    }
    __syncthreads();
    if (tid != 0) return;

    // the walk over the direction planes, pairs written from the end back
    const int cap = Vmax + nmax + 1;
    int* out = aln + 2 * job * cap;
    int i = end_row, j = n, t = 0;
    bool stopped = false;
    while (j > 0) {
        int cs = GAPSEQ, k = 0;
        if (!stopped && i > 0) {
            const int w = dir[(int64_t)i * W + j];
            cs = w >> SLOT_BITS;
            k = w & MAX_SLOT;
        }
        if (cs == STOP) {
            stopped = true;
            continue;
        }
        int pi = -1, pj = -1;
        if (cs == GAPSEQ) {
            pj = --j;
        } else {
            const int lo = of[i - 1], np = of[i] - lo;
            pi = i - 1;
            if (cs == MATCH) {
                pj = --j;
                i = k < np ? preds[lo + k] : 0;   // slot np: the source
            } else {
                i = np > 0 ? preds[lo + k] : 0;
            }
        }
        ++t;
        out[2 * (cap - t)] = pi;
        out[2 * (cap - t) + 1] = pj;
    }
    score[job] = end_score;
    acnt[job] = t;
}

// The run width C for rows of ``nmax`` + 1 columns and the block's threads.
void launch_shape(int nmax, int& C, int& threads) {
    const int W = nmax + 1;
    C = W <= 256 ? 1 : W <= 512 ? 2 : W <= 1024 ? 4 : 8;
    threads = (W + C - 1) / C;
    threads = ((threads + 31) / 32) * 32;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
}

int launch(int B, int Vmax, int nmax, const uint8_t* bases,
           const int32_t* offs, const int32_t* preds, const uint8_t* seqs,
           const int32_t* nv, const int32_t* ns, int* H, int* F1, int* F2,
           uint16_t* dir, const Scores& s, int* score, int* acnt, int* aln,
           cudaStream_t st) {
    if (B <= 0) return 0;
    int C, threads;
    launch_shape(nmax, C, threads);
    auto kernel = C == 1 ? poa_align_kernel<1>
                : C == 2 ? poa_align_kernel<2>
                : C == 4 ? poa_align_kernel<4> : poa_align_kernel<8>;
    kernel<<<B, threads, 0, st>>>(Vmax, nmax, bases, offs, preds, seqs, nv,
                                  ns, H, F1, F2, dir, s, score, acnt, aln);
    return static_cast<int>(cudaGetLastError());
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
// [B, Vmax + 1] absolute into preds (int32), nv and ns int32 [B]; the
// planes H, F1, F2 (int32) and dir (uint16) of B (Vmax + 1) (nmax + 1)
// cells; outputs score and acnt int32 [B] and aln int32 [B, Vmax + nmax + 1,
// 2].  Launches on ``stream`` and returns cudaGetLastError() (0 on
// success).
extern "C" int poa_align_launch(int B, int Vmax, int nmax, const void* bases,
                                const void* offs, const void* preds,
                                const void* seqs, const void* nv,
                                const void* ns, void* H, void* F1, void* F2,
                                void* dir, int m, int x, int o1, int e1,
                                int o2, int e2, void* score, void* acnt,
                                void* aln, void* stream) {
    const Scores s{m, x, o1, e1, o2, e2};
    return launch(B, Vmax, nmax, static_cast<const uint8_t*>(bases),
                  static_cast<const int32_t*>(offs),
                  static_cast<const int32_t*>(preds),
                  static_cast<const uint8_t*>(seqs),
                  static_cast<const int32_t*>(nv),
                  static_cast<const int32_t*>(ns), static_cast<int*>(H),
                  static_cast<int*>(F1), static_cast<int*>(F2),
                  static_cast<uint16_t*>(dir), s, static_cast<int*>(score),
                  static_cast<int*>(acnt), static_cast<int*>(aln),
                  static_cast<cudaStream_t>(stream));
}

// The rounds of one ops/poa.py::poa_consensus_many call on the card.  Jobs:
// ``counts[t]`` sequences each, lengths ``lens``, codes concatenated in
// ``codes``.  Job t's consensus goes to ``cons`` at the offset of its first
// code in ``codes`` (a consensus is never longer than its job's codes), its
// length to cons_len[t] (0 for a job without a non-empty sequence).
// stats (int64 [7]) gets the launches, then the largest launch's (by cells)
// round, jobs, Vmax, nmax, predecessor entries and cells; device_ms
// (double [2]) the launches' summed device time and the largest's (CUDA
// events around each launch).  With ``kept``, round ``keep_round``'s inputs
// are copied there (int32: Rounds::copy_inputs; sized by an earlier run's
// stats of the same jobs).  Returns 0, a cudaError, or -1 when a node's
// in-degree passes MAX_SLOT, the slot field's largest value.
extern "C" int poa_consensus_run(const void* codes, const void* lens,
                                 const void* counts, int njobs, int m, int x,
                                 int o1, int e1, int o2, int e2, void* stream,
                                 void* cons, void* cons_len, void* stats,
                                 void* device_ms, int keep_round,
                                 void* kept) {
    const auto* code = static_cast<const uint8_t*>(codes);
    const auto* len = static_cast<const int32_t*>(lens);
    const auto* cnt = static_cast<const int32_t*>(counts);
    auto* out = static_cast<uint8_t*>(cons);
    auto* out_len = static_cast<int32_t*>(cons_len);
    auto* st_out = static_cast<int64_t*>(stats);
    auto* ms_out = static_cast<double*>(device_ms);
    const auto st = static_cast<cudaStream_t>(stream);
    const Scores s{m, x, o1, e1, o2, e2};
    for (int k = 0; k < 7; ++k) st_out[k] = 0;
    ms_out[0] = ms_out[1] = 0.0;

    poa_graph::Rounds rounds(code, len, cnt, njobs);
    DeviceBuf d_bases, d_offs, d_preds, d_seqs, d_nv, d_ns, d_H, d_F1, d_F2,
        d_dir, d_score, d_acnt, d_aln;
    std::vector<int32_t> acnt, aln;
    cudaEvent_t start = nullptr, stop = nullptr, done = nullptr;
    cudaError_t err = cudaEventCreate(&start);
    if (err == cudaSuccess) err = cudaEventCreate(&stop);
    if (err == cudaSuccess)
        err = cudaEventCreateWithFlags(
            &done, cudaEventBlockingSync | cudaEventDisableTiming);
    int rc = 0;
    for (int64_t round = 0; err == cudaSuccess; ++round) {
        const int B = rounds.pack();
        if (B == 0) break;
        if (rounds.widest > MAX_SLOT) {
            rc = -1;
            break;
        }
        if (kept && round == keep_round)
            rounds.copy_inputs(static_cast<int32_t*>(kept));
        const size_t cells = static_cast<size_t>(B) * (rounds.vmax + 1) *
                             (rounds.nmax + 1);
        const size_t pairs = static_cast<size_t>(B) *
                             (rounds.vmax + rounds.nmax + 1);
        if ((err = upload(d_bases, rounds.bases, st)) != cudaSuccess ||
            (err = upload(d_offs, rounds.offs, st)) != cudaSuccess ||
            (err = upload(d_preds, rounds.preds, st)) != cudaSuccess ||
            (err = upload(d_seqs, rounds.seqs, st)) != cudaSuccess ||
            (err = upload(d_nv, rounds.nv, st)) != cudaSuccess ||
            (err = upload(d_ns, rounds.ns, st)) != cudaSuccess ||
            (err = d_H.reserve(cells * 4, st)) != cudaSuccess ||
            (err = d_F1.reserve(cells * 4, st)) != cudaSuccess ||
            (err = d_F2.reserve(cells * 4, st)) != cudaSuccess ||
            (err = d_dir.reserve(cells * 2, st)) != cudaSuccess ||
            (err = d_score.reserve(B * 4, st)) != cudaSuccess ||
            (err = d_acnt.reserve(B * 4, st)) != cudaSuccess ||
            (err = d_aln.reserve(pairs * 8, st)) != cudaSuccess ||
            (err = cudaEventRecord(start, st)) != cudaSuccess)
            break;
        rc = launch(B, rounds.vmax, rounds.nmax,
                    static_cast<const uint8_t*>(d_bases.ptr),
                    static_cast<const int32_t*>(d_offs.ptr),
                    static_cast<const int32_t*>(d_preds.ptr),
                    static_cast<const uint8_t*>(d_seqs.ptr),
                    static_cast<const int32_t*>(d_nv.ptr),
                    static_cast<const int32_t*>(d_ns.ptr),
                    static_cast<int*>(d_H.ptr), static_cast<int*>(d_F1.ptr),
                    static_cast<int*>(d_F2.ptr),
                    static_cast<uint16_t*>(d_dir.ptr), s,
                    static_cast<int*>(d_score.ptr),
                    static_cast<int*>(d_acnt.ptr),
                    static_cast<int*>(d_aln.ptr), st);
        if (rc != 0) break;
        ++st_out[0];
        if ((err = cudaEventRecord(stop, st)) != cudaSuccess ||
            (err = cudaEventRecord(done, st)) != cudaSuccess ||
            (err = cudaEventSynchronize(done)) != cudaSuccess)
            break;
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
        ms_out[0] += ms;
        if (rounds.cells > st_out[6]) {
            st_out[1] = round;
            st_out[2] = B;
            st_out[3] = rounds.vmax;
            st_out[4] = rounds.nmax;
            st_out[5] = static_cast<int64_t>(rounds.preds.size());
            st_out[6] = rounds.cells;
            ms_out[1] = ms;
        }
        rounds.fuse_all(aln.data(), acnt.data());
    }
    for (DeviceBuf* buf : {&d_bases, &d_offs, &d_preds, &d_seqs, &d_nv,
                           &d_ns, &d_H, &d_F1, &d_F2, &d_dir, &d_score,
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
