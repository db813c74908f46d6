// Batched affine-gap Smith-Waterman score + end coordinates: the chained
// wavefront design, for Hopper.
//
// Replaces the chain family of the SW variant harness misc/kexp.py:
// make_call's pallas_call at :1462 with the kernel bodies build_kernel_chain
// (:534), _chain7 (:694), _chain9 (:875) and _chain10 (:1222).  Same contract
// as csrc/sw_score_ends.cu and ciri_long_tpu/ops/sw.py::sw_score_ends (codes
// A0 C1 G2 T3 N4 PAD5, N scores 0, PAD poisons the diagonal term, a gap of
// length L costs open + (L-1)*extend; per job (score, q_end, r_end) with ties
// to the highest score, then the smallest r_end, then the smallest q_end;
// (0, -1, -1) when no cell is positive), for C jobs per stream.
//
// Layout (built by the wrapper, misc/kexp.py::chain_layout): the batch is cut
// into B/C streams of C consecutive jobs.  A stream is [6, r_0, 6, r_1, ...,
// 6, r_{C-1}, 6]: each job's reference codes (PAD kept as 5) behind a
// boundary code 6, and one closing boundary, T = C*(Lr+1) + 1 slots, the
// boundary of job m at slot m*(Lr+1).  The queries stay [B/C, C*Lq], job
// m's row i at m*Lq + i.
//
// Recurrence (plain Gotoh in int32, as sw_score_ends.cu):
//   E[i][j] = max(E[i][j-1] - gE, H[i][j-1] - gO)
//   F[i][j] = max(F[i-1][j] - gE, H[i-1][j] - gO)
//   H[i][j] = max(H[i-1][j-1] + s(q[i], r[j]), E, F, 0)
// with H = 0 and E = F = NEG on the borders.  A boundary slot is the column
// -1 border of the job after it: its cell is (H 0, E NEG, F NEG) in every
// row, which is what the next job's first column reads to its left, on its
// diagonal and (for the strip below) above.  So the stream is swept as one
// reference, and the fill and drain of a strip (31 steps a warp, 64 a warp
// of the pipeline) is paid once per stream of C jobs, not once per job.
//
// Design: the wavefront of csrc/sw_score_ends.cu (sw_wave_kernel) over the
// stream.  A block of K warps per stream (kexp.py::chain_plan gives R, K,
// the streams a block and where the handoff row lives):
//
//   Strips.  A strip is 32*R query rows: lane t holds rows 32R*s + R*t ..
//   + R-1 of every job, and at its step d computes slot p = d - t of its R
//   rows.  The R rows share the slot, so they meet a boundary at one step.
//   Warps.  Warp k sweeps strips k, k+K, ... (a group of K strips at a
//   time), two 32-step chunks behind warp k-1, and takes the row above its
//   strip (warp k-1's bottom (M, F) row) from a ring of RING = 128 slots in
//   shared memory, 32 slots at the start of each chunk; one __syncthreads a
//   chunk.  Warp k's chunk c reads the slots 32c..32c+31 that warp k-1's
//   lane 31 wrote in its chunks c and c+1, while warp k-1, at its chunk
//   c+2, writes 2..64 slots ahead of them (tests/test_torch_sw_chain.py
//   asserts it on the emulated schedule).  So warp k is in an earlier job
//   than warp k-1 for 64 steps after each boundary; nothing but the ring
//   passes between them, and the ring carries the boundary's border.
//   Groups.  Warp 0 of group g+1 takes the row above from a handoff row of
//   T (M, F) slots that lane 31 of warp K-1 wrote in group g: in dynamic
//   shared memory when it fits, else in global scratch [B/C, T] int2.  With
//   K = 1 a block holds P streams, a warp each, and has no barrier.
//   Steps.  A chunk's 32 steps are one fixed loop, unrolled 8 ways (nvcc
//   crashed on the fully unrolled chunk of sw_score_ends.cu).  The boundary
//   slots are known in advance (every job is padded to Lr), so a chunk
//   whose slots p = 32c-31 .. 32c+31 hold no boundary and lie inside
//   [0, T) runs the branch-free step of the wavefront: the code from the
//   stream, the score from the lane's [code][row][thread] table in shared
//   memory.  Only a chunk that holds a boundary (or the stream's edge) runs
//   the masked step, in which a lane that meets a boundary takes the border
//   (M = -gO, i.e. H = 0, and E = F = NEG), sets its job's best aside and
//   turns to the other of its two score tables, which already holds the
//   next job's rows: a few moves, since the 32 lanes meet the boundary at
//   32 different steps, one at a time.  At the chunk's end the lanes that
//   crossed, together, flush the ended job's best (below), fill the table
//   they left with the rows of the job after next and fetch the codes of
//   the one after that.  A job spans at least 32 slots, so a lane crosses
//   at most one boundary a chunk: the wrapper pads a reference of fewer
//   than 31 columns with PAD, which changes no result (a trailing PAD
//   column's H comes from a gap out of an earlier cell, so it is lower and
//   later in the contract's order).  H is kept as M = H - gO, as in
//   sw_score_ends.cu.
//   The best, per job.  Each of a lane's rows keeps its first maximum along
//   the job's columns (strict >) in registers.  After the job's closing
//   boundary the lane folds its R rows in the contract's order and folds
//   the winner into the job's key with one atomicMax: key = score << 32 |
//   (2^32 - 1 - (j*Lq + i)), so the larger key is the higher score, then
//   the smaller j, then the smaller i (the wrapper keeps Lq * Lr <= 2^32).
//   The keys of a block's jobs live in shared memory when P*C*8 bytes fit
//   beside the handoff rows, else in global scratch [B] uint64; lanes and
//   warps fold into them in any order, which is what lets the warps of a
//   block be in different jobs at one step.  After the sweep the block
//   decodes its own jobs' keys (every fold into them came from this block).
//
// Bound: as sw_score_ends.cu, integer ALU and shuffle latency, at least 7
// integer instructions per cell update (csrc/op_rate.cu) plus one boundary
// slot per job and the masked steps of the chunks that hold a boundary
// (about 64 / (Lr+1) of them); parallelism is K warps per stream, B/C * K
// warps, so chaining trades warps for a shorter fill and drain and pays
// off only where the reference is short.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int BOUNDARY = 6;
constexpr int MAX_SMEM = 232448;  // shared memory a Hopper block may have
constexpr unsigned FULL = 0xffffffffu;
constexpr int CHAIN_WARPS = 8;    // warps a block (K * P)
constexpr int CHAIN_THREADS = CHAIN_WARPS * 32;
constexpr int RING = 128;         // ring slots between two warps

typedef unsigned long long u64;

// The handoff row's slot ``p`` (M, F), the border past T.  ``edge`` is
// written by the sweep, so it is not declared __restrict__.
__device__ __forceinline__ int2 load_edge(const int2* edge, int p, int T,
                                          int2 border) {
    return p < T ? edge[p] : border;
}

// The best cell (score, i, j) of a job as one key: larger is better in the
// contract's order.  0 stands for no positive cell.
__device__ __forceinline__ u64 pack_best(int score, int i, int j, int Lq) {
    const unsigned ij = (unsigned)j * (unsigned)Lq + (unsigned)i;
    return ((u64)(unsigned)score << 32) | (u64)(0xffffffffu - ij);
}

// One lane over one strip: its R rows' M = H - gO and E at the last slot,
// each row's best M in the current job and the slot that first reached it
// (and, from a boundary to the chunk's end, those of the job that ended),
// the lane's bottom row (M, F) for lane t+1, M of the row above at the slot
// before (the first row's diagonal), the job it is in, the offset of that
// job's score table, whether it crossed a boundary in this chunk, and the
// query codes of the job after next.
template <int R>
struct ChainLane {
    int M[R], E[R], bm[R], bp[R], pbm[R], pbp[R], nq[R];
    int out_M, out_F, dgM, job, tsel;
    bool crossed;
};

// What a step reads and writes beside the lane's state.
struct ChainIO {
    int* tab;                 // + tsel + (code * R + u) * CHAIN_THREADS
    const int8_t* sr_lane;    // slot p = d - lane at sr_lane[d]
    const int8_t* qr;         // the stream's queries, job m row i at m*Lq+i
    u64* keys;                // the stream's C job keys
    int2* ring_out;
    int2* edge;
    bool to_ring, to_edge;
    int lane, T, span, C, Lq, i0, gE, gO, MB, match, mismatch;
};

// The lane's score table for its R rows of the job whose table starts at
// ``tsel``, query codes q[u] (PAD past the query), plus gO: NEG for PAD or
// a code outside 0..4, 0 for N.
template <int R>
__device__ __forceinline__ void fill_table(const ChainIO& io, int tsel,
                                           const int* q) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
        const unsigned qc = (unsigned)q[u];
#pragma unroll
        for (int c = 0; c < 6; ++c)
            io.tab[tsel + (c * R + u) * CHAIN_THREADS] =
                (qc >= 5u || c == 5 ? NEG
                 : qc == 4u || c == 4 ? 0
                 : (int)qc == c ? io.match : -io.mismatch) + io.gO;
    }
}

// Codes of job m's rows of this lane (PAD for rows past Lq or m >= C).
template <int R>
__device__ __forceinline__ void fetch_rows(const ChainIO& io, int m,
                                           int* q) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
        const int i = io.i0 + u;
        q[u] = (m < io.C && i < io.Lq) ? (int)io.qr[(size_t)m * io.Lq + i]
                                       : 5;
    }
}

// Offset of the second score table: job m's table is table m & 1.
constexpr int TABLE = 6 * CHAIN_THREADS;

// The lane meets the boundary at slot p: it keeps the ended job's best for
// the chunk's end and starts the next job, whose table is already filled.
template <int R>
__device__ __forceinline__ void cross_boundary(ChainLane<R>& st, int p,
                                               int MB) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
        st.pbm[u] = st.bm[u];
        st.pbp[u] = st.bp[u];
        st.bm[u] = MB;
        st.bp[u] = p;
    }
    ++st.job;
    st.tsel ^= R * TABLE;
    st.crossed = true;
}

// At the end of a chunk, every lane that crossed a boundary in it (at most
// one: a job spans at least 32 slots) flushes the job that ended into its
// key, fills the other table with the next job's rows and fetches the
// codes of the job after it.
template <int R>
__device__ __forceinline__ void after_boundary(ChainLane<R>& st,
                                               const ChainIO& io) {
    const int ended = st.job - 1;
    if (ended >= 0) {
        const int jbase = ended * io.span + 1;    // the job's column 0
        u64 key = 0;
#pragma unroll
        for (int u = 0; u < R; ++u) {
            const int i = io.i0 + u;
            const int sc = st.pbm[u] - io.MB;
            if (i < io.Lq && sc > 0) {
                const u64 k = pack_best(sc, i, st.pbp[u] - jbase, io.Lq);
                key = k > key ? k : key;
            }
        }
        if (key) atomicMax(io.keys + ended, key);
    }
    fill_table<R>(io, st.tsel ^ (R * TABLE), st.nq);
    fetch_rows<R>(io, st.job + 2, st.nq);
    st.crossed = false;
}

// One step d of the sweep: lane t computes slot p = d - t of its R rows.
// MASKED: the chunk holds a boundary or the stream's edge; a slot outside
// [0, T) or on a boundary is the border (M = -gO, E = F = NEG).  (tM, tF):
// the row above the strip at slot d, for lane 0.
template <int R, bool MASKED>
__device__ __forceinline__ void chain_step(ChainLane<R>& st,
                                           const ChainIO& io, int d, int tM,
                                           int tF) {
    const int p = d - io.lane;
    bool inside = true, border = false;
    int code;
    if (MASKED) {
        inside = (unsigned)p < (unsigned)io.T;
        code = inside ? (int)io.sr_lane[d] : 5;
        border = !inside || code == BOUNDARY;
    } else {
        code = io.sr_lane[d];
    }
    const int* t =
        io.tab + st.tsel + min((unsigned)code, 5u) * (R * CHAIN_THREADS);
    int upM = __shfl_up_sync(FULL, st.out_M, 1);
    int upF = __shfl_up_sync(FULL, st.out_F, 1);
    if (io.lane == 0) {
        upM = tM;
        upF = tF;
    }
    int dg = st.dgM;          // M[i-1][p-1] of the lane's first row
    st.dgM = upM;
    int mu = upM, fu = upF;
#pragma unroll
    for (int u = 0; u < R; ++u) {
        const int left = st.M[u];
        int e = max(st.E[u] - io.gE, left);
        int f = max(fu - io.gE, mu);
        const int h = max(max(dg + t[u * CHAIN_THREADS], e), max(f, 0));
        int m = h + io.MB;
        if (MASKED) {
            m = border ? io.MB : m;
            e = border ? NEG : e;
            f = border ? NEG : f;
        }
        if (m > st.bm[u]) {
            st.bm[u] = m;
            st.bp[u] = p;
        }
        dg = left;
        mu = m;
        fu = f;
        st.M[u] = m;
        st.E[u] = e;
    }
    st.out_M = mu;
    st.out_F = fu;
    if (io.to_ring && inside) io.ring_out[p & (RING - 1)] = make_int2(mu, fu);
    if (io.to_edge && inside) io.edge[p] = make_int2(mu, fu);
    if (MASKED && inside && code == BOUNDARY) cross_boundary<R>(st, p, io.MB);
}

// A chunk's 32 steps; ``top`` holds the row above the strip at slots
// 32c + lane.
template <int R, bool MASKED>
__device__ __forceinline__ void chain_chunk(ChainLane<R>& st,
                                            const ChainIO& io, int c,
                                            int2 top) {
#pragma unroll 8
    for (int kk = 0; kk < 32; ++kk) {
        const int tM = __shfl_sync(FULL, top.x, kk);
        const int tF = __shfl_sync(FULL, top.y, kk);
        chain_step<R, MASKED>(st, io, c * 32 + kk, tM, tF);
    }
    if (MASKED && st.crossed) after_boundary<R>(st, io);
}

// Bytes of dynamic shared memory before the keys: the two score tables.
__host__ __device__ constexpr int table_bytes(int R) {
    return 2 * R * TABLE * 4;
}

// blockDim.x = K * P * 32 (K warps a stream, P streams a block, P > 1 only
// with K = 1).  Dynamic shared memory: the two score tables ([job & 1]
// [code][row][thread] int32), the P * C job keys when ``key_smem``, then
// the P handoff rows (P * T int2) when ``edge_smem``; otherwise ``gkeys``
// (B uint64) and ``scratch`` (rows * T int2, read only when a stream has
// more than K strips).  Needs Lr >= 31.
template <int R>
__global__ void __launch_bounds__(CHAIN_THREADS, 2)
sw_chain_kernel(const int8_t* __restrict__ qrows,
                const int8_t* __restrict__ stream, int rows, int C, int Lq,
                int Lr, int match, int mismatch, int gap_open,
                int gap_extend, int K, int key_smem, int edge_smem,
                int2* scratch, u64* gkeys, int* __restrict__ out_score,
                int* __restrict__ out_qend, int* __restrict__ out_rend) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ int2 ring[(CHAIN_WARPS - 1) * RING];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int P = (blockDim.x >> 5) / K;
    const int slot = warp / K;             // this warp's stream in the block
    const int k = warp - slot * K;         // its place in the pipeline
    const int row = blockIdx.x * P + slot;
    const bool have_row = row < rows;
    const int span = Lr + 1;
    const int T = C * span + 1;

    u64* const block_keys = key_smem
        ? reinterpret_cast<u64*>(dyn + table_bytes(R))
        : gkeys + (size_t)blockIdx.x * P * C;
    const int n_keys = min(P, rows - blockIdx.x * P) * C;
    for (int x = threadIdx.x; x < n_keys; x += blockDim.x) block_keys[x] = 0;
    __syncthreads();

    constexpr int SR = 32 * R;                  // query rows a strip
    const int strips = (Lq + SR - 1) / SR;
    const int groups = (strips + K - 1) / K;    // uniform when K > 1 (P = 1)
    const int chunks = (T + 31 + 31) >> 5;      // a strip's T + 31 steps
    const int MB = -gap_open;                   // M of the border (H = 0)
    const int2 border = make_int2(MB, NEG);
    ChainIO io;
    io.tab = reinterpret_cast<int*>(dyn) + threadIdx.x;
    io.sr_lane = stream + (size_t)row * T - lane;
    io.qr = qrows + (size_t)row * C * Lq;
    io.keys = block_keys + (size_t)slot * C;
    io.ring_out = ring + k * RING;              // written by warps k < K-1
    unsigned char* const edge_base = dyn + table_bytes(R) +
        (key_smem ? ((size_t)P * C * sizeof(u64) + 15) / 16 * 16 : 0);
    io.edge = edge_smem ? reinterpret_cast<int2*>(edge_base) + (size_t)slot * T
                        : scratch + (size_t)row * T;
    io.lane = lane;
    io.T = T;
    io.span = span;
    io.C = C;
    io.Lq = Lq;
    io.gE = gap_extend;
    io.gO = gap_open;
    io.MB = MB;
    io.match = match;
    io.mismatch = mismatch;
    const int2* ring_in = ring + (k - 1) * RING;  // read by warps k >= 1

    for (int g = 0; g < groups; ++g) {
        const int s = g * K + k;                  // this warp's strip
        const bool live = have_row && s < strips;
        io.i0 = s * SR + lane * R;                // this lane's first row
        const bool from_edge = k == 0 && g > 0;
        io.to_ring = lane == 31 && k + 1 < K && s + 1 < strips;
        io.to_edge = lane == 31 && k + 1 == K && s + 1 < strips;
        ChainLane<R> st;
#pragma unroll
        for (int u = 0; u < R; ++u) {
            st.M[u] = MB;
            st.E[u] = NEG;
            st.bm[u] = MB;
            st.bp[u] = 0;
            st.pbm[u] = MB;
            st.pbp[u] = 0;
        }
        st.out_M = MB;
        st.out_F = NEG;
        st.dgM = MB;
        st.job = -1;
        st.tsel = R * TABLE;        // slot 0's boundary turns to table 0
        st.crossed = false;
        if (live) {
            fetch_rows<R>(io, 0, st.nq);
            fill_table<R>(io, 0, st.nq);
            fetch_rows<R>(io, 1, st.nq);
        }
        int2 cur = border, nxt = border;  // the row above the strip
        if (live && from_edge) {
            cur = load_edge(io.edge, lane, T, border);
            nxt = load_edge(io.edge, 32 + lane, T, border);
        }
        const int iters = chunks + 2 * (K - 1);
        for (int it = 0; it < iters; ++it) {
            const int c = it - 2 * k;             // this warp's chunk
            if (live && c >= 0 && c < chunks) {
                if (k > 0) {
                    cur = ring_in[(c * 32 + lane) & (RING - 1)];
                } else if (from_edge && c > 0) {
                    cur = nxt;
                    nxt = load_edge(io.edge, c * 32 + 32 + lane, T, border);
                }
                // the chunk's slots 32c-31 .. 32c+31: the first boundary at
                // or after the lowest, and the stream's edges
                const int lo = c * 32 - 31;
                const int nb = lo <= 0 ? 0 : (lo + span - 1) / span * span;
                if (lo >= 0 && c * 32 + 31 < T && nb > c * 32 + 31)
                    chain_chunk<R, false>(st, io, c, cur);
                else
                    chain_chunk<R, true>(st, io, c, cur);
            }
            if (K > 1) __syncthreads();  // the ring's slots are written
        }
        if (K == 1) __syncwarp();  // the handoff row is complete
    }

    // every fold into this block's keys is done: decode its jobs
    __syncthreads();
    for (int x = threadIdx.x; x < n_keys; x += blockDim.x) {
        const u64 key = block_keys[x];
        const size_t out = (size_t)blockIdx.x * P * C + x;
        if (key == 0) {
            out_score[out] = 0;
            out_qend[out] = -1;
            out_rend[out] = -1;
        } else {
            const unsigned ij = 0xffffffffu - (unsigned)key;
            out_score[out] = (int)(key >> 32);
            out_qend[out] = (int)(ij % (unsigned)Lq);
            out_rend[out] = (int)(ij / (unsigned)Lq);
        }
    }
}

template <int R>
int chain_launch(const void* qrows, const void* stream, int rows, int C,
                 int Lq, int Lr, int match, int mismatch, int gap_open,
                 int gap_extend, int K, int P, int key_smem, int edge_smem,
                 void* scratch, void* keys, void* score, void* q_end,
                 void* r_end, cudaStream_t st) {
    // the dynamic shared memory this kernel may opt into: the block's
    // limit less its static arrays (the 48 KB default counts them too)
    static int max_dyn = -1;
    if (max_dyn < 0) {
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, sw_chain_kernel<R>);
        if (err != cudaSuccess) return static_cast<int>(err);
        const int room = MAX_SMEM - (int)attr.sharedSizeBytes;
        err = cudaFuncSetAttribute(
            sw_chain_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            room);
        if (err != cudaSuccess) return static_cast<int>(err);
        max_dyn = room;
    }
    const long long T = (long long)C * (Lr + 1) + 1;
    const long long key_bytes =
        key_smem ? ((long long)P * C * 8 + 15) / 16 * 16 : 0;
    const long long dyn = table_bytes(R) + key_bytes +
                          (edge_smem ? (long long)P * T * 8 : 0);
    if (dyn > max_dyn) return static_cast<int>(cudaErrorInvalidValue);
    if (!key_smem && keys == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    // a stream of more than K strips writes a handoff row: it needs one
    if (!edge_smem && scratch == nullptr && (Lq + 32 * R - 1) / (32 * R) > K)
        return static_cast<int>(cudaErrorInvalidValue);
    sw_chain_kernel<R><<<(rows + P - 1) / P, K * P * 32, (size_t)dyn, st>>>(
        static_cast<const int8_t*>(qrows), static_cast<const int8_t*>(stream),
        rows, C, Lq, Lr, match, mismatch, gap_open, gap_extend, K, key_smem,
        edge_smem, static_cast<int2*>(scratch), static_cast<u64*>(keys),
        static_cast<int*>(score), static_cast<int*>(q_end),
        static_cast<int*>(r_end));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Launches on ``stream_`` and returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a plan it
// cannot launch; allocates nothing.  R query rows a lane (1, 2 or 4), K
// warps a stream, P streams a block (K * P <= 8, P > 1 only with K = 1).
// ``key_smem`` non-zero: the job keys live in shared memory, else ``keys``
// holds rows * C uint64; ``edge_smem`` non-zero: the handoff rows live in
// P * T * 8 bytes of shared memory, else ``scratch`` holds rows * T int2
// (null when no stream has more than K strips).  Needs Lq >= 1, Lr >= 31
// (a job of at least 32 slots: the wrapper pads shorter references with
// PAD), Lq * Lr <= 2^32 and T = C*(Lr+1)+1 below 2^31 - 64.
extern "C" int sw_chain_launch(const void* qrows, const void* stream,
                               int rows, int C, int Lq, int Lr, int match,
                               int mismatch, int gap_open, int gap_extend,
                               int R, int K, int P, int key_smem,
                               int edge_smem, void* scratch, void* keys,
                               void* score, void* q_end, void* r_end,
                               void* stream_) {
    if (rows <= 0) return 0;
    if (K < 1 || P < 1 || K * P > CHAIN_WARPS || (K > 1 && P > 1) ||
        Lq < 1 || Lr < 31 || C < 1 ||
        (long long)C * (Lr + 1) + 1 >= (long long)INT_MAX - 64 ||
        (unsigned long long)Lq * (unsigned long long)Lr > (1ull << 32))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream_);
    switch (R) {
        case 1:
            return chain_launch<1>(qrows, stream, rows, C, Lq, Lr, match,
                                   mismatch, gap_open, gap_extend, K, P,
                                   key_smem, edge_smem, scratch, keys, score,
                                   q_end, r_end, st);
        case 2:
            return chain_launch<2>(qrows, stream, rows, C, Lq, Lr, match,
                                   mismatch, gap_open, gap_extend, K, P,
                                   key_smem, edge_smem, scratch, keys, score,
                                   q_end, r_end, st);
        case 4:
            return chain_launch<4>(qrows, stream, rows, C, Lq, Lr, match,
                                   mismatch, gap_open, gap_extend, K, P,
                                   key_smem, edge_smem, scratch, keys, score,
                                   q_end, r_end, st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
