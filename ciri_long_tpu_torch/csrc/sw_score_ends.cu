// Batched affine-gap Smith-Waterman score + end coordinates for Hopper.
//
// Replaces the four Pallas TPU kernels of ciri_long_tpu/ops/sw_pallas.py
// (K1 _sw_chain_kernel, K2 _sw_wave5_kernel, K3 _sw_wave_kernel, K4
// _sw_kernel), which compute one contract, ciri_long_tpu/ops/sw.py::
// sw_score_ends: codes A0 C1 G2 T3 N4 PAD5, N scores 0, PAD poisons the
// diagonal term, a gap of length L costs open + (L-1)*extend, and the result
// per row is (score, q_end, r_end) with ties to the highest score, then the
// smallest r_end, then the smallest q_end; (0, -1, -1) when no cell is
// positive.  The TPU kernels differ only in Mosaic layout; here two routes
// serve every shape (ops/sw.py::_tile_plan picks the route).
//
// Recurrence (plain Gotoh in int32; equal to the prefix-max form of sw.py
// because gap_open >= gap_extend, which the wrapper checks):
//   E[i][j] = max(E[i][j-1] - gE, H[i][j-1] - gO)
//   F[i][j] = max(F[i-1][j] - gE, H[i-1][j] - gO)
//   H[i][j] = max(H[i-1][j-1] + s(q[i], r[j]), E, F, 0)
// with H = 0 and E = F = NEG on the borders.  Every H is >= 0 and every E, F
// >= -gO, so no value comes near int32 overflow; no wraparound tricks (K1's
// frame at sw_pallas.py:397-410 relies on them, which CUDA C++ leaves
// undefined) and no packed best: the best cell is kept as (score, i, j).
//
// Route 1, the wavefront (sw_wave_kernel<R>, every shape _tile_plan leaves
// to it): a block of K warps per row, pipelined over the query's strips
// (ops/sw.py::_wave_plan gives K, R, the rows a block and where the handoff
// row lives).
//
//   Strips.  A strip is 32*R query rows: lane t holds rows 32R*s + R*t ..
//   + R-1, so the vertical dependence between a lane's R rows stays in
//   registers and one set of shuffles serves R cells.  At its step d lane t
//   computes column j = d - t of its R rows.
//   Warps.  Warp k sweeps strips k, k+K, k+2K, ... (a group of K strips at a
//   time); it runs two 32-step chunks behind warp k-1 and takes the row
//   above its strip, warp k-1's bottom (M, F) row, from a ring of RING = 128
//   columns in shared memory, 32 columns at the start of each chunk.  The
//   warps step through the chunks in lockstep, one __syncthreads a chunk.
//   Warp k's chunk c needs the columns 32c..32c+31 of warp k-1's bottom row,
//   which warp k-1's lane 31 computes at steps 32c+31..32c+62, in its chunks
//   c and c+1: both are done before warp k's chunk c (lag 2).  In that
//   chunk warp k-1 is at its chunk c+2, whose lane 31 writes the columns
//   32c+33..32c+64, 2..64 ahead of the ones warp k reads, so a ring of 128
//   never hands out a slot before it has been read
//   (tests/test_torch_sw_wave.py asserts it on the emulated schedule).  A
//   group's critical path is (Lr + 31) + 64 (K - 1) steps instead of
//   K (Lr + 31).
//   Groups.  Warp 0 of group g+1 takes the row above from a handoff row
//   that lane 31 of warp K-1 wrote in group g, fetched one chunk ahead of
//   its use: in dynamic shared memory when Lr * 8 bytes fit beside the ring
//   and the score table, else in global scratch [B, Lr] int2.  Within a
//   group warp K-1 writes columns 2(K-1) chunks behind warp 0's reads (and
//   with K = 1, lane 31 writes columns its warp fetched a chunk before), so
//   the row is never overwritten before it is read.  With K = 1 (one strip
//   a row, or more rows than the card needs warps for) a block holds P
//   rows, a warp each, and has no barrier in its sweep.
//   Steps.  A chunk's 32 steps are one fixed loop without branches,
//   unrolled 8 ways (unrolled whole, nvcc 12.8 crashes at R = 2 and 4, and
//   R = 1 spills).  A lane's score against each reference code 0..5 (plus
//   gap_open) comes from a [code][row][thread] table in shared memory built
//   once a strip (PAD, and any code outside 0..4, scores NEG; N scores 0),
//   the code from global memory (the block's warps read one row: L1 serves
//   it).  Only a strip's first chunk and its last, where some lane's column
//   lies outside [0, lr), mask their cells.  H is kept as M = H - gap_open,
//   which E to the right and F below both need (the table adds gap_open
//   back on the diagonal), so a cell is csrc/op_rate.cu's update plus its
//   best.
//   Real lengths.  Each block first finds its row's real lengths lq and lr,
//   one past the last code in 0..4, and sweeps only those strips and
//   columns.  That is exact: a cell in a trailing PAD row (i >= lq) or
//   column (j >= lr) has a poisoned diagonal, so a positive H there comes
//   from a gap (E or F) out of a cell above or to the left; following those
//   moves back reaches a cell outside the trailing PAD rows and columns
//   whose H is at least as high (each move costs gap_open or gap_extend,
//   both >= 0) and that comes first in the contract's order (a smaller j,
//   or the same j and a smaller i).  And the DP flows only down and to the
//   right, so the cells kept never read the ones cut.  PAD inside a row is
//   swept like any code.
//   The best.  With R rows a lane and K warps a row, sweep order no longer
//   gives the smallest j, then i, so every fold compares the whole (score,
//   j, i) with ``before``: each row keeps its first maximum along j (strict
//   >), then a lane's rows, the lanes (shuffles) and the block's warps
//   (shared memory) are folded.
//
// Route 2, reference tiles (sw_tile_kernel<R> + sw_tile_merge_kernel), for
// a short query against a long reference: one warp per (row, tile).  Tile k
// owns columns [k*T, min((k+1)*T, Lr)) and sweeps the window [max(0, k*T -
// halo), min((k+1)*T, Lr)) with the usual zero border, halo = Lq +
// floor(Lq*match/gE) + 1.  A positive local alignment covers at most Lq
// diagonal steps and fewer than Lq*match/gE gap columns (each costs >= gE,
// since gO >= gE, and the matches bring at most Lq*match), so the optimum
// ending in an owned column lies whole inside the tile and the tile's H
// there is exact; elsewhere a tile's H never exceeds the true H (its border
// is 0 <= H, NEG <= E).  So each tile may report its best over all its
// columns, and the best record under the contract's order is the answer.
//
//   Step body.  A tile's warp is the wavefront's with K = 1 on its window:
//   strips of 32*R query rows (R from the query's length, ops/sw.py::
//   _tile_rows), wave_chunk's branch-free 32-step chunks over the
//   [code][row][thread] score table with M = H - gO, masked only in a
//   strip's first chunk and the chunks that reach past the window's real
//   width, and a handoff row between strips, (T + halo) int2 a warp in
//   dynamic shared memory, only for a query of more than one strip.  The
//   first strip's row above is the border, so it shuffles none in; a
//   row's best is one packed key a cell (one max instead of a compare and
//   two selects; the plan keeps |M| < 2^16 and the window under 2^15
//   steps).
//   Real lengths.  The warp first finds the row's real query length lq and
//   its window's real width lr (one past the window's last code in 0..4,
//   by ballots from the window's end) and sweeps only those strips and
//   columns.  A window that holds no code in 0..4 (it starts at or past
//   the row's real reference length, or lies in a PAD run) does no sweep
//   and writes the empty record.  That is exact by the wavefront's argument
//   applied to the window as its own DP: a cut cell (a row i >= lq, or a
//   column past the window's last real code) has a poisoned diagonal, so a
//   positive H there comes from a gap out of a cell above or to the left;
//   following those moves back reaches a kept cell whose H is at least as
//   high and that comes first in the contract's order, and no kept cell
//   reads a cut one.  So the tile's record, the first maximum of its kept
//   cells, is the first maximum of its whole window, and the halo argument
//   above holds for it unchanged.
//   The best.  Each row keeps its first maximum along j (strict >); a
//   lane's rows and the lanes are folded on the whole (score, j, i) with
//   ``before``, so the record is the tile's first cell in the contract's
//   order whatever the rows a lane.  The merge runs one warp per row over
//   the [B, n_tiles] records in the same order.
//
// Bound: the DP is latency- and integer-ALU-bound: O(B*Lq*Lr) cell updates
// of at least 7 integer instructions (csrc/op_rate.cu) against O(B*(Lq+Lr))
// bytes of codes.  The wavefront issues about 9 instructions a cell and
// 10 a step shared by a lane's R cells (4 shuffles, 2 selects, the code
// load, its table offset, the ring or handoff store), and fills the card
// with B*K warps; the tiles spend the same a step, over B*ceil(Lr/T) warps
// of (lr + 31) steps a strip, for a halo overhead of halo/T columns.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <vector>
#include <cuda_runtime.h>

#include "row_views.h"

namespace {

constexpr int NEG = -(1 << 28);
constexpr int MERGE_WARPS = 4;     // the merge's rows a block
constexpr int MAX_SMEM = 232448;  // shared memory a Hopper block may have
constexpr unsigned FULL = 0xffffffffu;
constexpr int WAVE_WARPS = 8;     // the wavefront's warps a block (K * P)
constexpr int WAVE_THREADS = WAVE_WARPS * 32;
constexpr int RING = 128;         // ring columns between two warps
constexpr int PACK_D = 1 << 15;   // steps a packed best tells apart
constexpr int TILE_WARPS = 4;     // the tiles' (row, tile) warps a block
constexpr int TILE_THREADS = TILE_WARPS * 32;

// (score, i, j) ordered as the contract orders the best cell: higher score,
// then smaller j, then smaller i.
__device__ __forceinline__ bool before(int s, int i, int j, int bs, int bi,
                                       int bj) {
    return s > bs || (s == bs && (j < bj || (j == bj && i < bi)));
}

__device__ __forceinline__ void fold_lanes(int& best, int& best_i,
                                           int& best_j) {
    for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_down_sync(FULL, best, off);
        const int oi = __shfl_down_sync(FULL, best_i, off);
        const int oj = __shfl_down_sync(FULL, best_j, off);
        if (before(ob, oi, oj, best, best_i, best_j)) {
            best = ob;
            best_i = oi;
            best_j = oj;
        }
    }
}

__device__ __forceinline__ void write_ends(int row, int best, int best_i,
                                           int best_j, int* out_score,
                                           int* out_qend, int* out_rend) {
    const bool none = best <= 0;
    out_score[row] = none ? 0 : best;
    out_qend[row] = none ? -1 : best_i;
    out_rend[row] = none ? -1 : best_j;
}

// The handoff row's column ``col`` (M, F), the border past lr.  ``edge`` is
// written by the sweep, so it is not declared __restrict__.
__device__ __forceinline__ int2 load_edge(const int2* edge, int col, int lr,
                                          int2 border) {
    return col < lr ? edge[col] : border;
}

// One lane of the wavefront over one strip: its R rows' M = H - gO and E at
// the last column, each row's best M and the step that first reached it,
// the lane's bottom row (M, F) for lane t+1, and M of the row above at the
// column before (the first row's diagonal).
template <int R>
struct WaveLane {
    int M[R], E[R], bm[R], bd[R];
    int out_M, out_F, dgM;
};

// Where a step's values go: the lane's score table row for code 0, the
// reference row shifted by the lane, and lane 31's ring and handoff rows.
struct WaveIO {
    const int* tab;          // + (code * R + u) * TH: s + gO
    const int8_t* rr_lane;   // column j = d - lane at rr_lane[d]
    int2* ring_out;
    int2* edge;
    bool to_ring, to_edge;
    int lane, lr, gE, MB;
};

// One step d of the sweep: lane t computes column j = d - t of its R rows.
// MASKED: some lane's column lies outside [0, lr), where the cell is the
// border (M = -gO, E = F = NEG) and no code is read.  (tM, tF): the row
// above the strip at column d, for lane 0.  TH: the threads of the block's
// score table.  PACK: each row's best is one key, bm = max(m * 2^15 +
// (2^15 - 1 - d)) (the largest M, then the smallest d; bd unused), which
// needs |M| < 2^16 and d < 2^15 (pack_best / unpack_best).
template <int R, bool MASKED, int TH, bool PACK = false>
__device__ __forceinline__ void wave_step(WaveLane<R>& st, const WaveIO& io,
                                          int d, int tM, int tF) {
    const int j = d - io.lane;
    const bool cell = !MASKED || (unsigned)j < (unsigned)io.lr;
    const int code = cell ? (int)io.rr_lane[d] : 5;
    const int* t = io.tab + min((unsigned)code, 5u) * (R * TH);
    int upM = __shfl_up_sync(FULL, st.out_M, 1);
    int upF = __shfl_up_sync(FULL, st.out_F, 1);
    if (io.lane == 0) {
        upM = tM;
        upF = tF;
    }
    int dg = st.dgM;          // M[i-1][j-1] of the lane's first row
    st.dgM = upM;
    int mu = upM, fu = upF;
#pragma unroll
    for (int u = 0; u < R; ++u) {
        const int left = st.M[u];
        int e = max(st.E[u] - io.gE, left);
        int f = max(fu - io.gE, mu);
        const int h = max(max(dg + t[u * TH], e), max(f, 0));
        int m = h + io.MB;
        if (MASKED) {
            m = cell ? m : io.MB;
            e = cell ? e : NEG;
            f = cell ? f : NEG;
        }
        if (PACK) {
            st.bm[u] = max(st.bm[u], m * PACK_D + (PACK_D - 1 - d));
        } else if (m > st.bm[u]) {
            st.bm[u] = m;
            st.bd[u] = d;
        }
        dg = left;
        mu = m;
        fu = f;
        st.M[u] = m;
        st.E[u] = e;
    }
    st.out_M = mu;
    st.out_F = fu;
    if (io.to_ring && cell) io.ring_out[j & (RING - 1)] = make_int2(mu, fu);
    if (io.to_edge && cell) io.edge[j] = make_int2(mu, fu);
}

// A chunk's 32 steps, a fixed loop without branches; ``top`` holds the row
// above the strip at columns 32c + lane, or with BORDER the strip is the
// query's first and the row above is the zero border (no shuffles).
template <int R, bool MASKED, int TH, bool BORDER = false, bool PACK = false>
__device__ __forceinline__ void wave_chunk(WaveLane<R>& st, const WaveIO& io,
                                           int c, int2 top) {
#pragma unroll 8
    for (int kk = 0; kk < 32; ++kk) {
        const int tM = BORDER ? io.MB : __shfl_sync(FULL, top.x, kk);
        const int tF = BORDER ? NEG : __shfl_sync(FULL, top.y, kk);
        wave_step<R, MASKED, TH, PACK>(st, io, c * 32 + kk, tM, tF);
    }
}

__device__ __forceinline__ int warp_max(int v) {
    for (int off = 16; off > 0; off >>= 1)
        v = max(v, __shfl_xor_sync(FULL, v, off));
    return v;
}

// The wavefront: blockDim.x = K * P * 32 (K warps a row, P rows a block,
// P > 1 only with K = 1).  ``edge_smem``: the handoff rows (P * Lr int2)
// live in dynamic shared memory; otherwise ``scratch`` holds B * Lr int2
// (read only by rows of more than K strips).
template <int R>
__global__ void __launch_bounds__(WAVE_THREADS, 2)
sw_wave_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
               int B, int Lq, int Lr, int match, int mismatch, int gap_open,
               int gap_extend, int K, int edge_smem, int2* scratch,
               int* __restrict__ out_score, int* __restrict__ out_qend,
               int* __restrict__ out_rend) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ int2 ring[(WAVE_WARPS - 1) * RING];
    __shared__ int sc_tab[6 * R * WAVE_THREADS];  // [code][row][thread]
    __shared__ int red_s[WAVE_WARPS], red_i[WAVE_WARPS], red_j[WAVE_WARPS];
    __shared__ int lens[2 * WAVE_WARPS];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int P = (blockDim.x >> 5) / K;
    const int slot = warp / K;             // this warp's row in the block
    const int k = warp - slot * K;         // its place in the row's pipeline
    const int row = blockIdx.x * P + slot;
    const bool have_row = row < B;
    const int8_t* qr = q + (size_t)row * Lq;  // read only when have_row
    const int8_t* rr = r + (size_t)row * Lr;

    // The row's real lengths: one past its last code in 0..4.
    if (threadIdx.x < 2 * P) lens[threadIdx.x] = 0;
    __syncthreads();
    {
        int lq = 0, lr = 0;
        if (have_row) {
            for (int x = k * 32 + lane; x < Lq; x += K * 32)
                if ((unsigned)qr[x] < 5u) lq = x + 1;
            for (int x = k * 32 + lane; x < Lr; x += K * 32)
                if ((unsigned)rr[x] < 5u) lr = x + 1;
        }
        lq = warp_max(lq);
        lr = warp_max(lr);
        if (lane == 0) {
            atomicMax(&lens[2 * slot], lq);
            atomicMax(&lens[2 * slot + 1], lr);
        }
    }
    __syncthreads();
    const int lq = lens[2 * slot];
    const int lr = lens[2 * slot + 1];

    constexpr int SR = 32 * R;                  // query rows a strip
    const int strips = lr > 0 ? (lq + SR - 1) / SR : 0;
    const int groups = (strips + K - 1) / K;    // uniform when K > 1 (P = 1)
    const int chunks = (lr + 31 + 31) >> 5;     // a strip's lr + 31 steps
    const int MB = -gap_open;                   // M of the border (H = 0)
    const int2 border = make_int2(MB, NEG);
    WaveIO io;
    io.tab = sc_tab + threadIdx.x;
    io.rr_lane = rr - lane;
    io.ring_out = ring + k * RING;              // written by warps k < K-1
    io.edge = edge_smem ? reinterpret_cast<int2*>(dyn) + (size_t)slot * Lr
                        : scratch + (size_t)row * Lr;
    io.lane = lane;
    io.lr = lr;
    io.gE = gap_extend;
    io.MB = MB;
    const int2* ring_in = ring + (k - 1) * RING;  // read by warps k >= 1
    int* tab = sc_tab + threadIdx.x;

    int best = 0, best_i = -1, best_j = INT_MAX;
    for (int g = 0; g < groups; ++g) {
        const int s = g * K + k;                  // this warp's strip
        const bool live = s < strips;
        const int i0 = s * SR + lane * R;         // this lane's first row
        const bool from_edge = k == 0 && g > 0;
        io.to_ring = lane == 31 && k + 1 < K && s + 1 < strips;
        io.to_edge = lane == 31 && k + 1 == K && s + 1 < strips;
        if (live) {
#pragma unroll
            for (int u = 0; u < R; ++u) {
                const int i = i0 + u;
                const unsigned qc = i < lq ? (unsigned)(int)qr[i] : 5u;
#pragma unroll
                for (int c = 0; c < 6; ++c)
                    tab[(c * R + u) * WAVE_THREADS] =
                        (qc >= 5u || c == 5 ? NEG
                         : qc == 4u || c == 4 ? 0
                         : (int)qc == c ? match : -mismatch) + gap_open;
            }
        }
        WaveLane<R> st;
#pragma unroll
        for (int u = 0; u < R; ++u) {
            st.M[u] = MB;
            st.E[u] = NEG;
            st.bm[u] = MB;
            st.bd[u] = 0;
        }
        st.out_M = MB;
        st.out_F = NEG;
        st.dgM = MB;
        int2 cur = border, nxt = border;  // the row above the strip
        if (live && from_edge) {
            cur = load_edge(io.edge, lane, lr, border);
            nxt = load_edge(io.edge, 32 + lane, lr, border);
        }
        const int iters = chunks + 2 * (K - 1);
        for (int it = 0; it < iters; ++it) {
            const int c = it - 2 * k;             // this warp's chunk
            if (live && c >= 0 && c < chunks) {
                if (k > 0) {
                    cur = ring_in[(c * 32 + lane) & (RING - 1)];
                } else if (from_edge && c > 0) {
                    cur = nxt;
                    nxt = load_edge(io.edge, c * 32 + 32 + lane, lr, border);
                }
                if (c > 0 && c * 32 + 31 < lr)
                    wave_chunk<R, false, WAVE_THREADS>(st, io, c, cur);
                else
                    wave_chunk<R, true, WAVE_THREADS>(st, io, c, cur);
            }
            if (K > 1) __syncthreads();  // the ring's columns are written
        }
        if (K == 1) __syncwarp();  // the handoff row is complete
        if (live) {
#pragma unroll
            for (int u = 0; u < R; ++u) {
                const int i = i0 + u;
                const int sc = st.bm[u] - MB;
                const int j = st.bd[u] - lane;
                if (i < lq && sc > 0 &&
                    before(sc, i, j, best, best_i, best_j)) {
                    best = sc;
                    best_i = i;
                    best_j = j;
                }
            }
        }
    }

    fold_lanes(best, best_i, best_j);
    if (lane == 0) {
        red_s[warp] = best;
        red_i[warp] = best_i;
        red_j[warp] = best_j;
    }
    __syncthreads();
    if (k != 0 || lane != 0 || !have_row) return;
    for (int w = warp + 1; w < warp + K; ++w) {
        if (before(red_s[w], red_i[w], red_j[w], best, best_i, best_j)) {
            best = red_s[w];
            best_i = red_i[w];
            best_j = red_j[w];
        }
    }
    write_ends(row, best, best_i, best_j, out_score, out_qend, out_rend);
}

// One past the last code in 0..4 of x[0, n), by one ballot a 32-code chunk
// from the end (0 when there is none).
__device__ __forceinline__ int real_length(const int8_t* __restrict__ x,
                                           int n, int lane) {
    for (int hi = n; hi > 0; hi -= 32) {
        const int at = hi - 32 + lane;
        const unsigned m =
            __ballot_sync(FULL, at >= 0 && (unsigned)x[at] < 5u);
        if (m) return hi - 32 + (32 - __clz(m));
    }
    return 0;
}

// One warp per (row, tile), blockDim.x / 32 <= TILE_WARPS of them a block
// (the score table is laid out for TILE_THREADS); ``edge_cols`` int2 of
// dynamic shared memory a warp for the handoff row (0 for a one-strip
// query).  Writes records[row][tile] = (score, i, j) with j global,
// (0, -1, INT_MAX) when the tile has no positive cell.
template <int R>
__global__ void __launch_bounds__(TILE_THREADS)
sw_tile_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
               int B, int Lq, int Lr, int match, int mismatch, int gap_open,
               int gap_extend, int T, int halo, int n_tiles, int edge_cols,
               int3* __restrict__ records) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ int sc_tab[6 * R * TILE_THREADS];  // [code][row][thread]
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int w = blockIdx.x * (blockDim.x >> 5) + warp;  // B*n_tiles < 2^31
    if (w >= B * n_tiles) return;  // whole warps leave together
    const int row = w / n_tiles;
    const int tile = w - row * n_tiles;
    const int start = max(0, tile * T - halo);
    const int8_t* qr = q + (size_t)row * Lq;
    const int8_t* rr = r + (size_t)row * Lr + start;
    const int lq = real_length(qr, Lq, lane);
    const int lr = real_length(rr, min(tile * T + T, Lr) - start, lane);

    constexpr int SR = 32 * R;                  // query rows a strip
    const int strips = lr > 0 ? (lq + SR - 1) / SR : 0;
    const int chunks = (lr + 31 + 31) >> 5;     // a strip's lr + 31 steps
    const int MB = -gap_open;                   // M of the border (H = 0)
    const int2 border = make_int2(MB, NEG);
    WaveIO io;
    io.tab = sc_tab + threadIdx.x;
    io.rr_lane = rr - lane;
    io.ring_out = nullptr;
    io.edge = reinterpret_cast<int2*>(dyn) + (size_t)warp * edge_cols;
    io.to_ring = false;
    io.lane = lane;
    io.lr = lr;
    io.gE = gap_extend;
    io.MB = MB;
    int* tab = sc_tab + threadIdx.x;

    int best = 0, best_i = -1, best_j = INT_MAX;
    for (int s = 0; s < strips; ++s) {
        const int i0 = s * SR + lane * R;       // this lane's first row
        io.to_edge = lane == 31 && s + 1 < strips;
#pragma unroll
        for (int u = 0; u < R; ++u) {
            const int i = i0 + u;
            const unsigned qc = i < lq ? (unsigned)(int)qr[i] : 5u;
#pragma unroll
            for (int c = 0; c < 6; ++c)
                tab[(c * R + u) * TILE_THREADS] =
                    (qc >= 5u || c == 5 ? NEG
                     : qc == 4u || c == 4 ? 0
                     : (int)qc == c ? match : -mismatch) + gap_open;
        }
        WaveLane<R> st;
#pragma unroll
        for (int u = 0; u < R; ++u) {
            st.M[u] = MB;
            st.E[u] = NEG;
            st.bm[u] = MB * PACK_D + (PACK_D - 1);  // (MB, step 0)
            st.bd[u] = 0;
        }
        st.out_M = MB;
        st.out_F = NEG;
        st.dgM = MB;
        int2 cur = border, nxt = border;  // the row above the strip
        if (s > 0) {
            cur = load_edge(io.edge, lane, lr, border);
            nxt = load_edge(io.edge, 32 + lane, lr, border);
        }
        for (int c = 0; c < chunks; ++c) {
            if (s > 0 && c > 0) {
                cur = nxt;
                nxt = load_edge(io.edge, c * 32 + 32 + lane, lr, border);
            }
            const bool inner = c > 0 && c * 32 + 31 < lr;
            if (s > 0 && inner)
                wave_chunk<R, false, TILE_THREADS, false, true>(st, io, c,
                                                                 cur);
            else if (s > 0)
                wave_chunk<R, true, TILE_THREADS, false, true>(st, io, c,
                                                                cur);
            else if (inner)
                wave_chunk<R, false, TILE_THREADS, true, true>(st, io, c,
                                                                cur);
            else
                wave_chunk<R, true, TILE_THREADS, true, true>(st, io, c,
                                                               cur);
        }
        __syncwarp();  // the handoff row is complete
#pragma unroll
        for (int u = 0; u < R; ++u) {
            const int i = i0 + u;
            const int sc = (st.bm[u] >> 15) - MB;  // PACK_D = 2^15
            const int j = PACK_D - 1 - (st.bm[u] & (PACK_D - 1)) - lane;
            if (i < lq && sc > 0 && before(sc, i, j, best, best_i, best_j)) {
                best = sc;
                best_i = i;
                best_j = j;
            }
        }
    }
    fold_lanes(best, best_i, best_j);
    if (lane == 0)
        records[w] = best > 0 ? make_int3(best, best_i, start + best_j)
                              : make_int3(0, -1, INT_MAX);
}

// One warp per row: the best of its n_tiles records, in the contract's order.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
sw_tile_merge_kernel(const int3* __restrict__ records, int B, int n_tiles,
                     int* __restrict__ out_score, int* __restrict__ out_qend,
                     int* __restrict__ out_rend) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
    if (row >= B) return;
    int best = 0, best_i = -1, best_j = INT_MAX;
    for (int t = lane; t < n_tiles; t += 32) {
        const int3 x = records[(size_t)row * n_tiles + t];
        if (before(x.x, x.y, x.z, best, best_i, best_j)) {
            best = x.x;
            best_i = x.y;
            best_j = x.z;
        }
    }
    fold_lanes(best, best_i, best_j);
    if (lane == 0)
        write_ends(row, best, best_i, best_j, out_score, out_qend, out_rend);
}

int blocks_for(int warps, int per_block) {
    return (warps + per_block - 1) / per_block;
}

template <int R>
int wave_launch(const void* q, const void* r, int B, int Lq, int Lr,
                int match, int mismatch, int gap_open, int gap_extend, int K,
                int P, int edge_smem, void* scratch, void* score,
                void* q_end, void* r_end, cudaStream_t stream) {
    // the dynamic shared memory this kernel may opt into: the block's
    // limit less its static arrays (the 48 KB default counts them too)
    static int max_dyn = -1;
    if (max_dyn < 0) {
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, sw_wave_kernel<R>);
        if (err != cudaSuccess) return static_cast<int>(err);
        const int room = MAX_SMEM - (int)attr.sharedSizeBytes;
        err = cudaFuncSetAttribute(
            sw_wave_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            room);
        if (err != cudaSuccess) return static_cast<int>(err);
        max_dyn = room;
    }
    const long long dyn = edge_smem ? (long long)P * Lr * sizeof(int2) : 0;
    if (dyn > max_dyn) return static_cast<int>(cudaErrorInvalidValue);
    // a row of more than K strips writes a handoff row: it needs one
    if (!edge_smem && scratch == nullptr && (Lq + 32 * R - 1) / (32 * R) > K)
        return static_cast<int>(cudaErrorInvalidValue);
    sw_wave_kernel<R><<<blocks_for(B, P), K * P * 32, (size_t)dyn, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(r), B, Lq,
        Lr, match, mismatch, gap_open, gap_extend, K, edge_smem,
        static_cast<int2*>(scratch), static_cast<int*>(score),
        static_cast<int*>(q_end), static_cast<int*>(r_end));
    return static_cast<int>(cudaGetLastError());
}

template <int R>
int tile_launch(const void* q, const void* r, int B, int Lq, int Lr,
                int match, int mismatch, int gap_open, int gap_extend, int T,
                int halo, int n_tiles, int edge_cols, void* records,
                cudaStream_t stream) {
    static int max_dyn = -1;  // as wave_launch: the block's limit less the
    if (max_dyn < 0) {        // static table
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, sw_tile_kernel<R>);
        if (err != cudaSuccess) return static_cast<int>(err);
        const int room = MAX_SMEM - (int)attr.sharedSizeBytes;
        err = cudaFuncSetAttribute(
            sw_tile_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            room);
        if (err != cudaSuccess) return static_cast<int>(err);
        max_dyn = room;
    }
    const long long warp_bytes = (long long)edge_cols * sizeof(int2);
    if (warp_bytes > max_dyn) return static_cast<int>(cudaErrorInvalidValue);
    int warps = TILE_WARPS;
    if (warp_bytes * warps > max_dyn) warps = (int)(max_dyn / warp_bytes);
    const int tiles = B * n_tiles;
    sw_tile_kernel<R><<<blocks_for(tiles, warps), warps * 32,
                        (size_t)(warp_bytes * warps), stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(r), B, Lq,
        Lr, match, mismatch, gap_open, gap_extend, T, halo, n_tiles,
        edge_cols, static_cast<int3*>(records));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on ``stream`` and returns
// cudaGetLastError() (0 on success); neither allocates.

// The wavefront: R query rows a lane (1, 2 or 4), K warps a row, P rows a
// block (K * P <= 8, P > 1 only with K = 1).  ``edge_smem`` non-zero: the
// handoff rows live in P * Lr * 8 bytes of dynamic shared memory; else
// ``scratch`` holds B * Lr int2 (null when no row has more than K strips).
// Returns cudaErrorInvalidValue for a plan it cannot launch.
extern "C" int sw_wave_launch(const void* q, const void* r, int B, int Lq,
                              int Lr, int match, int mismatch, int gap_open,
                              int gap_extend, int R, int K, int P,
                              int edge_smem, void* scratch, void* score,
                              void* q_end, void* r_end, void* stream) {
    if (B <= 0) return 0;
    if (K < 1 || P < 1 || K * P > WAVE_WARPS || (K > 1 && P > 1) || Lq < 0 ||
        Lr < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (R) {
        case 1:
            return wave_launch<1>(q, r, B, Lq, Lr, match, mismatch, gap_open,
                                  gap_extend, K, P, edge_smem, scratch,
                                  score, q_end, r_end, st);
        case 2:
            return wave_launch<2>(q, r, B, Lq, Lr, match, mismatch, gap_open,
                                  gap_extend, K, P, edge_smem, scratch,
                                  score, q_end, r_end, st);
        case 4:
            return wave_launch<4>(q, r, B, Lq, Lr, match, mismatch, gap_open,
                                  gap_extend, K, P, edge_smem, scratch,
                                  score, q_end, r_end, st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Tiles of T owned columns swept from halo columns before them, R query
// rows a lane (1, 2 or 4).  ``records`` holds B * ceil(Lr / T) int3.
// Returns cudaErrorInvalidValue when one warp's handoff row does not fit a
// block's shared memory beside the score table, when a packed best could
// overflow (Lq * match or gap_open of 2^16 or more, T + halo + 62 of 2^15
// or more), or when there are 2^31 (row, tile) warps or more.
extern "C" int sw_tiles_launch(const void* q, const void* r, int B, int Lq,
                               int Lr, int match, int mismatch, int gap_open,
                               int gap_extend, int R, int T, int halo,
                               void* records, void* score, void* q_end,
                               void* r_end, void* stream) {
    if (B <= 0) return 0;
    if (T <= 0 || halo < 0 || Lr <= 0 || Lq < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_tiles = (Lr + T - 1) / T;
    if ((long long)B * n_tiles > INT_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    // the packed best: |M| < 2^16 (M <= Lq * match - gO) and a window
    // under PACK_D steps (lr + 62 at most)
    if ((long long)Lq * match >= (1 << 16) || gap_open >= (1 << 16) ||
        T + halo + 62 >= PACK_D)
        return static_cast<int>(cudaErrorInvalidValue);
    const int edge_cols = Lq > 32 * R ? T + halo : 0;
    int rc;
    switch (R) {
        case 1:
            rc = tile_launch<1>(q, r, B, Lq, Lr, match, mismatch, gap_open,
                                gap_extend, T, halo, n_tiles, edge_cols,
                                records, st);
            break;
        case 2:
            rc = tile_launch<2>(q, r, B, Lq, Lr, match, mismatch, gap_open,
                                gap_extend, T, halo, n_tiles, edge_cols,
                                records, st);
            break;
        case 4:
            rc = tile_launch<4>(q, r, B, Lq, Lr, match, mismatch, gap_open,
                                gap_extend, T, halo, n_tiles, edge_cols,
                                records, st);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    if (rc != 0) return rc;
    sw_tile_merge_kernel<<<blocks_for(B, MERGE_WARPS), MERGE_WARPS * 32, 0,
                           st>>>(
        static_cast<const int3*>(records), B, n_tiles,
        static_cast<int*>(score), static_cast<int*>(q_end),
        static_cast<int*>(r_end));
    return static_cast<int>(cudaGetLastError());
}

namespace {

// The reverse pass's inputs (the reference's reverse pass, ssw.c:836-849):
// each row's prefix up to its forward end, reversed, PAD past it (all PAD
// for a row without a positive cell, end -1); a warp a row, both sides.
// Replaces ops/sw.py::_reverse_prefix's gather on the rows path.
__global__ void __launch_bounds__(row_views::EXPAND_WARPS * 32)
reverse_prefix_kernel(const int8_t* __restrict__ qpad,
                      const int8_t* __restrict__ rpad,
                      const int* __restrict__ q_end,
                      const int* __restrict__ r_end, int B,
                      const row_views::Group* __restrict__ groups, int G,
                      int8_t* __restrict__ rq, int8_t* __restrict__ rr) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * row_views::EXPAND_WARPS +
                          (threadIdx.x >> 5);
    if (row >= B) return;
    const row_views::Group g = groups[row_views::group_of(groups, G, row)];
    const long long k = row - g.start;
    const long long qa = g.abase + k * g.la, ra = g.bbase + k * g.lb;
    const int eq = q_end[row], er = r_end[row];
    for (int x = lane; x < g.la; x += 32)
        rq[qa + x] = x <= eq ? qpad[qa + eq - x] : (int8_t)5;
    for (int x = lane; x < g.lb; x += 32)
        rr[ra + x] = x <= er ? rpad[ra + er - x] : (int8_t)5;
}

// out[row] = (score, q_begin, q_end, r_begin, r_end) from the forward
// pass (score, q_end, r_end: [3][B]) and the reverse pass's ends (the
// offsets of the begins: [3][B]); begins -1 where the score is not
// positive (ops/sw.py::_sw_align_fused's assembly).
__global__ void rows_result_kernel(const int* __restrict__ fwd,
                                   const int* __restrict__ rev, int B,
                                   int* __restrict__ out) {
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= B) return;
    const int s = fwd[row], qe = fwd[B + row], re = fwd[2 * B + row];
    const bool none = s <= 0;
    int* o = out + 5 * (size_t)row;
    o[0] = s;
    o[1] = none ? -1 : qe - rev[B + row];
    o[2] = qe;
    o[3] = none ? -1 : re - rev[2 * B + row];
    o[4] = re;
}

// A group's plan row (ops/sw.py::sw_align_rows): start, rows, Lq, Lr,
// match, mismatch, gap_open, gap_extend, route (0 wavefront, 1 tiles),
// R, then K, P and the handoff row's place (0 none, 1 shared memory, 2
// global scratch) for the wavefront, or T and halo for the tiles.
constexpr int PLAN_COLS = 13;

int launch_group(const int* p, const int8_t* q, const int8_t* r, int* score,
                 int* q_end, int* r_end, void* scratch, cudaStream_t st) {
    if (p[8] == 0)
        return sw_wave_launch(q, r, p[1], p[2], p[3], p[4], p[5], p[6], p[7],
                              p[9], p[10], p[11], p[12] == 1,
                              p[12] == 2 ? scratch : nullptr, score, q_end,
                              r_end, st);
    return sw_tiles_launch(q, r, p[1], p[2], p[3], p[4], p[5], p[6], p[7],
                           p[9], p[10], p[11], scratch, score, q_end, r_end,
                           st);
}

}  // namespace

// The native rounds' staging on CUDA device ``device`` (null on failure),
// kept by ops/rows.py::row_stage for the process.
extern "C" void* sw_rows_stage_new(int device) {
    return row_views::stage_new(device);
}

// One fused SW round of B rows over ragged views (ops/rows.py): ``views``
// int32 [4][B] (query offsets and lengths into ``qcodes``, reference
// offsets and lengths into ``rcodes``), rows grouped in order by ``plans``
// (int32 [G][PLAN_COLS]).  On the stage's stream: one upload, the rows
// expanded to each group's padded layout, the forward pass a group, the
// reversed prefixes, the reverse pass a group, the [B, 5] answers (score,
// q_begin, q_end, r_begin, r_end, as ops/sw.py::_sw_align_fused gives
// them) in one download to ``out``.  ``phase_ns`` (double [3]) gets the
// upload, device-wait and download ns (csrc/row_views.h).  Returns 0, a
// cudaError, or cudaErrorInvalidValue for a plan that does not tile the
// rows.
extern "C" int sw_rows_run(void* stage, const void* qcodes, long long nq,
                           const void* rcodes, long long nr,
                           const void* views, int B, const void* plans,
                           int G, void* out, void* phase_ns) {
    using namespace row_views;
    Stage& s = *static_cast<Stage*>(stage);
    auto* phase = static_cast<double*>(phase_ns);
    const int64_t t0 = now_ns();
    if (B <= 0) {
        phase[0] += static_cast<double>(now_ns() - t0);
        return 0;
    }
    cudaError_t err = cudaSetDevice(s.device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto* plan = static_cast<const int*>(plans);
    std::vector<Group> groups(G);
    long long qsize = 0, rsize = 0, next = 0;
    size_t scratch = 16;
    for (int g = 0; g < G; ++g) {
        const int* p = plan + g * PLAN_COLS;
        if (p[0] != next || p[1] <= 0 || p[2] <= 0 || p[3] <= 0)
            return static_cast<int>(cudaErrorInvalidValue);
        next += p[1];
        groups[g] = Group{p[0], p[1], p[2], p[3], qsize, rsize};
        qsize += align_up((size_t)p[1] * p[2]);
        rsize += align_up((size_t)p[1] * p[3]);
        if (p[8] == 0 && p[12] == 2)
            scratch = std::max(scratch, (size_t)p[1] * p[3] * 8);
        else if (p[8] == 1 && p[10] > 0)
            scratch = std::max(scratch, (size_t)p[1] *
                                            ((p[3] + p[10] - 1) / p[10]) *
                                            12);
    }
    if (next != B) return static_cast<int>(cudaErrorInvalidValue);

    // pinned: views, groups, query codes, reference codes | the answers
    const size_t o_groups = align_up((size_t)16 * B);
    const size_t o_q = o_groups + align_up(sizeof(Group) * G);
    const size_t o_r = o_q + align_up((size_t)nq);
    const size_t in_bytes = o_r + align_up((size_t)nr);
    const size_t out_bytes = (size_t)20 * B;
    const size_t n3 = align_up((size_t)12 * B);
    if ((err = s.reserve_host(in_bytes + out_bytes)) != cudaSuccess ||
        (err = s.in.reserve(in_bytes, s.stream)) != cudaSuccess ||
        (err = s.pad.reserve(2 * (qsize + rsize), s.stream)) !=
            cudaSuccess ||
        (err = s.ints.reserve(2 * n3 + out_bytes, s.stream)) !=
            cudaSuccess ||
        (err = s.scratch.reserve(scratch, s.stream)) != cudaSuccess)
        return static_cast<int>(err);
    stage_bytes(s, 0, views, (size_t)16 * B);
    stage_bytes(s, o_groups, groups.data(), sizeof(Group) * G);
    stage_bytes(s, o_q, qcodes, (size_t)nq);
    stage_bytes(s, o_r, rcodes, (size_t)nr);
    const cudaStream_t st = s.stream;
    if ((err = cudaMemcpyAsync(s.in.ptr, s.host, in_bytes,
                               cudaMemcpyHostToDevice, st)) != cudaSuccess)
        return static_cast<int>(err);
    const int64_t t1 = now_ns();
    phase[0] += static_cast<double>(t1 - t0);

    const int* d_views = s.in.at<int>(0);
    const Group* d_groups = s.in.at<Group>(o_groups);
    int8_t* qpad = s.pad.at<int8_t>(0);
    int8_t* rpad = qpad + qsize;
    int8_t* rq = rpad + rsize;
    int8_t* rr = rq + qsize;
    int* fwd = s.ints.at<int>(0);
    int* rev = s.ints.at<int>(n3);
    int* res = s.ints.at<int>(2 * n3);
    expand_kernel<<<expand_blocks(B), EXPAND_WARPS * 32, 0, st>>>(
        s.in.at<int8_t>(o_q), s.in.at<int8_t>(o_r), d_views, B, d_groups, G,
        qpad, rpad);
    if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    for (int pass = 0; pass < 2; ++pass) {
        int* ends = pass ? rev : fwd;
        for (int g = 0; g < G; ++g) {
            const int rc = launch_group(
                plan + g * PLAN_COLS, (pass ? rq : qpad) + groups[g].abase,
                (pass ? rr : rpad) + groups[g].bbase, ends + groups[g].start,
                ends + B + groups[g].start, ends + 2 * B + groups[g].start,
                s.scratch.ptr, st);
            if (rc != 0) return rc;
        }
        if (pass == 0) {
            reverse_prefix_kernel<<<expand_blocks(B), EXPAND_WARPS * 32, 0,
                                    st>>>(qpad, rpad, fwd + B, fwd + 2 * B,
                                          B, d_groups, G, rq, rr);
            if ((err = cudaGetLastError()) != cudaSuccess)
                return static_cast<int>(err);
        }
    }
    rows_result_kernel<<<(B + 255) / 256, 256, 0, st>>>(fwd, rev, B, res);
    if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    return static_cast<int>(
        finish_round(s, res, out_bytes, in_bytes, out, t1, phase));
}
