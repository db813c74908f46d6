// Batched affine-gap Smith-Waterman score + end coordinates: the row-scan
// design, for Hopper.
//
// Replaces the row family of the SW variant harness misc/kexp.py: make_call's
// pallas_call at :1586 with the kernel bodies build_kernel (:1065, rank-2
// layout) and build_kernel_r3 (:31, rank-3 layout).  Same contract as
// csrc/sw_score_ends.cu and ciri_long_tpu/ops/sw.py::sw_score_ends: codes A0
// C1 G2 T3 N4 PAD5, N scores 0, PAD poisons the diagonal term, a gap of
// length L costs open + (L-1)*extend, and per row (score, q_end, r_end) with
// ties to the highest score, then the smallest r_end, then the smallest
// q_end; (0, -1, -1) when no cell is positive.
//
// Recurrence, one query row i at a time over every reference column at once
// (the formulation of ops/sw.py, exact because gap_open >= gap_extend, which
// the wrapper checks):
//   F[j]  = max(F[j] - gE, H[j] - gO)                  (H, F of row i-1)
//   H0[j] = max(H[j-1] + s(q[i], r[j]), F[j], 0)
//   E[j]  = max_{k<j}(H0[k] + k*gE) - gO - (j-1)*gE    (an exclusive prefix max)
//   H[j]  = max(H0[j], E[j])
// The prefix max, shifted by -(j-1)*gE, obeys E[j+1] = max(E[j] - gE,
// H0[j] - gO) with E[0] = NEG, so a run of columns maps the E entering it,
// e, to max(e - n*gE, x) (n the run's columns, x the E leaving it from NEG),
// and two runs compose to another such map: a scan over runs in column
// order gives every run the E entering it.
//
// Design: a thread owns a run of W consecutive columns (W = 4 .. 32, the
// wrapper's plan), the same run for every query row, so H (kept as M = H -
// gO, which E to the right and F below both need) and F of its run stay in
// registers for the whole sweep.  NW = ceil(Lr / 32W) warps cover a batch
// row (at most 16, Lr <= 16 * 32 * W); a block holds P batch rows.  Per
// query row a thread:
//   pass 1  updates F, computes H0 and, from E = NEG, the E leaving its run;
//   scan    composes the runs' maps over its warp's lanes (five shuffles),
//           then takes the E entering its warp from warp w-1;
//   pass 2  runs E across its columns from the E entering it, H =
//           max(H0, E), and the row's first maximum along its columns.
// Only two values cross threads: H[i-1][c0-1], the last column of the left
// neighbour's run in the row above (a shuffle, or from warp w-1), and the E
// entering the run (the scan).  Between warps they pass through a ring of
// D = 16 rows in shared memory: after row i warp w-1's lane 31 writes (E
// leaving warp w-1, M of its last column) to slot i mod D, fences, and
// publishes i+1 as its count of rows done; warp w spins on that count before
// its pass 2 of row i, and warp w-1 waits before writing slot i mod D until
// warp w has done row i-D, which read it.  So the warps of a row run skewed
// by about a row, a pipeline along the columns, with no block barrier in the
// row loop.  The scores come from a [code] table of the row's query code
// (plus gO) that lanes 0-5 of each warp write per row between two
// __syncwarp; a thread keeps its columns' table offsets in registers.
//
// Best cell: each thread keeps its own (score, i, j): per row the first
// maximum along its run (strict >), taken by a higher score or an equal
// score at a smaller j (rows arrive in order, so an equal (score, j) keeps
// the earlier row, whatever the skew between warps).  Then the lanes
// (shuffles) and the row's warps (shared memory, after one block barrier)
// are folded on (score desc, j asc, i asc): the row-then-column tie rule of
// ops/sw.py:99-104.
//
// Bound: integer ALU, at least 7 integer instructions per cell update
// (csrc/op_rate.cu) against B*(Lq+Lr) bytes of codes; this design issues
// about 12 a cell (two passes over the run) plus, per row and thread, the
// scan's five shuffles and the ring's handoff, shared by W cells.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int MAX_WARPS = 16;     // warps a block (NW * P)
constexpr int MAX_THREADS = MAX_WARPS * 32;
constexpr int DEPTH = 16;         // rows in the ring between two warps
constexpr unsigned FULL = 0xffffffffu;

// (score desc, j asc, i asc): whether (b, i, j) beats (ob, oi, oj)
__device__ __forceinline__ bool beats(int b, int i, int j, int ob, int oi,
                                      int oj) {
    return b > ob || (b == ob && (j < oj || (j == oj && i < oi)));
}

__device__ __forceinline__ void fold_lanes(int& best, int& best_i,
                                           int& best_j) {
    for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_down_sync(FULL, best, off);
        const int oi = __shfl_down_sync(FULL, best_i, off);
        const int oj = __shfl_down_sync(FULL, best_j, off);
        if (beats(ob, oi, oj, best, best_i, best_j)) {
            best = ob;
            best_i = oi;
            best_j = oj;
        }
    }
}

// Pass 2 over a run: E from the E entering it, M = max(M0, E - gO), the
// row's first maximum along the run (columns below ``cols`` only, unless
// FULL_RUN).
template <int W, bool FULL_RUN>
__device__ __forceinline__ void pass2(int (&M)[W], int e, int gO, int gE,
                                      int cols, int& rb, int& rk) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
        const int m0 = M[k];
        const int m = max(m0, e - gO);
        e = max(e - gE, m0);
        M[k] = m;
        if ((FULL_RUN || k < cols) && m > rb) {
            rb = m;
            rk = k;
        }
    }
}

// blockDim.x = P * NW * 32: P batch rows a block, NW warps a row.
template <int W>
__global__ void __launch_bounds__(MAX_THREADS)
sw_rowscan_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
                  int B, int Lq, int Lr, int NW, int match, int mismatch,
                  int gap_open, int gap_extend, int* __restrict__ out_score,
                  int* __restrict__ out_qend, int* __restrict__ out_rend) {
    __shared__ int tab[MAX_WARPS * 8];          // [warp][code]: s + gO
    __shared__ int ring_e[MAX_WARPS][DEPTH];    // warp w -> warp w+1: E
    __shared__ int ring_m[MAX_WARPS][DEPTH];    // and M of its last column
    __shared__ int done[MAX_WARPS];             // rows a warp has finished
    __shared__ int red[3][MAX_WARPS];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int P = (blockDim.x >> 5) / NW;
    const int slot = warp / NW;                 // this warp's row in the block
    const int w = warp - slot * NW;             // its place along the columns
    const int row = blockIdx.x * P + slot;
    const bool have_row = row < B;              // uniform over the row's warps
    const int c0 = (w * 32 + lane) * W;         // this thread's first column
    const int cols = min(max(Lr - c0, 0), W);   // its columns inside Lr
    const int gO = gap_open, gE = gap_extend;
    const int MB = -gO;                         // M of the border (H = 0)
    const int WgE = W * gE;

    if (lane == 0) done[warp] = 0;
    __syncthreads();

    int M[W], F[W];
    unsigned off[(W + 1) / 2];  // table offsets, two 16-bit halves a word
    {
        const int8_t* const rr = r + (size_t)(have_row ? row : 0) * Lr;
#pragma unroll
        for (int k = 0; k < W; ++k) {
            const unsigned code =
                k < cols ? min((unsigned)(int)rr[c0 + k], 5u) : 5u;
            const unsigned o = warp * 8 + code;
            if (k & 1)
                off[k >> 1] |= o << 16;
            else
                off[k >> 1] = o;
            M[k] = MB;
            F[k] = NEG;
        }
    }

    int best = MB, best_i = -1, best_j = INT_MAX;
    if (have_row) {
        const int8_t* const qr = q + (size_t)row * Lq;
        const volatile int* const done_left = done + warp - 1;
        const volatile int* const done_right = done + warp + 1;
        const int from = warp > 0 ? warp - 1 : 0;
        const volatile int* const in_e = ring_e[from];
        const volatile int* const in_m = ring_m[from];
        volatile int* const out_e = ring_e[warp];
        volatile int* const out_m = ring_m[warp];
        int left_M = MB;   // M[i-1][c0-1] for lane 0: warp w-1's last column
        int qn = qr[0];
        for (int i = 0; i < Lq; ++i) {
            const unsigned qc = (unsigned)qn;
            if (i + 1 < Lq) qn = qr[i + 1];
            __syncwarp();  // every lane has read the table of row i-1
            if (lane < 6)
                tab[warp * 8 + lane] =
                    (qc >= 5u || lane == 5 ? NEG
                     : qc == 4u || lane == 4 ? 0
                     : (int)qc == lane ? match : -mismatch) + gO;
            __syncwarp();

            // pass 1: F, H0 (as M0) and the E leaving the run from NEG
            int dg = __shfl_up_sync(FULL, M[W - 1], 1);
            if (lane == 0) dg = left_M;
            int x = NEG;
#pragma unroll
            for (int k = 0; k < W; ++k) {
                const unsigned o =
                    (k & 1) ? off[k >> 1] >> 16 : off[k >> 1] & 0xffffu;
                const int old = M[k];
                const int f = max(F[k] - gE, old);
                const int h0 = max(max(dg + tab[o], f), 0);
                const int m0 = h0 - gO;
                F[k] = f;
                M[k] = m0;
                x = max(x - gE, m0);
                dg = old;
            }

            // scan: the runs' maps composed over the lanes, in column order
            int y = x;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int o = __shfl_up_sync(FULL, y, d);
                if (lane >= d) y = max(y, o - d * WgE);
            }
            int e = __shfl_up_sync(FULL, y, 1);   // E entering from lanes < t
            if (lane == 0) e = NEG;
            const int y31 = __shfl_sync(FULL, y, 31);
            int e_warp = NEG;                     // E entering this warp
            if (w > 0) {
                while (*done_left <= i) {
                }
                __threadfence_block();
                e_warp = in_e[i & (DEPTH - 1)];
                left_M = in_m[i & (DEPTH - 1)];   // for row i+1's diagonal
            }
            e = max(e, e_warp - lane * WgE);

            // pass 2: E, H and the row's first maximum along the run
            int rb = MB, rk = 0;
            if (cols == W)
                pass2<W, true>(M, e, gO, gE, cols, rb, rk);
            else
                pass2<W, false>(M, e, gO, gE, cols, rb, rk);
            if (rb > best || (rb == best && c0 + rk < best_j)) {
                best = rb;
                best_i = i;
                best_j = c0 + rk;
            }

            // hand (E leaving this warp, M of its last column) to warp w+1
            if (w + 1 < NW) {
                while (*done_right <= i - DEPTH) {
                }
            }
            const int last_M = __shfl_sync(FULL, M[W - 1], 31);
            if (lane == 31) {
                if (w + 1 < NW) {
                    out_e[i & (DEPTH - 1)] = max(e_warp - 32 * WgE, y31);
                    out_m[i & (DEPTH - 1)] = last_M;
                }
                __threadfence_block();
                *(volatile int*)(done + warp) = i + 1;
            }
        }
    }

    // M to score; rows with no positive cell keep (0, -1, INT_MAX)
    best -= MB;
    if (best <= 0) {
        best = 0;
        best_i = -1;
        best_j = INT_MAX;
    }
    fold_lanes(best, best_i, best_j);
    if (lane == 0) {
        red[0][warp] = best;
        red[1][warp] = best_i;
        red[2][warp] = best_j;
    }
    __syncthreads();
    if (w != 0 || lane != 0 || !have_row) return;
    for (int v = warp + 1; v < warp + NW; ++v) {
        if (beats(red[0][v], red[1][v], red[2][v], best, best_i, best_j)) {
            best = red[0][v];
            best_i = red[1][v];
            best_j = red[2][v];
        }
    }
    const bool none = best <= 0;
    out_score[row] = none ? 0 : best;
    out_qend[row] = none ? -1 : best_i;
    out_rend[row] = none ? -1 : best_j;
}

template <int W>
int rowscan_launch(const void* q, const void* r, int B, int Lq, int Lr,
                   int NW, int P, int match, int mismatch, int gap_open,
                   int gap_extend, void* score, void* q_end, void* r_end,
                   cudaStream_t stream) {
    sw_rowscan_kernel<W><<<(B + P - 1) / P, P * NW * 32, 0, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(r), B, Lq,
        Lr, NW, match, mismatch, gap_open, gap_extend,
        static_cast<int*>(score), static_cast<int*>(q_end),
        static_cast<int*>(r_end));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  W reference columns a thread (4, 8, 16
// or 32), P batch rows a block; NW = ceil(Lr / 32W) warps a row, NW * P <=
// 16.  Launches on ``stream`` and returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a plan it cannot launch; allocates nothing.
// Needs Lq, Lr >= 1.
extern "C" int sw_rowscan_launch(const void* q, const void* r, int B, int Lq,
                                 int Lr, int W, int P, int match,
                                 int mismatch, int gap_open, int gap_extend,
                                 void* score, void* q_end, void* r_end,
                                 void* stream) {
    if (B <= 0) return 0;
    if (Lq < 1 || Lr < 1 || W < 1 || P < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int NW = (Lr + 32 * W - 1) / (32 * W);
    if (NW * P > MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (W) {
        case 4:
            return rowscan_launch<4>(q, r, B, Lq, Lr, NW, P, match, mismatch,
                                     gap_open, gap_extend, score, q_end,
                                     r_end, st);
        case 8:
            return rowscan_launch<8>(q, r, B, Lq, Lr, NW, P, match, mismatch,
                                     gap_open, gap_extend, score, q_end,
                                     r_end, st);
        case 16:
            return rowscan_launch<16>(q, r, B, Lq, Lr, NW, P, match,
                                      mismatch, gap_open, gap_extend, score,
                                      q_end, r_end, st);
        case 32:
            return rowscan_launch<32>(q, r, B, Lq, Lr, NW, P, match,
                                      mismatch, gap_open, gap_extend, score,
                                      q_end, r_end, st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
