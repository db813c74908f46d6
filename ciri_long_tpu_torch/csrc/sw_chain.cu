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
// boundary code 6, and one closing boundary, T = C*(Lr+1) + 1 slots.  The
// queries stay [B/C, C*Lq], job k's row i at k*Lq + i.
//
// Design: the wavefront of csrc/sw_score_ends.cu run over a stream instead of
// one reference.  One warp per stream, four streams per block; lane t owns
// query row i = 32*s + t of strip s and at step d computes slot p = d - t, so
// the stream passes through the lanes and each boundary reaches lane t one
// step after lane t-1.  When a lane meets a boundary it flushes its best
// cell of the job that ended, loads row i of the next job's query, and
// resets H, E (and emits the column -1 border: H 0, F NEG, which the lane
// below and the strip below read as the new job's border).  So the 31-step
// fill and drain of a strip is paid once per stream of C jobs instead of
// once per job; no lane waits for the next job.  Strips over Lq > 32 pass H
// and F through one [B/C, T] int2 scratch row, as in sw_score_ends.cu.  H
// and E of the row stay in registers; H, F and the code of the row above
// come from lane t-1 by __shfl_up_sync; lane 0 takes them from the scratch
// row and the stream, fetched 32 slots at a time one chunk ahead.
//
// Best cell: a lane keeps its (score, i, j) for the current job (replaced
// only by a higher score or an equal score at a smaller j), and at the
// job's closing boundary merges it into a per-(job, lane) record in global
// memory: written in strip 0, replaced in a later strip only by a higher
// score or an equal score at a smaller j (an earlier strip has the smaller
// i).  After the last strip the warp reduces each job's 32 records (score
// desc, j asc, i asc).  The records are read back only by the lane that
// wrote them.
//
// Bound: as sw_score_ends.cu, integer ALU and shuffle latency, at least 7
// integer instructions per cell update (csrc/op_rate.cu) plus one boundary
// slot per job; parallelism is
// one warp per stream, B/C warps, so chaining trades warps for a shorter
// fill and drain and pays off only where the reference is short.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int BOUNDARY = 6;
constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL = 0xffffffffu;

// Chunk of the row above (H, F) and of the stream codes, one slot per lane.
// Slots past T read as the empty border.  ``edge`` is written by this
// kernel, so it is not declared __restrict__.
__device__ __forceinline__ void load_chunk(const int2* edge,
                                           const int8_t* __restrict__ stream,
                                           int slot, int T, bool first,
                                           int2& up, int& code) {
    if (slot < T) {
        code = stream[slot];
        up = first ? make_int2(0, NEG) : edge[slot];
    } else {
        code = BOUNDARY;
        up = make_int2(0, NEG);
    }
}

// (score desc, j asc, i asc): whether (b, i, j) beats (ob, oi, oj)
__device__ __forceinline__ bool beats(int b, int i, int j, int ob, int oi,
                                      int oj) {
    return b > ob || (b == ob && (j < oj || (j == oj && i < oi)));
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sw_chain_kernel(const int8_t* __restrict__ qrows,
                const int8_t* __restrict__ stream, int rows, int C, int Lq,
                int T, int match, int mismatch, int gap_open, int gap_extend,
                int2* __restrict__ scratch, int* __restrict__ records,
                int* __restrict__ out_score, int* __restrict__ out_qend,
                int* __restrict__ out_rend) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= rows) return;  // whole warps leave together
    const int8_t* const qr = qrows + (size_t)row * C * Lq;
    const int8_t* const sr = stream + (size_t)row * T;
    int2* const edge = scratch + (size_t)row * T;
    int* const rec = records + (size_t)row * C * 32 * 3;

    const int n_strips = (Lq + 31) / 32;
    for (int s = 0; s < n_strips; ++s) {
        const int i = s * 32 + lane;
        const bool row_ok = i < Lq;
        const bool first = s == 0;

        int2 cur_up, nxt_up;
        int cur_code, nxt_code;
        load_chunk(edge, sr, lane, T, first, cur_up, cur_code);
        load_chunk(edge, sr, 32 + lane, T, first, nxt_up, nxt_code);

        int H_left = 0, E_left = NEG;              // H[i][j-1], E[i][j-1]
        int out_H = 0, out_F = NEG, out_code = 5;  // this lane's last cell
        int diag = 0;                              // H[i-1][j-1]
        int job = -1, j = 0, qc = 5;
        int best = 0, best_i = -1, best_j = INT_MAX;
        const int steps = T + 31;
        for (int d = 0; d < steps; ++d) {
            const int m = d & 31;
            if (m == 0 && d > 0) {
                cur_up = nxt_up;
                cur_code = nxt_code;
                load_chunk(edge, sr, d + 32 + lane, T, first, nxt_up,
                           nxt_code);
            }
            const int l0_H = __shfl_sync(FULL, cur_up.x, m);
            const int l0_F = __shfl_sync(FULL, cur_up.y, m);
            const int l0_code = __shfl_sync(FULL, cur_code, m);
            int up_H = __shfl_up_sync(FULL, out_H, 1);
            int up_F = __shfl_up_sync(FULL, out_F, 1);
            int rc = __shfl_up_sync(FULL, out_code, 1);
            if (lane == 0) {
                up_H = l0_H;
                up_F = l0_F;
                rc = l0_code;
            }
            const int p = d - lane;
            int H = 0, F = NEG;  // a boundary is the column -1 border
            if (p >= 0 && p < T) {
                if (rc == BOUNDARY) {
                    if (job >= 0) {
                        int* const e = rec + (job * 32 + lane) * 3;
                        if (first || best > e[0] ||
                            (best == e[0] && best_j < e[2])) {
                            e[0] = best;
                            e[1] = best_i;
                            e[2] = best_j;
                        }
                    }
                    ++job;
                    j = 0;
                    qc = (row_ok && job < C) ? qr[job * Lq + i] : 5;
                    best = 0;
                    best_i = -1;
                    best_j = INT_MAX;
                    H_left = 0;
                    E_left = NEG;
                } else {
                    int sc;
                    if (qc >= 5 || rc >= 5) {
                        sc = NEG;
                    } else if (qc == 4 || rc == 4) {
                        sc = 0;
                    } else {
                        sc = qc == rc ? match : -mismatch;
                    }
                    const int E = max(E_left - gap_extend, H_left - gap_open);
                    F = max(up_F - gap_extend, up_H - gap_open);
                    H = max(max(diag + sc, E), max(F, 0));
                    H_left = H;
                    E_left = E;
                    if (row_ok && H > 0 &&
                        (H > best || (H == best && j < best_j))) {
                        best = H;
                        best_i = i;
                        best_j = j;
                    }
                    ++j;
                }
                if (lane == 31) edge[p] = make_int2(H, F);
            }
            diag = up_H;
            out_H = H;
            out_F = F;
            out_code = rc;
        }
        __syncwarp();  // lane 31's scratch row is complete for lane 0
    }

    for (int k = 0; k < C; ++k) {
        const int* const e = rec + (k * 32 + lane) * 3;
        int best = e[0], best_i = e[1], best_j = e[2];
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
        if (lane == 0) {
            const bool none = best <= 0;
            const size_t out = (size_t)row * C + k;
            out_score[out] = none ? 0 : best;
            out_qend[out] = none ? -1 : best_i;
            out_rend[out] = none ? -1 : best_j;
        }
    }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on ``stream_`` and returns
// cudaGetLastError() (0 on success); allocates nothing.  ``scratch`` holds
// rows * T int2 (H, F) values and ``records`` rows * C * 32 * 3 ints.
// Needs Lq >= 1.
extern "C" int sw_chain_launch(const void* qrows, const void* stream,
                               int rows, int C, int Lq, int T, int match,
                               int mismatch, int gap_open, int gap_extend,
                               void* scratch, void* records, void* score,
                               void* q_end, void* r_end, void* stream_) {
    if (rows <= 0) return 0;
    const int blocks = (rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    sw_chain_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                      static_cast<cudaStream_t>(stream_)>>>(
        static_cast<const int8_t*>(qrows), static_cast<const int8_t*>(stream),
        rows, C, Lq, T, match, mismatch, gap_open, gap_extend,
        static_cast<int2*>(scratch), static_cast<int*>(records),
        static_cast<int*>(score), static_cast<int*>(q_end),
        static_cast<int*>(r_end));
    return static_cast<int>(cudaGetLastError());
}
