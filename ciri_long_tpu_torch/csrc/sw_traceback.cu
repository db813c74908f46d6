// Batched affine-gap Smith-Waterman WITH traceback for Hopper.
//
// Replaces the XLA device program ciri_long_tpu/ops/sw_tb_batch.py::
// _align_one / sw_traceback_batch (ROADMAP X5): per job, the output of the
// host DP ops/traceback.py::sw_traceback(q, r, match, mismatch, gap_open,
// gap_extend), with q the query (collapse's doubled read, n codes) and r the
// reference (its ~50-base junction window, m codes).  Host indices: i over
// q, j over r, H/E/F with
//   E[i][j] = max(E[i][j-1] - gE, H[i][j-1] - gO)    gap consuming r
//   F[i][j] = max(F[i-1][j] - gE, H[i-1][j] - gO)    gap consuming q
//   H[i][j] = max(H[i-1][j-1] + s(q[i], r[j]), E, F, 0)
// (equal to the host's prefix-max form since gO >= gE); N scores 0 against
// anything and PAD (>= 5) scores NEG.  The end cell is the maximum score,
// then the smallest reference end j, then the smallest query end i
// (sw_tb_batch.py:115-123); no positive cell gives score 0 and no path.
//
// Direction codes, one byte a cell, in host semantics (sw_tb_batch.py:
// 18-22): bits 0-1 the case STOP 0 (H == 0), M 1, E 2, F 3 in that priority;
// bit 2 E-stay (j > 1, E == E[i][j-1] - gE and E != H[i][j-1] - gO); bit 3
// F-stay (i > 1, F == F[i-1][j] - gE and F != H[i-1][j] - gO).  The
// traceback is the host's state machine (sw_tb_batch.py:137-189) over them.
//
// Design: one warp per job over its real lengths.  Lane t owns reference row
// j = 32*s + t of strip s (m <= 64 in collapse: two strips) and the warp
// sweeps anti-diagonals across the query: at step d lane t computes column
// i = d - t.  F and H of the cell to the left stay in registers; (H, E) of
// the row above and the query code come from lane t-1 by __shfl_up_sync;
// lane 0 takes them from an (H, E) handoff row that lane 31 of the previous
// strip wrote into a global [n] int2 row (the one-row argument of
// sw_score_ends.cu), fetched 32 columns at a time one chunk ahead.  Every
// step the warp writes its 32 code bytes to 32 consecutive bytes, laid out
// (strip, step, lane): ceil(m / 32) * (n + 31) * 32 bytes a job, at an offset
// the wrapper computes from each job's real n and m.  After the sweep lane
// 0 walks the traceback from the end cell and writes the ops (1 M, 2 I,
// 3 D) from the end of the job's ops row backwards.
//
// Bound: the sweep's cell update (the SW update plus the code's compares
// and its byte; csrc/op_rate.cu times it) over sum(n * m) cells, against the
// direction bytes written once; the traceback is one dependent load a path
// step by one lane, ~m steps for a junction window.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int STOP = 0, CM = 1, CE = 2, CF = 3;

// Chunk column ``col`` of the row above (H, E) and of the query codes, one
// column per lane; the first strip's row above is the border (0, NEG).
// ``edge`` is written by the sweep, so it is not declared __restrict__.
__device__ __forceinline__ void load_chunk(const int2* edge,
                                           const int8_t* __restrict__ qr,
                                           int col, int n, bool first,
                                           int2& up, int& code) {
    if (col < n) {
        code = qr[col];
        up = first ? make_int2(0, NEG) : edge[col];
    } else {
        code = 5;
        up = make_int2(0, NEG);
    }
}

// (score, j, i) in the order of the end cell: higher score, then smaller
// reference end j, then smaller query end i.
__device__ __forceinline__ bool before(int s, int j, int i, int bs, int bj,
                                       int bi) {
    return s > bs || (s == bs && (j < bj || (j == bj && i < bi)));
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sw_traceback_kernel(const int8_t* __restrict__ q,
                    const int8_t* __restrict__ r,
                    const int* __restrict__ ns, const int* __restrict__ ms,
                    int B, int W, int M, int match, int mismatch,
                    int gap_open, int gap_extend,
                    const long long* __restrict__ code_off,
                    uint8_t* codes_all, int2* edge_rows, int cap,
                    int8_t* __restrict__ ops_all, int* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int job = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    if (job >= B) return;  // whole warps leave together
    const int n = min(max(ns[job], 0), W);
    const int m = min(max(ms[job], 0), M);
    int* o = out + (size_t)job * 6;
    if (n == 0 || m == 0) {
        if (lane == 0) {
            o[0] = 0;
            o[1] = o[2] = o[3] = o[4] = -1;
            o[5] = 0;
        }
        return;
    }
    const int8_t* qr = q + (size_t)job * W;
    const int8_t* rr = r + (size_t)job * M;
    uint8_t* codes = codes_all + code_off[job];
    int2* edge = edge_rows + (size_t)job * W;
    const int n_strips = (m + 31) / 32;
    const int steps = n + 31;

    int best = 0, best_j = INT_MAX, best_i = INT_MAX;
    for (int s = 0; s < n_strips; ++s) {
        const int j = s * 32 + lane;
        const bool row_ok = j < m;
        const int rc = row_ok ? rr[j] : 5;
        const bool first = s == 0;
        const bool hand_off = lane == 31 && s + 1 < n_strips;
        // this row's best: i rises along the sweep, so strict > keeps the
        // smallest i at the row's maximum
        int s_best = 0, s_i = INT_MAX;

        int2 cur_up, nxt_up;
        int cur_code, nxt_code;
        load_chunk(edge, qr, lane, n, first, cur_up, cur_code);
        load_chunk(edge, qr, 32 + lane, n, first, nxt_up, nxt_code);

        int H_left = 0, F_left = NEG;        // H[i-1][j], F[i-1][j]
        int out_H = 0, out_E = NEG, out_code = 5;
        int diag = 0;                        // H[i-1][j-1]
        uint8_t* strip_codes = codes + (size_t)s * steps * 32 + lane;
        for (int d = 0; d < steps; ++d) {
            const int k = d & 31;
            if (k == 0 && d > 0) {
                cur_up = nxt_up;
                cur_code = nxt_code;
                load_chunk(edge, qr, d + 32 + lane, n, first, nxt_up,
                           nxt_code);
            }
            const int l0_H = __shfl_sync(FULL, cur_up.x, k);
            const int l0_E = __shfl_sync(FULL, cur_up.y, k);
            const int l0_code = __shfl_sync(FULL, cur_code, k);
            int up_H = __shfl_up_sync(FULL, out_H, 1);
            int up_E = __shfl_up_sync(FULL, out_E, 1);
            int qc = __shfl_up_sync(FULL, out_code, 1);
            if (lane == 0) {
                up_H = l0_H;
                up_E = l0_E;
                qc = l0_code;
            }
            const int i = d - lane;
            int H = 0, E = NEG;              // the border column, seen by t+1
            int code = 0;
            if (i >= 0 && i < n) {
                int sc;
                if (qc >= 5 || rc >= 5) {
                    sc = NEG;
                } else if (qc == 4 || rc == 4) {
                    sc = 0;
                } else {
                    sc = qc == rc ? match : -mismatch;
                }
                const int dv = diag + sc;
                const int F = max(F_left - gap_extend, H_left - gap_open);
                E = max(up_E - gap_extend, up_H - gap_open);
                H = max(max(dv, E), max(F, 0));
                const int cs = H == 0 ? STOP
                             : H == dv ? CM
                             : H == E ? CE
                             : H == F ? CF : STOP;
                const bool estay = j > 0 && E == up_E - gap_extend &&
                                   E != up_H - gap_open;
                const bool fstay = i > 0 && F == F_left - gap_extend &&
                                   F != H_left - gap_open;
                code = cs | (estay << 2) | (fstay << 3);
                if (row_ok && H > s_best) {
                    s_best = H;
                    s_i = i;
                }
                H_left = H;
                F_left = F;
                if (hand_off) edge[i] = make_int2(H, E);
            }
            strip_codes[(size_t)d * 32] = (uint8_t)code;
            diag = up_H;
            out_H = H;
            out_E = E;
            out_code = qc;
        }
        if (s_best > 0 && before(s_best, j, s_i, best, best_j, best_i)) {
            best = s_best;
            best_j = j;
            best_i = s_i;
        }
        __syncwarp();  // the handoff row and the codes are complete
    }

    for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_down_sync(FULL, best, off);
        const int oj = __shfl_down_sync(FULL, best_j, off);
        const int oi = __shfl_down_sync(FULL, best_i, off);
        if (before(ob, oj, oi, best, best_j, best_i)) {
            best = ob;
            best_j = oj;
            best_i = oi;
        }
    }
    if (lane != 0) return;
    if (best <= 0) {
        o[0] = 0;
        o[1] = o[2] = o[3] = o[4] = -1;
        o[5] = 0;
        return;
    }
    // the host state machine; (i, j) are host indices, 1-based cells
    int8_t* ops = ops_all + (size_t)job * cap;
    int i = best_i + 1, j = best_j + 1, state = 0, cnt = 0;
    while (i > 0 && j > 0) {
        const int jj = j - 1, t = jj & 31;
        const int c = codes[((size_t)(jj >> 5) * steps + (i - 1 + t)) * 32 + t];
        if (state == 0) {
            const int cs = c & 3;
            if (cs == STOP) break;
            if (cs == CM) {
                ops[cap - 1 - cnt++] = 1;
                --i;
                --j;
            } else {
                state = cs == CE ? 1 : 2;
            }
        } else if (state == 1) {          // E: a reference base, D
            ops[cap - 1 - cnt++] = 3;
            if (!((c >> 2) & 1)) state = 0;
            --j;
        } else {                          // F: a query base, I
            ops[cap - 1 - cnt++] = 2;
            if (!((c >> 3) & 1)) state = 0;
            --i;
        }
    }
    o[0] = best;
    o[1] = i;
    o[2] = best_i;
    o[3] = j;
    o[4] = best_j;
    o[5] = cnt;
}

}  // namespace

// Plain C entry point for ctypes.  ``codes`` holds the direction bytes of
// every job at ``code_off`` (int64 [B]), ceil(m/32) * (n + 31) * 32 bytes a
// job; ``edge_rows`` holds B * W int2 when any m exceeds 32 (any pointer
// otherwise); ``ops`` is [B, cap] int8 with cap >= max n + max m; ``out``
// is [B, 6] int32 (score, q_begin, q_end, r_begin, r_end, op count).
// Launches on ``stream``, allocates nothing, and returns cudaGetLastError()
// (0 on success).
extern "C" int sw_traceback_launch(const void* q, const void* r,
                                   const void* ns, const void* ms, int B,
                                   int W, int M, int match, int mismatch,
                                   int gap_open, int gap_extend,
                                   const void* code_off, void* codes,
                                   void* edge_rows, int cap, void* ops,
                                   void* out, void* stream) {
    if (B <= 0) return 0;
    sw_traceback_kernel<<<(B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK,
                          WARPS_PER_BLOCK * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(r),
        static_cast<const int*>(ns), static_cast<const int*>(ms), B, W, M,
        match, mismatch, gap_open, gap_extend,
        static_cast<const long long*>(code_off),
        static_cast<uint8_t*>(codes), static_cast<int2*>(edge_rows), cap,
        static_cast<int8_t*>(ops), static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}
