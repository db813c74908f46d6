// Batched affine-gap Smith-Waterman score + end coordinates for Hopper.
//
// Replaces the four Pallas TPU kernels of ciri_long_tpu/ops/sw_pallas.py
// (K1 _sw_chain_kernel, K2 _sw_wave5_kernel, K3 _sw_wave_kernel, K4
// _sw_kernel), which compute one contract, ciri_long_tpu/ops/sw.py::
// sw_score_ends: codes A0 C1 G2 T3 N4 PAD5, N scores 0, PAD poisons the
// diagonal term, a gap of length L costs open + (L-1)*extend, and the result
// per row is (score, q_end, r_end) with ties to the highest score, then the
// smallest r_end, then the smallest q_end; (0, -1, -1) when no cell is
// positive.  The TPU kernels differ only in Mosaic layout; here one kernel
// serves every shape.
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
// Design: one warp per batch row, four rows per block.  Lane t owns query
// row i = 32*s + t of strip s and the warp sweeps anti-diagonals d across
// the reference: at step d lane t computes column j = d - t.  H and E of the
// row stay in registers; H, F and the reference code of the row above come
// from lane t-1 by __shfl_up_sync.  Lane 0 takes the row above from a global
// [B, Lr] int2 (H, F) scratch row written by lane 31 of the previous strip;
// the warp fetches that row and the reference codes 32 columns at a time,
// coalesced, one chunk ahead, and lane 0 picks its value out with
// __shfl_sync, so no step waits on memory.  One row suffices: column c is
// fetched by step c - 32 and consumed (every lane's chunk value enters a
// full-warp shuffle) by step c, while lane 31 overwrites it at step c + 31.
//
// Bound: the DP is latency- and integer-ALU-bound: O(B*Lq*Lr) cell updates
// of ~12 integer ops and 6 shuffles per warp step, against O(B*(Lq+Lr))
// bytes of codes plus the O(B*Lr*(Lq/32)) scratch round trips, which stay
// in L2.  Parallelism is one warp per batch row, so small batches leave
// most of the card idle; splitting long queries over several warps is later
// work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL = 0xffffffffu;

// Chunk c of the row above (H, F) and of the reference codes, one column per
// lane.  Columns past Lr read as the empty border (H 0, F NEG, code PAD).
// ``edge`` is written by this kernel, so it is not declared __restrict__: no
// read-only cache path may serve it.
__device__ __forceinline__ void load_chunk(const int2* edge,
                                           const int8_t* __restrict__ ref,
                                           int col, int Lr, bool first,
                                           int2& up, int& code) {
    if (col < Lr) {
        code = ref[col];
        up = first ? make_int2(0, NEG) : edge[col];
    } else {
        code = 5;
        up = make_int2(0, NEG);
    }
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sw_score_ends_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ r, int B, int Lq, int Lr,
                     int match, int mismatch, int gap_open, int gap_extend,
                     int2* __restrict__ scratch, int* __restrict__ out_score,
                     int* __restrict__ out_qend, int* __restrict__ out_rend) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= B) return;  // whole warps leave together
    const int8_t* qr = q + (size_t)row * Lq;
    const int8_t* rr = r + (size_t)row * Lr;
    int2* const edge = scratch + (size_t)row * Lr;  // row above the strip

    int best = 0, best_i = -1, best_j = INT_MAX;
    const int n_strips = (Lq + 31) / 32;
    for (int s = 0; s < n_strips; ++s) {
        const int i = s * 32 + lane;
        const bool row_ok = i < Lq;
        const int qc = row_ok ? qr[i] : 5;
        const bool first = s == 0;

        int2 cur_up, nxt_up;
        int cur_code, nxt_code;
        load_chunk(edge, rr, lane, Lr, first, cur_up, cur_code);
        load_chunk(edge, rr, 32 + lane, Lr, first, nxt_up, nxt_code);

        int H_left = 0, E_left = NEG;         // H[i][j-1], E[i][j-1]
        int out_H = 0, out_F = NEG, out_code = 5;  // this lane's last cell
        int diag = 0;                         // H[i-1][j-1]
        const int steps = Lr + 31;
        for (int d = 0; d < steps; ++d) {
            const int m = d & 31;
            if (m == 0 && d > 0) {
                cur_up = nxt_up;
                cur_code = nxt_code;
                load_chunk(edge, rr, d + 32 + lane, Lr, first, nxt_up,
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
            const int j = d - lane;
            int H = 0, F = NEG;  // column -1 border, seen by lane t+1
            if (j >= 0 && j < Lr) {
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
                if (lane == 31) edge[j] = make_int2(H, F);
            }
            diag = up_H;
            out_H = H;
            out_F = F;
            out_code = rc;
        }
        __syncwarp();  // lane 31's scratch row is complete for lane 0
    }

    // lexicographic (score desc, r_end asc, q_end asc) across the lanes
    for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_down_sync(FULL, best, off);
        const int oi = __shfl_down_sync(FULL, best_i, off);
        const int oj = __shfl_down_sync(FULL, best_j, off);
        if (ob > best ||
            (ob == best && (oj < best_j || (oj == best_j && oi < best_i)))) {
            best = ob;
            best_i = oi;
            best_j = oj;
        }
    }
    if (lane == 0) {
        const bool none = best <= 0;
        out_score[row] = none ? 0 : best;
        out_qend[row] = none ? -1 : best_i;
        out_rend[row] = none ? -1 : best_j;
    }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); allocates nothing.  ``scratch`` holds
// B * Lr int2 (H, F) values.
extern "C" int sw_score_ends_launch(const void* q, const void* r, int B,
                                    int Lq, int Lr, int match, int mismatch,
                                    int gap_open, int gap_extend,
                                    void* scratch, void* score, void* q_end,
                                    void* r_end, void* stream) {
    if (B <= 0) return 0;
    const int blocks = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    sw_score_ends_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(r), B, Lq,
        Lr, match, mismatch, gap_open, gap_extend,
        static_cast<int2*>(scratch), static_cast<int*>(score),
        static_cast<int*>(q_end), static_cast<int*>(r_end));
    return static_cast<int>(cudaGetLastError());
}
