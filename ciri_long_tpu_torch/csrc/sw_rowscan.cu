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
//
// Design: one block per batch row; its threads own contiguous runs of
// reference columns (``cols`` each) and the block sweeps the Lq query rows.
// The H and F rows and the reference codes live in shared memory (8 bytes a
// column plus the code; Lr = 16384 takes 148 KiB of the 227 KiB a block may
// have; the wrapper raises above the limit, about Lr = 25 000, instead of
// tiling).  A column j sits at slot j + j/32, so the threads of a warp, each
// at its own run, hit distinct banks.  Per row, pass 1 updates F, computes
// H0 and each thread's max of H0[k] + k*gE; a warp shuffle scan and a scan
// of the warp totals through shared memory give every thread the max over
// the columns left of its run; pass 2 recomputes H0, runs the prefix max
// across its own columns, and writes H.  Two __syncthreads per row: one for
// the warp totals, one so that no thread reads a neighbour's H[c0-1] of the
// row above after the neighbour has overwritten it.
//
// Best cell: each thread keeps its own (score, i, j), replaced only by a
// higher score or an equal score at a smaller j (rows arrive in order, so
// for an equal (score, j) the earlier row keeps it); the block then reduces
// (score desc, j asc, i asc).  This is the row-then-column tie rule of
// ops/sw.py:99-104.
//
// Bound: integer ALU, at least 7 integer instructions per cell update
// (csrc/op_rate.cu) against
// B*(Lq+Lr) bytes of codes; every row costs two block barriers and two scans
// whatever Lr is, so short references pay for synchronisation, not cells.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int slot(int j) { return j + (j >> 5); }

__device__ __forceinline__ int subst(int qc, int rc, int match,
                                     int mismatch) {
    if (qc >= 5 || rc >= 5) return NEG;
    if (qc == 4 || rc == 4) return 0;
    return qc == rc ? match : -mismatch;
}

// (score desc, j asc, i asc): whether (b, i, j) beats (ob, oi, oj)
__device__ __forceinline__ bool beats(int b, int i, int j, int ob, int oi,
                                      int oj) {
    return b > ob || (b == ob && (j < oj || (j == oj && i < oi)));
}

__global__ void __launch_bounds__(MAX_THREADS)
sw_rowscan_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
                  int Lq, int Lr, int cols, int match, int mismatch,
                  int gap_open, int gap_extend, int* __restrict__ out_score,
                  int* __restrict__ out_qend, int* __restrict__ out_rend) {
    extern __shared__ int smem[];
    __shared__ int warp_total[32];
    __shared__ int red[3][32];

    const int padded = Lr + (Lr >> 5) + 1;
    int* const Hs = smem;
    int* const Fs = smem + padded;
    int8_t* const Rs = reinterpret_cast<int8_t*>(smem + 2 * padded);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int n_warps = blockDim.x >> 5;
    const int8_t* const qr = q + (size_t)blockIdx.x * Lq;
    const int8_t* const rr = r + (size_t)blockIdx.x * Lr;

    for (int j = tid; j < Lr; j += blockDim.x) {
        Hs[slot(j)] = 0;
        Fs[slot(j)] = NEG;
        Rs[j] = rr[j];
    }
    __syncthreads();

    const int c0 = min(tid * cols, Lr);
    const int c1 = min(c0 + cols, Lr);
    int best = 0, best_i = -1, best_j = INT_MAX;
    for (int i = 0; i < Lq; ++i) {
        const int qc = qr[i];
        // H[i-1][c0-1], read before the owner of column c0-1 rewrites it
        const int diag0 = (c0 > 0 && c0 < c1) ? Hs[slot(c0 - 1)] : 0;

        // pass 1: F, H0 and this run's max of H0[k] + k*gE
        int diag = diag0;
        int run_max = NEG;
        for (int j = c0; j < c1; ++j) {
            const int Hp = Hs[slot(j)];
            const int F = max(Fs[slot(j)] - gap_extend, Hp - gap_open);
            const int H0 =
                max(max(diag + subst(qc, Rs[j], match, mismatch), F), 0);
            Fs[slot(j)] = F;
            run_max = max(run_max, H0 + j * gap_extend);
            diag = Hp;
        }

        // exclusive prefix max of run_max over the threads, in column order
        int incl = run_max;
        for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(FULL, incl, off);
            if (lane >= off) incl = max(incl, o);
        }
        int carry = __shfl_up_sync(FULL, incl, 1);
        if (lane == 0) carry = NEG;
        if (lane == 31) warp_total[warp] = incl;
        __syncthreads();
        int wt = lane < n_warps ? warp_total[lane] : NEG;
        for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(FULL, wt, off);
            if (lane >= off) wt = max(wt, o);
        }
        const int warps_left = __shfl_sync(FULL, wt, max(warp - 1, 0));
        if (warp > 0) carry = max(carry, warps_left);

        // pass 2: E from the running prefix max, H, the best cell
        diag = diag0;
        int P = carry;  // max_{k<j}(H0[k] + k*gE)
        for (int j = c0; j < c1; ++j) {
            const int Hp = Hs[slot(j)];
            const int H0 = max(
                max(diag + subst(qc, Rs[j], match, mismatch), Fs[slot(j)]), 0);
            diag = Hp;
            const int H = max(H0, P - gap_open - (j - 1) * gap_extend);
            P = max(P, H0 + j * gap_extend);
            Hs[slot(j)] = H;
            if (H > 0 && (H > best || (H == best && j < best_j))) {
                best = H;
                best_i = i;
                best_j = j;
            }
        }
        __syncthreads();
    }

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
        red[0][warp] = best;
        red[1][warp] = best_i;
        red[2][warp] = best_j;
    }
    __syncthreads();
    if (warp != 0) return;
    best = lane < n_warps ? red[0][lane] : 0;
    best_i = lane < n_warps ? red[1][lane] : -1;
    best_j = lane < n_warps ? red[2][lane] : INT_MAX;
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
        out_score[blockIdx.x] = none ? 0 : best;
        out_qend[blockIdx.x] = none ? -1 : best_i;
        out_rend[blockIdx.x] = none ? -1 : best_j;
    }
}

}  // namespace

// Dynamic shared memory of one block for a reference of Lr columns: the
// padded H and F rows and the codes.  The wrapper checks it against the
// card's limit with the same formula.
extern "C" int sw_rowscan_smem_bytes(int Lr) {
    return 2 * 4 * (Lr + (Lr >> 5) + 1) + Lr;
}

// Plain C entry point for ctypes.  Launches on ``stream`` and returns the
// first CUDA error (0 on success); allocates nothing.  Needs Lq, Lr >= 1.
extern "C" int sw_rowscan_launch(const void* q, const void* r, int B, int Lq,
                                 int Lr, int match, int mismatch,
                                 int gap_open, int gap_extend, void* score,
                                 void* q_end, void* r_end, void* stream) {
    if (B <= 0) return 0;
    const int threads = min(MAX_THREADS, (Lr + 31) / 32 * 32);
    const int cols = (Lr + threads - 1) / threads;
    const int smem = sw_rowscan_smem_bytes(Lr);
    cudaError_t err = cudaFuncSetAttribute(
        sw_rowscan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sw_rowscan_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(r), Lq, Lr,
        cols, match, mismatch, gap_open, gap_extend, static_cast<int*>(score),
        static_cast<int*>(q_end), static_cast<int*>(r_end));
    return static_cast<int>(cudaGetLastError());
}
