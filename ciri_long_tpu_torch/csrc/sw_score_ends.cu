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
// of one sweep serve every shape (ops/sw.py::_tile_plan picks the route).
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
// The sweep (one warp over one reference row): lane t owns query row
// i = 32*s + t of strip s and the warp sweeps anti-diagonals d across the
// columns: at step d lane t computes column j = d - t.  H and E of the row
// stay in registers; H, F and the reference code of the row above come from
// lane t-1 by __shfl_up_sync.  Lane 0 takes the row above from an int2
// (H, F) handoff row written by lane 31 of the previous strip; the warp
// fetches that row and the reference codes 32 columns at a time, one chunk
// ahead, and lane 0 picks its value out with __shfl_sync, so no step waits
// on memory.  One row suffices: column c is fetched by step c - 32 and
// consumed (every lane's chunk value enters a full-warp shuffle) by step c,
// while lane 31 overwrites it at step c + 31.
//
// Route 1, the wavefront (sw_score_ends_kernel): one warp per batch row
// over all Lr columns, the handoff row in a global [B, Lr] int2 scratch.
// A 64-row launch gives the card 64 warps, each ~Lr serial steps.
//
// Route 2, reference tiles (sw_tile_kernel + sw_tile_merge_kernel), for a
// short query against a long reference: one warp per (row, tile).  Tile k
// owns columns [k*T, min((k+1)*T, Lr)) and sweeps from max(0, k*T - halo)
// with the usual zero border, halo = Lq + floor(Lq*match/gE) + 1.  A
// positive local alignment covers at most Lq diagonal steps and fewer than
// Lq*match/gE gap columns (each costs >= gE, since gO >= gE, and the matches
// bring at most Lq*match), so the optimum ending in an owned column lies
// whole inside the tile and the tile's H there is exact; elsewhere a tile's
// H never exceeds the true H (its border is 0 <= H, NEG <= E).  So each
// tile may report its best over all its columns, and the best record under
// the contract's order is the answer.  The handoff row lives in dynamic
// shared memory, (T + halo) int2 per warp, and only for queries of more
// than one strip.  The merge runs one warp per row over the [B, n_tiles]
// records.
//
// Bound: the DP is latency- and integer-ALU-bound: O(B*Lq*Lr) cell updates
// of at least 7 integer instructions (csrc/op_rate.cu) and 6 shuffles per
// warp step, against O(B*(Lq+Lr)) bytes of codes.  The wavefront's
// parallelism is one warp per row; the tiles give B*ceil(Lr/T) warps of
// (T + halo + 31) steps a strip, for a halo overhead of halo/T columns.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int WARPS_PER_BLOCK = 4;
constexpr int MAX_SMEM = 232448;  // shared memory a Hopper block may have
constexpr unsigned FULL = 0xffffffffu;

// Chunk c of the row above (H, F) and of the reference codes, one column per
// lane.  Columns past W read as the empty border (H 0, F NEG, code PAD).
// ``edge`` is written by the sweep, so it is not declared __restrict__: no
// read-only cache path may serve it.
__device__ __forceinline__ void load_chunk(const int2* edge,
                                           const int8_t* __restrict__ ref,
                                           int col, int W, bool first,
                                           int2& up, int& code) {
    if (col < W) {
        code = ref[col];
        up = first ? make_int2(0, NEG) : edge[col];
    } else {
        code = 5;
        up = make_int2(0, NEG);
    }
}

// (score, i, j) ordered as the contract orders the best cell: higher score,
// then smaller j, then smaller i.
__device__ __forceinline__ bool before(int s, int i, int j, int bs, int bi,
                                       int bj) {
    return s > bs || (s == bs && (j < bj || (j == bj && i < bi)));
}

// One warp sweeps query qr [Lq] against reference columns rr [0, W), the
// handoff row ``edge`` (W int2) between strips.  Returns in lane 0 the best
// positive cell (score, i, j) with j local to rr, or (0, -1, INT_MAX).
__device__ __forceinline__ void sweep(const int8_t* __restrict__ qr, int Lq,
                                      const int8_t* __restrict__ rr, int W,
                                      int match, int mismatch, int gap_open,
                                      int gap_extend, int2* edge, int& best,
                                      int& best_i, int& best_j) {
    const int lane = threadIdx.x & 31;
    best = 0;
    best_i = -1;
    best_j = INT_MAX;
    const int n_strips = (Lq + 31) / 32;
    for (int s = 0; s < n_strips; ++s) {
        const int i = s * 32 + lane;
        const bool row_ok = i < Lq;
        const int qc = row_ok ? qr[i] : 5;
        const bool first = s == 0;
        const bool hand_off = lane == 31 && s + 1 < n_strips;
        // this strip's best: j rises along the sweep, so the first cell at
        // the strip's maximum has its smallest j; rows past Lq never win
        int s_best = row_ok ? 0 : INT_MAX, s_j = INT_MAX;

        int2 cur_up, nxt_up;
        int cur_code, nxt_code;
        load_chunk(edge, rr, lane, W, first, cur_up, cur_code);
        load_chunk(edge, rr, 32 + lane, W, first, nxt_up, nxt_code);

        int H_left = 0, E_left = NEG;         // H[i][j-1], E[i][j-1]
        int out_H = 0, out_F = NEG, out_code = 5;  // this lane's last cell
        int diag = 0;                         // H[i-1][j-1]
        const int steps = W + 31;
        for (int d = 0; d < steps; ++d) {
            const int m = d & 31;
            if (m == 0 && d > 0) {
                cur_up = nxt_up;
                cur_code = nxt_code;
                load_chunk(edge, rr, d + 32 + lane, W, first, nxt_up,
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
            if (j >= 0 && j < W) {
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
                if (H > s_best) {
                    s_best = H;
                    s_j = j;
                }
                if (hand_off) edge[j] = make_int2(H, F);
            }
            diag = up_H;
            out_H = H;
            out_F = F;
            out_code = rc;
        }
        if (row_ok && s_best > 0 &&
            before(s_best, i, s_j, best, best_i, best_j)) {
            best = s_best;
            best_i = i;
            best_j = s_j;
        }
        __syncwarp();  // lane 31's handoff row is complete for lane 0
    }

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

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sw_score_ends_kernel(const int8_t* __restrict__ q,
                     const int8_t* __restrict__ r, int B, int Lq, int Lr,
                     int match, int mismatch, int gap_open, int gap_extend,
                     int2* __restrict__ scratch, int* __restrict__ out_score,
                     int* __restrict__ out_qend, int* __restrict__ out_rend) {
    const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= B) return;  // whole warps leave together
    int best, best_i, best_j;
    sweep(q + (size_t)row * Lq, Lq, r + (size_t)row * Lr, Lr, match,
          mismatch, gap_open, gap_extend, scratch + (size_t)row * Lr, best,
          best_i, best_j);
    if ((threadIdx.x & 31) == 0)
        write_ends(row, best, best_i, best_j, out_score, out_qend, out_rend);
}

// One warp per (row, tile); ``edge_cols`` int2 of dynamic shared memory per
// warp (0 for a one-strip query).  Writes records[row][tile] = (score, i, j)
// with j global, (0, -1, INT_MAX) when the tile has no positive cell.
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sw_tile_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
               int B, int Lq, int Lr, int match, int mismatch, int gap_open,
               int gap_extend, int T, int halo, int n_tiles, int edge_cols,
               int3* __restrict__ records) {
    extern __shared__ int2 edges[];
    const int warp = threadIdx.x >> 5;
    const int w = blockIdx.x * (blockDim.x >> 5) + warp;  // B*n_tiles < 2^31
    if (w >= B * n_tiles) return;  // whole warps leave together
    const int row = w / n_tiles;
    const int tile = w - row * n_tiles;
    const int start = max(0, tile * T - halo);
    const int end = min(tile * T + T, Lr);
    int best, best_i, best_j;
    sweep(q + (size_t)row * Lq, Lq, r + (size_t)row * Lr + start,
          end - start, match, mismatch, gap_open, gap_extend,
          edges + warp * edge_cols, best, best_i, best_j);
    if ((threadIdx.x & 31) == 0)
        records[w] = best > 0 ? make_int3(best, best_i, start + best_j)
                              : make_int3(0, -1, INT_MAX);
}

// One warp per row: the best of its n_tiles records, in the contract's order.
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
sw_tile_merge_kernel(const int3* __restrict__ records, int B, int n_tiles,
                     int* __restrict__ out_score, int* __restrict__ out_qend,
                     int* __restrict__ out_rend) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
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
    if (lane == 0)
        write_ends(row, best, best_i, best_j, out_score, out_qend, out_rend);
}

int blocks_for(int warps, int per_block) {
    return (warps + per_block - 1) / per_block;
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on ``stream`` and returns
// cudaGetLastError() (0 on success); neither allocates.

// The wavefront.  ``scratch`` holds B * Lr int2 (H, F) values.
extern "C" int sw_score_ends_launch(const void* q, const void* r, int B,
                                    int Lq, int Lr, int match, int mismatch,
                                    int gap_open, int gap_extend,
                                    void* scratch, void* score, void* q_end,
                                    void* r_end, void* stream) {
    if (B <= 0) return 0;
    sw_score_ends_kernel<<<blocks_for(B, WARPS_PER_BLOCK),
                           WARPS_PER_BLOCK * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(r), B, Lq,
        Lr, match, mismatch, gap_open, gap_extend,
        static_cast<int2*>(scratch), static_cast<int*>(score),
        static_cast<int*>(q_end), static_cast<int*>(r_end));
    return static_cast<int>(cudaGetLastError());
}

// Tiles of T owned columns swept from halo columns before them.
// ``records`` holds B * ceil(Lr / T) int3.  Returns cudaErrorInvalidValue
// when one warp's handoff row does not fit a block's shared memory, or
// when there are 2^31 (row, tile) warps or more.
extern "C" int sw_tiles_launch(const void* q, const void* r, int B, int Lq,
                               int Lr, int match, int mismatch, int gap_open,
                               int gap_extend, int T, int halo,
                               void* records, void* score, void* q_end,
                               void* r_end, void* stream) {
    if (B <= 0) return 0;
    if (T <= 0 || halo < 0 || Lr <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int n_tiles = (Lr + T - 1) / T;
    if ((long long)B * n_tiles > INT_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int edge_cols = Lq > 32 ? T + halo : 0;
    const long long warp_bytes = (long long)edge_cols * sizeof(int2);
    if (warp_bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    int warps = WARPS_PER_BLOCK;
    if (warp_bytes * warps > MAX_SMEM) warps = (int)(MAX_SMEM / warp_bytes);
    const int smem = (int)(warp_bytes * warps);
    static int smem_opted = 48 * 1024;  // the default a block may have
    if (smem > smem_opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            sw_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            MAX_SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        smem_opted = MAX_SMEM;
    }
    sw_tile_kernel<<<blocks_for(B * n_tiles, warps), warps * 32,
                     smem, st>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(r), B, Lq,
        Lr, match, mismatch, gap_open, gap_extend, T, halo, n_tiles,
        edge_cols, static_cast<int3*>(records));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sw_tile_merge_kernel<<<blocks_for(B, WARPS_PER_BLOCK),
                           WARPS_PER_BLOCK * 32, 0, st>>>(
        static_cast<const int3*>(records), B, n_tiles,
        static_cast<int*>(score), static_cast<int*>(q_end),
        static_cast<int*>(r_end));
    return static_cast<int>(cudaGetLastError());
}
