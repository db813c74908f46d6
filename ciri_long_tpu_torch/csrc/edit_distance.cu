// Batched unit-cost edit distance (Levenshtein) for Hopper.
//
// Replaces the XLA device program ciri_long_tpu/ops/edit.py::
// edit_distance_batch_padded (a lax.scan over the rows of a with the
// insertions resolved by a cummin; ROADMAP X7).  Contract: for each pair b,
// out[b] = D(a[b, :alen[b]], b[b, :blen[b]]), equality on codes (N equals N,
// as edit.py:47 and native/alncore.cpp:17 have it); alen 0 gives blen and
// blen 0 gives alen.  Lengths are clamped to [0, La] and [0, Lb], so no
// length makes the kernel read outside its rows.
//
// Recurrence, D[r][c] over rows r of a and columns c of b:
//   D[0][c] = c, D[r][0] = r,
//   D[r][c] = min(D[r-1][c-1] + (a[r-1] != b[c-1]), D[r-1][c] + 1,
//                 D[r][c-1] + 1).
//
// The sweep is the wavefront of csrc/sw_score_ends.cu with min / +1 in place
// of the affine max: one warp per pair; lane t owns row r = 32*s + t + 1 of
// strip s and at step d computes column c = d - t + 1.  The row above comes
// from lane t-1 by __shfl_up_sync, with b's code beside it; lane 0 takes it
// from a handoff row that lane 31 of the previous strip wrote (the border
// D[0][c] = c in strip 0), fetched 32 columns at a time one chunk ahead and
// picked out with __shfl_sync.  The handoff row is one [Lb] int32 row of a
// global scratch per pair (the same one-row argument as sw_score_ends.cu:
// column c is fetched by step c - 32 and overwritten at step c + 31); a pair
// whose a fits one strip (alen <= 32, every pair of collapse's junction
// curation) never touches it.  The scratch has no length limit, so HPC reads
// of any length go through the one design.
//
// Bound: ~5 integer instructions a cell (compare, select, add, min, a DPX
// add-min; csrc/op_rate.cu times that update) over sum(alen * blen) cells
// and 3 shuffles a warp step, against the codes read once and 4 bytes a pair
// written: the kernel is bound by its instructions and, for short pairs, by
// the 31 fill and drain steps of each strip.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL = 0xffffffffu;

// Chunk column ``col`` of the row above and of b's codes, one column per
// lane: the first strip's row above is the border D[0][col + 1] = col + 1.
// ``edge`` is written by the sweep, so it is not declared __restrict__.
__device__ __forceinline__ void load_chunk(const int* edge,
                                           const int8_t* __restrict__ br,
                                           int col, int m, bool first,
                                           int& up, int& code) {
    if (col < m) {
        code = br[col];
        up = first ? col + 1 : edge[col];
    } else {
        code = -1;
        up = 0;
    }
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
edit_distance_kernel(const int8_t* __restrict__ a,
                     const int8_t* __restrict__ b,
                     const int* __restrict__ alen,
                     const int* __restrict__ blen, int B, int La, int Lb,
                     int* edge_rows, int* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    if (row >= B) return;  // whole warps leave together
    const int n = min(max(alen[row], 0), La);
    const int m = min(max(blen[row], 0), Lb);
    if (n == 0 || m == 0) {
        if (lane == 0) out[row] = n + m;
        return;
    }
    const int8_t* ar = a + (size_t)row * La;
    const int8_t* br = b + (size_t)row * Lb;
    int* edge = edge_rows + (size_t)row * Lb;
    const int n_strips = (n + 31) / 32;
    for (int s = 0; s < n_strips; ++s) {
        const int i = s * 32 + lane;          // a[i]: DP row i + 1
        const int ac = i < n ? ar[i] : -2;
        const bool first = s == 0;
        const bool hand_off = lane == 31 && s + 1 < n_strips;
        const bool last_row = i == n - 1;

        int cur_up, nxt_up, cur_code, nxt_code;
        load_chunk(edge, br, lane, m, first, cur_up, cur_code);
        load_chunk(edge, br, 32 + lane, m, first, nxt_up, nxt_code);

        int left = i + 1;        // D[i+1][c-1], the border D[i+1][0] first
        int diag = i;            // D[i][c-1]: lane 0's border; the other
                                 // lanes take theirs from lane t-1
        int out_D = i + 1, out_code = -1;
        const int steps = m + 31;
        for (int d = 0; d < steps; ++d) {
            const int k = d & 31;
            if (k == 0 && d > 0) {
                cur_up = nxt_up;
                cur_code = nxt_code;
                load_chunk(edge, br, d + 32 + lane, m, first, nxt_up,
                           nxt_code);
            }
            const int l0_up = __shfl_sync(FULL, cur_up, k);
            const int l0_code = __shfl_sync(FULL, cur_code, k);
            int up = __shfl_up_sync(FULL, out_D, 1);
            int bc = __shfl_up_sync(FULL, out_code, 1);
            if (lane == 0) {
                up = l0_up;
                bc = l0_code;
            }
            const int j = d - lane;           // b[j]: DP column j + 1
            int D = i + 1;                    // before column 0: the border
            if (j >= 0 && j < m) {
                D = min(diag + (ac != bc), min(up, left) + 1);
                left = D;
                if (hand_off) edge[j] = D;
                if (last_row && j == m - 1) out[row] = D;
            }
            diag = up;
            out_D = D;
            out_code = bc;
        }
        __syncwarp();  // lane 31's handoff row is complete for lane 0
    }
}

}  // namespace

// Plain C entry point for ctypes.  ``edge_rows`` holds B * Lb int32 when
// any alen exceeds 32 (it may be any pointer otherwise).  Launches on
// ``stream``, allocates nothing, and returns cudaGetLastError() (0 on
// success).
extern "C" int edit_distance_launch(const void* a, const void* b,
                                    const void* alen, const void* blen,
                                    int B, int La, int Lb, void* edge_rows,
                                    void* out, void* stream) {
    if (B <= 0) return 0;
    edit_distance_kernel<<<(B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK,
                           WARPS_PER_BLOCK * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<const int*>(alen), static_cast<const int*>(blen), B, La,
        Lb, static_cast<int*>(edge_rows), static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}
