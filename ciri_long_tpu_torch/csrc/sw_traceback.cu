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
// Design: one block per job, K warps (K = ceil(m / 32) up to MAX_WARPS for
// the launch).  Warp k owns reference rows j = 32k..32k+31 (strip k) and
// sweeps anti-diagonals across the query: at its step d lane t computes
// column i = d - t.  F and H of the cell to the left stay in registers;
// (H, E) of the row above come from lane t-1 by __shfl_up_sync, the query
// code from global memory (the block's warps read the same row, so L1
// serves it), and the lane's score against that code from a [6 codes]
// [threads] table in shared memory built from its reference code.  Lane 0
// takes (H, E) of the row above from lane 31 of warp k-1 through a ring of
// RING columns in shared memory, indexed by column.
// The warps step through 32-step chunks in lockstep, one __syncthreads a
// chunk, warp k two chunks behind warp k-1: its chunk c needs the columns
// warp k-1 finished in its chunks c and c+1, and the columns written in the
// same chunk lie 2..64 ahead of the ones read, so a ring of 128 never hands
// out a slot before it has been read.  The critical path is n + 31 + 64(K-1)
// steps instead of ceil(m / 32) * (n + 31).  A job with more strips than the
// block has warps sweeps them in groups of K; warp 0 of the next group
// takes (H, E) from a handoff row of global scratch that lane 31 of warp
// K-1 wrote (one [W] int2 row a job; fetched 32 columns at a time one chunk
// ahead, as csrc/sw_score_ends.cu does).  A chunk's 32 steps have no
// branch, so the compiler unrolls them and overlaps one step's direction
// byte with the next step's recurrence; only the chunks at a strip's ends,
// where some lane's column lies outside [0, n), mask their cells.  With one
// warp a scheduler (200 jobs of two warps fill 400 of the card's 528), a
// step's time is the latency of one warp's instructions, not throughput.
//
// Every step a warp stores its 32 code bytes next to each other, laid out
// (strip, step, lane), a strip's n + 31 steps rounded up to whole 32-step
// chunks: ceil(m / 32) * ceil((n + 31) / 32) * 1024 bytes a job.  Two routes
// (the wrapper's plan, ops/sw_tb_batch.py::tb_plan, picks per job):
//   smem    the job's bytes fit a block's dynamic shared memory (every
//           collapse job: 100 KB at n 1552, m 50, two blocks a SM): the
//           direction bytes never reach HBM;
//   global  they do not: the same layout in global scratch at the job's
//           offset.
// After the sweep the warps' bests are reduced in (score, j, i) order and
// thread 0 walks the path, merging runs as it goes: the ops path is written
// as (length, op) runs, host ops 0 M, 1 I, 2 D, from the end of the job's
// row backwards.
//
// Bound: the sweep's cell update (the SW update plus the code's compares
// and its byte; csrc/op_rate.cu times it) over sum(n * m) cells, against
// the codes read once and the outputs written once (and on the global route
// the direction bytes written once); the walk is one dependent shared (or
// global) load a path step by one thread, ~m steps for a junction window.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int MAX_WARPS = 8;
constexpr int RING = 128;                // ring columns between two warps
constexpr int MAX_SMEM = 232448 - 8192;  // opt-in dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;
constexpr int STOP = 0, CM = 1, CE = 2, CF = 3;

// Chunk column ``col`` of the handoff row (H, E); the border past n.
// ``edge`` is written by the sweep, so it is not declared __restrict__.
__device__ __forceinline__ int2 load_edge(const int2* edge, int col, int n) {
    return col < n ? edge[col] : make_int2(0, NEG);
}

// (score, j, i) in the order of the end cell: higher score, then smaller
// reference end j, then smaller query end i.
__device__ __forceinline__ bool before(int s, int j, int i, int bs, int bj,
                                       int bi) {
    return s > bs || (s == bs && (j < bj || (j == bj && i < bi)));
}

template <bool SMEM>
__global__ void __launch_bounds__(MAX_WARPS * 32)
sw_traceback_kernel(const int8_t* __restrict__ q,
                    const int8_t* __restrict__ r,
                    const int* __restrict__ ns, const int* __restrict__ ms,
                    const int* __restrict__ jobs, int W, int M, int match,
                    int mismatch, int gap_open, int gap_extend,
                    const long long* __restrict__ code_off,
                    uint8_t* codes_all, int2* edge_rows, int cap,
                    int2* __restrict__ runs_all, int* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int red_s[MAX_WARPS], red_j[MAX_WARPS], red_i[MAX_WARPS];
    __shared__ int sc_tab[6 * MAX_WARPS * 32];  // [query code][thread]
    const int K = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int job = jobs[blockIdx.x];
    const int n = min(max(ns[job], 0), W);
    const int m = min(max(ms[job], 0), M);
    int* o = out + (size_t)job * 6;
    if (n == 0 || m == 0) {              // the whole block leaves
        if (threadIdx.x == 0) {
            o[0] = 0;
            o[1] = o[2] = o[3] = o[4] = -1;
            o[5] = 0;
        }
        return;
    }
    const int8_t* qr = q + (size_t)job * W;
    const int8_t* rr = r + (size_t)job * M;
    int2* ring = reinterpret_cast<int2*>(smem);
    uint8_t* codes = SMEM ? smem + (size_t)(K - 1) * RING * sizeof(int2)
                          : codes_all + code_off[blockIdx.x];
    int2* edge = edge_rows + (size_t)blockIdx.x * W;
    const int strips = (m + 31) >> 5;
    const int groups = (strips + K - 1) / K;
    const int chunks = (n + 31 + 31) >> 5;  // a strip's n + 31 steps
    const int steps = chunks * 32;          // its direction bytes' stride
    const int2* ring_in = ring + (warp - 1) * RING;   // used by warp >= 1
    int2* ring_out = ring + warp * RING;              // used by warp < K-1

    int best = 0, best_j = INT_MAX, best_i = INT_MAX;
    for (int g = 0; g < groups; ++g) {
        const int s = g * K + warp;      // this warp's strip
        const bool live = s < strips;
        const int j = s * 32 + lane;
        const bool row_ok = j < m;
        const int rc = row_ok ? rr[j] : 5;
        const bool from_edge = warp == 0 && g > 0;
        const bool to_ring = lane == 31 && warp + 1 < K && s + 1 < strips;
        const bool to_edge = lane == 31 && warp + 1 == K && s + 1 < strips;
        // this row's best: i rises along the sweep, so strict > keeps the
        // smallest i at the row's maximum
        int s_best = 0, s_i = INT_MAX;
        int H_left = 0, F_left = NEG;    // H[i-1][j], F[i-1][j]
        int out_H = 0, out_E = NEG;      // handed to lane t+1
        int diag = 0;                    // H[i-1][j-1]
        int2 cur_up = make_int2(0, NEG), nxt_up = cur_up;
        if (from_edge) {
            cur_up = load_edge(edge, lane, n);
            nxt_up = load_edge(edge, 32 + lane, n);
        }
        uint8_t* strip_codes = codes + (size_t)s * steps * 32 + lane;
        // this lane's score against each query code 0..5 (5: PAD, and any
        // code past it or below 0, scores NEG)
        int* sc_col = sc_tab + threadIdx.x;
#pragma unroll
        for (int qc = 0; qc < 6; ++qc)
            sc_col[qc * MAX_WARPS * 32] =
                qc >= 5 || rc >= 5 ? NEG
                : qc == 4 || rc == 4 ? 0
                : qc == rc ? match : -mismatch;
        __syncwarp();

        // One step d of the sweep: lane t computes cell (i, j), i = d - t.
        // MASKED: some lane's i lies outside [0, n), where the cell is the
        // border (H 0, E NEG, code 0) and the row's state stays.
        auto step = [&](int d, int k, uint8_t* chunk_codes, auto masked) {
            constexpr bool MASKED = decltype(masked)::value;
            const int i = d - lane;
            const bool cell = !MASKED || (unsigned)i < (unsigned)n;
            const int sc = sc_col[min((unsigned)(cell ? qr[i] : 5), 5u) *
                                  (MAX_WARPS * 32)];
            int up_H = __shfl_up_sync(FULL, out_H, 1);
            int up_E = __shfl_up_sync(FULL, out_E, 1);
            // lane 0's row above: the group's handoff row, the ring from
            // warp k-1, or the border (warp-uniform)
            int top_H = 0, top_E = NEG;
            if (from_edge) {
                top_H = __shfl_sync(FULL, cur_up.x, k);
                top_E = __shfl_sync(FULL, cur_up.y, k);
            } else if (warp > 0) {
                const int2 v = ring_in[d & (RING - 1)];
                top_H = v.x;
                top_E = v.y;
            }
            if (lane == 0) {
                up_H = top_H;
                up_E = top_E;
            }
            const int dv = diag + sc;
            const int F = max(F_left - gap_extend, H_left - gap_open);
            int E = max(up_E - gap_extend, up_H - gap_open);
            int H = max(max(dv, E), max(F, 0));
            const int cs = H == 0 ? STOP
                         : H == dv ? CM
                         : H == E ? CE
                         : H == F ? CF : STOP;
            const bool estay = j > 0 && E == up_E - gap_extend &&
                               E != up_H - gap_open;
            const bool fstay = i > 0 && F == F_left - gap_extend &&
                               F != H_left - gap_open;
            int code = cs | (estay << 2) | (fstay << 3);
            if (MASKED) {
                code = cell ? code : 0;
                H = cell ? H : 0;
                E = cell ? E : NEG;
            }
            if (cell && row_ok && H > s_best) {
                s_best = H;
                s_i = i;
            }
            if (cell) {
                H_left = H;
                F_left = F;
            }
            if (cell && to_ring) ring_out[i & (RING - 1)] = make_int2(H, E);
            if (cell && to_edge) edge[i] = make_int2(H, E);
            chunk_codes[k * 32] = (uint8_t)code;
            diag = up_H;
            out_H = H;
            out_E = E;
        };

        const int iters = chunks + 2 * (K - 1);
        for (int it = 0; it < iters; ++it) {
            const int c = it - 2 * warp;  // this warp's chunk
            if (live && c >= 0 && c < chunks) {
                if (from_edge && c > 0) {
                    cur_up = nxt_up;
                    nxt_up = load_edge(edge, c * 32 + 32 + lane, n);
                }
                uint8_t* chunk_codes = strip_codes + (size_t)c * 32 * 32;
                // a fixed 32 steps with no branch in them, so the compiler
                // unrolls them and overlaps one step's code byte with the
                // next step's recurrence; in the chunks where every lane's
                // column lies in [0, n) no mask is needed
                if (c * 32 >= 31 && c * 32 + 31 < n) {
#pragma unroll 8
                    for (int k = 0; k < 32; ++k)
                        step(c * 32 + k, k, chunk_codes, std::false_type{});
                } else {
#pragma unroll 8
                    for (int k = 0; k < 32; ++k)
                        step(c * 32 + k, k, chunk_codes, std::true_type{});
                }
            }
            __syncthreads();  // the ring's columns of this chunk are written
        }
        if (s_best > 0 && before(s_best, j, s_i, best, best_j, best_i)) {
            best = s_best;
            best_j = j;
            best_i = s_i;
        }
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
    if (lane == 0) {
        red_s[warp] = best;
        red_j[warp] = best_j;
        red_i[warp] = best_i;
    }
    __syncthreads();  // the bests, and every direction byte, are written
    if (threadIdx.x != 0) return;
    for (int w = 1; w < K; ++w) {
        if (before(red_s[w], red_j[w], red_i[w], best, best_j, best_i)) {
            best = red_s[w];
            best_j = red_j[w];
            best_i = red_i[w];
        }
    }
    if (best <= 0) {
        o[0] = 0;
        o[1] = o[2] = o[3] = o[4] = -1;
        o[5] = 0;
        return;
    }
    // the host state machine; (i, j) are host indices, 1-based cells; the
    // ops (0 M, 1 I, 2 D) merge into runs written from the row's end
    int2* runs = runs_all + (size_t)job * cap;
    int i = best_i + 1, j = best_j + 1, state = 0, cnt = 0;
    int run_op = -1, run_len = 0;
    while (i > 0 && j > 0) {
        const int jj = j - 1, t = jj & 31;
        const int c = codes[((size_t)(jj >> 5) * steps + (i - 1 + t)) * 32 + t];
        int op;
        if (state == 0) {
            const int cs = c & 3;
            if (cs == STOP) break;
            if (cs != CM) {
                state = cs == CE ? 1 : 2;
                continue;
            }
            op = 0;
            --i;
            --j;
        } else if (state == 1) {          // E: a reference base, D
            op = 2;
            if (!((c >> 2) & 1)) state = 0;
            --j;
        } else {                          // F: a query base, I
            op = 1;
            if (!((c >> 3) & 1)) state = 0;
            --i;
        }
        if (op == run_op) {
            ++run_len;
        } else {
            if (run_len) runs[cap - 1 - cnt++] = make_int2(run_len, run_op);
            run_op = op;
            run_len = 1;
        }
    }
    if (run_len) runs[cap - 1 - cnt++] = make_int2(run_len, run_op);
    o[0] = best;
    o[1] = i;
    o[2] = best_i;
    o[3] = j;
    o[4] = best_j;
    o[5] = cnt;
}

}  // namespace

// Plain C entry point for ctypes: one launch of one route over the
// ``n_jobs`` jobs listed in ``jobs`` (int32), ``warps`` warps a block
// (1..MAX_WARPS).  ``smem`` route (non-zero): ``smem_bytes`` of dynamic
// shared memory a block, the rings and the largest job's direction bytes;
// global route: ``codes`` holds each listed job's direction bytes at
// ``code_off`` (int64, by list position), ceil(m / 32) * ceil((n + 31) /
// 32) * 1024 bytes a job, and ``smem_bytes`` covers the rings.
// ``edge_rows`` holds n_jobs * W int2 when a job has more strips than
// ``warps`` (any pointer otherwise); ``runs`` is [B, cap] int2 with cap >=
// max n + max m; ``out``
// is [B, 6] int32 (score, q_begin, q_end, r_begin, r_end, run count).
// Launches on ``stream``, allocates nothing, and returns cudaGetLastError()
// (0 on success).
extern "C" int sw_traceback_launch(const void* q, const void* r,
                                   const void* ns, const void* ms,
                                   const void* jobs, int n_jobs, int warps,
                                   int smem, int smem_bytes, int W, int M,
                                   int match, int mismatch, int gap_open,
                                   int gap_extend, const void* code_off,
                                   void* codes, void* edge_rows, int cap,
                                   void* runs, void* out, void* stream) {
    if (n_jobs <= 0) return 0;
    if (warps < 1 || warps > MAX_WARPS || smem_bytes < 0 ||
        smem_bytes > MAX_SMEM)
        return static_cast<int>(cudaErrorInvalidValue);
    auto kernel =
        smem ? sw_traceback_kernel<true> : sw_traceback_kernel<false>;
    // each route opts in once: the 48 KB default counts the static bests too
    static bool opted[2] = {false, false};
    if (!opted[smem != 0]) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted[smem != 0] = true;
    }
    kernel<<<n_jobs, warps * 32, smem_bytes,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(r),
        static_cast<const int*>(ns), static_cast<const int*>(ms),
        static_cast<const int*>(jobs), W, M, match, mismatch, gap_open,
        gap_extend, static_cast<const long long*>(code_off),
        static_cast<uint8_t*>(codes), static_cast<int2*>(edge_rows), cap,
        static_cast<int2*>(runs), static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}
