// Batched banded global alignment (NW) with traceback for Hopper.
//
// Replaces the XLA device program ciri_long_tpu/ops/nw_tb_batch.py::
// _build_kernel (forward :67, walk :177; ROADMAP X4): per pair (q, r) of
// int8 codes, the banded global affine alignment of ALL of q (n codes) to
// ALL of r (m codes) that native/nwcore.cpp::nw_banded_core computes, with
// match / -mismatch over codes 0..3, 0 against N (4) and NEG against PAD
// (>= 5), gaps of length L costing gap_open + (L - 1) * gap_extend.
//
// Band coordinates: row i, column c = j - i - lo, c in [0, W), W = hi - lo +
// 1, with lo = min(0, m - n) - band and hi = max(0, m - n) + band.  A cell
// outside the band or outside [0, m] holds NEG = -(1 << 28), and NEG is not
// clamped when a gap is subtracted from it.  The recurrences are JAX's
// (nw_tb_batch.py:79-140), value for value:
//   F    = max(F[i-1][c+1] - gE, H[i-1][c+1] - gO)
//   Ht   = max(H[i-1][c] + s(q[i-1], r[j-1]), F)      (NEG off the band)
//   E    = max over c' < c of Ht[c'] - gO - (c - c' - 1) gE, by the
//          prefix-max identity (exact for gO >= gE), from the values
//          g[c'] = Ht[c'] + gE c' of the cells with Ht > NEG / 2
//   H    = max(Ht, E)
// and the edge cell j == 0 (when the band reaches it) holds H = F = -gO -
// (i - 1) gE, E = NEG; row 0 holds H = E = -gO - (j - 1) gE for j >= 1.
//
// Traceback codes, one byte a cell (nw_tb_batch.py:146-161): bits 0-1 the
// case at H, E first (H == E, j > 0), then F (H == F), then the diagonal
// (3); bit 2 the E-stay flag (j > 1, E == E[c-1] - gE, E[c-1] > NEG / 2),
// bit 3 the F-stay flag (i > 1, F == F[i-1][c+1] - gE, F[i-1][c+1] > NEG /
// 2); 0 outside the band.  The walk is JAX's three-state machine (H, E, F)
// from (n, m) to (0, 0): it emits M (0), I (1, consumes q) and D (2,
// consumes r) and merges them into runs of length << 4 | op, the entries
// of native/nwcore.cpp's Cigar, written backwards from the end of the
// pair's run buffer (n + m entries: a path has at most n + m steps).
//
// Design: one warp a pair and pass.  Warp 2p runs pair p's traceback pass
// at (lo, hi) and writes its (n + 1) x W code plane to global memory; warp
// 2p + 1 runs its check pass at (lo2, hi2), the doubled band, and keeps
// only the score at (n, m).  A lane owns ceil(W / 32) neighbouring columns.
// A row is three sweeps over the lane's columns: F and Ht from the row
// above, then E from the lane's carry of the prefix max (a warp scan of the
// lanes' maxima, five shuffles), then the codes, which need E of the column
// to the left.  The rows live in shared memory, five int rows a warp (H and
// F of the row above and of this row, E of this row), or, when a launch's
// widest band does not fit a block's shared memory, in global scratch at
// the warp's slot.  After the last row lane 0 walks the plane (one dependent
// global load a step, ~n + m steps).  The host plan (ops/nw_tb_batch.py::
// nw_plan) groups pairs under a byte budget for the planes and picks the
// warps a block and the row placement.
//
// Bound: a cell of either pass is the NW row update and, in the traceback
// pass, its code (csrc/op_rate.cu kind 6 times it), against the codes read
// once and the planes and outputs written once.  A row's sweeps are serial
// within the warp and W is ~33-200 at call's units, so a warp's step
// latency, not the card's issue rate, bounds a launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int HALF_NEG = NEG / 2;        // Python's NEG // 2 (exact)
constexpr int MAX_WARPS = 8;
constexpr int ROW_INTS = 5;              // Hp, Fp, Hn, Fn, En a warp
constexpr int MAX_SMEM = 232448 - 8192;  // opt-in dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int sub_score(int a, int b, int match,
                                         int mismatch) {
    if (a >= 5 || b >= 5) return NEG;
    if (a == 4 || b == 4) return 0;
    return a == b ? match : -mismatch;
}

// One pass of one pair on one warp: the DP over rows 1..n in band (lo, hi);
// with CODES each row's code bytes go to plane[i * W + c].  Returns the
// score at (n, m) on every lane.
template <bool CODES>
__device__ int nw_pass(const int8_t* __restrict__ q,
                       const int8_t* __restrict__ r, int n, int m, int lo,
                       int hi, int* rows, int wcap, int match, int mismatch,
                       int go, int ge, uint8_t* __restrict__ plane,
                       int lane) {
    const int W = hi - lo + 1;
    const int C = (W + 31) >> 5;
    const int c0 = lane * C;
    const int c1 = min(W, c0 + C);
    int* Hp = rows;
    int* Fp = rows + wcap;
    int* Hn = rows + 2 * wcap;
    int* Fn = rows + 3 * wcap;
    int* En = rows + 4 * wcap;

    // row 0: H = E = -gO - (j - 1) gE for 1 <= j <= m, H(0, 0) = 0
    for (int c = c0; c < c1; ++c) {
        const int j = c + lo;
        const bool ok = j >= 0 && j <= m;
        const int h = ok ? (j == 0 ? 0 : -go - (j - 1) * ge) : NEG;
        Hp[c] = h;
        Fp[c] = NEG;
        if (CODES) {
            const int jl = j - 1;
            const int el = (c >= 1 && jl >= 1 && jl <= m)
                               ? -go - (jl - 1) * ge : NEG;
            const bool stay = j > 1 && c >= 1 && h == el - ge;
            plane[c] = (ok && j >= 1) ? (uint8_t)(1 | (stay << 2)) : 0;
        }
    }
    __syncwarp();

    const int c_nm = m - n - lo;
    int score = NEG;
    for (int i = 1; i <= n; ++i) {
        const int jlo = max(0, i + lo);
        const int jhi = min(m, i + hi);
        const int jmin = max(1, jlo);
        const int base = i + lo;                 // j = c + base
        const int qi = q[i - 1];
        const int edge = -go - (i - 1) * ge;

        // sweep 1: F and Ht from the row above; the lane's max of g
        int agg = NEG;
        for (int c = c0; c < c1; ++c) {
            const int j = c + base;
            const bool valid = j >= jmin && j <= jhi;
            const bool is_j0 = j == 0 && jlo == 0;
            const int rj = (j >= 1 && j <= m) ? r[j - 1] : 5;
            const int d = Hp[c] + sub_score(qi, rj, match, mismatch);
            const int hup = c + 1 < W ? Hp[c + 1] : NEG;
            const int fup = c + 1 < W ? Fp[c + 1] : NEG;
            int f = max(fup - ge, hup - go);
            int ht = max(d, f);
            ht = valid ? ht : NEG;
            ht = is_j0 ? edge : ht;
            f = valid ? f : NEG;
            f = is_j0 ? edge : f;
            Hn[c] = ht;
            Fn[c] = f;
            agg = max(agg, ht > HALF_NEG ? ht + ge * c : NEG);
        }
        // the lanes' exclusive prefix max: the carry into the lane's first
        // column
        int incl = agg;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl = max(incl, v);
        }
        int run = __shfl_up_sync(FULL, incl, 1);
        if (lane == 0) run = NEG;

        // sweep 2: E by the prefix max, then H
        for (int c = c0; c < c1; ++c) {
            const int j = c + base;
            const bool valid = j >= jmin && j <= jhi;
            const bool is_j0 = j == 0 && jlo == 0;
            const int ht = Hn[c];
            int e = run > HALF_NEG ? run - go - (c - 1) * ge : NEG;
            run = max(run, ht > HALF_NEG ? ht + ge * c : NEG);
            e = valid ? e : NEG;
            int h = max(ht, e);
            h = is_j0 ? edge : h;
            h = (valid || is_j0) ? h : NEG;
            e = is_j0 ? NEG : e;
            Hn[c] = h;
            En[c] = e;
        }
        __syncwarp();

        // sweep 3: the codes (E of the column to the left, F of the row
        // above)
        if (CODES) {
            uint8_t* row = plane + (size_t)i * W;
            for (int c = c0; c < c1; ++c) {
                const int j = c + base;
                const bool in_cell = (j >= jmin && j <= jhi) ||
                                     (j == 0 && jlo == 0);
                const int h = Hn[c];
                const int e = En[c];
                const int f = Fn[c];
                const int cs = (h == e && j > 0 && in_cell) ? 1
                             : (h == f && in_cell) ? 2 : 3;
                const int el = c >= 1 ? En[c - 1] : NEG;
                const bool es = j > 1 && c >= 1 && e == el - ge &&
                                el > HALF_NEG;
                const int fup = c + 1 < W ? Fp[c + 1] : NEG;
                const bool fs = i > 1 && c <= W - 2 && f == fup - ge &&
                                fup > HALF_NEG;
                row[c] = in_cell ? (uint8_t)(cs | (es << 2) | (fs << 3)) : 0;
            }
        }
        if (i == n && c_nm >= c0 && c_nm < c1) score = Hn[c_nm];
        int* t = Hp; Hp = Hn; Hn = t;
        t = Fp; Fp = Fn; Fn = t;
        __syncwarp();
    }
    return __shfl_sync(FULL, score, c_nm / C);
}

// Lane 0's walk of a traceback plane; returns the runs written backwards
// before ``end``, or -1 when the plane leads off the band or to a cell
// without a case.
__device__ int nw_walk(const uint8_t* __restrict__ plane, int W, int n,
                       int m, int lo, unsigned* end) {
    int i = n, j = m, state = 0, cur = -1, len = 0, cnt = 0;
    while (i > 0 || j > 0) {
        const int c = j - i - lo;
        if (i < 0 || j < 0 || c < 0 || c >= W) return -1;
        const int code = plane[(size_t)i * W + c];
        int op;
        if (state == 0) {
            const int cs = code & 3;
            if (cs == 1) { state = 1; continue; }
            if (cs == 2) { state = 2; continue; }
            if (cs == 0) return -1;
            op = 0; --i; --j;
        } else if (state == 1) {
            op = 2;
            state = (code >> 2) & 1;
            --j;
        } else {
            op = 1;
            state = (code >> 3) & 1 ? 2 : 0;
            --i;
        }
        if (op == cur) {
            ++len;
        } else {
            if (len) end[-1 - cnt++] = ((unsigned)len << 4) | (unsigned)cur;
            cur = op;
            len = 1;
        }
    }
    if (len) end[-1 - cnt++] = ((unsigned)len << 4) | (unsigned)cur;
    return cnt;
}

// geom [B, 6] int32: n, m, lo, hi, lo2, hi2; offs [B, 4] int64: q offset,
// r offset, plane offset, run offset.  out [B, 3] int32: the traceback
// pass's score, the check pass's score, the run count (-1 on a bad plane).
__global__ void nw_traceback_kernel(const int8_t* __restrict__ q,
                                    const int8_t* __restrict__ r,
                                    const int* __restrict__ geom,
                                    const long long* __restrict__ offs,
                                    int n_pairs, int wcap, int* rows_global,
                                    int match, int mismatch, int go, int ge,
                                    uint8_t* planes, unsigned* runs,
                                    int* out) {
    extern __shared__ int smem[];
    const int wid = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + wid;
    if (w >= 2LL * n_pairs) return;
    const int p = (int)(w >> 1);
    const bool tb = (w & 1) == 0;
    int* rows = rows_global ? rows_global + w * ROW_INTS * wcap
                            : smem + wid * ROW_INTS * wcap;
    const int* g = geom + 6 * p;
    const long long* o = offs + 4 * p;
    const int n = g[0], m = g[1];
    const int8_t* qp = q + o[0];
    const int8_t* rp = r + o[1];
    if (tb) {
        const int lo = g[2], hi = g[3];
        uint8_t* plane = planes + o[2];
        const int s = nw_pass<true>(qp, rp, n, m, lo, hi, rows, wcap, match,
                                    mismatch, go, ge, plane, lane);
        __syncwarp();
        if (lane == 0) {
            out[3 * p] = s;
            out[3 * p + 2] = nw_walk(plane, hi - lo + 1, n, m, lo,
                                     runs + o[3] + n + m);
        }
    } else {
        const int s = nw_pass<false>(qp, rp, n, m, g[4], g[5], rows, wcap,
                                     match, mismatch, go, ge, nullptr, lane);
        if (lane == 0) out[3 * p + 1] = s;
    }
}

}  // namespace

// Plain C entry point for ctypes: both passes of ``n_pairs`` pairs, warps
// 2p and 2p + 1 for pair p, ``warps`` a block.  The rows of a warp are
// ROW_INTS rows of ``wcap`` ints (the launch's widest band), in dynamic
// shared memory when ``rows`` is NULL, else at the warp's slot of that
// global scratch (2 * n_pairs * ROW_INTS * wcap ints).  Launches on
// ``stream`` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan it cannot launch.
extern "C" int nw_traceback_launch(const void* q, const void* r,
                                   const void* geom, const void* offs,
                                   int n_pairs, int warps, int wcap,
                                   void* rows, int match, int mismatch,
                                   int gap_open, int gap_extend,
                                   void* planes, void* runs, void* out,
                                   void* stream) {
    if (n_pairs <= 0) return 0;
    const long long smem =
        rows ? 0 : (long long)warps * ROW_INTS * wcap * (long long)sizeof(int);
    if (warps < 1 || warps > MAX_WARPS || wcap < 1 || smem > MAX_SMEM)
        return static_cast<int>(cudaErrorInvalidValue);
    static bool opted = false;
    if (!opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            nw_traceback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            MAX_SMEM);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted = true;
    }
    const long long blocks = (2LL * n_pairs + warps - 1) / warps;
    nw_traceback_kernel<<<(unsigned)blocks, warps * 32, (size_t)smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(r),
        static_cast<const int*>(geom), static_cast<const long long*>(offs),
        n_pairs, wcap, static_cast<int*>(rows), match, mismatch, gap_open,
        gap_extend, static_cast<uint8_t*>(planes),
        static_cast<unsigned*>(runs), static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}
