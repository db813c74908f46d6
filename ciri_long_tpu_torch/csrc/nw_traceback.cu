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
// Traceback codes, one nibble a cell (nw_tb_batch.py:146-161): bits 0-1 the
// case at H, E first (H == E, j > 0), then F (H == F), then the diagonal
// (3); bit 2 the E-stay flag (j > 1, E == E[c-1] - gE, E[c-1] > NEG / 2),
// bit 3 the F-stay flag (i > 1, F == F[i-1][c+1] - gE, F[i-1][c+1] > NEG /
// 2); 0 outside the band.  A plane row holds S = 16 * cols(W) bytes, two
// codes a byte (column c in byte c / 2, the high nibble for odd c), cols(W)
// the least power of two with 32 cols(W) >= W (ops/nw_tb_batch.py::
// plane_stride).  The walk is JAX's three-state machine (H, E, F) from
// (n, m) to (0, 0): it emits M (0), I (1, consumes q) and D (2, consumes r)
// and merges them into runs of length << 4 | op, the entries of
// native/nwcore.cpp's Cigar, written backwards from the end of the pair's
// run buffer (n + m entries: a path has at most n + m steps).
//
// Design: a pass at a time.  Each pair has two passes: its traceback pass
// at (lo, hi), which writes its (n + 1) x S byte plane and walks it, and
// its check pass at (lo2, hi2), the doubled band, which keeps only the score
// at (n, m).  The host plan (ops/nw_tb_batch.py::nw_plan) puts every pass in
// a width class by its own W, longest first, and gives each class a kernel
// launch of its own; the launches of a plan run side by side on streams
// forked from the caller's.
//   - Register classes, W <= 256: a warp a pass, lane l keeping columns
//     [l C, l C + C) of H and F in registers, C = cols(W) = 1, 2, 4 or 8.  A
//     row takes H and F at c + 1 of the row above from the next lane's first
//     column (a shuffle, NEG past the warp), the carry of the prefix max from
//     the lanes' maxima (one shift and five shuffle steps), and E at c - 1
//     from the previous lane's last column; the r codes slide one column a
//     row through a shuffle.  F, Ht and g are DPX add-max operations.  A
//     lane's codes go out as one store of C nibbles.
//   - Block classes, 256 < W <= 8 192: a pass on a block of K = cols(W) / 8
//     warps of 8 columns a lane, as above; the warps exchange their edge
//     columns' H and F, their maxima of g (the carry into the next warps)
//     and their last E through shared memory, two barriers a row.
//   - The wide class, W > 8 192 (and any pass a plan forces there): a warp a
//     pass, C columns a lane, five rows in global scratch (a lane's columns
//     padded by one int), three sweeps a row.
// The walk uses one warp: the path's band column moves by at most one a
// step (0 on M, +1 on I, -1 on D), so the warp stages the 32 rows x 64
// columns of the plane around the path's cell in shared memory (one 32-byte
// row a lane), and lane 0 walks the tile, reloaded when the path leaves it.
//
// Bound: a cell of either pass is the NW row update and, in the traceback
// pass, its code (csrc/op_rate.cu kind 6 times it), against the codes read
// once and the planes and outputs written once.  A row is serial within a
// pass (about nine shuffles deep), but with every class in flight at once
// the card's issue rate bounds a launch: the classes end together.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int HALF_NEG = NEG / 2;        // Python's NEG // 2 (exact)
constexpr int REG_WARPS = 4;             // warps a block, register classes
constexpr int WIDE_WARPS = 8;            // warps a block, wide classes
constexpr int ROW_INTS = 5;              // Hp, Fp, Hn, Fn, En a warp
constexpr int TILE_ROWS = 32;            // the walk's tile: rows
constexpr int TILE_BYTES = 32;           // and bytes a row (64 columns)
constexpr int TILE_INTS = TILE_ROWS * TILE_BYTES / 4;
constexpr int MAX_CLASSES = 16;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ long long clock_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ int sub_score(int a, int b, int match,
                                         int mismatch) {
    if (a >= 5 || b >= 5) return NEG;
    if (a == 4 || b == 4) return 0;
    return a == b ? match : -mismatch;
}

__device__ __forceinline__ int r_code(const int8_t* __restrict__ r, int j,
                                      int m) {
    return (j >= 1 && j <= m) ? r[j - 1] : 5;
}

// Row 0's code at column c (j = c + lo): case E with the E-stay flag.
__device__ __forceinline__ unsigned row0_code(int c, int W, int lo, int m,
                                              int go, int ge) {
    const int j = c + lo;
    const bool ok = c < W && j >= 1 && j <= m;
    const int h = -go - (j - 1) * ge;
    const int jl = j - 1;
    const int el = (c >= 1 && jl >= 1 && jl <= m) ? -go - (jl - 1) * ge
                                                  : NEG;
    const bool stay = j > 1 && c >= 1 && h == el - ge;
    return ok ? 1u | ((unsigned)stay << 2) : 0u;
}

// A lane's C nibbles of one plane row (C <= 8) to ``row``: one store a lane
// (C = 1: the even lanes store their pair of lanes' byte); only bytes below
// the row's S.
template <int C>
__device__ __forceinline__ void store_nibbles(uint8_t* row, unsigned word,
                                              int S, int lane) {
    if (C == 1) {
        const unsigned hi = __shfl_down_sync(FULL, word, 1);
        if ((lane & 1) == 0 && (lane >> 1) < S)
            row[lane >> 1] = (uint8_t)(word | (hi << 4));
    } else if (C == 2) {
        if (lane < S) row[lane] = (uint8_t)word;
    } else if (C == 4) {
        if (2 * lane < S)
            reinterpret_cast<uint16_t*>(row)[lane] = (uint16_t)word;
    } else {
        if (4 * lane < S) reinterpret_cast<unsigned*>(row)[lane] = word;
    }
}

// What the K warps of a block class exchange a row through shared memory:
// each warp's lane-0 H and F (the row above's c + 1 for the warp before),
// the warps' maxima of g (the prefix max's carry), each warp's last E (E at
// c - 1 for the warp after) and the score at (n, m).
struct Xchg {
    int xh[32], xf[32], tot[32], el[32];
    int score;
};

// One pass of one pair, rows in registers: lane l of warp kw of K owns
// columns [(32 kw + l) C, ... + C); K > 1 (BLOCK) joins the warps of a
// block through ``x`` with two barriers a row.  With CODES each row's codes
// go to plane + i * S.  Returns the score at (n, m) on every lane.
template <int C, bool CODES, bool BLOCK>
__device__ int reg_pass(const int8_t* __restrict__ q,
                        const int8_t* __restrict__ r, int n, int m, int lo,
                        int hi, int match, int mismatch, int go, int ge,
                        uint8_t* __restrict__ plane, int S, int lane,
                        int kw, int K, Xchg* x) {
    const int W = hi - lo + 1;
    const int cb = (32 * kw + lane) * C;
    // this warp's bytes of a plane row: from kw 16 C, below S
    const int lim = S - kw * 16 * C;
    if (CODES) plane += kw * 16 * C;
    int h[C], f[C], rc[C];

    // row 0: H = E = -gO - (j - 1) gE for 1 <= j <= m, H(0, 0) = 0
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const int c = cb + k;
        const int j = c + lo;
        const bool ok = c < W && j >= 0 && j <= m;
        h[k] = ok ? (j == 0 ? 0 : -go - (j - 1) * ge) : NEG;
        f[k] = NEG;
        rc[k] = r_code(r, c + 1 + lo, m);
        if (CODES) word |= row0_code(c, W, lo, m, go, ge) << (4 * k);
    }
    if (CODES) store_nibbles<C>(plane, word, lim, lane);
    if (BLOCK) {
        if (lane == 0) {
            x->xh[kw] = h[0];
            x->xf[kw] = f[0];
        }
        __syncthreads();
    }

    int qn = q[0];
    for (int i = 1; i <= n; ++i) {
        const int qi = qn;
        if (i < n) qn = q[i];
        const int base = i + lo;                 // j = c + base
        const int jlo = max(0, base);
        const int cl = max(1, jlo) - base;       // valid: cl <= c <= ch
        const int ch = min(m, i + hi) - base;
        const int cj0 = jlo == 0 ? -base : -1;   // the j == 0 column
        const int edge = -go - (i - 1) * ge;
        const bool qbad = qi >= 5, qn4 = qi == 4;

        // H and F at c + 1 of the row above, past the lane's last column
        int hnx = __shfl_down_sync(FULL, h[0], 1);
        int fnx = __shfl_down_sync(FULL, f[0], 1);
        const int rnx = __shfl_down_sync(FULL, rc[0], 1);
        if (lane == 31) {
            const bool next = BLOCK && kw + 1 < K;
            hnx = next ? x->xh[kw + 1] : NEG;
            fnx = next ? x->xf[kw + 1] : NEG;
        }

        // sweep 1: F and Ht from the row above (in place), the lane's max
        // of g, the F-stay flags
        int agg = NEG;
        unsigned fsb = 0;
#pragma unroll
        for (int k = 0; k < C; ++k) {
            const int c = cb + k;
            const int hup = k + 1 < C ? h[k + 1] : hnx;
            const int fup = k + 1 < C ? f[k + 1] : fnx;
            const int rj = rc[k];
            const int s = (qbad || rj >= 5) ? NEG
                        : (qn4 || rj == 4) ? 0
                        : (rj == qi ? match : -mismatch);
            const bool valid = c >= cl && c <= ch;
            const bool is_j0 = c == cj0;
            int fv = __viaddmax_s32(fup, -ge, hup - go);
            int ht = __viaddmax_s32(h[k], s, fv);
            ht = valid ? ht : NEG;
            ht = is_j0 ? edge : ht;
            fv = valid ? fv : NEG;
            fv = is_j0 ? edge : fv;
            if (CODES) {
                const bool fs = i > 1 && c <= W - 2 && fv == fup - ge &&
                                fup > HALF_NEG;
                fsb |= (unsigned)fs << k;
            }
            h[k] = ht;
            f[k] = fv;
            // g = Ht + gE c without the Ht > NEG / 2 test: a cell off the
            // band, or fed only by NEG, holds Ht within a few rows' scores of
            // NEG, so its g stays under NEG / 2 and E's test on the carry
            // drops it as the test on Ht would
            agg = __viaddmax_s32(ht, ge * c, agg);
        }
        // the lanes' exclusive prefix max: the carry into the lane's first
        // column
        int run = __shfl_up_sync(FULL, agg, 1);
        if (lane == 0) run = NEG;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(FULL, run, o);
            if (lane >= o) run = max(run, v);
        }
        if (BLOCK) {
            // the warps before this one: the carry into its lane 0
            const int tot = __shfl_sync(FULL, max(run, agg), 31);
            if (lane == 0) x->tot[kw] = tot;
            __syncthreads();
            int carry = NEG;
            for (int w = 0; w < kw; ++w) carry = max(carry, x->tot[w]);
            run = max(run, carry);
        }

        // sweep 2: E by the prefix max, then H
        int e[C];
#pragma unroll
        for (int k = 0; k < C; ++k) {
            const int c = cb + k;
            const bool valid = c >= cl && c <= ch;
            const bool is_j0 = c == cj0;
            const int ht = h[k];
            int ev = run > HALF_NEG ? run - go - (c - 1) * ge : NEG;
            run = __viaddmax_s32(ht, ge * c, run);
            ev = valid ? ev : NEG;
            int hv = max(ht, ev);
            hv = is_j0 ? edge : hv;
            h[k] = (valid || is_j0) ? hv : NEG;
            e[k] = is_j0 ? NEG : ev;
        }

        if (BLOCK) {
            if (lane == 31) x->el[kw] = e[C - 1];
            if (lane == 0) {
                x->xh[kw] = h[0];
                x->xf[kw] = f[0];
            }
            __syncthreads();
        }

        // the codes: E of the column to the left, F-stay from sweep 1
        if (CODES) {
            int el = __shfl_up_sync(FULL, e[C - 1], 1);
            if (lane == 0) el = BLOCK && kw > 0 ? x->el[kw - 1] : NEG;
            word = 0;
#pragma unroll
            for (int k = 0; k < C; ++k) {
                const int c = cb + k;
                const int j = c + base;
                const bool in_cell = (c >= cl && c <= ch) || c == cj0;
                const int left = k ? e[k - 1] : el;
                const int cs = (h[k] == e[k] && j > 0) ? 1
                             : (h[k] == f[k]) ? 2 : 3;
                const bool es = j > 1 && c >= 1 && e[k] == left - ge &&
                                left > HALF_NEG;
                const unsigned code =
                    in_cell ? (unsigned)cs | ((unsigned)es << 2) |
                                  (((fsb >> k) & 1u) << 3)
                            : 0u;
                word |= code << (4 * k);
            }
            store_nibbles<C>(plane + (size_t)i * S, word, lim, lane);
        }

        // the r codes of the next row: one column to the right
#pragma unroll
        for (int k = 0; k + 1 < C; ++k) rc[k] = rc[k + 1];
        rc[C - 1] = lane == 31 ? r_code(r, cb + C + i + lo, m) : rnx;
    }
    const int c_nm = m - n - lo;
    int score = NEG;
#pragma unroll
    for (int k = 0; k < C; ++k)
        if (c_nm - cb == k) score = h[k];
    if (!BLOCK) return __shfl_sync(FULL, score, c_nm / C);
    if (c_nm / C / 32 == kw && c_nm / C % 32 == lane) x->score = score;
    __syncthreads();
    return x->score;
}

// Ints of one row of a wide class of C columns a lane: each lane's C
// columns and one int of padding, so that the lanes' columns c = l C + k
// fall in distinct banks (C is a power of two).
__host__ __device__ __forceinline__ long long wide_row(int C) {
    return 32LL * (C + 1);
}

// One pass of one pair on one warp, rows in global scratch: lane l owns
// columns [l C, l C + C), C a power of two >= 8; five rows of wide_row(C)
// ints at ``rows``, column c at c + c / C.  Same outputs as reg_pass.
template <bool CODES>
__device__ int wide_pass(const int8_t* __restrict__ q,
                         const int8_t* __restrict__ r, int n, int m, int lo,
                         int hi, int C, int* rows, int match, int mismatch,
                         int go, int ge, uint8_t* __restrict__ plane, int S,
                         int lane) {
    const int W = hi - lo + 1;
    const int wc = (int)wide_row(C);
    const int lg = __ffs(C) - 1;
    const int c0 = lane * C;
    const int c1 = min(W, c0 + C);
    int* Hp = rows;
    int* Fp = rows + wc;
    int* Hn = rows + 2 * wc;
    int* Fn = rows + 3 * wc;
    int* En = rows + 4 * wc;
    const bool store = 4 * lane * (C / 8) < S;
#define AT(c) ((c) + ((c) >> lg))

    for (int c = c0; c < c0 + C; ++c) {
        const int j = c + lo;
        const bool ok = c < W && j >= 0 && j <= m;
        Hp[AT(c)] = ok ? (j == 0 ? 0 : -go - (j - 1) * ge) : NEG;
        Fp[AT(c)] = NEG;
    }
    if (CODES && store) {
        for (int g = 0; g < C / 8; ++g) {
            unsigned word = 0;
            for (int k = 0; k < 8; ++k)
                word |= row0_code(c0 + 8 * g + k, W, lo, m, go, ge)
                        << (4 * k);
            reinterpret_cast<unsigned*>(plane)[lane * (C / 8) + g] = word;
        }
    }
    __syncwarp();

    for (int i = 1; i <= n; ++i) {
        const int base = i + lo;
        const int jlo = max(0, base);
        const int cl = max(1, jlo) - base;
        const int ch = min(m, i + hi) - base;
        const int cj0 = jlo == 0 ? -base : -1;
        const int qi = q[i - 1];
        const int edge = -go - (i - 1) * ge;

        // sweep 1: F and Ht from the row above; the lane's max of g
        int agg = NEG;
        int hc = c0 < c1 ? Hp[AT(c0)] : NEG;
        for (int c = c0; c < c1; ++c) {
            const bool valid = c >= cl && c <= ch;
            const bool is_j0 = c == cj0;
            const int d = hc + sub_score(qi, r_code(r, c + base, m), match,
                                         mismatch);
            const int hup = c + 1 < W ? Hp[AT(c + 1)] : NEG;
            const int fup = c + 1 < W ? Fp[AT(c + 1)] : NEG;
            hc = hup;
            int fv = max(fup - ge, hup - go);
            int ht = max(d, fv);
            ht = valid ? ht : NEG;
            ht = is_j0 ? edge : ht;
            fv = valid ? fv : NEG;
            fv = is_j0 ? edge : fv;
            Hn[AT(c)] = ht;
            Fn[AT(c)] = fv;
            agg = max(agg, ht > HALF_NEG ? ht + ge * c : NEG);
        }
        int run = __shfl_up_sync(FULL, agg, 1);
        if (lane == 0) run = NEG;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(FULL, run, o);
            if (lane >= o) run = max(run, v);
        }

        // sweep 2: E by the prefix max, then H
        for (int c = c0; c < c1; ++c) {
            const bool valid = c >= cl && c <= ch;
            const bool is_j0 = c == cj0;
            const int ht = Hn[AT(c)];
            int ev = run > HALF_NEG ? run - go - (c - 1) * ge : NEG;
            run = max(run, ht > HALF_NEG ? ht + ge * c : NEG);
            ev = valid ? ev : NEG;
            int hv = max(ht, ev);
            hv = is_j0 ? edge : hv;
            Hn[AT(c)] = (valid || is_j0) ? hv : NEG;
            En[AT(c)] = is_j0 ? NEG : ev;
        }
        __syncwarp();

        // sweep 3: the codes, 8 nibbles a store
        if (CODES && store) {
            unsigned* row = reinterpret_cast<unsigned*>(plane + (size_t)i * S);
            int el = c0 >= 1 && c0 - 1 < W ? En[AT(c0 - 1)] : NEG;
            for (int g = 0; g < C / 8; ++g) {
                unsigned word = 0;
                for (int k = 0; k < 8; ++k) {
                    const int c = c0 + 8 * g + k;
                    if (c >= c1) break;
                    const int j = c + base;
                    const int ev = En[AT(c)];
                    const int left = el;
                    el = ev;
                    const bool in_cell = (c >= cl && c <= ch) || c == cj0;
                    if (!in_cell) continue;
                    const int hv = Hn[AT(c)], fv = Fn[AT(c)];
                    const int cs = (hv == ev && j > 0) ? 1
                                 : (hv == fv) ? 2 : 3;
                    const bool es = j > 1 && c >= 1 && ev == left - ge &&
                                    left > HALF_NEG;
                    const int fup = c + 1 < W ? Fp[AT(c + 1)] : NEG;
                    const bool fs = i > 1 && c <= W - 2 && fv == fup - ge &&
                                    fup > HALF_NEG;
                    word |= ((unsigned)cs | ((unsigned)es << 2) |
                             ((unsigned)fs << 3)) << (4 * k);
                }
                row[lane * (C / 8) + g] = word;
            }
        }
        int* t = Hp; Hp = Hn; Hn = t;
        t = Fp; Fp = Fn; Fn = t;
        __syncwarp();
    }
    const int c_nm = m - n - lo;
    return __shfl_sync(FULL, c_nm >= c0 && c_nm < c1 ? Hp[AT(c_nm)] : NEG,
                       c_nm / C);
#undef AT
}

// The warp's walk of a traceback plane through a tile of TILE_ROWS rows x
// 2 TILE_BYTES columns in shared memory (``tile``, TILE_INTS ints), lane 0
// stepping; returns the runs written backwards before ``end``, or -1 when
// the plane leads off the band or to a cell without a case.
__device__ int walk_warp(const uint8_t* __restrict__ plane, int S, int W,
                         int n, int m, int lo, unsigned* end,
                         uint8_t* tile, int lane) {
    int i = n, j = m, state = 0, cur = -1, len = 0, cnt = 0, status = 0;
    while (true) {
        const int c = j - i - lo;
        if (i < 0 || j < 0 || c < 0 || c >= W) return -1;
        const int i0 = i;
        const int b0 = max(0, (c >> 1) - TILE_BYTES / 2) & ~15;
        const int ri = i0 - lane;
        if (ri >= 0) {
            const uint4* src = reinterpret_cast<const uint4*>(
                plane + (size_t)ri * S + b0);
            uint4* dst = reinterpret_cast<uint4*>(tile + lane * TILE_BYTES);
            dst[0] = src[0];
            dst[1] = src[1];
        }
        __syncwarp();
        if (lane == 0) {
            while (i > 0 || j > 0) {
                const int cc = j - i - lo;
                if (i < 0 || j < 0 || cc < 0 || cc >= W) {
                    status = -1;
                    break;
                }
                const int b = (cc >> 1) - b0;
                if (i0 - i >= TILE_ROWS || b < 0 || b >= TILE_BYTES) break;
                const int code =
                    (tile[(i0 - i) * TILE_BYTES + b] >> ((cc & 1) * 4)) & 15;
                int op;
                if (state == 0) {
                    const int cs = code & 3;
                    if (cs == 1) { state = 1; continue; }
                    if (cs == 2) { state = 2; continue; }
                    if (cs == 0) { status = -1; break; }
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
                    if (len) end[-1 - cnt++] = ((unsigned)len << 4) |
                                               (unsigned)cur;
                    cur = op;
                    len = 1;
                }
            }
            if (status == 0 && i <= 0 && j <= 0) {
                if (len) end[-1 - cnt++] = ((unsigned)len << 4) |
                                           (unsigned)cur;
                status = 1;
            }
        }
        status = __shfl_sync(FULL, status, 0);
        if (status < 0) return -1;
        if (status > 0) return __shfl_sync(FULL, cnt, 0);
        i = __shfl_sync(FULL, i, 0);
        j = __shfl_sync(FULL, j, 0);
        state = __shfl_sync(FULL, state, 0);
        cur = __shfl_sync(FULL, cur, 0);
        len = __shfl_sync(FULL, len, 0);
        cnt = __shfl_sync(FULL, cnt, 0);
        __syncwarp();
    }
}

__device__ __forceinline__ int plane_stride(int W) {
    int C = 1;
    while (32 * C < W) C <<= 1;
    return 16 * C;
}

struct Args {
    const int8_t* q;
    const int8_t* r;
    const int* geom;         // [P, 6] n, m, lo, hi, lo2, hi2
    const long long* offs;   // [P, 4] q, r, plane, run offsets
    const int* tasks;        // the class's tasks: 2 p (traceback), 2 p + 1
    int count;
    int match, mismatch, go, ge;
    uint8_t* planes;
    unsigned* runs;
    int* out;                // [P, 3] s1, s2, run count
    long long* stamps;       // [2 P, 3] or null: start, after rows, end
};

// A task's pass on its warp: the traceback pass (plane, walk, s1, count)
// or the check pass (s2).  PASS runs the rows: PASS(codes, lo, hi, plane,
// S) -> score.
template <typename Pass>
__device__ void run_task(const Args& a, int slot, int lane, uint8_t* tile,
                         Pass pass) {
    const int task = a.tasks[slot];
    const int p = task >> 1;
    const int* g = a.geom + 6 * p;
    const long long* o = a.offs + 4 * p;
    const int n = g[0], m = g[1];
    long long* st = a.stamps ? a.stamps + 3LL * task : nullptr;
    if (st && lane == 0) st[0] = clock_ns();
    if ((task & 1) == 0) {
        const int lo = g[2], hi = g[3];
        const int W = hi - lo + 1;
        const int S = plane_stride(W);
        uint8_t* plane = a.planes + o[2];
        const int s = pass(true, lo, hi, plane, S);
        __syncwarp();
        if (st && lane == 0) st[1] = clock_ns();
        const int cnt = walk_warp(plane, S, W, n, m, lo,
                                  a.runs + o[3] + n + m, tile, lane);
        if (lane == 0) {
            a.out[3 * p] = s;
            a.out[3 * p + 2] = cnt;
            if (st) st[2] = clock_ns();
        }
    } else {
        const int s = pass(false, g[4], g[5], nullptr, 0);
        if (lane == 0) {
            a.out[3 * p + 1] = s;
            if (st) st[1] = st[2] = clock_ns();
        }
    }
}

template <int C>
__global__ void __launch_bounds__(REG_WARPS * 32, C == 8 ? 8 : 1)
nw_reg_kernel(Args a) {
    __shared__ __align__(16) int tiles[REG_WARPS][TILE_INTS];
    const int wid = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int slot = blockIdx.x * REG_WARPS + wid;
    if (slot >= a.count) return;
    const int p = a.tasks[slot] >> 1;
    const int* g = a.geom + 6 * p;
    const long long* o = a.offs + 4 * p;
    const int8_t* qp = a.q + o[0];
    const int8_t* rp = a.r + o[1];
    const int n = g[0], m = g[1];
    run_task(a, slot, lane, reinterpret_cast<uint8_t*>(tiles[wid]),
             [&](bool codes, int lo, int hi, uint8_t* plane, int S) {
                 return codes
                     ? reg_pass<C, true, false>(qp, rp, n, m, lo, hi,
                                                a.match, a.mismatch, a.go,
                                                a.ge, plane, S, lane, 0, 1,
                                                nullptr)
                     : reg_pass<C, false, false>(qp, rp, n, m, lo, hi,
                                                 a.match, a.mismatch, a.go,
                                                 a.ge, nullptr, 0, lane, 0,
                                                 1, nullptr);
             });
}

// A block class: one task a block of K = blockDim.x / 32 warps, 8 columns a
// lane (32 K lanes); warp 0 walks the plane.
__global__ void __launch_bounds__(1024) nw_block_kernel(Args a) {
    __shared__ Xchg x;
    __shared__ __align__(16) int tile[TILE_INTS];
    const int kw = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int K = blockDim.x >> 5;
    const int slot = blockIdx.x;
    const int task = a.tasks[slot];
    const int p = task >> 1;
    const int* g = a.geom + 6 * p;
    const long long* o = a.offs + 4 * p;
    const int8_t* qp = a.q + o[0];
    const int8_t* rp = a.r + o[1];
    const int n = g[0], m = g[1];
    long long* st = a.stamps ? a.stamps + 3LL * task : nullptr;
    const bool lead = kw == 0 && lane == 0;
    if (st && lead) st[0] = clock_ns();
    if ((task & 1) == 0) {
        const int lo = g[2], hi = g[3];
        const int W = hi - lo + 1;
        const int S = plane_stride(W);
        uint8_t* plane = a.planes + o[2];
        const int s = reg_pass<8, true, true>(qp, rp, n, m, lo, hi, a.match,
                                              a.mismatch, a.go, a.ge, plane,
                                              S, lane, kw, K, &x);
        if (kw != 0) return;
        if (st && lane == 0) st[1] = clock_ns();
        const int cnt = walk_warp(plane, S, W, n, m, lo,
                                  a.runs + o[3] + n + m,
                                  reinterpret_cast<uint8_t*>(tile), lane);
        if (lane == 0) {
            a.out[3 * p] = s;
            a.out[3 * p + 2] = cnt;
            if (st) st[2] = clock_ns();
        }
    } else {
        const int s = reg_pass<8, false, true>(qp, rp, n, m, g[4], g[5],
                                               a.match, a.mismatch, a.go,
                                               a.ge, nullptr, 0, lane, kw, K,
                                               &x);
        if (lead) {
            a.out[3 * p + 1] = s;
            if (st) st[1] = st[2] = clock_ns();
        }
    }
}

// ``C`` columns a lane; a warp's rows at rows + slot * ROW_INTS *
// wide_row(C).
__global__ void __launch_bounds__(WIDE_WARPS * 32)
nw_wide_kernel(Args a, int C, int* rows_global) {
    __shared__ __align__(16) int tiles[WIDE_WARPS][TILE_INTS];
    const int wid = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int slot = blockIdx.x * WIDE_WARPS + wid;
    if (slot >= a.count) return;
    int* rows = rows_global + (long long)slot * ROW_INTS * wide_row(C);
    uint8_t* tile = reinterpret_cast<uint8_t*>(tiles[wid]);
    const int p = a.tasks[slot] >> 1;
    const int* g = a.geom + 6 * p;
    const long long* o = a.offs + 4 * p;
    const int8_t* qp = a.q + o[0];
    const int8_t* rp = a.r + o[1];
    const int n = g[0], m = g[1];
    run_task(a, slot, lane, tile,
             [&](bool codes, int lo, int hi, uint8_t* plane, int S) {
                 return codes
                     ? wide_pass<true>(qp, rp, n, m, lo, hi, C, rows,
                                       a.match, a.mismatch, a.go, a.ge,
                                       plane, S, lane)
                     : wide_pass<false>(qp, rp, n, m, lo, hi, C, rows,
                                        a.match, a.mismatch, a.go, a.ge,
                                        nullptr, 0, lane);
             });
}

// Streams and events the classes of one launch fork onto, made once.
std::mutex g_mutex;
bool g_ready = false;
cudaStream_t g_side[MAX_CLASSES];
cudaEvent_t g_fork, g_join[MAX_CLASSES];

cudaError_t ready() {
    if (g_ready) return cudaSuccess;
    cudaError_t err = cudaEventCreateWithFlags(&g_fork,
                                               cudaEventDisableTiming);
    for (int k = 0; k < MAX_CLASSES && err == cudaSuccess; ++k) {
        err = cudaStreamCreateWithFlags(&g_side[k], cudaStreamNonBlocking);
        if (err == cudaSuccess)
            err = cudaEventCreateWithFlags(&g_join[k],
                                           cudaEventDisableTiming);
    }
    if (err == cudaSuccess) g_ready = true;
    return err;
}

cudaError_t launch_class(const Args& a, int kind, int C, int warps,
                         int* rows, cudaStream_t st) {
    if (kind == 1) {
        nw_block_kernel<<<a.count, warps * 32, 0, st>>>(a);
    } else if (kind == 0) {
        const unsigned blocks = (a.count + REG_WARPS - 1) / REG_WARPS;
        switch (C) {
            case 1: nw_reg_kernel<1><<<blocks, REG_WARPS * 32, 0, st>>>(a);
                    break;
            case 2: nw_reg_kernel<2><<<blocks, REG_WARPS * 32, 0, st>>>(a);
                    break;
            case 4: nw_reg_kernel<4><<<blocks, REG_WARPS * 32, 0, st>>>(a);
                    break;
            default: nw_reg_kernel<8><<<blocks, REG_WARPS * 32, 0, st>>>(a);
        }
    } else {
        const unsigned blocks = (a.count + WIDE_WARPS - 1) / WIDE_WARPS;
        nw_wide_kernel<<<blocks, WIDE_WARPS * 32, 0, st>>>(a, C, rows);
    }
    return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes: the passes of one plan's launch, class by
// class.  ``classes`` holds n_classes rows of six int64 (kind, start,
// count, warps, C, rows offset): kind 0 a register class (C = 1, 2, 4, 8;
// REG_WARPS warps a block), 1 a block class (a task a block of ``warps`` =
// C / 8 <= 32 warps of 8 columns a lane), 2 a wide class (C a power of two
// >= 8, WIDE_WARPS warps a block) with its rows in global scratch (ROW_INTS
// * wide_row(C) ints for each of its tasks, from ``rows`` + rows offset
// ints); its tasks are tasks[start : start + count].  A plan of one class
// launches on ``stream``; a plan of several forks its classes onto streams
// of their own after the work queued on ``stream`` and joins them back into
// it.  ``stamps`` (int64 [2 P, 3] or NULL) gets each task's %globaltimer at
// its start, after its rows and at its end.  Returns 0, a cudaError_t, or
// cudaErrorInvalidValue for a plan it cannot launch.
extern "C" int nw_traceback_launch(const void* q, const void* r,
                                   const void* geom, const void* offs,
                                   const void* tasks,
                                   const long long* classes, int n_classes,
                                   void* rows, int match, int mismatch,
                                   int gap_open, int gap_extend,
                                   void* planes, void* runs, void* out,
                                   void* stamps, void* stream) {
    if (n_classes < 0 || n_classes > MAX_CLASSES)
        return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < n_classes; ++k) {
        const long long* c = classes + 6 * k;
        const long long kind = c[0], warps = c[3], C = c[4];
        const bool ok =
            (kind == 0 && (C == 1 || C == 2 || C == 4 || C == 8)) ||
            (kind == 1 && warps >= 1 && warps <= 32 && C == 8 * warps) ||
            (kind == 2 && C >= 8 && (C & (C - 1)) == 0 && rows != nullptr &&
             c[5] >= 0);
        if (c[1] < 0 || c[2] < 0 || c[2] >= (1LL << 31) || !ok)
            return static_cast<int>(cudaErrorInvalidValue);
    }
    std::lock_guard<std::mutex> lock(g_mutex);
    cudaError_t err = ready();
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t main = static_cast<cudaStream_t>(stream);
    const bool fork = n_classes > 1;
    if (fork) {
        err = cudaEventRecord(g_fork, main);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    for (int k = 0; k < n_classes; ++k) {
        const long long* c = classes + 6 * k;
        if (c[2] == 0) continue;
        Args a{static_cast<const int8_t*>(q), static_cast<const int8_t*>(r),
               static_cast<const int*>(geom),
               static_cast<const long long*>(offs),
               static_cast<const int*>(tasks) + c[1], (int)c[2], match,
               mismatch, gap_open, gap_extend,
               static_cast<uint8_t*>(planes), static_cast<unsigned*>(runs),
               static_cast<int*>(out), static_cast<long long*>(stamps)};
        cudaStream_t st = fork ? g_side[k] : main;
        if (fork) {
            err = cudaStreamWaitEvent(st, g_fork, 0);
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        err = launch_class(a, (int)c[0], (int)c[4], (int)c[3],
                           c[0] == 2 ? static_cast<int*>(rows) + c[5]
                                     : nullptr,
                           st);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (fork) {
            err = cudaEventRecord(g_join[k], st);
            if (err == cudaSuccess)
                err = cudaStreamWaitEvent(main, g_join[k], 0);
            if (err != cudaSuccess) return static_cast<int>(err);
        }
    }
    return 0;
}

// Resident blocks an SM of one class's kernel (cudaOccupancy...), for the
// measurement of a plan: kind, C and warps as in nw_traceback_launch's
// class rows.  Returns 0 or a cudaError_t.
extern "C" int nw_traceback_occupancy(int kind, int C, int warps,
                                      int* blocks) {
    if (kind == 1)
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, nw_block_kernel, warps * 32, 0));
    if (kind == 2)
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, nw_wide_kernel, WIDE_WARPS * 32, 0));
    cudaError_t err;
    switch (C) {
        case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks, nw_reg_kernel<1>, REG_WARPS * 32, 0);
                break;
        case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks, nw_reg_kernel<2>, REG_WARPS * 32, 0);
                break;
        case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    blocks, nw_reg_kernel<4>, REG_WARPS * 32, 0);
                break;
        default: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     blocks, nw_reg_kernel<8>, REG_WARPS * 32, 0);
    }
    return static_cast<int>(err);
}
