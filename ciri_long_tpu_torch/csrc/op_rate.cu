// The card's peak rate for the arithmetic of one Smith-Waterman cell update:
// the operations bound of the SW kernels (misc/kexp.py::cell_rate and
// sw_bound).  No scoring path calls it.
//
// Each thread runs CHAINS independent cells, one update per step, all in
// registers: no memory traffic and no dependence between threads, so the
// instructions' own throughput is all that bounds it.  One update is
//   hm = H - gO                          (once, for E to the right and F below)
//   E  = max(E - gE, hm)                 F = max(F - gE, hm)
//   s  = q == r ? match : -mismatch      H = max(H_diag + s, E, F, 0)
// in one of two forms:
//   DPX=true  Hopper's DPX instructions: __viaddmax_s32 for E and F,
//             __vimax3_s32_relu for H; 7 instructions (sub, 2 DPX, compare,
//             select, add, DPX);
//   DPX=false plain int32: 11 instructions as written (sub, 2 x (sub, max),
//             compare, select, add, 3 max); ptxas for sm_90a fuses the
//             add-max pairs and the three-way max into DPX instructions
//             itself, so this form runs nearly as fast.
// The launcher's caller times it and counts cells = blocks * THREADS * CHAINS
// * steps.
//
// recurrence_rate_launch times two more updates the same way, the bounds of
// collapse's kernels:
//   kind 0, edit distance (csrc/edit_distance.cu):
//     D = min(D_diag + (a != b), min(D_up, D_left) + 1)
//     a compare and select, an add, a min and a DPX add-min;
//   kind 1, SW with traceback (csrc/sw_traceback.cu): the DPX SW update
//     above plus the direction code, the case (H == 0, H == diag + s,
//     H == E, H == F) and the two stay bits (E == E_up - gE, E != H_up - gO;
//     F == F_left - gE, F != H_left - gO) packed into one byte;
//   kind 2, the bit-parallel edit distance (csrc/edit_distance.cu): one
//     Myers/Hyyro update of a 32-row word for one text column, its match
//     mask (an xor standing in for the kernel's table load), the update
//     with the row above's delta hin, and hout, the delta at the word's top
//     row, which is the next update's hin.  A "cell" of this kind is one
//     word update: 32 DP cells.
//   kind 3, the graph alignment of collapse's POA (csrc/poa_align.cu), a
//     cell with one predecessor: F1 = max(F1_up + e1, H_up + o1) and F2
//     alike (DPX add-max each), M = max(H_diag, source) + s with its slot
//     (compare, select, compare, select, add), Hpre = max3, the two E
//     pieces from running prefix maxima of Hpre - j e (sub, max, add each),
//     H = max3, and the direction word: five compares, three selects, a
//     shift and an or.
//   kind 4, a candidate of the chaining DP (csrc/chain_dp.cu): dr and dq,
//     the five window tests, alpha = min(dq, dr, k), g = |dr - dq|, its
//     log term (a multiply standing in for the kernel's table load), skip,
//     pen on either side of dr >= dq, cand = (f + alpha) - pen in float64
//     round-to-nearest adds and multiplies, and the running best (compare,
//     two selects).  A "cell" of this kind is one candidate.
//   kind 5, one lag of one window of the tandem pre-screen
//     (csrc/screen_keep.cu): the lag's range test, the k-mer compare and the
//     count's add.
//   kind 6, a cell of the center-star polish's banded NW
//     (csrc/nw_traceback.cu): F = max(F_up - gE, H_up - gO) (a DPX add-max),
//     the substitution (compare, select) and Ht = max(H_diag + s, F), g =
//     Ht + gE c into the running prefix max, E = carry - gO - (c - 1) gE,
//     H = max(Ht, E), and the 4-bit code: the case (H == E, H == F), the
//     E-stay and F-stay compares, shifts and ors.
//   kind 7, 32 positions of one lag of the lag profile (csrc/lag_profile.cu)
//     in its packed form, the least work the profile's compares need: a
//     read's codes as two bit planes and a valid mask, a bit a position;
//     the partner's three words at the lag by three funnel shifts (a word
//     of the step, the same for all chains, standing in for their loads),
//     the valid pairs (and), the equal ones (two xors and an and-not, which
//     ptxas fuses into LOP3s), two popcounts and two adds.  A "cell" of
//     this kind is 32 (position, lag) pairs.
//   kind 8, the same word with one popcount and one add: the matches
//     only, for a read whose valid codes form one run (its valid pairs at
//     lag d are n - d, no popcount needed).
//
// serial_step_launch times a latency, not a rate: one warp runs the step
// of the chaining DP that no design can take off its serial path, the
// newest candidate against the best of the older window,
//   c = (f + alpha) - pen                two float64 round-to-nearest adds
//   f = c > best ? c : best              a compare and a select
// with each step's alpha, pen and best known before it (computed from
// the step count, off the chain), so only f -> f is dependent.  The caller
// divides the launch's time by its steps: the least time a step of a row
// takes, whatever the window's other candidates cost (csrc/chain_dp.cu's
// serial bound).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHAINS = 8;

template <bool DPX>
__global__ void __launch_bounds__(THREADS)
cell_rate_kernel(int steps, int q, int match, int mismatch, int gap_open,
                 int gap_extend, int* out) {
    int h[CHAINS], hd[CHAINS], e[CHAINS], f[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        h[k] = threadIdx.x + k;
        hd[k] = blockIdx.x + k;
        e[k] = k;
        f[k] = 2 * k + 1;
    }
    const int nge = -gap_extend;
    const int nmis = -mismatch;
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
            const int hm = h[k] - gap_open;
            const int s = h[k] == q ? match : nmis;
            int hn;
            if (DPX) {
                e[k] = __viaddmax_s32(e[k], nge, hm);
                f[k] = __viaddmax_s32(f[k], nge, hm);
                hn = __vimax3_s32_relu(hd[k] + s, e[k], f[k]);
            } else {
                e[k] = max(e[k] + nge, hm);
                f[k] = max(f[k] + nge, hm);
                hn = max(max(hd[k] + s, e[k]), max(f[k], 0));
            }
            hd[k] = h[k];
            h[k] = hn;
        }
    }
    int acc = 0;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc ^= h[k] ^ e[k] ^ f[k];
    if (acc == 0x7fffffff) out[0] = acc;  // keeps the work live
}

__global__ void __launch_bounds__(THREADS)
edit_rate_kernel(int steps, int q, int* out) {
    int left[CHAINS], up[CHAINS], dg[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        left[k] = threadIdx.x + k;
        up[k] = blockIdx.x + k;
        dg[k] = k;
    }
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
            const int sub = (up[k] & 7) != q;
            const int d = __viaddmin_s32(min(up[k], left[k]), 1, dg[k] + sub);
            dg[k] = up[k];
            up[k] = left[k];
            left[k] = d;
        }
    }
    int acc = 0;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc ^= left[k] ^ up[k] ^ dg[k];
    if (acc == 0x7fffffff) out[0] = acc;  // keeps the work live
}

__global__ void __launch_bounds__(THREADS)
tb_rate_kernel(int steps, int q, int match, int mismatch, int gap_open,
               int gap_extend, int* out) {
    int h[CHAINS], hd[CHAINS], e[CHAINS], f[CHAINS];
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        h[k] = threadIdx.x + k;
        hd[k] = blockIdx.x + k;
        e[k] = k;
        f[k] = 2 * k + 1;
    }
    const int nge = -gap_extend;
    const int nmis = -mismatch;
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
            const int hm = h[k] - gap_open;
            const int s = h[k] == q ? match : nmis;
            const int dv = hd[k] + s;
            const int en = __viaddmax_s32(e[k], nge, hm);
            const int fn = __viaddmax_s32(f[k], nge, hm);
            const int hn = __vimax3_s32_relu(dv, en, fn);
            const int cs = hn == 0 ? 0 : hn == dv ? 1 : hn == en ? 2
                         : hn == fn ? 3 : 0;
            const bool estay = en == e[k] + nge && en != hm;
            const bool fstay = fn == f[k] + nge && fn != hm;
            acc += (unsigned)(cs | (estay << 2) | (fstay << 3));
            e[k] = en;
            f[k] = fn;
            hd[k] = h[k];
            h[k] = hn;
        }
    }
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc ^= h[k] ^ e[k] ^ f[k];
    if (acc == 0x7fffffffu) out[0] = (int)acc;  // keeps the work live
}

// csrc/edit_distance.cu::word_update
__device__ __forceinline__ void word_update(uint32_t eq, int hin,
                                            uint32_t& pv, uint32_t& mv,
                                            uint32_t& ph, uint32_t& mh) {
    const uint32_t xv = eq | mv;
    if (hin < 0) eq |= 1u;
    const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
    ph = mv | ~(xh | pv);
    mh = pv & xh;
    const uint32_t phs = (ph << 1) | (uint32_t)(hin > 0);
    const uint32_t mhs = (mh << 1) | (uint32_t)(hin < 0);
    pv = mhs | ~(xv | phs);
    mv = phs & xv;
}

__global__ void __launch_bounds__(THREADS)
myers_rate_kernel(int steps, int q, int* out) {
    uint32_t pv[CHAINS], mv[CHAINS];
    int hin[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        pv[k] = ~(threadIdx.x + k);
        mv[k] = blockIdx.x + k;
        hin[k] = k % 3 - 1;
    }
    const uint32_t base = (uint32_t)q * 0x9e3779b9u;
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
            uint32_t ph, mh;
            word_update(base ^ (uint32_t)(t + k), hin[k], pv[k], mv[k], ph,
                        mh);
            hin[k] = (int)(ph >> 31) - (int)(mh >> 31);
        }
    }
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc ^= pv[k] ^ mv[k] ^ (uint32_t)hin[k];
    if (acc == 0x7fffffffu) out[0] = (int)acc;  // keeps the work live
}

__global__ void __launch_bounds__(THREADS)
poa_rate_kernel(int steps, int q, int match, int mismatch, int* out) {
    constexpr int o1 = -8, e1 = -2, o2 = -24, e2 = -1;
    int h[CHAINS], f1[CHAINS], f2[CHAINS], m1[CHAINS], m2[CHAINS];
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        h[k] = threadIdx.x + k;
        f1[k] = blockIdx.x + k;
        f2[k] = k;
        m1[k] = 2 * k;
        m2[k] = 3 * k;
    }
    const int nmis = -mismatch;
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
            const int hu = h[k];
            const int v1 = __viaddmax_s32(f1[k], e1, hu + o1);
            const int v2 = __viaddmax_s32(f2[k], e2, hu + o2);
            const int src = t + k;                       // the source row
            const bool take_src = src > hu;
            const int mb = take_src ? src : hu;
            const int slot = take_src ? 1 : 0;
            const int mrow = mb + ((hu & 3) == q ? match : nmis);
            const int hp = max(mrow, max(v1, v2));
            m1[k] = max(m1[k], hp - t * e1);
            m2[k] = max(m2[k], hp - t * e2);
            const int ev1 = m1[k] + o1 + t * e1;
            const int ev2 = m2[k] + o2 + t * e2;
            const int hn = max(hp, max(ev1, ev2));
            const bool is_e = hn == ev1 || hn == ev2;
            const bool is_m = hn == mrow;
            const bool is_f = hn == v1 || hn == v2;
            const int cs = is_e ? 1 : is_m ? 2 : is_f ? 3 : 0;
            acc += (unsigned)((cs << 14) | (is_m && !is_e ? slot : 0));
            f1[k] = v1;
            f2[k] = v2;
            h[k] = hn;
        }
    }
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc ^= h[k] ^ f1[k] ^ f2[k];
    if (acc == 0x7fffffffu) out[0] = (int)acc;  // keeps the work live
}

__global__ void __launch_bounds__(THREADS)
chain_rate_kernel(int steps, int q, int* out) {
    int dr[CHAINS], dq[CHAINS], bj[CHAINS];
    double fj[CHAINS], best[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        dr[k] = threadIdx.x + 40 * k + 1;
        dq[k] = blockIdx.x % 97 + k + 1;
        fj[k] = 15.0 + k;
        best[k] = 15.0;
        bj[k] = -1;
    }
    const double kd = 15.0, two_k = 30.0;
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
            const int r = dr[k] + (t & 63);
            const int s = dq[k] + (t & 31) - q;
            const bool ok = r > 0 && s > 0 && s <= 5000 && r <= 200000 &&
                            (r & 1023) != q;
            const double alpha = static_cast<double>(min(min(s, r), 15));
            const int g = abs(r - s);
            const double lgv = __dmul_rn(static_cast<double>(g), 1e-3);
            const double skip = __dmul_rn(
                0.1, fmax(0.0, __dsub_rn(static_cast<double>(s), two_k)));
            const double pen =
                r >= s ? __dadd_rn(lgv, skip)
                       : __dadd_rn(
                             __dadd_rn(__dmul_rn(0.5, static_cast<double>(g)),
                                       __dmul_rn(0.5, lgv)),
                             skip);
            const double cand = __dsub_rn(__dadd_rn(fj[k], alpha), pen);
            if (ok && cand > best[k]) {
                best[k] = cand;
                bj[k] = t;
            }
            fj[k] = __dadd_rn(fj[k], kd * 1e-9);
        }
    }
    double acc = 0.0;
    int iacc = 0;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        acc += best[k];
        iacc ^= bj[k];
    }
    if (acc == -1.0 || iacc == 0x7fffffff) out[0] = iacc;  // keeps it live
}

__global__ void __launch_bounds__(THREADS)
screen_rate_kernel(int steps, int q, int* out) {
    int cnt[CHAINS], kid[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        cnt[k] = 0;
        kid[k] = (threadIdx.x * 7 + k) & 1023;
    }
    const int room = steps - q;
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
        const int xi = (t * 13) & 1023;    // the window's broadcast k-mer
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
            const int d = threadIdx.x + 1 + k * THREADS;
            if (d < room - t) cnt[k] += kid[k] == xi;
        }
    }
    int acc = 0;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc ^= cnt[k];
    if (acc == 0x7fffffff) out[0] = acc;  // keeps the work live
}

template <bool DEN>
__global__ void __launch_bounds__(THREADS)
lag_rate_kernel(int steps, int q, int* out) {
    uint32_t lo[CHAINS], hi[CHAINS], va[CHAINS];
    int num[CHAINS], den[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        lo[k] = threadIdx.x * 0x9e3779b9u + k;
        hi[k] = blockIdx.x ^ (k * 0x85ebca6bu);
        va[k] = ~(threadIdx.x << k);
        num[k] = 0;
        den[k] = 0;
    }
    const uint32_t base = (uint32_t)q * 0x9e3779b9u;
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
        const uint32_t w = base ^ (uint32_t)t;    // the partner's next word
        const uint32_t wv = w | (w >> 7);
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
            const int sh = (q + 3 * k) & 31;      // the lag mod 32
            const uint32_t blo = __funnelshift_r(lo[k], w, sh);
            const uint32_t bhi = __funnelshift_r(hi[k], ~w, sh);
            const uint32_t bv = __funnelshift_r(va[k], wv, sh);
            const uint32_t both = va[k] & bv;
            const uint32_t eq = both & ~((lo[k] ^ blo) | (hi[k] ^ bhi));
            num[k] += __popc(eq);
            if (DEN) den[k] += __popc(both);
            lo[k] = blo;
            hi[k] = bhi;
            va[k] = bv;
        }
    }
    int acc = 0;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc ^= num[k] ^ (den[k] << 8);
    if (acc == 0x7fffffff) out[0] = acc;  // keeps the work live
}

__global__ void __launch_bounds__(THREADS)
nw_rate_kernel(int steps, int q, int match, int mismatch, int gap_open,
               int gap_extend, int* out) {
    int h[CHAINS], hd[CHAINS], e[CHAINS], f[CHAINS], run[CHAINS];
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        h[k] = threadIdx.x + k;
        hd[k] = blockIdx.x + k;
        e[k] = k;
        f[k] = 2 * k + 1;
        run[k] = -k;
    }
    const int nge = -gap_extend;
    const int nmis = -mismatch;
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
        const int ramp = t * gap_extend;
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
            const int s = h[k] == q ? match : nmis;
            const int fn = __viaddmax_s32(f[k], nge, h[k] - gap_open);
            const int ht = max(hd[k] + s, fn);
            const int en = run[k] - gap_open - ramp;
            run[k] = max(run[k], ht + ramp);
            const int hn = max(ht, en);
            const int cs = hn == en ? 1 : hn == fn ? 2 : 3;
            const bool estay = en == e[k] + nge;
            const bool fstay = fn == f[k] + nge;
            acc += (unsigned)(cs | (estay << 2) | (fstay << 3));
            e[k] = en;
            f[k] = fn;
            hd[k] = h[k];
            h[k] = hn;
        }
    }
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) acc ^= h[k] ^ e[k] ^ f[k] ^ run[k];
    if (acc == 0x7fffffffu) out[0] = (int)acc;  // keeps the work live
}

__global__ void serial_step_kernel(int steps, double* out) {
    double f = 15.0;
    int pre = -1;
#pragma unroll 8
    for (int t = 0; t < steps; ++t) {
        const double alpha = static_cast<double>((t & 7) + 1);
        const double pen = __dmul_rn(alpha, 0.375);
        const double best = static_cast<double>(t >> 2) + 15.0;
        const double c = __dsub_rn(__dadd_rn(f, alpha), pen);
        const bool take = c > best;
        f = take ? c : best;
        pre = take ? t - 1 : pre;
    }
    if (f == -1.0 || pre == 0x7fffffff) out[0] = f;  // keeps the chain live
}

}  // namespace

// One warp running ``steps`` dependent steps of serial_step_kernel (see
// above).  Launches on ``stream`` and returns cudaGetLastError().
extern "C" int serial_step_launch(int steps, void* out, void* stream) {
    serial_step_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        steps, static_cast<double*>(out));
    return static_cast<int>(cudaGetLastError());
}

// Plain C entry point for ctypes: ``blocks`` blocks of THREADS threads, each
// running CHAINS cells for ``steps`` updates (a multiple of 4), in the DPX
// form when ``dpx`` is non-zero.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
extern "C" int cell_rate_launch(int dpx, int blocks, int steps, int q,
                                int match, int mismatch, int gap_open,
                                int gap_extend, void* out, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    auto* o = static_cast<int*>(out);
    if (dpx)
        cell_rate_kernel<true><<<blocks, THREADS, 0, st>>>(
            steps, q, match, mismatch, gap_open, gap_extend, o);
    else
        cell_rate_kernel<false><<<blocks, THREADS, 0, st>>>(
            steps, q, match, mismatch, gap_open, gap_extend, o);
    return static_cast<int>(cudaGetLastError());
}

// Cells one block updates per step.
extern "C" int cell_rate_block_cells() { return THREADS * CHAINS; }

// The same for the updates of collapse's kernels: ``kind`` 0 the edit
// distance's DP cell, 1 SW with traceback, 2 the bit-parallel edit
// distance's word, 3 the POA graph alignment's cell, 4 the chaining DP's
// candidate, 5 the tandem screen's window and lag, 6 the banded NW's cell
// with its code, 7 the lag profile's packed word, 8 that word without
// the valid pairs' popcount (see above).  Returns
// cudaErrorInvalidValue for another kind.
extern "C" int recurrence_rate_launch(int kind, int blocks, int steps, int q,
                                      int match, int mismatch, int gap_open,
                                      int gap_extend, void* out,
                                      void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    auto* o = static_cast<int*>(out);
    if (kind == 0)
        edit_rate_kernel<<<blocks, THREADS, 0, st>>>(steps, q, o);
    else if (kind == 1)
        tb_rate_kernel<<<blocks, THREADS, 0, st>>>(
            steps, q, match, mismatch, gap_open, gap_extend, o);
    else if (kind == 2)
        myers_rate_kernel<<<blocks, THREADS, 0, st>>>(steps, q, o);
    else if (kind == 3)
        poa_rate_kernel<<<blocks, THREADS, 0, st>>>(steps, q, match,
                                                    mismatch, o);
    else if (kind == 4)
        chain_rate_kernel<<<blocks, THREADS, 0, st>>>(steps, q, o);
    else if (kind == 5)
        screen_rate_kernel<<<blocks, THREADS, 0, st>>>(steps, q, o);
    else if (kind == 6)
        nw_rate_kernel<<<blocks, THREADS, 0, st>>>(
            steps, q, match, mismatch, gap_open, gap_extend, o);
    else if (kind == 7)
        lag_rate_kernel<true><<<blocks, THREADS, 0, st>>>(steps, q, o);
    else if (kind == 8)
        lag_rate_kernel<false><<<blocks, THREADS, 0, st>>>(steps, q, o);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
