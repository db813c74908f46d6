// One read against itself at a range of lags, on packed bit planes, for
// Hopper: the shared body of csrc/lag_profile.cu (the lag profile: codes,
// k = 1) and csrc/tandem_counts.cu (k-mer matches).  For read b of width
// W (int8 codes; 0-3 bases, 4 N, 5 PAD), a window i of k codes is valid
// when its codes are all < 4 (signed, as JAX's ``x < 4``) and i <= W - k,
// its id JAX's int32 base-4 id kid*4 + c (wrapping); a pair (i, i + d)
// counts in
//   den  when both windows are valid,
//   num  when, besides, their ids are equal.
//
// Block: a (segment of seg positions, chunk of CHUNK lags, read), THREADS
// threads (the launch picks seg from its shape); warp w owns the chunk's
// lags wb .. wb + 127 (wb = dmin + 128 w), lane l the lags wb + l + 32 m,
// m < LANE_LAGS.  Two routes, picked per read on the card (row_odd, one
// pass over the row):
//
// Packed route (every code in 0..5, where a window's ids are equal exactly
// when its codes are):
//   1. stage: the segment's positions and its partners as three bit planes
//      in shared memory, code bit 0 (L), code bit 1 (H) and valid (V), one
//      bit a position, 32 positions a word by __ballot_sync, zero past W;
//      one run of words from p0 when the partners' words start within the
//      segment's (lag offsets under the segment), else two.
//   2. step w of a lane: the positions p0 + 32 w .. + 31 (A's word w, the
//      same for every lane: a broadcast) against their partners at lag d:
//      a funnel shift of two partner words by d mod 32 (S_j, the lane's
//      shift fixed, one new word a plane a step, loaded by every lane of
//      the warp from one or two addresses).  The lane's lags 32 apart take
//      S_w .. S_w+3 from a ring of four registers a plane, so a step costs
//      3 shared loads and 3 funnel shifts for four lags.
//      eq = VA & VB & ~((LA ^ LB) | (HA ^ HB)): 1 where the two codes are
//      valid and equal.
//      Profile: num += popc(eq), den += popc(VA & VB).
//      k-mers: the k-run AND m[i] = eq[i] & .. & eq[i + k - 1] by doubling
//      (levels of 2, 4, 8 bits: level h + 1 = level h & level h shifted by
//      2^h, each word from its level's next word by a funnel shift, a
//      pipeline LEVELS + 1 words deep), then m = top & top shifted by k -
//      2^LEVELS; count += popc(m).  Exact: an invalid code, a position past
//      W and a window past W - k all hold a zero eq bit in the run.
//   Each warp stops at its last word with a partner at or below the last
//   valid code staged.
// Value route (a read with a code outside 0..5: a negative code is valid
// and its id wraps, which bit planes cannot hold): each lane walks its
// lags' windows of the segment with both ids rolled by value from the
// codes (kid_{i+1} = (kid_i - c_i 4^(k-1)) * 4 + c_{i+k}, uint32, as JAX's
// int32 wraps), brute force, any width.
//
// Work of the packed route: a (word, lag) pair costs ~9 integer operations
// and 2 popcounts (profile) or ~13 and 1 (k-mers); the bound is the valid
// pairs at csrc/op_rate.cu's packed lag rate (kind 7, 32 pairs a word).
// Shared memory: 3 planes of U_WORDS words, 4 KB.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lagp {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int LANE_LAGS = 4;                    // a lane's lags, 32 apart
constexpr int WARP_LAGS = 32 * LANE_LAGS;
constexpr int CHUNK = WARPS * WARP_LAGS;        // lags a block: 2 048
constexpr int SEG_MAX = 4096;                   // positions a block
constexpr int AHEAD = 4;                        // words past the segment
// a segment's words and its partners' words (the lanes' first partner
// word lies up to CHUNK / 32 - 3 words past the chunk's, the ring reads
// LANE_LAGS words ahead, one more for the funnel's high word)
__host__ __device__ constexpr int a_words(int seg) {
    return seg / 32 + AHEAD;
}
__host__ __device__ constexpr int b_words(int seg) {
    return (seg + CHUNK) / 32 + AHEAD + LANE_LAGS + 3;
}
constexpr int U_WORDS = a_words(SEG_MAX) + b_words(SEG_MAX);

struct Planes {
    uint32_t l[U_WORDS];                        // code bit 0
    uint32_t h[U_WORDS];                        // code bit 1
    uint32_t v[U_WORDS];                        // valid (0..3)
};

// One more read on the value route in *tally (may be null).
__device__ __forceinline__ void tally_read(int* tally) {
    if (tally) atomicAdd(tally, 1);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
    return a < b ? a : b;
}

// whether some byte of x, as an unsigned code, passes 5
__device__ __forceinline__ bool odd4(unsigned x) {
    return __vcmpgtu4(x, 0x05050505u) != 0;
}

// Whether row[0, W) holds a code outside 0..5, for the whole block (16-byte
// loads where the row allows); ends on a barrier.
__device__ __forceinline__ bool row_odd(const int8_t* __restrict__ row,
                                        int W) {
    const int tid = threadIdx.x;
    const int head = min(static_cast<int>(
        (16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15), W);
    bool odd = false;
    for (int i = tid; i < head; i += blockDim.x)
        odd |= static_cast<uint8_t>(row[i]) > 5;
    const int n16 = (W - head) / 16;
    const int4* v = reinterpret_cast<const int4*>(row + head);
    for (int i = tid; i < n16; i += blockDim.x) {
        const int4 x = v[i];
        odd |= odd4(x.x) | odd4(x.y) | odd4(x.z) | odd4(x.w);
    }
    for (int i = head + 16 * n16 + tid; i < W; i += blockDim.x)
        odd |= static_cast<uint8_t>(row[i]) > 5;
    return __syncthreads_or(odd);
}

// Stage n plane words from position pos (the row's codes, zero past W)
// into word at.. of the planes; end = max(end, the last valid position
// staged + 1).
__device__ __forceinline__ void stage(const int8_t* __restrict__ row, int W,
                                      int64_t pos, int n, Planes& pl, int at,
                                      int* end) {
    const int lane = threadIdx.x & 31;
    for (int i = threadIdx.x >> 5; i < n; i += WARPS) {
        const int64_t base = pos + 32LL * i;
        uint32_t bl = 0, bh = 0, bv = 0;
        if (base < W) {                         // the same for the warp
            const int64_t p = base + lane;
            const int c = p < W ? row[p] : 5;
            bv = __ballot_sync(FULL, static_cast<unsigned>(c) < 4u);
            bl = __ballot_sync(FULL, c & 1);
            bh = __ballot_sync(FULL, c & 2);
        }
        if (lane == 0) {
            pl.l[at + i] = bl;
            pl.h[at + i] = bh;
            pl.v[at + i] = bv;
            if (bv)
                atomicMax(end, static_cast<int>(base) + 32 - __clz(bv));
        }
    }
}

// The packed route's counts of this block's lanes (every code of the read
// in 0..5): lane lag wb + l + 32 m, m < LANE_LAGS, over the windows of
// [p0, p0 + seg).  PROFILE: num and den of the codes (k = 1, LEVELS 0);
// else num of the k-mers (k in 2^LEVELS .. 2^(LEVELS+1) - 1).
template <bool PROFILE, int LEVELS>
__device__ __forceinline__ void packed_lags(
        const int8_t* __restrict__ row, int W, int k, int64_t p0, int seg,
        int64_t dmin, Planes& pl, int* end, int (&num)[LANE_LAGS],
        int (&den)[LANE_LAGS]) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    // the partners' first word, in words past p0: one run of words when it
    // lies within the segment's, else a run of its own after the segment's
    const int64_t bw0 = dmin >> 5;
    const int aw = a_words(seg), bw = b_words(seg);
    int b_at;
    if (bw0 <= aw) {
        b_at = static_cast<int>(bw0);
        stage(row, W, p0, static_cast<int>(bw0) + bw, pl, 0, end);
    } else {
        b_at = aw;
        stage(row, W, p0, aw, pl, 0, end);
        stage(row, W, p0 + 32 * bw0, bw, pl, aw, end);
    }
    __syncthreads();
    const int64_t wb = dmin + static_cast<int64_t>(WARP_LAGS) * warp;
    // words with a window whose partner at the warp's first lag ends at or
    // before the last valid code staged
    const int64_t room = *end - (k - 1) - wb - p0;
    const int nw = room <= 0 ? 0
                             : static_cast<int>(min64((room + 31) >> 5,
                                                      seg >> 5));
    // profile: a step a word; k-mers: LEVELS + 1 more to drain the levels
    const int steps = PROFILE ? nw : (nw ? nw + LEVELS + 1 : 0);
    const int q = b_at + static_cast<int>(((wb + lane) >> 5) - bw0);
    const int s = static_cast<int>((wb + lane) & 31);
    const int fs = k - (1 << LEVELS);           // the last level's shift
    uint32_t lo[3], S[LANE_LAGS][3];
    uint32_t lv[LANE_LAGS][LEVELS + 1];         // the k-run's levels
#pragma unroll
    for (int m = 0; m < LANE_LAGS; ++m)
#pragma unroll
        for (int h = 0; h <= LEVELS; ++h) lv[m][h] = 0;
    lo[0] = pl.l[q];
    lo[1] = pl.h[q];
    lo[2] = pl.v[q];
#pragma unroll
    for (int j = 0; j < LANE_LAGS - 1; ++j) {
        const uint32_t hl = pl.l[q + j + 1], hh = pl.h[q + j + 1],
                       hv = pl.v[q + j + 1];
        S[j][0] = __funnelshift_r(lo[0], hl, s);
        S[j][1] = __funnelshift_r(lo[1], hh, s);
        S[j][2] = __funnelshift_r(lo[2], hv, s);
        lo[0] = hl;
        lo[1] = hh;
        lo[2] = hv;
    }
    for (int t = 0; t < steps; t += LANE_LAGS) {
#pragma unroll
        for (int u = 0; u < LANE_LAGS; ++u) {
            const int w = t + u;
            if (w >= steps) break;
            // S_{w+3} into the slot S_{w-1} held
            const int r = q + w + LANE_LAGS;
            const uint32_t hl = pl.l[r], hh = pl.h[r], hv = pl.v[r];
            const int NEW = (u + LANE_LAGS - 1) % LANE_LAGS;
            S[NEW][0] = __funnelshift_r(lo[0], hl, s);
            S[NEW][1] = __funnelshift_r(lo[1], hh, s);
            S[NEW][2] = __funnelshift_r(lo[2], hv, s);
            lo[0] = hl;
            lo[1] = hh;
            lo[2] = hv;
            const uint32_t al = pl.l[w], ah = pl.h[w], av = pl.v[w];
#pragma unroll
            for (int m = 0; m < LANE_LAGS; ++m) {
                const int o = (u + m) % LANE_LAGS;
                const uint32_t v = av & S[o][2];
                const uint32_t eq = v & ~((al ^ S[o][0]) | (ah ^ S[o][1]));
                if (PROFILE) {
                    num[m] += __popc(eq);
                    den[m] += __popc(v);
                } else {
                    uint32_t top = eq;
#pragma unroll
                    for (int h = 0; h < LEVELS; ++h) {
                        const uint32_t next =
                            lv[m][h] & __funnelshift_r(lv[m][h], top, 1 << h);
                        lv[m][h] = top;
                        top = next;
                    }
                    const uint32_t run =
                        lv[m][LEVELS]
                        & __funnelshift_r(lv[m][LEVELS], top, fs);
                    lv[m][LEVELS] = top;
                    if (w > LEVELS) num[m] += __popc(run);
                }
            }
        }
    }
}

// The value route of one pair of windows' range: num += #{i in [i0, i1):
// windows i and i + d valid and their ids equal by value}, den += the
// valid pairs; codes from ``row`` (global or shared memory), i1 + d <= W -
// k + 1.  The ids roll in uint32, JAX's int32 wrap.
__device__ __forceinline__ void value_pairs(const int8_t* row, int k,
                                            int64_t i0, int64_t i1,
                                            int64_t d, int& num, int& den) {
    if (i0 >= i1) return;
    uint32_t top = 1;                           // 4^(k-1)
    for (int j = 1; j < k; ++j) top *= 4u;
    uint32_t ka = 0, kb = 0;
    int bad_a = 0, bad_b = 0;                   // codes >= 4 in the window
    for (int j = 0; j < k; ++j) {
        const int ca = row[i0 + j], cb = row[i0 + d + j];
        ka = ka * 4u + static_cast<uint32_t>(ca);
        kb = kb * 4u + static_cast<uint32_t>(cb);
        bad_a += ca >= 4;
        bad_b += cb >= 4;
    }
    for (int64_t i = i0;; ++i) {
        if (bad_a == 0 && bad_b == 0) {
            ++den;
            num += ka == kb;
        }
        if (i + 1 >= i1) break;
        const int oa = row[i], na = row[i + k];
        const int ob = row[i + d], nb = row[i + d + k];
        ka = (ka - static_cast<uint32_t>(oa) * top) * 4u
             + static_cast<uint32_t>(na);
        kb = (kb - static_cast<uint32_t>(ob) * top) * 4u
             + static_cast<uint32_t>(nb);
        bad_a += (na >= 4) - (oa >= 4);
        bad_b += (nb >= 4) - (ob >= 4);
    }
}

// The value route's counts of this block's lanes, as packed_lags lays
// them out.
__device__ __forceinline__ void value_lags(const int8_t* __restrict__ row,
                                           int W, int k, int64_t p0, int seg,
                                           int64_t dmin,
                                           int (&num)[LANE_LAGS],
                                           int (&den)[LANE_LAGS]) {
    const int lane = threadIdx.x & 31;
    const int64_t wb = dmin + static_cast<int64_t>(WARP_LAGS)
                              * (threadIdx.x >> 5);
#pragma unroll
    for (int m = 0; m < LANE_LAGS; ++m) {
        const int64_t d = wb + lane + 32 * m;
        const int64_t i1 = min64(p0 + seg,
                                 static_cast<int64_t>(W) - k + 1 - d);
        value_pairs(row, k, p0, i1, d, num[m], den[m]);
    }
}

}  // namespace lagp
