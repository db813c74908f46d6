// The exact k-mer self-match count of one read over a range of lags, for
// Hopper: the body of csrc/screen_keep.cu (the CCS screen, lags 1..M; its
// lag ranges from lo > 1 served csrc/tandem_counts.cu's earlier design).
// One block of THREADS threads a read of width W <= MAX_W (codes 0-3 bases,
// 4 N, 5 PAD):
//   kid[i]   the base-4 id of the k-mer at i, valid when its k codes are all
//            < 4 and i <= W - k; nwin = the last valid window + 1
//   cnt[d - lo] = #{i : kid[i], kid[i + d] valid and equal}, d in lo..hi
//            (lo >= 1, hi <= nwin - 1)
// Only the pairs of equal k-mers count, and they are few in all but
// low-complexity reads:
//   1. write_keys: the read's codes staged in shared memory (16-byte words
//      when W allows); thread t rolls the k-mer ids of its run of ceil(W /
//      THREADS) windows twice: to count its valid ones, then, at a block
//      scan's offset, to write one 32-bit key a valid window, hash(kid) <<
//      POS_BITS | i, in position order (hash: Fibonacci hashing of kid to
//      HASH_BITS bits).
//   2. count_pairs sorts the keys (bitonic, shared memory; the next power of
//      two of the valid windows), so windows of one hash lie together by
//      position and [key + lo, key + hi] holds the windows of that hash
//      lo..hi lags past a window (a position plus a lag stays under
//      2^POS_BITS: no carry into the hash).
//   3. The route: each thread counts the keys its sorted windows (t, t +
//      THREADS, ...) would walk, from the first key >= key + lo (a galloping
//      search from the next key, which stays inside the run of equal hashes)
//      to key + hi; if any thread passes WALK_CAP, the read is low-complexity
//      (a poly-A, a short repeat) and takes the lag route, else the pair
//      route.
//   4. Pair route: each sorted window walks those keys and, where the two
//      windows' codes are equal (the hash can collide), adds one to cnt[d -
//      lo] with a shared-memory atomic.
//   5. Lag route: kid by position replaces the keys; in each pass of PASS
//      lags, thread t owns lags at .. at + LAGS - 1 (at = lo + LAGS t + the
//      pass's start) and walks the windows i0 + u (u < LAGS) while i0 + at <
//      nwin, comparing kid[i] (a broadcast) with kid[i + d] from 2 LAGS
//      registers that slide LAGS windows a step (one load a window, two
//      16-byte loads a step), as int32.
// Work: the pair route is bound by its sort, O(W log^2 W) shared-memory
// compare-exchanges a read, and its walk, the equal pairs plus a search a
// window; the lag route by the valid windows times the lags.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace kmer {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_W = 4096;                // the largest screen bucket
constexpr int LAGS = 8;                    // lags a thread a pass, lag route
constexpr int PASS = THREADS * LAGS;       // lags a pass of the lag route
constexpr int POS_BITS = 13;               // position + lag < 2^POS_BITS
constexpr int HASH_BITS = 32 - POS_BITS;
constexpr uint32_t POS_MASK = (1u << POS_BITS) - 1;
constexpr int WALK_CAP = 256;              // keys a thread walks, pair route
constexpr int PAD = 2 * LAGS;              // -1s past kid on the lag route
constexpr int SLACK = 3;                   // kid's shift for 16-byte loads
static_assert(2 * MAX_W <= (1 << POS_BITS), "key positions overflow");
static_assert(LAGS == 8, "the lag route loads its lags as two int4");

__host__ __device__ constexpr int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// bytes of shared memory a read of width W takes for its codes (16-byte
// words), and words for its keys (which the lag route overwrites with kid,
// shifted by up to SLACK words, and PAD entries of -1 past it)
__host__ __device__ constexpr int codes_bytes(int W) {
    return (W + 15) / 16 * 16;
}
__host__ __device__ constexpr int keys_words(int W) {
    return pow2_at_least(W) > W + PAD + SLACK
               ? (pow2_at_least(W) > THREADS ? pow2_at_least(W) : THREADS)
               : (W + PAD + SLACK > THREADS ? W + PAD + SLACK : THREADS);
}

// The k-mer windows of this thread's run [i_lo, i_hi) of the read's codes,
// rolled: fn(i, id) for each valid window i (all k codes < 4, i <= W - k).
template <typename Fn>
__device__ __forceinline__ void for_each_window(const int8_t* codes, int W,
                                                int k, int i_lo, int i_hi,
                                                Fn fn) {
    const uint32_t mask = (1u << (2 * k)) - 1u;   // k <= 15
    uint32_t id = 0;
    int good = 0;                          // codes < 4 ending here
    for (int j = i_lo; j < min(i_lo + k - 1, W); ++j) {
        const int c = codes[j];
        id = ((id << 2) | static_cast<uint32_t>(c & 3)) & mask;
        good = c < 4 ? good + 1 : 0;
    }
    for (int i = i_lo; i < i_hi && i + k <= W; ++i) {
        const int c = codes[i + k - 1];
        id = ((id << 2) | static_cast<uint32_t>(c & 3)) & mask;
        good = c < 4 ? good + 1 : 0;
        if (good >= k) fn(i, id);
    }
}

__device__ __forceinline__ uint32_t hash_kid(uint32_t kid) {
    return (kid * 2654435761u) >> (32 - HASH_BITS);
}

// this thread's run of windows [i_lo, i_hi)
__device__ __forceinline__ int run_start(int W) {
    return min(static_cast<int>(threadIdx.x) * ((W + THREADS - 1) / THREADS),
               W);
}
__device__ __forceinline__ int run_end(int W) {
    return min(run_start(W) + (W + THREADS - 1) / THREADS, W);
}

// inclusive block scan of one int a thread; ``tot`` (a warp's total each)
// keeps the block's warp totals until the next call
__device__ __forceinline__ int block_scan(int x, int* tot) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) tot[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += tot[w];
    __syncthreads();
    return incl;
}

// Bitonic sort of keys[0, THREADS * E) ascending.  Warp w holds the
// segment [32 E w, 32 E (w + 1)), lane l its elements 32 E w + 32 j + l in
// registers: strides under 32 are shuffles, strides under 32 E exchanges
// between a thread's own registers, and only strides of a warp's segment
// or more go through shared memory, one block barrier a stage.
template <int E>
__device__ __forceinline__ void block_sort(uint32_t* keys) {
    constexpr int P = THREADS * E;
    constexpr int S = 32 * E;               // a warp's segment
    const int lane = threadIdx.x & 31;
    const int base = S * (threadIdx.x >> 5) + lane;
    uint32_t v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = keys[base + 32 * j];
    for (int size = 2; size <= P; size <<= 1) {
        if (size > S) {                     // strides size/2 .. S
#pragma unroll
            for (int j = 0; j < E; ++j) keys[base + 32 * j] = v[j];
            __syncthreads();
            for (int stride = size >> 1; stride >= S; stride >>= 1) {
                for (int c = threadIdx.x; c < P / 2; c += THREADS) {
                    const int lo = 2 * c - (c & (stride - 1));
                    const int hi = lo + stride;
                    const uint32_t a = keys[lo], b = keys[hi];
                    if ((a > b) == ((lo & size) == 0)) {
                        keys[lo] = b;
                        keys[hi] = a;
                    }
                }
                __syncthreads();
            }
#pragma unroll
            for (int j = 0; j < E; ++j) v[j] = keys[base + 32 * j];
        }
#pragma unroll
        for (int h = E / 2; h >= 1; h >>= 1) {  // strides 32 h
            if (64 * h > size) continue;
#pragma unroll
            for (int j = 0; j < E; ++j) {
                if ((j ^ h) <= j) continue;
                const bool asc = ((base + 32 * j) & size) == 0;
                const uint32_t a = v[j], b = v[j ^ h];
                v[j] = asc ? min(a, b) : max(a, b);
                v[j ^ h] = asc ? max(a, b) : min(a, b);
            }
        }
#pragma unroll
        for (int stride = 16; stride >= 1; stride >>= 1) {
            if (2 * stride > size) continue;
            const bool lower = (lane & stride) == 0;
#pragma unroll
            for (int j = 0; j < E; ++j) {
                const uint32_t other =
                    __shfl_xor_sync(0xffffffffu, v[j], stride);
                const bool asc = ((base + 32 * j) & size) == 0;
                v[j] = (lower == asc) ? min(v[j], other) : max(v[j], other);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) keys[base + 32 * j] = v[j];
    __syncthreads();
}

// the block's shared scalars
struct Shared {
    int warp_tot[WARPS];
    int last_valid;
};

struct Windows {
    int nvalid;                            // valid windows
    int nwin;                              // the last valid window + 1
};

// 1. Stage read x's codes and write the keys of its valid windows, then
// 0xffffffff up to the next power of two (at least THREADS); ends on a
// barrier.  A read with no valid window writes no key (nvalid 0).
__device__ __forceinline__ Windows write_keys(const int8_t* __restrict__ x,
                                              int W, int k, int8_t* codes,
                                              uint32_t* keys, Shared& sh) {
    const int tid = threadIdx.x;
    if (tid == 0) sh.last_valid = -1;
    if (W % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
        const int4* x4 = reinterpret_cast<const int4*>(x);
        int4* c4 = reinterpret_cast<int4*>(codes);
        for (int i = tid; i < W / 16; i += THREADS) c4[i] = x4[i];
    } else {
        for (int i = tid; i < W; i += THREADS) codes[i] = x[i];
    }
    __syncthreads();
    const int i_lo = run_start(W), i_hi = run_end(W);
    int n_valid = 0, my_last = -1;
    for_each_window(codes, W, k, i_lo, i_hi, [&](int i, uint32_t) {
        ++n_valid;
        my_last = i;
    });
    atomicMax(&sh.last_valid, my_last);
    int r = block_scan(n_valid, sh.warp_tot) - n_valid;
    Windows win{0, sh.last_valid + 1};
    for (int w = 0; w < WARPS; ++w) win.nvalid += sh.warp_tot[w];
    if (win.nvalid == 0) return win;
    for_each_window(codes, W, k, i_lo, i_hi, [&](int i, uint32_t id) {
        keys[r++] = hash_kid(id) << POS_BITS | static_cast<uint32_t>(i);
    });
    const int P = max(pow2_at_least(win.nvalid), THREADS);
    for (int s = win.nvalid + tid; s < P; s += THREADS) keys[s] = 0xffffffffu;
    __syncthreads();
    return win;
}

// the first s in [from, n) with keys[s] >= target, or n (keys ascending):
// doubling steps from ``from``, then a binary search of the last step
__device__ __forceinline__ int first_at_least(const uint32_t* keys, int from,
                                              int n, uint32_t target) {
    int lo = from, hi = from, step = 1;
    while (hi < n && keys[hi] < target) {
        lo = hi + 1;
        hi += step;
        step <<= 1;
    }
    hi = min(hi, n);
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < target) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// w[0, LAGS) = p[0, LAGS), p 16-byte aligned: two 16-byte loads (a warp's
// lanes read 8 words apart)
__device__ __forceinline__ void load_lags(const int* p, int* w) {
    const int4 a = reinterpret_cast<const int4*>(p)[0];
    const int4 b = reinterpret_cast<const int4*>(p)[1];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// 5. The lag route of count_pairs: kid over the keys (every thread
// is past the keys' last read), -1 for invalid windows and PAD past the
// read, shifted so that kid + at is 16-byte aligned for every thread's
// first lag at (at = lo mod 4).  Thread t's lags d = at + s compare kid[i]
// (a broadcast) with w[u + s] = kid[i0 + at + u + s] for window i = i0 +
// u, while some lag of the thread stays below nwin - i0; the reads stay
// under nwin + 2 LAGS <= W + PAD.
__device__ __forceinline__ void lag_count(const int8_t* codes, int W, int k,
                                          uint32_t* keys, int nwin, int lo,
                                          int hi, int* cnt) {
    int* kid = reinterpret_cast<int*>(keys) + (4 - lo % 4) % 4;
    const int i_lo = run_start(W), i_hi = run_end(W);
    for (int i = i_lo; i < i_hi; ++i) kid[i] = -1;
    if (static_cast<int>(threadIdx.x) < PAD) kid[W + threadIdx.x] = -1;
    for_each_window(codes, W, k, i_lo, i_hi, [&](int i, uint32_t id) {
        kid[i] = static_cast<int>(id);
    });
    __syncthreads();
    for (int at = lo + LAGS * static_cast<int>(threadIdx.x); at <= hi;
         at += PASS) {
        int c[LAGS];
        int w[2 * LAGS];
        load_lags(kid + at, w);
#pragma unroll
        for (int s = 0; s < LAGS; ++s) c[s] = 0;
        for (int i0 = 0; i0 + at < nwin; i0 += LAGS) {
            load_lags(kid + i0 + at + LAGS, w + LAGS);
#pragma unroll
            for (int u = 0; u < LAGS; ++u) {
                const int xi = kid[i0 + u];   // the same for every thread
                if (xi < 0) continue;
#pragma unroll
                for (int s = 0; s < LAGS; ++s) c[s] += w[u + s] == xi;
            }
#pragma unroll
            for (int s = 0; s < LAGS; ++s) w[s] = w[LAGS + s];
        }
#pragma unroll
        for (int s = 0; s < LAGS; ++s)
            if (at + s <= hi) cnt[at + s - lo] = c[s];
    }
}

// 2-5. cnt[d - lo] += the equal k-mer pairs at lag d, d in lo..hi (1 <= lo,
// 0 <= hi <= nwin - 1; lo > hi counts nothing), of the read whose codes and
// keys write_keys wrote (nvalid > 0); the caller has zeroed cnt[0, hi - lo]
// before this call's first barrier.  Returns true for the lag route; ends
// on a barrier.
__device__ __forceinline__ bool count_pairs(const int8_t* codes, int W,
                                            int k, uint32_t* keys,
                                            Windows win, int lo, int hi,
                                            int* cnt) {
    const int tid = threadIdx.x;
    const int nvalid = win.nvalid;
    // 2. bitonic sort of the P keys (P = THREADS * E, E a power of two)
    switch (max(pow2_at_least(nvalid), THREADS) / THREADS) {
    case 1: block_sort<1>(keys); break;
    case 2: block_sort<2>(keys); break;
    case 4: block_sort<4>(keys); break;
    case 8: block_sort<8>(keys); break;
    default: block_sort<16>(keys); break;
    }

    // 3. the route: the keys each thread's windows walk, capped (from lo =
    // 1 the walk starts at the next key, no search)
    int walked = 0;
    for (int s = tid; s < nvalid && walked <= WALK_CAP; s += THREADS) {
        const uint32_t key = keys[s];
        const uint32_t last = key + static_cast<uint32_t>(hi);
        for (int s2 = lo == 1 ? s + 1
                              : first_at_least(keys, s + 1, nvalid,
                                               key + static_cast<uint32_t>(lo));
             s2 < nvalid && keys[s2] <= last && walked <= WALK_CAP; ++s2)
            ++walked;
    }
    const bool lag_route = __syncthreads_or(walked > WALK_CAP);

    if (!lag_route) {
        // 4. pair route: the equal k-mers lo..hi lags past each window
        // (equal hashes, then equal codes)
        for (int s = tid; s < nvalid; s += THREADS) {
            const uint32_t key = keys[s];
            const uint32_t last = key + static_cast<uint32_t>(hi);
            const int p = static_cast<int>(key & POS_MASK);
            for (int s2 = lo == 1 ? s + 1
                                  : first_at_least(
                                        keys, s + 1, nvalid,
                                        key + static_cast<uint32_t>(lo));
                 s2 < nvalid; ++s2) {
                const uint32_t k2 = keys[s2];
                if (k2 > last) break;
                const int p2 = static_cast<int>(k2 & POS_MASK);
                bool same = true;
                for (int j = 0; j < k && same; ++j)
                    same = codes[p + j] == codes[p2 + j];
                if (same) atomicAdd(&cnt[p2 - p - lo], 1);
            }
        }
    } else {
        // 5. lag route
        lag_count(codes, W, k, keys, win.nwin, lo, hi, cnt);
    }
    __syncthreads();
    return lag_route;
}

}  // namespace kmer
