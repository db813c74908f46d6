// The CCS tandem pre-screen for Hopper: which reads may hold a tandem
// period that the host's lag voting could elect.
//
// Replaces the XLA device program ciri_long_tpu/ops/period.py::screen_keep
// (tandem_counts, :90 _tandem_counts_impl over :32 _chunked_lag_sum, fused
// with the support election; ROADMAP X3).  Contract, for read b of width W
// (the row of ``reads``, codes 0-3 bases, 4 N, 5 PAD), length L = len[b]
// and lag range M = max_lag[b] (the JAX bucket's b // 2, not L // 2: the
// support windows clip at M):
//   kid[i]   the base-4 id of the k-mer at i, valid when its k codes are all
//            < 4 and i <= W - k
//   cnt[d]   #{i : kid[i], kid[i + d] valid and equal}, d in 1..M
//   sup[l]   cs[hi[l]] - cs[lo[l] - 1], cs the inclusive prefix sum of cnt
//            (cs[0] = 0), lo = clip(lo_raw[l], 1, M + 1), hi = clip(hi_raw[l],
//            0, M), the raw windows ceil(0.94 l - 4) and floor(1.06 l + 4)
//            as numpy's float64 gives them, computed by the host and uploaded
//   keep[b]  any l in 1..M with l >= min_period, float32(l) * min_units <=
//            float32(L), sup[l] >= 8 and 20 sup[l] >= L.
//
// Design: one block a read (W <= MAX_W); cnt counts only the pairs of equal
// k-mers, which are few in all but low-complexity reads.
//   1. The read's codes are staged in shared memory (16-byte words when W
//      allows); thread t rolls the k-mer ids of its run of ceil(W /
//      THREADS) windows twice: to count its valid ones, then, at a block
//      scan's offset, to write one 32-bit key a valid window, hash(kid) <<
//      POS_BITS | i, in position order (hash: Fibonacci hashing of kid to
//      HASH_BITS bits).  A read with no valid window ends here: all its
//      supports are 0.
//   2. The keys are bitonic-sorted in shared memory (the next power of two
//      of the valid windows), so windows of one hash lie together by
//      position and key + M bounds the windows within M lags of a window.
//   3. Route, per read: each thread counts the keys its windows (sorted
//      index t, t + THREADS, ...) would walk; if any thread passes
//      WALK_CAP, the read is low-complexity (a poly-A, a short repeat) and
//      takes the lag route, else the pair route.
//   4. Pair route: each sorted window walks forward through the keys up to
//      key + M and, where the two windows' codes are equal (the hash can
//      collide), adds one to cnt[d] with a shared-memory atomic.  Lag
//      route: kid by position replaces the keys; thread t owns lags 8t + 1
//      .. 8t + 8 and walks the valid windows i while i + 8t + 1 < nwin,
//      comparing kid[i] (a broadcast) with kid[i + d] from eight registers
//      that slide one window a step (one load a window): the lag-parallel
//      count.
//   5. A block scan of cnt gives cs and one __syncthreads_or the election.
// Shared memory: the codes, the keys and cs, ~29 KB at W = 4 096, seven
// blocks an SM.  Bound: the reads' bytes, or the equal pairs at
// csrc/op_rate.cu's compare rate; the pair route's cost is the sort,
// O(W log^2 W) shared-memory compare-exchanges a read, the lag route's the
// windows times the lags.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_W = 4096;                // the largest screen bucket
constexpr int MAX_LAG = MAX_W / 2;
constexpr int LAGS = MAX_LAG / THREADS;    // lags a thread on the lag route
constexpr int POS_BITS = 13;               // position + MAX_LAG < 2^POS_BITS
constexpr int HASH_BITS = 32 - POS_BITS;
constexpr uint32_t POS_MASK = (1u << POS_BITS) - 1;
constexpr int WALK_CAP = 256;              // keys a thread walks, pair route
constexpr int PAD = 2 * LAGS;              // -1s past kid on the lag route
static_assert(MAX_W + MAX_LAG <= (1 << POS_BITS), "key positions overflow");
static_assert(LAGS == 8, "the lag route slides eight registers");

__host__ __device__ constexpr int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// bytes of dynamic shared memory a read of width W takes: its codes (16-
// byte words), the keys (which the lag route overwrites with kid and PAD
// entries of -1 past it), cnt / cs
__host__ __device__ constexpr int codes_bytes(int W) {
    return (W + 15) / 16 * 16;
}
__host__ __device__ constexpr int keys_words(int W) {
    return pow2_at_least(W) > W + PAD
               ? (pow2_at_least(W) > THREADS ? pow2_at_least(W) : THREADS)
               : (W + PAD > THREADS ? W + PAD : THREADS);
}
__host__ __device__ constexpr int smem_bytes(int W) {
    return codes_bytes(W) + 4 * (keys_words(W) + MAX_LAG + 1);
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

__global__ void __launch_bounds__(THREADS)
screen_keep_kernel(const int8_t* __restrict__ reads, int W,
                   const int* __restrict__ lens,
                   const int* __restrict__ max_lag,
                   const int* __restrict__ lo_raw,
                   const int* __restrict__ hi_raw, int k, int min_period,
                   float min_units, uint8_t* __restrict__ keep,
                   uint8_t* __restrict__ routes) {
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* codes = reinterpret_cast<int8_t*>(smem);
    uint32_t* keys = reinterpret_cast<uint32_t*>(smem + codes_bytes(W));
    int* cs = reinterpret_cast<int*>(keys + keys_words(W));
    __shared__ int warp_tot[THREADS / 32];
    __shared__ int last_valid;
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int8_t* x = reads + static_cast<int64_t>(b) * W;
    const int L = lens[b];
    const int M = max_lag[b];
    if (tid == 0) last_valid = -1;
    if (W % 16 == 0 && (reinterpret_cast<uintptr_t>(reads) & 15) == 0) {
        const int4* x4 = reinterpret_cast<const int4*>(x);
        int4* c4 = reinterpret_cast<int4*>(codes);
        for (int i = tid; i < W / 16; i += THREADS) c4[i] = x4[i];
    } else {
        for (int i = tid; i < W; i += THREADS) codes[i] = x[i];
    }
    __syncthreads();

    // 1. this thread's run of windows: its valid count, then its keys at
    // the block scan's offset
    const int run = (W + THREADS - 1) / THREADS;
    const int i_lo = min(tid * run, W);
    const int i_hi = min(i_lo + run, W);
    int n_valid = 0, my_last = -1;
    for_each_window(codes, W, k, i_lo, i_hi, [&](int i, uint32_t) {
        ++n_valid;
        my_last = i;
    });
    atomicMax(&last_valid, my_last);
    int r = block_scan(n_valid, warp_tot) - n_valid;
    int nvalid = 0;
    for (int w = 0; w < THREADS / 32; ++w) nvalid += warp_tot[w];
    if (nvalid == 0) {                     // no k-mer: every support is 0
        if (tid == 0) {
            keep[b] = 0;
            if (routes) routes[b] = 0;
        }
        return;
    }
    for_each_window(codes, W, k, i_lo, i_hi, [&](int i, uint32_t id) {
        keys[r++] = hash_kid(id) << POS_BITS | static_cast<uint32_t>(i);
    });
    const int P = max(pow2_at_least(nvalid), THREADS);
    for (int s = nvalid + tid; s < P; s += THREADS) keys[s] = 0xffffffffu;
    for (int d = tid; d <= MAX_LAG; d += THREADS) cs[d] = 0;
    __syncthreads();
    const int nwin = last_valid + 1;       // windows past it are invalid

    // 2. bitonic sort of the P keys (P = THREADS * E, E a power of two)
    switch (P / THREADS) {
    case 1: block_sort<1>(keys); break;
    case 2: block_sort<2>(keys); break;
    case 4: block_sort<4>(keys); break;
    case 8: block_sort<8>(keys); break;
    default: block_sort<16>(keys); break;
    }

    // 3. the route: the keys each thread's windows walk, capped
    int walked = 0;
    for (int s = tid; s < nvalid && walked <= WALK_CAP; s += THREADS) {
        const uint32_t lim = keys[s] + static_cast<uint32_t>(M);
        for (int s2 = s + 1; s2 < nvalid && keys[s2] <= lim &&
                             walked <= WALK_CAP;
             ++s2)
            ++walked;
    }
    const bool lag_route = __syncthreads_or(walked > WALK_CAP);

    if (!lag_route) {
        // 4a. pair route: the equal k-mers within M lags of each window
        // (equal hashes, then equal codes)
        for (int s = tid; s < nvalid; s += THREADS) {
            const uint32_t key = keys[s];
            const uint32_t lim = key + static_cast<uint32_t>(M);
            const int p = static_cast<int>(key & POS_MASK);
            for (int s2 = s + 1; s2 < nvalid; ++s2) {
                const uint32_t k2 = keys[s2];
                if (k2 > lim) break;
                const int p2 = static_cast<int>(k2 & POS_MASK);
                bool same = true;
                for (int j = 0; j < k && same; ++j)
                    same = codes[p + j] == codes[p2 + j];
                if (same) atomicAdd(&cs[p2 - p], 1);
            }
        }
    } else {
        // 4b. lag route: kid over the keys (every thread is past the keys'
        // last read, the barrier above), -1 for invalid windows and PAD
        // past the read
        int* kid = reinterpret_cast<int*>(keys);
        for (int i = i_lo; i < i_hi; ++i) kid[i] = -1;
        if (tid < PAD) kid[W + tid] = -1;
        for_each_window(codes, W, k, i_lo, i_hi, [&](int i, uint32_t id) {
            kid[i] = static_cast<int>(id);
        });
        __syncthreads();
        // thread t's lags d = at + s (at = 8 t + 1) compare kid[i] (a
        // broadcast) with w[u + s] = kid[i0 + at + u + s] for window
        // i = i0 + u, while some lag of the thread stays below nwin
        const int at = LAGS * tid + 1;
        if (at <= M && at < nwin) {
            int cnt[LAGS];
            int w[2 * LAGS];
#pragma unroll
            for (int s = 0; s < LAGS; ++s) {
                cnt[s] = 0;
                w[s] = kid[at + s];
            }
            for (int i0 = 0; i0 + at < nwin; i0 += LAGS) {
#pragma unroll
                for (int s = 0; s < LAGS; ++s)
                    w[LAGS + s] = kid[i0 + at + LAGS + s];
#pragma unroll
                for (int u = 0; u < LAGS; ++u) {
                    const int xi = kid[i0 + u];  // the same for every thread
                    if (xi < 0) continue;
#pragma unroll
                    for (int s = 0; s < LAGS; ++s) cnt[s] += w[u + s] == xi;
                }
#pragma unroll
                for (int s = 0; s < LAGS; ++s) w[s] = w[LAGS + s];
            }
#pragma unroll
            for (int s = 0; s < LAGS; ++s) cs[at + s] = cnt[s];
        }
    }
    __syncthreads();

    // 5. inclusive scan of cs[1..MAX_LAG] (thread t's run is lags
    // t*LAGS+1 .. t*LAGS+LAGS), then the election
    int runv[LAGS];
    int tot = 0;
#pragma unroll
    for (int s = 0; s < LAGS; ++s) {
        runv[s] = cs[tid * LAGS + 1 + s];
        tot += runv[s];
    }
    int before = block_scan(tot, warp_tot) - tot;
#pragma unroll
    for (int s = 0; s < LAGS; ++s) {
        before += runv[s];
        cs[tid * LAGS + 1 + s] = before;
    }
    __syncthreads();

    bool any = false;
    const float Lf = static_cast<float>(L);
    for (int l = tid + 1; l <= M; l += THREADS) {
        const int lo = min(max(lo_raw[l - 1], 1), M + 1);
        const int hi = min(max(hi_raw[l - 1], 0), M);
        const int sup = cs[hi] - cs[lo - 1];
        const bool valid = l >= min_period &&
                           __fmul_rn(static_cast<float>(l), min_units) <= Lf;
        any |= valid && sup >= 8 && 20 * sup >= L;
    }
    any = __syncthreads_or(any);
    if (tid == 0) {
        keep[b] = any ? 1 : 0;
        if (routes) routes[b] = lag_route ? 1 : 0;
    }
}

}  // namespace

// One block a read of ``reads`` [B, W] (W <= MAX_W, every max_lag in
// 1..MAX_LAG, which ops/period.py checks); lo_raw and hi_raw hold the raw
// support windows of lags 1..max(max_lag).  ``routes`` (B bytes, or null)
// gets 1 for a read that took the lag route, 0 for the pair route.
// Launches on ``stream`` and returns cudaGetLastError().
extern "C" int screen_keep_launch(const void* reads, int B, int W,
                                  const void* lens, const void* max_lag,
                                  const void* lo_raw, const void* hi_raw,
                                  int k, int min_period, float min_units,
                                  void* keep, void* routes, void* stream) {
    if (B == 0) return 0;
    if (W > MAX_W || k < 1 || k > 15)
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = smem_bytes(W);
    cudaError_t err = cudaFuncSetAttribute(
        screen_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    screen_keep_kernel<<<B, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(reads), W, static_cast<const int*>(lens),
        static_cast<const int*>(max_lag), static_cast<const int*>(lo_raw),
        static_cast<const int*>(hi_raw), k, min_period, min_units,
        static_cast<uint8_t*>(keep), static_cast<uint8_t*>(routes));
    return static_cast<int>(cudaGetLastError());
}
