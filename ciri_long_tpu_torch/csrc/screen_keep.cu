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
// k-mers, which are few in all but low-complexity reads, by
// csrc/kmer_pairs.h over lags 1..min(M, nwin - 1): the codes staged, one
// sorted 32-bit key hash(kid) << POS_BITS | i a valid window, then the pair
// route (each window walks the keys of its hash up to key + M and checks
// the codes) or, when a thread would walk over WALK_CAP keys, the lag route
// (each thread counts LAGS lags over every window, as int32).  A read with
// no valid window ends after its keys: all its supports are 0.  Then a
// block scan of cnt gives cs and one __syncthreads_or the election.
// Shared memory: the codes, the keys and cs, ~29 KB at W = 4 096; 48
// registers a thread, five blocks an SM.  Bound: the reads' bytes, or the equal pairs at
// csrc/op_rate.cu's compare rate; the pair route's cost is the sort,
// O(W log^2 W) shared-memory compare-exchanges a read, the lag route's the
// windows times the lags.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_pairs.h"

namespace {

using namespace kmer;

constexpr int MAX_LAG = MAX_W / 2;
static_assert(MAX_LAG == THREADS * LAGS, "the scan takes LAGS lags a thread");

// bytes of dynamic shared memory a read of width W takes: its codes, its
// keys and cnt / cs
__host__ __device__ constexpr int smem_bytes(int W) {
    return codes_bytes(W) + 4 * (keys_words(W) + MAX_LAG + 1);
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
    __shared__ Shared sh;
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int L = lens[b];
    const int M = max_lag[b];

    // 1. the keys of the read's valid windows
    const Windows win = write_keys(reads + static_cast<int64_t>(b) * W, W, k,
                                   codes, keys, sh);
    if (win.nvalid == 0) {                 // no k-mer: every support is 0
        if (tid == 0) {
            keep[b] = 0;
            if (routes) routes[b] = 0;
        }
        return;
    }
    for (int d = tid; d <= MAX_LAG; d += THREADS) cs[d] = 0;

    // 2-4. cs[d] = the equal k-mer pairs at lag d, d in 1..M
    const bool lag_route = count_pairs(codes, W, k, keys, win, 1,
                                       min(M, win.nwin - 1), cs + 1);

    // 5. inclusive scan of cs[1..MAX_LAG] (thread t's run is lags
    // t*LAGS+1 .. t*LAGS+LAGS), then the election
    int runv[LAGS];
    int tot = 0;
#pragma unroll
    for (int s = 0; s < LAGS; ++s) {
        runv[s] = cs[tid * LAGS + 1 + s];
        tot += runv[s];
    }
    int before = block_scan(tot, sh.warp_tot) - tot;
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
