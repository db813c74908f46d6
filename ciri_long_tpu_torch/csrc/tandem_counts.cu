// Exact k-mer self-match counts per lag, over a range of lags, for Hopper.
//
// Replaces the XLA device program ciri_long_tpu/ops/period.py:85
// tandem_counts (:90 _tandem_counts_impl over :32 _chunked_lag_sum) with a
// lag offset: the 'lag' mesh axis's shard of the tandem profile in
// ciri_long_tpu/parallel/mesh.py:114 (make_pipeline_step).  Contract, for
// read b of width W (the row of ``reads``: codes 0-3 bases, 4 N, 5 PAD):
//   kid[i]     the base-4 id of the k-mer at i, valid when its k codes are
//              all < 4 and i <= W - k
//   out[b, j]  #{i : kid[i], kid[i + d] valid and equal}, d = lag_offset +
//              j + 1, j in 0..max_lag-1 (0 for d >= W)
//
// Design (reads of W <= MAX_W = 4 096, the screen's widest bucket): one
// block a read, which counts only the pairs of equal k-mers
// (csrc/kmer_pairs.h, the screen's count): the read's codes staged and one
// sorted 32-bit key hash(kid) << POS_BITS | i a valid window; over lags lo =
// lag_offset + 1 .. hi = min(lag_offset + max_lag, nwin - 1) (nwin the last
// valid window + 1: no loop passes it), the pair route walks each window's
// keys from the first at or past key + lo (a galloping search) to key + hi
// and checks the codes, or, when a thread would walk over WALK_CAP keys (a
// low-complexity read), the lag route counts LAGS lags a thread a pass of
// THREADS * LAGS lags over the valid windows below nwin - d, comparing the
// ids as float32 where they are exact (k <= 12: count_pairs<true>, on the
// FP32 pipe, twice the INT32 pipe's rate).  A read with no
// valid window or a range past nwin writes zeros and ends.  Then the row in
// coalesced stores, zeros past hi.  Shared memory: the codes, the keys and
// cnt over min(max_lag, W) lags, ~29 KB at W = 4 096 and 2 048 lags.
// Bound: the reads' bytes and the counts' (one read, one write), or the
// equal pairs in the range at csrc/op_rate.cu's compare rate; the pair
// route's cost is the sort, O(W log^2 W) shared-memory compare-exchanges a
// read, the lag route's the windows times the lags.
//
// The wide route, for reads wider than MAX_W (whose keys' POS_BITS and
// shared memory hold no more): one block a (read, chunk of WIDE_LAGS
// lags), thread t the chunk's lag t, every valid window against its
// partner at each lag, the k-mer ids rolled from the codes in global
// memory (k loads a window, from L1) into shared tiles of WIDE_TILE
// windows: A the windows p0 + x (-1 where invalid), B the partners p0 +
// dmin + x (-2 where invalid or past the last window), so an invalid id
// never equals anything.  Thread t compares A[x], four at a time as one
// 16-byte broadcast, with B[x + t]; no loop passes the read's windows.
// Work: the windows times the lags, the brute-force measure, at any
// width.  Shared memory: 4 (2 WIDE_TILE
// + WIDE_LAGS) bytes, 33 KB.

#include <cstdint>
#include <cuda_runtime.h>

#include "kmer_pairs.h"

namespace {

using namespace kmer;

// lags of cnt a launch keeps: hi - lo + 1 <= min(max_lag, nwin - 1) < W
__host__ __device__ constexpr int cnt_words(int W, int max_lag) {
    return max_lag < W ? max_lag : W;
}

__host__ __device__ constexpr int smem_bytes(int W, int max_lag) {
    return codes_bytes(W) + 4 * (keys_words(W) + cnt_words(W, max_lag));
}

__global__ void __launch_bounds__(THREADS)
tandem_counts_kernel(const int8_t* __restrict__ reads, int W, int k,
                     int lag_offset, int max_lag, int* __restrict__ out,
                     uint8_t* __restrict__ routes) {
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* codes = reinterpret_cast<int8_t*>(smem);
    uint32_t* keys = reinterpret_cast<uint32_t*>(smem + codes_bytes(W));
    int* cnt = reinterpret_cast<int*>(keys + keys_words(W));
    __shared__ Shared sh;
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    int* row = out + static_cast<int64_t>(b) * max_lag;

    const Windows win = write_keys(reads + static_cast<int64_t>(b) * W, W, k,
                                   codes, keys, sh);
    // lags lo..hi, both under W when the range is not empty
    const int64_t lo = static_cast<int64_t>(lag_offset) + 1;
    const int64_t want = static_cast<int64_t>(lag_offset) + max_lag;
    const int64_t hi = want < win.nwin - 1 ? want : win.nwin - 1;
    if (win.nvalid == 0 || lo > hi) {      // nothing to count
        for (int j = tid; j < max_lag; j += THREADS) row[j] = 0;
        if (tid == 0 && routes) routes[b] = 0;
        return;
    }
    const int n = static_cast<int>(hi - lo) + 1;
    for (int j = tid; j < n; j += THREADS) cnt[j] = 0;
    const bool lag_route = count_pairs<true>(codes, W, k, keys, win,
                                             static_cast<int>(lo),
                                             static_cast<int>(hi), cnt);
    for (int j = tid; j < max_lag; j += THREADS) row[j] = j < n ? cnt[j] : 0;
    if (tid == 0 && routes) routes[b] = lag_route ? 1 : 0;
}

constexpr int WIDE_LAGS = 256;             // lags a block, a thread each
constexpr int WIDE_TILE = 4096;            // windows a tile

// the id of the k-mer at i, -1 when a code of it is not < 4 (i + k <= W)
__device__ __forceinline__ int kmer_id(const int8_t* row, int64_t i, int k) {
    int id = 0;
    for (int j = 0; j < k; ++j) {
        const int c = row[i + j];
        if (c >= 4) return -1;
        id = (id << 2) | (c & 3);
    }
    return id;
}

__global__ void __launch_bounds__(WIDE_LAGS)
tandem_wide_kernel(const int8_t* __restrict__ reads, int W, int k,
                   int lag_offset, int max_lag, int* __restrict__ out,
                   uint8_t* __restrict__ routes) {
    __shared__ __align__(16) int sa[WIDE_TILE];
    __shared__ __align__(16) int sb[WIDE_TILE + WIDE_LAGS];
    const int b = blockIdx.x;
    const int t = threadIdx.x;
    const int j = blockIdx.y * WIDE_LAGS + t;          // this thread's lag
    const int64_t dmin = static_cast<int64_t>(lag_offset) + 1
                         + static_cast<int64_t>(blockIdx.y) * WIDE_LAGS;
    const int8_t* row = reads + static_cast<int64_t>(b) * W;
    const int64_t nw = static_cast<int64_t>(W) - k + 1;   // windows
    // windows p < nw - dmin have a partner window for some lag
    const int64_t span = nw - dmin;
    int cnt = 0;
    for (int64_t p0 = 0; p0 < span; p0 += WIDE_TILE) {
        for (int x = t; x < WIDE_TILE; x += WIDE_LAGS) {
            const int64_t p = p0 + x;
            sa[x] = p < nw ? kmer_id(row, p, k) : -1;
        }
        for (int x = t; x < WIDE_TILE + WIDE_LAGS; x += WIDE_LAGS) {
            const int64_t p = p0 + dmin + x;
            const int id = p < nw ? kmer_id(row, p, k) : -1;
            sb[x] = id < 0 ? -2 : id;
        }
        __syncthreads();
        const int n = static_cast<int>(span - p0 < WIDE_TILE ? span - p0
                                                               : WIDE_TILE);
        const int4* a4 = reinterpret_cast<const int4*>(sa);
        const int* bt = sb + t;
        for (int x = 0; x < n; x += 4) {
            const int4 a = a4[x >> 2];
            cnt += (a.x == bt[x]) + (a.y == bt[x + 1]) + (a.z == bt[x + 2])
                   + (a.w == bt[x + 3]);
        }
        __syncthreads();
    }
    if (j < max_lag) out[static_cast<int64_t>(b) * max_lag + j] = cnt;
    if (routes && blockIdx.y == 0 && t == 0) routes[b] = 2;
}

}  // namespace

// reads int8 [B, W], out int32 [B, max_lag]; lags lag_offset + 1 ..
// lag_offset + max_lag.  ``routes`` (B bytes, or null) gets 1 for a read
// that took the lag route, 0 for the pair route or nothing to count, 2 for
// the wide route, which every read of a launch with W > MAX_W takes.
// Returns the cudaError of the launch (0 on success);
// cudaErrorInvalidValue for W < 1, k outside 1..15, a negative lag_offset,
// max_lag < 1, or, on the wide route, more than 65 535 chunks of lags.
extern "C" int tandem_counts_launch(const void* reads, int B, int W, int k,
                                    int lag_offset, int max_lag, void* out,
                                    void* routes, void* stream) {
    if (B == 0) return 0;
    if (W < 1 || k < 1 || k > 15 || lag_offset < 0 || max_lag < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W > MAX_W) {
        const int chunks = (max_lag + WIDE_LAGS - 1) / WIDE_LAGS;
        if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
        tandem_wide_kernel<<<dim3(B, chunks), WIDE_LAGS, 0, st>>>(
            static_cast<const int8_t*>(reads), W, k, lag_offset, max_lag,
            static_cast<int*>(out), static_cast<uint8_t*>(routes));
        return static_cast<int>(cudaGetLastError());
    }
    const int smem = smem_bytes(W, max_lag);
    cudaError_t err = cudaFuncSetAttribute(
        tandem_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tandem_counts_kernel<<<B, THREADS, smem, st>>>(
        static_cast<const int8_t*>(reads), W, k, lag_offset, max_lag,
        static_cast<int*>(out), static_cast<uint8_t*>(routes));
    return static_cast<int>(cudaGetLastError());
}
