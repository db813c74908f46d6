// Exact k-mer self-match counts per lag, over a range of lags, for Hopper.
//
// Replaces the XLA device program ciri_long_tpu/ops/period.py:85
// tandem_counts (:90 _tandem_counts_impl over :32 _chunked_lag_sum) with a
// lag offset: the 'lag' mesh axis's shard of the tandem profile in
// ciri_long_tpu/parallel/mesh.py:114 (make_pipeline_step).  Contract, for
// read b of width W (the row of ``reads``: int8 codes, 0-3 bases, 4 N, 5
// PAD):
//   kid[i]     JAX's int32 id of the k-mer at i, kid*4 + c over its codes
//              (wrapping), valid when its k codes are all < 4 (signed) and
//              i <= W - k
//   out[b, j]  #{i : kid[i], kid[i + d] valid and equal}, d = lag_offset +
//              j + 1, j in 0..max_lag-1 (0 for d >= W)
//
// Design: csrc/lag_planes.h's packed lag primitive at any width, one block
// a (segment of seg windows, chunk of 2 048 lags, read), 512 threads, a
// lane four lags 32 apart; the codes as bit planes, the equal codes of a
// lag 32 positions a word, their k-runs by doubling (k <= 15: up to three
// levels and a last shift), one popcount a word and lag; each warp stops
// at the read's last valid window.  Its cost is the (window, lag) pairs of
// the range, whatever the read holds.  The wrapper (ops/period.py::
// lag_plan) picks seg so that a few reads still cover the SMs; with more
// than one segment a read the blocks add their counts to ``out`` (zeroed)
// with integer atomics.  A read that holds a code outside 0..5 (a negative
// code is valid to JAX and its ids wrap, so equal ids need not be equal
// codes and the planes' bits are not its ids) takes the value route: brute
// force with the ids rolled by value (lag_planes.h's value_lags), its reads
// counted on the card in ``tally``.
//
// An earlier design sorted the k-mer keys of reads of up to 4 096 codes
// and counted only the equal pairs (csrc/kmer_pairs.h, the screen's count).
// That wins on random reads over a whole range of 2 048 lags (0.12 ms
// against 0.25 at 1 104 x 4 096, H100 80GB HBM3, 700 W) but sorts again for
// every lag range of the mesh's shards and falls back to every lag on
// low-complexity reads (1.15 ms there); the planes' cost follows the
// range.
//
// Bound: the reads' bytes and the counts' (one read, one write), or the
// equal pairs in the range at csrc/op_rate.cu's compare rate.

#include <cstdint>
#include <cuda_runtime.h>

#include "lag_planes.h"

namespace {

// lag_planes.h's counts of one block (LEVELS: the k-run's doubling levels,
// k in 2^LEVELS .. 2^(LEVELS+1) - 1), stored, or added to the zeroed out
// with more than one segment a read.
template <int LEVELS>
__global__ void __launch_bounds__(lagp::THREADS, 2)
tandem_counts_kernel(const int8_t* __restrict__ reads, int W, int k,
                     int lag_offset, int max_lag, int seg, int nseg,
                     int* __restrict__ out, uint8_t* __restrict__ routes,
                     int* __restrict__ tally) {
    __shared__ lagp::Planes pl;
    __shared__ int end;
    const int b = blockIdx.x / nseg;
    const int64_t p0 = static_cast<int64_t>(blockIdx.x % nseg) * seg;
    const int64_t dmin = static_cast<int64_t>(lag_offset) + 1
                         + static_cast<int64_t>(blockIdx.y) * lagp::CHUNK;
    const int8_t* row = reads + static_cast<int64_t>(b) * W;
    if (threadIdx.x == 0) end = 0;
    int num[lagp::LANE_LAGS] = {}, den[lagp::LANE_LAGS] = {};
    const bool odd = lagp::row_odd(row, W);
    if (threadIdx.x == 0 && blockIdx.x % nseg == 0 && blockIdx.y == 0) {
        if (routes) routes[b] = odd ? 1 : 0;
        if (odd) lagp::tally_read(tally);
    }
    if (odd)
        lagp::value_lags(row, W, k, p0, seg, dmin, num, den);
    else
        lagp::packed_lags<false, LEVELS>(row, W, k, p0, seg, dmin, pl, &end,
                                         num, den);
    const int j = blockIdx.y * lagp::CHUNK
                  + lagp::WARP_LAGS * (threadIdx.x >> 5)
                  + (threadIdx.x & 31);
    int* orow = out + static_cast<int64_t>(b) * max_lag;
#pragma unroll
    for (int m = 0; m < lagp::LANE_LAGS; ++m) {
        const int jm = j + 32 * m;
        if (jm >= max_lag) continue;
        if (nseg == 1)
            orow[jm] = num[m];
        else if (num[m])
            atomicAdd(&orow[jm], num[m]);
    }
}

}  // namespace

// reads int8 [B, W], out int32 [B, max_lag]; lags lag_offset + 1 ..
// lag_offset + max_lag, seg windows a block (a multiple of 32 up to 4 096;
// out zeroed when W > seg).  ``routes`` (B bytes, or null) gets each read's
// route: 0 the bit planes, 1 the value route (a read with a code outside
// 0..5).  tally (one int32, or null) gets one more for each read that took
// the value route.  Returns the cudaError of the launch (0 on success);
// cudaErrorInvalidValue for W < 1, k outside 1..15, a negative lag_offset,
// max_lag < 1, a bad seg or more than 65 535 chunks of lags.
extern "C" int tandem_counts_launch(const void* reads, int B, int W, int k,
                                    int lag_offset, int max_lag, int seg,
                                    void* out, void* routes, void* tally,
                                    void* stream) {
    if (B == 0) return 0;
    const int chunks = (max_lag + lagp::CHUNK - 1) / lagp::CHUNK;
    if (W < 1 || k < 1 || k > 15 || lag_offset < 0 || max_lag < 1
        || seg < 32 || seg % 32 || seg > lagp::SEG_MAX || chunks > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const int nseg = (W + seg - 1) / seg;
    if (static_cast<int64_t>(B) * nseg > 0x7fffffff)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int8_t* r = static_cast<const int8_t*>(reads);
    int* o = static_cast<int*>(out);
    uint8_t* ro = static_cast<uint8_t*>(routes);
    int* ta = static_cast<int*>(tally);
    const dim3 grid(B * nseg, chunks);
    if (k >= 8)
        tandem_counts_kernel<3><<<grid, lagp::THREADS, 0, st>>>(
            r, W, k, lag_offset, max_lag, seg, nseg, o, ro, ta);
    else if (k >= 4)
        tandem_counts_kernel<2><<<grid, lagp::THREADS, 0, st>>>(
            r, W, k, lag_offset, max_lag, seg, nseg, o, ro, ta);
    else if (k >= 2)
        tandem_counts_kernel<1><<<grid, lagp::THREADS, 0, st>>>(
            r, W, k, lag_offset, max_lag, seg, nseg, o, ro, ta);
    else
        tandem_counts_kernel<0><<<grid, lagp::THREADS, 0, st>>>(
            r, W, k, lag_offset, max_lag, seg, nseg, o, ro, ta);
    return static_cast<int>(cudaGetLastError());
}
