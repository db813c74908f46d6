// Match fractions of a read against itself at every lag of a range, for
// Hopper.
//
// Replaces the XLA device program ciri_long_tpu/ops/period.py:55
// lag_profile (its lag loop :32 _chunked_lag_sum, run twice: the matches
// and the valid pairs).  Contract, for read b of width W (the row of
// ``reads``, int8 codes, valid when < 4 as a signed byte: 0-3 bases, 4 N, 5
// PAD), d = lag_offset + j + 1 for j in 0..max_lag-1:
//   num[j]    #{i : i + d < W, codes i and i + d both valid and equal}
//   den[j]    #{i : i + d < W, codes i and i + d both valid}
//   out[b, j] num / max(den, 1), one IEEE float32 division (__fdiv_rn) of
//             the two counts converted to float32, as JAX's
//             num / jnp.maximum(den, 1).astype(float32): bit-equal (the
//             counts are exact integers under 2^24 for W under 2^24)
// A lag past the read gives 0 / 1 = 0.
//
// Design: csrc/lag_planes.h with k = 1: one block a (segment of seg
// positions, chunk of 2 048 lags, read), 512 threads, a lane four lags 32
// apart; the read's codes as three bit planes (bit 0, bit 1, valid) in
// shared memory, 32 (position, lag) pairs a step of a lane (a funnel shift
// of the partner's words, eq = VA & VB & ~((LA ^ LB) | (HA ^ HB)), num +=
// popc(eq), den += popc(VA & VB)); a read holding a code outside 0..5 (a
// negative code is valid and compares by value) takes the value route,
// signed compares of the codes, its reads counted on the card in
// ``tally``.  The
// wrapper (ops/period.py::lag_plan) picks seg from the launch's shape, so
// that a few wide reads still cover the SMs: with one segment a read the
// block writes its fractions; with more, each block adds its counts to
// ``acc`` (int32 [B, max_lag, 2], zeroed, then B x chunks arrival counts,
// zeroed) with integer atomics, exact and order-free, and the last block
// of a (read, chunk) to arrive divides.  Bound: the valid pairs at
// csrc/op_rate.cu's packed lag rate (kind 7: a word of 32 pairs, three
// funnel shifts, the logic, two popcounts), or the bytes (the reads once,
// the fractions once) at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

#include "lag_planes.h"

namespace {

using namespace lagp;

__global__ void __launch_bounds__(THREADS, 2)
lag_profile_kernel(const int8_t* __restrict__ reads, int W, int lag_offset,
                   int max_lag, int seg, int nseg, float* __restrict__ out,
                   int* __restrict__ acc, int* __restrict__ tally) {
    __shared__ Planes pl;
    __shared__ int end;
    __shared__ bool last;
    const int b = blockIdx.x / nseg;
    const int64_t p0 = static_cast<int64_t>(blockIdx.x % nseg) * seg;
    const int64_t dmin = static_cast<int64_t>(lag_offset) + 1
                         + static_cast<int64_t>(blockIdx.y) * CHUNK;
    const int8_t* row = reads + static_cast<int64_t>(b) * W;
    if (threadIdx.x == 0) end = 0;
    int num[LANE_LAGS] = {}, den[LANE_LAGS] = {};
    if (row_odd(row, W)) {
        if (threadIdx.x == 0 && blockIdx.x % nseg == 0 && blockIdx.y == 0)
            tally_read(tally);
        value_lags(row, W, 1, p0, seg, dmin, num, den);
    } else {
        packed_lags<true, 0>(row, W, 1, p0, seg, dmin, pl, &end, num, den);
    }
    // this lane's lag j + 32 m
    const int j = blockIdx.y * CHUNK + WARP_LAGS * (threadIdx.x >> 5)
                  + (threadIdx.x & 31);
    float* orow = out + static_cast<int64_t>(b) * max_lag;
    if (nseg == 1) {
#pragma unroll
        for (int m = 0; m < LANE_LAGS; ++m)
            if (j + 32 * m < max_lag)
                orow[j + 32 * m] = __fdiv_rn(static_cast<float>(num[m]),
                                             static_cast<float>(
                                                 max(den[m], 1)));
        return;
    }
    int* arow = acc + 2 * static_cast<int64_t>(b) * max_lag;
#pragma unroll
    for (int m = 0; m < LANE_LAGS; ++m) {
        const int jm = j + 32 * m;
        if (jm < max_lag && num[m]) atomicAdd(&arow[2 * jm], num[m]);
        if (jm < max_lag && den[m]) atomicAdd(&arow[2 * jm + 1], den[m]);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned* arrived = reinterpret_cast<unsigned*>(
            acc + 2 * static_cast<int64_t>(gridDim.x / nseg) * max_lag);
        last = atomicAdd(&arrived[static_cast<int64_t>(b) * gridDim.y
                                  + blockIdx.y], 1u)
               == static_cast<unsigned>(nseg - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int m = 0; m < LANE_LAGS; ++m) {
        const int jm = j + 32 * m;
        if (jm < max_lag)
            orow[jm] = __fdiv_rn(static_cast<float>(__ldcg(&arow[2 * jm])),
                                 static_cast<float>(
                                     max(__ldcg(&arow[2 * jm + 1]), 1)));
    }
}

}  // namespace

// reads int8 [B, W], out float32 [B, max_lag]; lags lag_offset + 1 ..
// lag_offset + max_lag, seg positions a block (a multiple of 32 up to
// 4 096); acc int32, B max_lag 2 + B chunks words zeroed, when W > seg
// (else unused, may be null); tally (one int32, or null) gets one more for
// each read that took the value route.  Returns the cudaError of the
// launch (0 on success);
// cudaErrorInvalidValue for W < 1, a negative lag_offset, max_lag < 1, a
// bad seg, acc null when needed, or more than 65 535 chunks of lags.
extern "C" int lag_profile_launch(const void* reads, int B, int W,
                                  int lag_offset, int max_lag, int seg,
                                  void* out, void* acc, void* tally,
                                  void* stream) {
    if (B == 0) return 0;
    if (W < 1 || lag_offset < 0 || max_lag < 1 || seg < 32 || seg % 32
        || seg > SEG_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int chunks = (max_lag + CHUNK - 1) / CHUNK;
    const int nseg = (W + seg - 1) / seg;
    if (chunks > 65535 || static_cast<int64_t>(B) * nseg > 0x7fffffff
        || (nseg > 1 && !acc))
        return static_cast<int>(cudaErrorInvalidValue);
    lag_profile_kernel<<<dim3(B * nseg, chunks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(reads), W, lag_offset, max_lag, seg, nseg,
        static_cast<float*>(out), static_cast<int*>(acc),
        static_cast<int*>(tally));
    return static_cast<int>(cudaGetLastError());
}
