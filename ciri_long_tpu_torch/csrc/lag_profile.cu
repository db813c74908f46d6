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
// Design: one block a (read, chunk of LAGS lags), thread t the chunk's lag
// t; positions in tiles of TILE.  The block stages the tile's codes twice
// as bytes in shared memory, the positions p0 + x (A, an invalid code as
// 0x10) and the partners p0 + dmin + x (B, an invalid code as 0x20; dmin
// the chunk's first lag, partners past W invalid), so that an invalid code
// never equals anything.  Thread t compares four positions a step: A's word
// x / 4 (the same for every thread: a broadcast) against the four bytes of
// B at x + t (a funnel shift of two words, the shift t mod 4 fixed for the
// thread, one new word a step), with the SIMD byte compares __vcmpeq4 (the
// matches) and __vcmplts4 (valid: signed < 4, both sides); the counts are
// popcounts of the byte masks, 8 a position.  Any width works: a tile is
// TILE positions whatever W is.  Bound: the (position, lag) pairs with both
// codes valid, each one compare, at csrc/op_rate.cu's screen-compare rate,
// or the bytes (the reads once, the fractions once) at 3.35 TB/s; a SIMD
// word does four pairs in ~10 instructions.  The tiles stop at the read's
// last valid code (found first, a pass over the row): a PAD tail costs one
// load a code, not a compare a lag.  Smem: TILE + TILE + LAGS + 16 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LAGS = 256;                  // lags a block, a thread each
constexpr int TILE = 4096;                 // positions a tile
constexpr int B_BYTES = TILE + LAGS + 16;  // partners a tile, one word spare
constexpr uint8_t BAD_A = 0x10;
constexpr uint8_t BAD_B = 0x20;
constexpr unsigned FOURS = 0x04040404u;

__global__ void __launch_bounds__(LAGS)
lag_profile_kernel(const int8_t* __restrict__ reads, int W, int lag_offset,
                   int max_lag, float* __restrict__ out) {
    __shared__ __align__(16) uint8_t sa[TILE];
    __shared__ __align__(16) uint8_t sb[B_BYTES];
    const int b = blockIdx.x;
    const int t = threadIdx.x;
    const int j = blockIdx.y * LAGS + t;               // this thread's lag
    const int64_t dmin = static_cast<int64_t>(lag_offset) + 1
                         + static_cast<int64_t>(blockIdx.y) * LAGS;
    const int8_t* row = reads + static_cast<int64_t>(b) * W;
    // the read's last valid code + 1: no pair past it counts (a PAD tail)
    __shared__ int end;
    if (t == 0) end = 0;
    __syncthreads();
    int mine = 0;
    for (int p = t; p < W; p += LAGS)
        if (row[p] < 4) mine = p + 1;
    atomicMax(&end, mine);
    __syncthreads();
    // positions p < end - dmin have a valid partner for some lag
    const int64_t span = static_cast<int64_t>(end) - dmin;
    const uint32_t* wa = reinterpret_cast<const uint32_t*>(sa);
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(sb);
    const int q = t >> 2;                              // B's word offset
    const int shift = 8 * (t & 3);
    unsigned num = 0, den = 0;
    for (int64_t p0 = 0; p0 < span; p0 += TILE) {
        for (int x = t; x < TILE; x += LAGS) {
            const int64_t p = p0 + x;
            const int c = p < end ? row[p] : 4;
            sa[x] = c < 4 ? static_cast<uint8_t>(c) : BAD_A;
        }
        for (int x = t; x < B_BYTES; x += LAGS) {
            const int64_t p = p0 + dmin + x;
            const int c = p < end ? row[p] : 4;
            sb[x] = c < 4 ? static_cast<uint8_t>(c) : BAD_B;
        }
        __syncthreads();
        const int words = static_cast<int>(
            (span - p0 < TILE ? span - p0 : TILE) + 3) / 4;
        uint32_t lo = wb[q];
        for (int w = 0; w < words; ++w) {
            const uint32_t hi = wb[q + w + 1];
            const uint32_t a = wa[w];
            const uint32_t v = __funnelshift_r(lo, hi, shift);
            num += __popc(__vcmpeq4(a, v));
            den += __popc(__vcmplts4(a, FOURS) & __vcmplts4(v, FOURS));
            lo = hi;
        }
        __syncthreads();
    }
    if (j < max_lag) {
        const float n = static_cast<float>(num >> 3);
        const float d = static_cast<float>(den >> 3 > 0 ? den >> 3 : 1);
        out[static_cast<int64_t>(b) * max_lag + j] = __fdiv_rn(n, d);
    }
}

}  // namespace

// reads int8 [B, W], out float32 [B, max_lag]; lags lag_offset + 1 ..
// lag_offset + max_lag.  Returns the cudaError of the launch (0 on
// success); cudaErrorInvalidValue for W < 1, a negative lag_offset or
// max_lag < 1, or more than 65 535 chunks of lags.
extern "C" int lag_profile_launch(const void* reads, int B, int W,
                                  int lag_offset, int max_lag, void* out,
                                  void* stream) {
    if (B == 0) return 0;
    if (W < 1 || lag_offset < 0 || max_lag < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int chunks = (max_lag + LAGS - 1) / LAGS;
    if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
    lag_profile_kernel<<<dim3(B, chunks), LAGS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(reads), W, lag_offset, max_lag,
        static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
