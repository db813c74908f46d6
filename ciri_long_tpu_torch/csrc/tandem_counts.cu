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
// Design: one block a (read, chunk of LAG_BLOCK lags).  The block stages
// the read's codes and then its k-mer ids in shared memory (an invalid
// window is -1; PAD_KID entries of -1 past W, so a lag group may read past
// the read's end), 5 bytes a code, 20 KB at MAX_W.  Each warp takes groups
// of GROUP consecutive lags: lane l walks windows i = l, l + 32, ... below
// W - d0 (d0 the group's first lag), loads kid[i] once and compares it with
// kid[i + d0 + g] for the GROUP lags g, then a warp reduction a lag.  The
// work is every (window, lag) pair: the reads' bytes are few, so the bound
// is those compares at csrc/op_rate.cu's screen-compare rate; GROUP lags a
// load of kid[i] keep shared-memory loads at 1 + 1/GROUP a compare.
// Every block recomputes its read's ids (k shared-memory loads a window),
// small beside LAG_BLOCK lags of compares.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_W = 4096;                 // the largest screen bucket
constexpr int GROUP = 4;                    // lags a warp compares at once
constexpr int LAG_BLOCK = 256;              // lags a block
constexpr int PAD_KID = GROUP;              // -1 ids past W

__host__ __device__ constexpr int codes_bytes(int W) {
    return (W + 15) / 16 * 16;
}

__host__ __device__ constexpr int smem_bytes(int W) {
    return codes_bytes(W) + 4 * (W + PAD_KID);
}

__global__ void __launch_bounds__(THREADS)
tandem_counts_kernel(const int8_t* __restrict__ reads, int W, int k,
                     int lag_offset, int max_lag, int chunks,
                     int* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* codes = reinterpret_cast<int8_t*>(smem);
    int* kid = reinterpret_cast<int*>(smem + codes_bytes(W));

    const int b = blockIdx.x / chunks;
    const int chunk = blockIdx.x % chunks;
    const int8_t* row = reads + static_cast<int64_t>(b) * W;
    for (int i = threadIdx.x; i < W; i += THREADS) codes[i] = row[i];
    __syncthreads();
    for (int i = threadIdx.x; i < W + PAD_KID; i += THREADS) {
        int id = -1;
        if (i <= W - k) {
            id = 0;
            for (int t = 0; t < k; ++t) {
                const int c = codes[i + t];
                if (c < 0 || c > 3) { id = -1; break; }
                id = id * 4 + c;
            }
        }
        kid[i] = id;
    }
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int j_end = min(max_lag, (chunk + 1) * LAG_BLOCK);
    int* out_row = out + static_cast<int64_t>(b) * max_lag;
    for (int j0 = chunk * LAG_BLOCK + warp * GROUP; j0 < j_end;
         j0 += WARPS * GROUP) {
        const int d0 = lag_offset + j0 + 1;
        int cnt[GROUP] = {};
        // i + d0 + g <= W - 1 + GROUP - 1 < W + PAD_KID: inside kid
        for (int i = lane; i < W - d0; i += 32) {
            const int a = kid[i];
            if (a < 0) continue;
#pragma unroll
            for (int g = 0; g < GROUP; ++g) cnt[g] += kid[i + d0 + g] == a;
        }
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
            int c = cnt[g];
            for (int s = 16; s > 0; s >>= 1)
                c += __shfl_down_sync(0xffffffffu, c, s);
            if (lane == 0 && j0 + g < j_end) out_row[j0 + g] = c;
        }
    }
}

}  // namespace

// reads int8 [B, W], out int32 [B, max_lag]; lags lag_offset + 1 ..
// lag_offset + max_lag.  Returns the cudaError of the launch (0 on
// success); cudaErrorInvalidValue for W outside 1..MAX_W, k outside
// 1..15, a negative lag_offset or max_lag < 1.
extern "C" int tandem_counts_launch(const void* reads, int B, int W, int k,
                                    int lag_offset, int max_lag, void* out,
                                    void* stream) {
    if (B == 0) return 0;
    if (W < 1 || W > MAX_W || k < 1 || k > 15 || lag_offset < 0
        || max_lag < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int chunks = (max_lag + LAG_BLOCK - 1) / LAG_BLOCK;
    const int64_t blocks = static_cast<int64_t>(B) * chunks;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    tandem_counts_kernel<<<static_cast<unsigned>(blocks), THREADS,
                           smem_bytes(W),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(reads), W, k, lag_offset, max_lag, chunks,
        static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}
