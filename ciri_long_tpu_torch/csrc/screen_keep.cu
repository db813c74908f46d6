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
// Design: one block a read (W <= MAX_W).  The block builds kid in shared
// memory (-1 for an invalid window, 4 bytes a position), finds the last
// valid window, then counts: thread t owns lags t + 1, t + 1 + THREADS, ...
// in registers and walks the windows i in order, comparing kid[i] (one
// shared-memory broadcast) with kid[i + d] (consecutive addresses across a
// warp, no bank conflict); an invalid kid[i] skips the step for the whole
// block.  The counts go to shared memory, a block scan (each thread's run
// of consecutive lags, then a warp scan of the run totals) gives cs, and
// the election is one __syncthreads_or.  Bound: the windows times the lags,
// one compare and add each (the sum over reads of (W - k + 1) * M), at
// csrc/op_rate.cu's int32 compare-add rate; the reads' bytes are small
// beside it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_W = 4096;                // the largest screen bucket
constexpr int MAX_LAG = MAX_W / 2;
constexpr int LAGS_A_THREAD = MAX_LAG / THREADS;

__global__ void __launch_bounds__(THREADS)
screen_keep_kernel(const int8_t* __restrict__ reads, int W,
                   const int* __restrict__ lens,
                   const int* __restrict__ max_lag,
                   const int* __restrict__ lo_raw,
                   const int* __restrict__ hi_raw, int k, int min_period,
                   float min_units, uint8_t* __restrict__ keep) {
    __shared__ int kid[MAX_W];
    __shared__ int cs[MAX_LAG + 1];
    __shared__ int warp_tot[THREADS / 32];
    __shared__ int last_valid;
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int8_t* x = reads + static_cast<int64_t>(b) * W;
    const int L = lens[b];
    const int M = max_lag[b];
    if (tid == 0) last_valid = -1;
    __syncthreads();

    int my_last = -1;
    for (int i = tid; i < W; i += THREADS) {
        int id = -1;
        if (i <= W - k) {
            id = 0;
            for (int j = 0; j < k; ++j) {
                const int c = x[i + j];
                if (c >= 4) {
                    id = -1;
                    break;
                }
                id = id * 4 + c;
            }
        }
        kid[i] = id;
        if (id >= 0) my_last = i;
    }
    atomicMax(&last_valid, my_last);
    __syncthreads();
    const int nwin = last_valid + 1;       // windows past it are invalid

    int cnt[LAGS_A_THREAD];
#pragma unroll
    for (int t = 0; t < LAGS_A_THREAD; ++t) cnt[t] = 0;
    for (int i = 0; i + 1 < nwin; ++i) {
        const int xi = kid[i];
        if (xi < 0) continue;              // the same for every thread
        const int room = nwin - i;         // lags d < room stay inside
#pragma unroll
        for (int t = 0; t < LAGS_A_THREAD; ++t) {
            const int d = tid + 1 + t * THREADS;
            if (d < room && d <= M) cnt[t] += kid[i + d] == xi;
        }
    }
    // cs[d] = cnt[d] first, lags beyond M stay 0
#pragma unroll
    for (int t = 0; t < LAGS_A_THREAD; ++t) cs[tid + 1 + t * THREADS] = cnt[t];
    if (tid == 0) cs[0] = 0;
    __syncthreads();

    // inclusive scan of cs[1..MAX_LAG]: thread t's run is lags
    // t*RUN+1 .. t*RUN+RUN
    constexpr int RUN = MAX_LAG / THREADS;
    int run[RUN];
    int tot = 0;
#pragma unroll
    for (int s = 0; s < RUN; ++s) {
        run[s] = cs[tid * RUN + 1 + s];
        tot += run[s];
    }
    int incl = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int before = incl - tot;
    for (int w = 0; w < warp; ++w) before += warp_tot[w];
#pragma unroll
    for (int s = 0; s < RUN; ++s) {
        before += run[s];
        cs[tid * RUN + 1 + s] = before;
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
    if (tid == 0) keep[b] = any ? 1 : 0;
}

}  // namespace

// One block a read of ``reads`` [B, W] (W <= MAX_W, every max_lag in
// 1..MAX_LAG, which ops/period.py checks); lo_raw and hi_raw hold the raw
// support windows of lags 1..max(max_lag).  Launches on ``stream`` and
// returns cudaGetLastError().
extern "C" int screen_keep_launch(const void* reads, int B, int W,
                                  const void* lens, const void* max_lag,
                                  const void* lo_raw, const void* hi_raw,
                                  int k, int min_period, float min_units,
                                  void* keep, void* stream) {
    if (B == 0) return 0;
    if (W > MAX_W || k < 1 || k > 15)
        return static_cast<int>(cudaErrorInvalidValue);
    screen_keep_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(reads), W, static_cast<const int*>(lens),
        static_cast<const int*>(max_lag), static_cast<const int*>(lo_raw),
        static_cast<const int*>(hi_raw), k, min_period, min_units,
        static_cast<uint8_t*>(keep));
    return static_cast<int>(cudaGetLastError());
}
