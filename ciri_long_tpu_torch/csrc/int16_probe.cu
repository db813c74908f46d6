// Packed 16-bit and 8-bit vector probes for Hopper.
//
// Replaces the six Pallas probes of misc/int16_probe.py (``run`` at :39, its
// pallas_call at :41, kernel bodies :20-37), which asked Mosaic whether the
// TPU's vector unit takes int16 and int8 lanes.  Here the same six questions
// go to Hopper's SIMD-within-a-register instructions, two int16 (or four
// int8) lanes in each 32-bit register:
//   0 int16 add 1              __vadd2
//   1 int16 max with 3         __vmaxs2
//   2 int16 where(x>0, x, -1)  __vcmpgts2 mask and select
//   3 int16 roll by 1, axis 1  one block per row: a lane's word takes the
//                              high half of the word before it, from lane-1
//                              by __shfl_up_sync, across warps (and the wrap
//                              from the row's last word) through shared memory
//   4 int8 add 1               __vadd4
//   5 bitcast int16 pairs to int32: the register is already the int32 (the
//     pair's first int16 is the low half, little-endian as in
//     lax.bitcast_convert_type), so the kernel copies the word.
//
// Bound: bytes; each word is read once and written once, one to three
// integer operations per word.
//
// int16_probe_all_launch runs all six in one launch (the redesign: each
// probe moves 128-512 KB, so six launches cost six times the card's
// per-launch floor, far more than their bytes): the grid's blocks are split
// by probe, an elementwise probe's blocks taking VEC words a thread in one
// 16-byte load and store, the roll's rows taking one block each.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;

template <int PROBE>
__global__ void __launch_bounds__(THREADS)
probe_elementwise(const unsigned* __restrict__ x, unsigned* __restrict__ out,
                  int n_words) {
    const int w = blockIdx.x * THREADS + threadIdx.x;
    if (w >= n_words) return;
    const unsigned v = x[w];
    unsigned y;
    if (PROBE == 0) {
        y = __vadd2(v, 0x00010001u);
    } else if (PROBE == 1) {
        y = __vmaxs2(v, 0x00030003u);
    } else if (PROBE == 2) {
        const unsigned keep = __vcmpgts2(v, 0u);  // 0xffff where x > 0
        y = (v & keep) | ~keep;                   // else 0xffff = -1
    } else if (PROBE == 4) {
        y = __vadd4(v, 0x01010101u);
    } else {
        y = v;
    }
    out[w] = y;
}

// One block per row of ``row_words`` words (a multiple of 32, at most 1024).
__global__ void probe_roll16(const unsigned* __restrict__ x,
                             unsigned* __restrict__ out, int row_words) {
    __shared__ unsigned words[1024];
    const int w = threadIdx.x;
    const size_t base = (size_t)blockIdx.x * row_words;
    const unsigned cur = x[base + w];
    words[w] = cur;
    __syncthreads();
    unsigned prev = __shfl_up_sync(FULL, cur, 1);
    if ((w & 31) == 0) prev = words[(w + row_words - 1) % row_words];
    // low half: element 2w-1, the high half of the word before; high half:
    // element 2w, the low half of this word
    out[base + w] = (cur << 16) | (prev >> 16);
}

constexpr int PROBES = 6;
constexpr int VEC = 4;            // words a thread of an elementwise probe

// The elementwise probes' word operation (probe 3, the roll, is not one).
__device__ __forceinline__ unsigned word_op(int probe, unsigned v) {
    switch (probe) {
        case 0: return __vadd2(v, 0x00010001u);
        case 1: return __vmaxs2(v, 0x00030003u);
        case 2: {
            const unsigned keep = __vcmpgts2(v, 0u);
            return (v & keep) | ~keep;
        }
        case 4: return __vadd4(v, 0x01010101u);
        default: return v;
    }
}

struct AllProbes {
    const unsigned* x[PROBES];
    unsigned* out[PROBES];
    int n_words[PROBES];
    int first_block[PROBES + 1];   // probe p runs blocks [first, next first)
    int row_words;                 // the roll's row, at most THREADS
};

__global__ void __launch_bounds__(THREADS) probe_all(AllProbes a) {
    __shared__ unsigned words[THREADS];
    int p = 0;
    while (blockIdx.x >= a.first_block[p + 1]) ++p;   // uniform in a block
    const int blk = blockIdx.x - a.first_block[p];
    const unsigned* x = a.x[p];
    unsigned* out = a.out[p];
    const int t = threadIdx.x;
    if (p == 3) {
        const int rw = a.row_words;
        const size_t base = (size_t)blk * rw;
        const unsigned cur = t < rw ? x[base + t] : 0u;
        words[t] = cur;
        __syncthreads();
        unsigned prev = __shfl_up_sync(FULL, cur, 1);
        if ((t & 31) == 0) prev = words[(t + rw - 1) % rw];
        if (t < rw) out[base + t] = (cur << 16) | (prev >> 16);
        return;
    }
    const int n = a.n_words[p];
    const int w0 = (blk * THREADS + t) * VEC;
    if (w0 + VEC <= n) {
        uint4 v = *reinterpret_cast<const uint4*>(x + w0);
        v.x = word_op(p, v.x);
        v.y = word_op(p, v.y);
        v.z = word_op(p, v.z);
        v.w = word_op(p, v.w);
        *reinterpret_cast<uint4*>(out + w0) = v;
    } else {
        for (int w = w0; w < n; ++w) out[w] = word_op(p, x[w]);
    }
}

}  // namespace

// Plain C entry point for ctypes: probe 0-5 as listed above over ``n_words``
// 32-bit words (rows of ``row_words`` words for the roll).  Launches on
// ``stream`` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an unknown probe or a roll row it does not take.
extern "C" int int16_probe_launch(int probe, const void* x, void* out,
                                  int n_words, int row_words, void* stream) {
    if (n_words <= 0) return 0;
    const auto* xin = static_cast<const unsigned*>(x);
    auto* y = static_cast<unsigned*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    const int blocks = (n_words + THREADS - 1) / THREADS;
    switch (probe) {
        case 0: probe_elementwise<0><<<blocks, THREADS, 0, st>>>(xin, y, n_words); break;
        case 1: probe_elementwise<1><<<blocks, THREADS, 0, st>>>(xin, y, n_words); break;
        case 2: probe_elementwise<2><<<blocks, THREADS, 0, st>>>(xin, y, n_words); break;
        case 3:
            if (row_words <= 0 || row_words > 1024 || row_words % 32 != 0 ||
                n_words % row_words != 0)
                return static_cast<int>(cudaErrorInvalidValue);
            probe_roll16<<<n_words / row_words, row_words, 0, st>>>(
                xin, y, row_words);
            break;
        case 4: probe_elementwise<4><<<blocks, THREADS, 0, st>>>(xin, y, n_words); break;
        case 5: probe_elementwise<5><<<blocks, THREADS, 0, st>>>(xin, y, n_words); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// All six probes in one launch: ``xs`` and ``outs`` the six probes' word
// arrays (16-byte aligned, as PyTorch allocates them), ``n_words`` their
// sizes, the roll's rows of ``row_words`` words (a multiple of 32, at most
// THREADS).  Launches on ``stream`` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a roll row it does not take.
extern "C" int int16_probe_all_launch(const void* const* xs,
                                      void* const* outs, const int* n_words,
                                      int row_words, void* stream) {
    if (row_words <= 0 || row_words > THREADS || row_words % 32 != 0 ||
        n_words[3] % row_words != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    AllProbes a;
    a.row_words = row_words;
    a.first_block[0] = 0;
    for (int p = 0; p < PROBES; ++p) {
        a.x[p] = static_cast<const unsigned*>(xs[p]);
        a.out[p] = static_cast<unsigned*>(outs[p]);
        a.n_words[p] = n_words[p];
        const int blocks = p == 3 ? n_words[p] / row_words
                                  : (n_words[p] + THREADS * VEC - 1) /
                                        (THREADS * VEC);
        a.first_block[p + 1] = a.first_block[p] + blocks;
    }
    if (a.first_block[PROBES] == 0) return 0;
    probe_all<<<a.first_block[PROBES], THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}
