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
