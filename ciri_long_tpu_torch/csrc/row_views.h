// The host side of a native round over ragged row views, shared by
// csrc/sw_score_ends.cu (sw_rows_run) and csrc/edit_distance.cu
// (edit_rows_run).
//
// A round's rows come as two flat int8 code buffers and int32 views, four
// rows of B: a offsets, a lengths, b offsets, b lengths (ops/rows.py::Rows).
// The round copies the buffers, views and its small tables into pinned
// staging that its Stage owns and reuses across rounds, uploads them in
// one copy, and lays each group of rows out as the PAD-suffixed [n, La]
// and [n, Lb] arrays the kernels read (expand_kernel, a warp a row).  Its
// answers come back in one device-to-host copy into pinned memory and one
// blocking-sync event a round, then into the caller's array.  Device
// buffers grow on the stage's own stream and never shrink; every round ends
// synchronised, so pinned memory is never in use when the next round
// regrows it.
//
// Phases (steady clock, ns, what ops/rows.py's callers count as
// fuser.ns.*): upload, from the call to the upload enqueued (staging,
// plan, buffers); device_wait, from there to the event's return (the
// launches, the kernels, the download's copy); download, the answers from
// pinned memory into the caller's array.

#pragma once

#include <chrono>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace row_views {

constexpr int PAD_CODE = 5;
constexpr int EXPAND_WARPS = 8;      // rows a block of expand_kernel

// Rows [start, start + count) of a round, laid out as [count, la] codes at
// abase and [count, lb] at bbase of the round's padded buffers.
struct Group {
    long long start, count, la, lb, abase, bbase;
};

inline int64_t now_ns() {
    return static_cast<int64_t>(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now().time_since_epoch())
            .count());
}

inline size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

// Buffers start at 1 MB and double: a round never waits on a regrowth
// once the largest round has run.
constexpr size_t MIN_BYTES = 1 << 20;

inline size_t grown(size_t cap, size_t bytes) {
    size_t want = cap ? cap : MIN_BYTES;
    while (want < bytes) want *= 2;
    return want;
}

// A device buffer that grows (stream-ordered, on the stage's stream) and
// never shrinks.
struct DevBuf {
    void* ptr = nullptr;
    size_t cap = 0;

    cudaError_t reserve(size_t bytes, cudaStream_t st) {
        if (bytes <= cap) return cudaSuccess;
        const size_t want = grown(cap, bytes);
        if (ptr) cudaFreeAsync(ptr, st);
        ptr = nullptr;
        cap = 0;
        const cudaError_t err = cudaMallocAsync(&ptr, want, st);
        if (err == cudaSuccess) cap = want;
        return err;
    }

    template <typename T>
    T* at(size_t offset) const {
        return reinterpret_cast<T*>(static_cast<char*>(ptr) + offset);
    }
};

// What the rounds on one device reuse: pinned staging, device buffers, a
// stream of its own and a blocking-sync event.  It lives as long as the
// process.
struct Stage {
    int device = 0;
    cudaStream_t stream = nullptr;
    cudaEvent_t done = nullptr;
    void* host = nullptr;   // pinned: the inputs, then the answers
    size_t host_cap = 0;
    DevBuf in, pad, ints, scratch;

    cudaError_t reserve_host(size_t bytes) {
        if (bytes <= host_cap) return cudaSuccess;
        const size_t want = grown(host_cap, bytes);
        if (host) cudaFreeHost(host);
        host = nullptr;
        host_cap = 0;
        const cudaError_t err = cudaHostAlloc(&host, want,
                                              cudaHostAllocDefault);
        if (err == cudaSuccess) host_cap = want;
        return err;
    }

    template <typename T>
    T* host_at(size_t offset) const {
        return reinterpret_cast<T*>(static_cast<char*>(host) + offset);
    }
};

inline Stage* stage_new(int device) {
    if (cudaSetDevice(device) != cudaSuccess) return nullptr;
    Stage* s = new Stage;
    s->device = device;
    if (cudaStreamCreateWithFlags(&s->stream, cudaStreamNonBlocking) !=
            cudaSuccess ||
        cudaEventCreateWithFlags(
            &s->done, cudaEventBlockingSync | cudaEventDisableTiming) !=
            cudaSuccess) {
        if (s->stream) cudaStreamDestroy(s->stream);
        delete s;
        return nullptr;
    }
    return s;
}

// Copy n bytes of ``src`` (may be null when n is 0) to the staging at
// ``offset``; returns the offset past them, aligned.
inline size_t stage_bytes(Stage& s, size_t offset, const void* src,
                          size_t n) {
    if (n) std::memcpy(s.host_at<char>(offset), src, n);
    return align_up(offset + n);
}

// The answers: enqueue the download of ``bytes`` at ``dev`` into the
// staging at ``offset``, wait for the stream, then copy them to ``out``.
// Adds the wait (from ``since``) and the copy to phase[1] and phase[2].
inline cudaError_t finish_round(Stage& s, const void* dev, size_t bytes,
                                size_t offset, void* out, int64_t since,
                                double* phase) {
    cudaError_t err = cudaSuccess;
    if (bytes)
        err = cudaMemcpyAsync(s.host_at<char>(offset), dev, bytes,
                              cudaMemcpyDeviceToHost, s.stream);
    if (err == cudaSuccess) err = cudaEventRecord(s.done, s.stream);
    if (err == cudaSuccess) err = cudaEventSynchronize(s.done);
    const int64_t waited = now_ns();
    phase[1] += static_cast<double>(waited - since);
    if (err != cudaSuccess) return err;
    if (bytes) std::memcpy(out, s.host_at<char>(offset), bytes);
    phase[2] += static_cast<double>(now_ns() - waited);
    return cudaSuccess;
}

__device__ __forceinline__ int group_of(const Group* g, int G,
                                        long long row) {
    int k = 0;
    while (k + 1 < G && g[k + 1].start <= row) ++k;
    return k;
}

// Row ``row`` of views ([4][B]: a offsets, a lengths, b offsets, b
// lengths) copied into its group's padded rows, PAD past its length; a
// warp a row, EXPAND_WARPS rows a block.
__global__ void __launch_bounds__(EXPAND_WARPS * 32)
expand_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
              const int* __restrict__ views, int B,
              const Group* __restrict__ groups, int G, int8_t* apad,
              int8_t* bpad) {
    const int lane = threadIdx.x & 31;
    const long long row =
        (long long)blockIdx.x * EXPAND_WARPS + (threadIdx.x >> 5);
    if (row >= B) return;
    const Group g = groups[group_of(groups, G, row)];
    const long long k = row - g.start;
    const int8_t* sa = a + views[row];
    const int na = views[B + row];
    const int8_t* sb = b + views[2 * B + row];
    const int nb = views[3 * B + row];
    int8_t* da = apad + g.abase + k * g.la;
    int8_t* db = bpad + g.bbase + k * g.lb;
    for (long long x = lane; x < g.la; x += 32)
        da[x] = x < na ? sa[x] : (int8_t)PAD_CODE;
    for (long long x = lane; x < g.lb; x += 32)
        db[x] = x < nb ? sb[x] : (int8_t)PAD_CODE;
}

inline int expand_blocks(int B) {
    return (B + EXPAND_WARPS - 1) / EXPAND_WARPS;
}

}  // namespace row_views
