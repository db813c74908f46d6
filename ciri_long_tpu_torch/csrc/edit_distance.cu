// Batched unit-cost edit distance (Levenshtein) for Hopper, bit-parallel.
//
// Replaces the XLA device program ciri_long_tpu/ops/edit.py::
// edit_distance_batch_padded (a lax.scan over the rows of a with the
// insertions resolved by a cummin; ROADMAP X7).  Contract: for each pair p,
// out[p] = D(a[p, :alen[p]], b[p, :blen[p]]), equality on codes (N equals N,
// as edit.py:47 and native/alncore.cpp:17 have it); alen 0 gives blen and
// blen 0 gives alen.  Lengths are clamped to [0, La] and [0, Lb], so no
// length makes the kernel read outside its rows.  Codes are 0..7, the range
// of the match masks; the host driver (edit_rows_run) refuses any other
// code, and the kernel's ``& 7`` only keeps a refused code inside the mask
// table.
//
// Algorithm: Myers/Hyyro's blockwise bit-parallel recurrence, as the host
// runs it in native/alncore.cpp::edit_distance_pair, on 32-bit words.  The
// pattern x (n codes) lies along the bits, the text y (m codes) is read a
// column at a time; word w holds the vertical deltas Pv/Mv of rows
// 32w..32w+31 and a column's update of it takes the horizontal delta hin of
// the row above the word and gives hout, the delta at its top row.  Row 0 is
// D[0][c] = c, so the first word's hin is +1 in every column; the answer is
// n plus the horizontal deltas at row n, read at bit (n-1) % 32 of the top
// word (the bits above it never feed it: carries and shifts only go up).
// Edit distance is symmetric, so each pair picks which of a and b is the
// pattern.
//
// Two routes, chosen per pair by edit_rows_run's plan (one launch runs both
// lists; blocks [0, thread_blocks) take the first list):
//   thread  the shorter sequence fits one word (or either is empty): one
//           thread per pair, the shorter as the pattern, one word update a
//           column.  Every junction-curation pair of collapse (20 codes
//           against at most 50) takes it.
//   warp    both are longer than 32: one warp per pair, the longer as the
//           pattern (more lanes busy, fewer steps), lane w owning word w.
//           Lane w updates column c at step c + w, a diagonal over words:
//           hout goes to lane w + 1 by __shfl_up_sync beside the column's
//           code, so a pair takes about m + words steps, each covering 32
//           rows a lane.  Lane 0 takes the code (and, past the first group,
//           hin) from a chunk of 32 columns fetched one chunk ahead and
//           picked out with __shfl_sync.  Patterns over 32 words loop over
//           groups of 32 words; lane 31 hands each column's hout to the next
//           group through an int8 row of global scratch (column c is fetched
//           by step c - 32 and overwritten at step c + 31, so one row
//           suffices).
// The match masks Peq[code] of a lane's word live in shared memory,
// [8 codes][block threads] words, the lane's own column of the table (no
// bank conflicts).
//
// Bound: one word update (~17 integer instructions: the mask load, the
// Myers/Hyyro update, the two delta bits) per word and text column,
// sum(ceil(pattern / 32) * text) updates at csrc/op_rate.cu's register-only
// rate for that update (kind 2), against the codes read once and 4 bytes a
// pair written.  What the warp route adds on top is the two shuffles a step
// and the idle lanes of patterns under 1024 codes.

#include <algorithm>
#include <cstdint>
#include <vector>
#include <cuda_runtime.h>

#include "row_views.h"

namespace {

constexpr int THREADS = 128;               // a block of either route
constexpr int WARPS_PER_BLOCK = THREADS / 32;
constexpr int CODES = 8;                   // match masks: codes 0..7
constexpr unsigned FULL = 0xffffffffu;

// One text column's update of a 32-row word: the horizontal deltas of its
// rows before the shift into (ph, mh), and the new vertical deltas.
__device__ __forceinline__ void word_update(uint32_t eq, int hin,
                                            uint32_t& pv, uint32_t& mv,
                                            uint32_t& ph, uint32_t& mh) {
    const uint32_t xv = eq | mv;
    if (hin < 0) eq |= 1u;
    const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
    ph = mv | ~(xh | pv);
    mh = pv & xh;
    const uint32_t phs = (ph << 1) | (uint32_t)(hin > 0);
    const uint32_t mhs = (mh << 1) | (uint32_t)(hin < 0);
    pv = mhs | ~(xv | phs);
    mv = phs & xv;
}

// The delta at bit ``bit``: +1, 0 or -1.
__device__ __forceinline__ int delta_at(uint32_t ph, uint32_t mh, int bit) {
    return (int)((ph >> bit) & 1u) - (int)((mh >> bit) & 1u);
}

// Set the caller's column of the mask table for the ``len`` codes at x.
__device__ __forceinline__ void build_peq(uint32_t* peq, const int8_t* x,
                                          int len) {
#pragma unroll
    for (int k = 0; k < CODES; ++k) peq[k * THREADS] = 0u;
    for (int i = 0; i < len; ++i) peq[(x[i] & 7) * THREADS] |= 1u << i;
}

// One pair whose shorter sequence fits a word, on one thread.
__device__ void thread_pair(const int8_t* ar, int n, const int8_t* br, int m,
                            uint32_t* peq, int* out) {
    if (n == 0 || m == 0) {
        *out = n + m;
        return;
    }
    const int8_t* x = ar;                  // the pattern: the shorter
    const int8_t* y = br;
    if (m < n) {
        x = br;
        y = ar;
        const int t = n;
        n = m;
        m = t;
    }
    build_peq(peq, x, n);
    uint32_t pv = FULL, mv = 0u, ph, mh;
    const int top = n - 1;
    int score = n;
#pragma unroll 4
    for (int c = 0; c < m; ++c) {
        word_update(peq[(y[c] & 7) * THREADS], 1, pv, mv, ph, mh);
        score += delta_at(ph, mh, top);
    }
    *out = score;
}

// Column ``col`` of the text and, past the first group, the hin the last
// group left there, packed as code | (hin + 1) << 3; 0 past the text.
// ``edge`` is written by the sweep, so it is not declared __restrict__.
__device__ __forceinline__ int load_col(const int8_t* __restrict__ y,
                                        const int8_t* edge, int col, int m,
                                        bool first) {
    if (col >= m) return 0;
    const int hin = first ? 1 : edge[col];
    return (y[col] & 7) | ((hin + 1) << 3);
}

// One pair with both sequences over a word, on one warp.
__device__ void warp_pair(const int8_t* ar, int n, const int8_t* br, int m,
                          uint32_t* peq, int8_t* edge, int* out) {
    const int lane = threadIdx.x & 31;
    const int8_t* x = ar;                  // the pattern: the longer
    const int8_t* y = br;
    if (m > n) {
        x = br;
        y = ar;
        const int t = n;
        n = m;
        m = t;
    }
    const int words = (n + 31) >> 5;
    const int groups = (words + 31) >> 5;
    const int top_bit = (n - 1) & 31;
    int score = n;
    for (int g = 0; g < groups; ++g) {
        const int w = g * 32 + lane;       // this lane's word
        const int g_words = min(32, words - g * 32);
        const bool active = lane < g_words;
        const bool first = g == 0;
        const bool last = g + 1 == groups;
        const bool scorer = last && lane == g_words - 1;
        const bool hand_off = !last && lane == 31;
        build_peq(peq, x + w * 32, active ? min(32, n - w * 32) : 0);

        int cur = load_col(y, edge, lane, m, first);
        int nxt = load_col(y, edge, 32 + lane, m, first);
        uint32_t pv = FULL, mv = 0u;
        int pass = 0;                 // code | (hout + 1) << 3 to lane + 1
        const int chunks = (m + g_words + 30) >> 5;   // m + g_words - 1 steps
        for (int ch = 0; ch < chunks; ++ch) {
            if (ch > 0) {
                cur = nxt;
                nxt = load_col(y, edge, ch * 32 + 32 + lane, m, first);
            }
            // a fixed 32 steps, no branch in them, so the compiler unrolls
            // them (steps past the last column update no lane)
#pragma unroll
            for (int k = 0; k < 32; ++k) {
                const int from_chunk = __shfl_sync(FULL, cur, k);
                int in = __shfl_up_sync(FULL, pass, 1);
                if (lane == 0) in = from_chunk;
                const int c = ch * 32 + k - lane;   // this lane's column
                const bool live = active && (unsigned)c < (unsigned)m;
                const int code = in & 7;
                const int hin = (in >> 3) - 1;
                uint32_t npv = pv, nmv = mv, ph, mh;
                word_update(peq[code * THREADS], hin, npv, nmv, ph, mh);
                const int hout = delta_at(ph, mh, 31);
                if (live) {
                    pv = npv;
                    mv = nmv;
                    pass = code | ((hout + 1) << 3);
                }
                if (live && scorer) score += delta_at(ph, mh, top_bit);
                if (live && hand_off) edge[c] = (int8_t)hout;
            }
        }
        __syncwarp();  // lane 31's handoff row is complete for the next group
    }
    if (lane == ((words - 1) & 31)) *out = score;
}

__global__ void __launch_bounds__(THREADS)
edit_distance_kernel(const int8_t* __restrict__ a,
                     const int8_t* __restrict__ b,
                     const int* __restrict__ alen,
                     const int* __restrict__ blen, int La, int Lb,
                     const int* __restrict__ order, int n_thread, int n_warp,
                     int thread_blocks, int8_t* edge_rows, int edge_len,
                     int* __restrict__ out) {
    __shared__ uint32_t peq_s[CODES * THREADS];
    uint32_t* peq = peq_s + threadIdx.x;
    int slot, p;
    const bool by_thread = (int)blockIdx.x < thread_blocks;
    if (by_thread) {
        slot = blockIdx.x * THREADS + threadIdx.x;
        if (slot >= n_thread) return;
        p = order[slot];
    } else {
        slot = (blockIdx.x - thread_blocks) * WARPS_PER_BLOCK +
               (threadIdx.x >> 5);
        if (slot >= n_warp) return;        // whole warps leave together
        p = order[n_thread + slot];
    }
    const int n = min(max(alen[p], 0), La);
    const int m = min(max(blen[p], 0), Lb);
    const int8_t* ar = a + (size_t)p * La;
    const int8_t* br = b + (size_t)p * Lb;
    if (by_thread)
        thread_pair(ar, n, br, m, peq, out + p);
    else
        warp_pair(ar, n, br, m, peq, edge_rows + (size_t)slot * edge_len,
                  out + p);
}

}  // namespace

// One launch of edit_distance_kernel.  ``order`` lists the pairs of the
// thread route (``n_thread``, those whose shorter sequence is at most 32
// codes) and then those of the warp route (``n_warp``).  ``edge_rows``
// holds n_warp * edge_len int8, edge_len >= max(La, Lb), when a warp-route
// pattern exceeds 1024 codes (it may be any pointer otherwise).  Launches
// on ``stream``, allocates nothing, and returns cudaGetLastError() (0 on
// success).
static int edit_distance_launch(const void* a, const void* b,
                                const void* alen, const void* blen, int La,
                                int Lb, const void* order, int n_thread,
                                int n_warp, void* edge_rows, int edge_len,
                                void* out, void* stream) {
    const int thread_blocks = (n_thread + THREADS - 1) / THREADS;
    const int warp_blocks = (n_warp + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    if (thread_blocks + warp_blocks == 0) return 0;
    edit_distance_kernel<<<thread_blocks + warp_blocks, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<const int*>(alen), static_cast<const int*>(blen), La, Lb,
        static_cast<const int*>(order), n_thread, n_warp, thread_blocks,
        static_cast<int8_t*>(edge_rows), edge_len, static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}

namespace {

constexpr int WORD = 32;            // the thread route's longest sequence
constexpr int GROUP = 32 * WORD;    // one warp's 32 words of pattern
constexpr int BAD_CODES = -2;       // edit_rows_run's refusal of a code

// True when a code outside 0..CODES-1 lies inside one of the B rows
// (off, len) of ``codes`` (n bytes): a scan of the buffer, and only when
// it holds such a code, of each row (ops/edit.py::edit_rows_plan's
// refusal).
bool bad_codes(const int8_t* codes, long long n, const int* off,
               const int* len, int B) {
    bool any = false;
    for (long long i = 0; i < n && !any; ++i)
        any = (uint8_t)codes[i] >= CODES;
    if (!any) return false;
    for (int p = 0; p < B; ++p)
        for (int i = 0; i < len[p]; ++i)
            if ((uint8_t)codes[off[p] + i] >= CODES) return true;
    return false;
}

}  // namespace

// The native rounds' staging on CUDA device ``device`` (null on failure),
// kept by ops/rows.py::row_stage for the process.
extern "C" void* edit_rows_stage_new(int device) {
    return row_views::stage_new(device);
}

// One fused edit-distance round of B pairs over ragged views
// (ops/rows.py): ``views`` int32 [4][B] (a offsets and lengths into
// ``acodes``, b offsets and lengths into ``bcodes``).  Plans the routes as
// ops/edit.py::edit_rows_plan does (the pairs whose shorter sequence is at
// most WORD codes first, then the rest, each in pair order; a code outside 0..7
// inside a pair's lengths refuses the round with BAD_CODES), then on the
// stage's stream: one upload, the pairs expanded to [B, La] and [B, Lb]
// (the longest of each side, at least 1), one launch of
// edit_distance_kernel, the int32 [B] distances in one download to
// ``out``.  ``info`` (int32 [2]) gets the thread and warp routes' pairs,
// ``phase_ns`` (double [3]) the upload, device-wait and download ns
// (csrc/row_views.h).  Returns 0, a cudaError or BAD_CODES.
extern "C" int edit_rows_run(void* stage, const void* acodes, long long na,
                             const void* bcodes, long long nb,
                             const void* views, int B, void* out,
                             void* info, void* phase_ns) {
    using namespace row_views;
    Stage& s = *static_cast<Stage*>(stage);
    auto* phase = static_cast<double*>(phase_ns);
    auto* routes = static_cast<int*>(info);
    const int64_t t0 = now_ns();
    routes[0] = routes[1] = 0;
    if (B <= 0) {
        phase[0] += static_cast<double>(now_ns() - t0);
        return 0;
    }
    const auto* v = static_cast<const int*>(views);
    const auto* a = static_cast<const int8_t*>(acodes);
    const auto* b = static_cast<const int8_t*>(bcodes);
    if (bad_codes(a, na, v, v + B, B) ||
        bad_codes(b, nb, v + 2 * B, v + 3 * B, B))
        return BAD_CODES;
    int La = 1, Lb = 1;
    for (int p = 0; p < B; ++p) {
        La = std::max(La, v[B + p]);
        Lb = std::max(Lb, v[3 * B + p]);
    }
    std::vector<int> order(B);
    int n_thread = 0;
    for (int p = 0; p < B; ++p)
        if (std::min(v[B + p], v[3 * B + p]) <= WORD) order[n_thread++] = p;
    int n_warp = n_thread;
    for (int p = 0; p < B; ++p)
        if (std::min(v[B + p], v[3 * B + p]) > WORD) order[n_warp++] = p;
    n_warp -= n_thread;
    const int edge_len = std::max(La, Lb);
    const size_t edge_bytes =
        edge_len > GROUP && n_warp ? (size_t)n_warp * edge_len : 1;
    cudaError_t err = cudaSetDevice(s.device);
    if (err != cudaSuccess) return static_cast<int>(err);

    // pinned: views, the route order, the group, a codes, b codes | out
    const size_t a_bytes = align_up((size_t)B * La);
    const Group group{0, B, La, Lb, 0, 0};
    const size_t o_order = align_up((size_t)16 * B);
    const size_t o_group = o_order + align_up((size_t)4 * B);
    const size_t o_a = o_group + align_up(sizeof(Group));
    const size_t o_b = o_a + align_up((size_t)na);
    const size_t in_bytes = o_b + align_up((size_t)nb);
    const size_t out_bytes = (size_t)4 * B;
    if ((err = s.reserve_host(in_bytes + out_bytes)) != cudaSuccess ||
        (err = s.in.reserve(in_bytes, s.stream)) != cudaSuccess ||
        (err = s.pad.reserve(a_bytes + (size_t)B * Lb, s.stream)) !=
            cudaSuccess ||
        (err = s.ints.reserve(out_bytes, s.stream)) != cudaSuccess ||
        (err = s.scratch.reserve(edge_bytes, s.stream)) != cudaSuccess)
        return static_cast<int>(err);
    stage_bytes(s, 0, views, (size_t)16 * B);
    stage_bytes(s, o_order, order.data(), (size_t)4 * B);
    stage_bytes(s, o_group, &group, sizeof(Group));
    stage_bytes(s, o_a, acodes, (size_t)na);
    stage_bytes(s, o_b, bcodes, (size_t)nb);
    const cudaStream_t st = s.stream;
    if ((err = cudaMemcpyAsync(s.in.ptr, s.host, in_bytes,
                               cudaMemcpyHostToDevice, st)) != cudaSuccess)
        return static_cast<int>(err);
    const int64_t t1 = now_ns();
    phase[0] += static_cast<double>(t1 - t0);

    const int* d_views = s.in.at<int>(0);
    int8_t* apad = s.pad.at<int8_t>(0);
    int8_t* bpad = apad + a_bytes;
    expand_kernel<<<expand_blocks(B), EXPAND_WARPS * 32, 0, st>>>(
        s.in.at<int8_t>(o_a), s.in.at<int8_t>(o_b), d_views, B,
        s.in.at<Group>(o_group), 1, apad, bpad);
    if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    const int rc = edit_distance_launch(
        apad, bpad, d_views + B, d_views + 3 * B, La, Lb,
        s.in.at<int>(o_order), n_thread, n_warp, s.scratch.ptr, edge_len,
        s.ints.ptr, st);
    if (rc != 0) return rc;
    routes[0] = n_thread;
    routes[1] = n_warp;
    return static_cast<int>(finish_round(s, s.ints.ptr, out_bytes, in_bytes,
                                         out, t1, phase));
}
