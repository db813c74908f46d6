// Colinear chaining of minimizer anchors and greedy chain extraction, for
// Hopper.
//
// Replaces the XLA device program ciri_long_tpu/ops/chain.py::_chain_dp
// (the windowed DP as a lax.scan over anchors) and ::chain_extract_batch
// (the greedy extraction as a while_loop state machine, vmapped over rows;
// ROADMAP X2).  The rows are ragged: row b holds anchors offs[b] ..
// offs[b+1]-1 of the concatenated (r, q, ctg) arrays, r contig-local, sorted
// by (r, q) as models/aligner.py::_anchors gives them.
//
// Contract: f and pre equal native/chaincore.cpp::py_chain's, bit for bit:
//   alpha = min(dq, dr, k)
//   skip  = 0.1 * max(0, dq - 2k)
//   pen   = dr >= dq ? lg + skip : (0.5*g + 0.5*lg) + skip   (g = |dr - dq|)
//   cand  = (f[j] + alpha) - pen        over j in [max(0, i - 64), i) with
//           0 < dr <= max_gap_r, 0 < dq <= max_gap_q and the same contig
//   f[i]  = max(k, cand), pre[i] = the smallest j of the largest cand when it
//           beats k, else -1
// in float64, with lg = log2(g + 1) from a table the host fills with
// std::log2 (chain_log2_table), the libm call whose values the native core
// uses.  Every add, subtract and multiply is an explicit round-to-nearest
// intrinsic, so nvcc contracts nothing into an FMA.  The native core is
// built by g++ under -march=native, whose only contractions there are
// 2.0*k and 0.5*g, both exact.  dr and dq are taken in contig-local int32:
// a candidate shares its contig, so they equal the global differences.
//
// Extraction equals ops/chain.py::backtrack_chains on (f, pre): candidates
// f >= min_score in descending f, ties by ascending index (np.argsort(-f,
// kind='stable')); each unused candidate walks its predecessors while they
// are unused, marking them; a path of >= min_anchors anchors is a chain
// (its anchors get the chain's id), a shorter one keeps its anchors
// consumed; the walk ends at max_chains chains.  Outputs: cid int8 per
// anchor (-1 none), scores [R, max_chains] float64 (the start's f), nch [R].
//
// Design:
//   chain_dp_kernel       one warp a row, serial over its anchors.  Lane l
//                         scores window slots l and l + 32 (j = i - 64 + l
//                         and i - 32 + l), whose f it holds in registers
//                         (the window shifts by one shuffle a step, lane 31
//                         taking the new f).  Only f feeds the next step:
//                         each step first turns its two candidates into
//                         order-preserving 64-bit keys, then computes the
//                         next step's admissibility, alpha and pen (loads
//                         of the window's anchors through the read-only
//                         cache, the log2 table) while two __reduce_max_sync
//                         give the largest key and two ballots the smallest
//                         j holding it.  The anchors' own r, q, ctg come a
//                         chunk of 32 ahead.  Bound: a row's steps are
//                         serial, each a chain of warp-collective operations
//                         (~0.4 us on an H100; issuing the loads a step
//                         later or earlier did not move it), and rows run
//                         side by side, so a launch takes about its longest
//                         row's steps, far above its operations bound (the
//                         candidates at op_rate.cu's float64 rate).
//   chain_extract_kernel  one block a row.  Candidates are compacted into
//                         (f's bits, index) keys, bitonic-sorted by the
//                         block (f is >= k > 0, so its bits order as its
//                         value), then one thread walks the greedy over a
//                         shared-memory used mask and predecessor copy.
//                         Rows up to SMEM_ROW anchors keep everything in
//                         shared memory; a longer row (a single read's map
//                         is not truncated) sorts and walks in global
//                         scratch the wrapper gives it.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WINDOW = 64;                 // predecessors a step (CHAIN_WINDOW)
constexpr int DP_WARPS = 4;                // rows a block of the DP
constexpr int EXT_THREADS = 256;
constexpr int SMEM_ROW = 8192;             // longest row sorted in smem
constexpr unsigned FULL = 0xffffffffu;

// An order-preserving 64-bit key of a double that is not NaN or -0.0
// (cand is never -0.0: f + alpha > 0), above 0, the key of "no candidate".
__device__ __forceinline__ uint64_t order_key(double x) {
    const uint64_t b = static_cast<uint64_t>(__double_as_longlong(x));
    return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double from_key(uint64_t key) {
    return __longlong_as_double(static_cast<long long>(
        (key >> 63) ? (key & 0x7fffffffffffffffull) : ~key));
}

// The f-independent terms of candidate j of anchor (ri, qi, ci): whether
// it is admissible, alpha and pen.  Branch-free, so that the compiler may
// overlap its loads with the step before's reduction.
__device__ __forceinline__ void terms(const int* __restrict__ rr,
                                      const int* __restrict__ qq,
                                      const int* __restrict__ cc,
                                      const double* __restrict__ lg, int j,
                                      int ri, int qi, int ci, int k,
                                      double two_k, int max_gap_r,
                                      int max_gap_q, bool& ok, double& alpha,
                                      double& pen) {
    const int jj = max(j, 0);
    const int dr = ri - __ldg(rr + jj);
    const int dq = qi - __ldg(qq + jj);
    ok = j >= 0 && dr > 0 && dq > 0 && dq <= max_gap_q && dr <= max_gap_r &&
         __ldg(cc + jj) == ci;
    const int g = ok ? abs(dr - dq) : 0;
    const double lgv = __ldg(lg + g);
    alpha = static_cast<double>(min(min(dq, dr), k));
    const double skip = __dmul_rn(
        0.1, fmax(0.0, __dsub_rn(static_cast<double>(dq), two_k)));
    pen = dr >= dq ? __dadd_rn(lgv, skip)
                   : __dadd_rn(
                         __dadd_rn(__dmul_rn(0.5, static_cast<double>(g)),
                                   __dmul_rn(0.5, lgv)),
                         skip);
}

__global__ void __launch_bounds__(DP_WARPS * 32)
chain_dp_kernel(const int64_t* __restrict__ offs, const int* __restrict__ r,
                const int* __restrict__ q, const int* __restrict__ ctg,
                int R, const double* __restrict__ lg, int k,
                int max_gap_r, int max_gap_q, double* __restrict__ f,
                int* __restrict__ pre) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * DP_WARPS + warp;
    if (row >= R) return;
    const int64_t base = offs[row];
    const int n = static_cast<int>(offs[row + 1] - base);
    const int* rr = r + base;
    const int* qq = q + base;
    const int* cc = ctg + base;
    double* fo = f + base;
    int* po = pre + base;
    const double kd = static_cast<double>(k);
    const double two_k = __dmul_rn(2.0, kd);

    // anchors 32c + lane of the current chunk c and of the next one
    int ra = 0, qa = 0, ca = 0, rn = 0, qn = 0, cn = 0;
    if (lane < n) {
        ra = __ldg(rr + lane);
        qa = __ldg(qq + lane);
        ca = __ldg(cc + lane);
    }
    if (32 + lane < n) {
        rn = __ldg(rr + 32 + lane);
        qn = __ldg(qq + 32 + lane);
        cn = __ldg(cc + 32 + lane);
    }
    // the window of step i: f[i - 64 + lane] and f[i - 32 + lane], and the
    // terms of those two candidates (none at step 0)
    double fw0 = 0.0, fw1 = 0.0, al0 = 0.0, al1 = 0.0, pe0 = 0.0, pe1 = 0.0;
    bool ok0 = false, ok1 = false;
    for (int i = 0; i < n; ++i) {
        const uint64_t k0 =
            ok0 ? order_key(__dsub_rn(__dadd_rn(fw0, al0), pe0)) : 0;
        const uint64_t k1 =
            ok1 ? order_key(__dsub_rn(__dadd_rn(fw1, al1), pe1)) : 0;
        // the window's shift and the next step's terms need no f of this
        // step: they overlap its reduction
        const double d0 = __shfl_down_sync(FULL, fw0, 1);
        const double d1 = __shfl_down_sync(FULL, fw1, 1);
        const double w1 = __shfl_sync(FULL, fw1, 0);
        const int i1 = i + 1;
        const int t1 = i1 & 31;
        if (t1 == 0) {
            ra = rn;
            qa = qn;
            ca = cn;
            const int a = i1 + 32 + lane;
            if (a < n) {
                rn = __ldg(rr + a);
                qn = __ldg(qq + a);
                cn = __ldg(cc + a);
            }
        }
        const int ri = __shfl_sync(FULL, ra, t1);
        const int qi = __shfl_sync(FULL, qa, t1);
        const int ci = __shfl_sync(FULL, ca, t1);
        bool nok0, nok1;
        double nal0, nal1, npe0, npe1;
        terms(rr, qq, cc, lg, i1 - WINDOW + lane, ri, qi, ci, k, two_k,
              max_gap_r, max_gap_q, nok0, nal0, npe0);
        terms(rr, qq, cc, lg, i1 - 32 + lane, ri, qi, ci, k, two_k,
              max_gap_r, max_gap_q, nok1, nal1, npe1);

        // the largest key, then the smallest j holding it
        const uint64_t km = k0 > k1 ? k0 : k1;
        const unsigned hi = __reduce_max_sync(FULL, (unsigned)(km >> 32));
        const unsigned lo = __reduce_max_sync(
            FULL, (unsigned)(km >> 32) == hi ? (unsigned)km : 0u);
        const uint64_t best = (static_cast<uint64_t>(hi) << 32) | lo;
        const bool take = best != 0 && from_key(best) > kd;
        const double fi = take ? from_key(best) : kd;
        const unsigned b0 = __ballot_sync(FULL, k0 == best);
        const unsigned b1 = __ballot_sync(FULL, k1 == best);
        if (lane == 0) {
            fo[i] = fi;
            po[i] = !take ? -1
                          : b0 ? i - WINDOW + __ffs(b0) - 1
                               : i - 32 + __ffs(b1) - 1;
        }
        fw0 = lane == 31 ? w1 : d0;
        fw1 = lane == 31 ? fi : d1;
        ok0 = nok0;
        ok1 = nok1;
        al0 = nal0;
        al1 = nal1;
        pe0 = npe0;
        pe1 = npe1;
    }
}

// (key, index) before (key2, index2) in the greedy's order: descending f,
// ascending index
__device__ __forceinline__ bool before(uint64_t ka, uint32_t ia, uint64_t kb,
                                       uint32_t ib) {
    return ka > kb || (ka == kb && ia < ib);
}

template <typename IdxT, typename PreT>
__device__ void extract_row(int n, const double* __restrict__ fr,
                            uint64_t* key, IdxT* idx, const PreT* pre_w,
                            uint8_t* used, int8_t* cid_w, int* n_cand,
                            double min_score, int min_anchors, int max_chains,
                            double* scores_row, int* nch_row) {
    const int tid = threadIdx.x;
    for (int a = tid; a < n; a += EXT_THREADS) {
        const double fa = fr[a];
        if (fa >= min_score) {
            const int p = atomicAdd(n_cand, 1);
            key[p] = static_cast<uint64_t>(__double_as_longlong(fa));
            idx[p] = static_cast<IdxT>(a);
        }
    }
    __syncthreads();
    const int nc = *n_cand;
    int P = 1;
    while (P < nc) P <<= 1;
    for (int p = nc + tid; p < P; p += EXT_THREADS) {
        key[p] = 0;                        // +0.0: after every candidate
        idx[p] = static_cast<IdxT>(~0u);
    }
    __syncthreads();
    for (int size = 2; size <= P; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int p = tid; p < P; p += EXT_THREADS) {
                const int o = p ^ stride;
                if (o > p) {
                    const uint64_t kp = key[p], ko = key[o];
                    const uint32_t ip = static_cast<uint32_t>(idx[p]);
                    const uint32_t io = static_cast<uint32_t>(idx[o]);
                    const bool fwd = (p & size) == 0;
                    if (fwd ? before(ko, io, kp, ip) : before(kp, ip, ko, io)) {
                        key[p] = ko;
                        key[o] = kp;
                        idx[p] = static_cast<IdxT>(io);
                        idx[o] = static_cast<IdxT>(ip);
                    }
                }
            }
            __syncthreads();
        }
    }
    if (tid == 0) {
        int nch = 0;
        for (int t = 0; t < nc && nch < max_chains; ++t) {
            const int a = static_cast<int>(idx[t]);
            if (used[a]) continue;
            int plen = 0;
            for (int v = a; v >= 0 && !used[v]; v = pre_w[v]) {
                used[v] = 1;
                ++plen;
            }
            if (plen < min_anchors) continue;
            int v = a;
            for (int s = 0; s < plen; ++s) {
                cid_w[v] = static_cast<int8_t>(nch);
                v = pre_w[v];
            }
            scores_row[nch] = fr[a];
            ++nch;
        }
        *nch_row = nch;
    }
    __syncthreads();
}

// goff[b]: row b's offset into the global scratch (next power of two of
// its length a row), or -1 for a row that fits shared memory.  Dynamic
// shared memory: SMEM_ROW-capped keys (8 bytes), indices (2), predecessors
// (2), used (1) and ids (1) a slot, sized by the wrapper for the launch's
// longest shared-memory row.
__global__ void __launch_bounds__(EXT_THREADS)
chain_extract_kernel(const int64_t* __restrict__ offs,
                     const double* __restrict__ f, const int* __restrict__ pre,
                     int R, int cap, double min_score, int min_anchors,
                     int max_chains, const int64_t* __restrict__ goff,
                     uint64_t* gkey, int* gidx, uint8_t* gused,
                     int8_t* __restrict__ cid, double* __restrict__ scores,
                     int* __restrict__ nch) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int n_cand;
    const int row = blockIdx.x;
    const int tid = threadIdx.x;
    const int64_t base = offs[row];
    const int n = static_cast<int>(offs[row + 1] - base);
    if (tid == 0) n_cand = 0;
    const int64_t g = goff[row];
    if (g < 0) {
        uint64_t* key = reinterpret_cast<uint64_t*>(smem);
        uint16_t* idx = reinterpret_cast<uint16_t*>(key + cap);
        int16_t* pre_s = reinterpret_cast<int16_t*>(idx + cap);
        uint8_t* used = reinterpret_cast<uint8_t*>(pre_s + cap);
        int8_t* cid_s = reinterpret_cast<int8_t*>(used + cap);
        for (int a = tid; a < n; a += EXT_THREADS) {
            pre_s[a] = static_cast<int16_t>(pre[base + a]);
            used[a] = 0;
            cid_s[a] = -1;
        }
        __syncthreads();
        extract_row<uint16_t, int16_t>(
            n, f + base, key, idx, pre_s, used, cid_s, &n_cand, min_score,
            min_anchors, max_chains, scores + (int64_t)row * max_chains,
            nch + row);
        for (int a = tid; a < n; a += EXT_THREADS) cid[base + a] = cid_s[a];
    } else {
        uint8_t* used = gused + g;
        for (int a = tid; a < n; a += EXT_THREADS) {
            used[a] = 0;
            cid[base + a] = -1;
        }
        __syncthreads();
        extract_row<int, int>(n, f + base, gkey + g, gidx + g, pre + base,
                              used, cid + base, &n_cand, min_score,
                              min_anchors, max_chains,
                              scores + (int64_t)row * max_chains, nch + row);
    }
}

}  // namespace

// log2(g + 1) for g in [0, n), from the host's libm (std::log2): the table
// the DP kernel reads, filled into the caller's host buffer.
extern "C" void chain_log2_table(double* out, int n) {
    for (int g = 0; g < n; ++g)
        out[g] = std::log2(static_cast<double>(g) + 1.0);
}

// One warp a row; ``lg`` holds more than max(max_gap_r, max_gap_q) entries
// on the device, so every admissible g = |dr - dq| has its entry.  Launches
// on ``stream`` and returns cudaGetLastError().
extern "C" int chain_dp_launch(const void* offs, const void* r, const void* q,
                               const void* ctg, int R, const void* lg,
                               int k, int max_gap_r, int max_gap_q,
                               void* f, void* pre, void* stream) {
    if (R == 0) return 0;
    const int blocks = (R + DP_WARPS - 1) / DP_WARPS;
    chain_dp_kernel<<<blocks, DP_WARPS * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(offs), static_cast<const int*>(r),
        static_cast<const int*>(q), static_cast<const int*>(ctg), R,
        static_cast<const double*>(lg), k, max_gap_r, max_gap_q,
        static_cast<double*>(f), static_cast<int*>(pre));
    return static_cast<int>(cudaGetLastError());
}

// One block a row; rows with goff[b] < 0 must hold at most ``cap`` anchors
// (a power of two up to SMEM_ROW, which ops/chain.py::SMEM_ROW mirrors).
extern "C" int chain_extract_launch(const void* offs, const void* f,
                                    const void* pre, int R, int cap,
                                    double min_score, int min_anchors,
                                    int max_chains, const void* goff,
                                    void* gkey, void* gidx, void* gused,
                                    void* cid, void* scores, void* nch,
                                    void* stream) {
    if (R == 0) return 0;
    if (cap < 1 || cap > SMEM_ROW || (cap & (cap - 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = cap * 14;             // see chain_extract_kernel
    cudaError_t err = cudaFuncSetAttribute(
        chain_extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    chain_extract_kernel<<<R, EXT_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(offs), static_cast<const double*>(f),
        static_cast<const int*>(pre), R, cap, min_score, min_anchors,
        max_chains, static_cast<const int64_t*>(goff),
        static_cast<uint64_t*>(gkey), static_cast<int*>(gidx),
        static_cast<uint8_t*>(gused), static_cast<int8_t*>(cid),
        static_cast<double*>(scores), static_cast<int*>(nch));
    return static_cast<int>(cudaGetLastError());
}
