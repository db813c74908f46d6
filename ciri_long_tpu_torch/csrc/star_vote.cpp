// The center-star column vote of CCS's polish, on the host (C++17, no CUDA).
//
// For every read of a batch: its consensus units (int8 codes), the index of
// its representative (the median-length unit, ops/ccs.py::star_rep_index)
// and, for every other unit, the run entries of its alignment to the
// representative (length << 4 | op, ops 0 M, 1 I, 2 D; 3 counts as D) where
// csrc/nw_traceback.cu's walk wrote them.  Returns each read's consensus,
// exactly ops/ccs.py::center_star_consensus(units, cigars=...):
//   - per representative column, a vote over {A, C, G, T, N, deletion}
//     (codes 0-4; a unit's aligned base or its deletion), the
//     representative's own call with a half-vote (doubled counts + 1), the
//     first maximum winning (np.argmax); columns won by the deletion drop;
//   - insertion slots (before column p, p = 0..n) that more than half the
//     units insert at, each filled with the modal insert length's first
//     donor: Counter(lengths in unit order).most_common(1), ties to the
//     first length seen, the donor the first unit inserting that length;
//   - the representative itself when no column and no slot survives.
// native/nwcore.cpp::py_center_star (its vote half) is the same vote after
// the host NW.
//
// Reads are split over ``threads`` std::threads; ctypes drops the
// interpreter lock for the call.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <utility>
#include <vector>

namespace {

// One read: units [u0, u1) of the batch; returns the consensus length
// written to ``out`` (capacity: the read's unit codes), or -1 on run
// entries that do not fit the unit or the representative.
int64_t vote_read(const int8_t* codes, const int64_t* unit_off, int64_t u0,
                  int64_t u1, int64_t rep_i, const uint64_t* run_addr,
                  const int64_t* run_cnt, int8_t* out) {
    const int64_t U = u1 - u0;
    const int8_t* rep = codes + unit_off[u0 + rep_i];
    const int64_t n = unit_off[u0 + rep_i + 1] - unit_off[u0 + rep_i];

    std::vector<int8_t> base_mat(U * n, -1);
    std::vector<int32_t> ins_len(U * (n + 1), 0);
    std::vector<int64_t> ins_qi(U * (n + 1), 0);
    for (int64_t ui = 0; ui < U; ++ui) {
        int8_t* row = base_mat.data() + ui * n;
        if (ui == rep_i) {
            std::copy(rep, rep + n, row);
            continue;
        }
        const int8_t* u = codes + unit_off[u0 + ui];
        const int64_t nu = unit_off[u0 + ui + 1] - unit_off[u0 + ui];
        const uint32_t* runs =
            reinterpret_cast<const uint32_t*>(run_addr[u0 + ui]);
        int64_t qi = 0, ri = 0;
        for (int64_t t = 0; t < run_cnt[u0 + ui]; ++t) {
            const int64_t l = runs[t] >> 4;
            const uint32_t op = runs[t] & 0xfu;
            if (op == 0) {
                if (qi + l > nu || ri + l > n) return -1;
                std::copy(u + qi, u + qi + l, row + ri);
                qi += l;
                ri += l;
            } else if (op == 1) {
                if (qi + l > nu || ri > n) return -1;
                ins_len[ui * (n + 1) + ri] = static_cast<int32_t>(l);
                ins_qi[ui * (n + 1) + ri] = qi;
                qi += l;
            } else if (op == 2 || op == 3) {
                if (ri + l > n) return -1;
                ri += l;
            }
        }
    }

    // the column vote; the representative's call gets a half-vote
    std::vector<int8_t> winner(n);
    std::vector<uint8_t> keep(n);
    bool any = false;
    for (int64_t j = 0; j < n; ++j) {
        int64_t c2[6] = {0, 0, 0, 0, 0, 0};
        for (int64_t ui = 0; ui < U; ++ui) {
            const int v = base_mat[ui * n + j];
            if (v < 0) c2[5] += 2;
            else if (v < 5) c2[v] += 2;
        }
        if (rep[j] >= 0 && rep[j] < 6) c2[rep[j]] += 1;
        int w = 0;
        for (int t = 1; t < 6; ++t)
            if (c2[t] > c2[w]) w = t;
        winner[j] = static_cast<int8_t>(w);
        keep[j] = w < 5;
        any = any || keep[j];
    }

    // insertion slots that more than half the units insert at
    std::vector<int64_t> qual;
    for (int64_t p = 0; p <= n; ++p) {
        int64_t sup = 0;
        for (int64_t ui = 0; ui < U; ++ui) sup += ins_len[ui * (n + 1) + p] > 0;
        if (2 * sup > U) qual.push_back(p);
    }

    int64_t len = 0;
    auto columns = [&](int64_t a, int64_t b) {
        for (int64_t j = a; j < b; ++j)
            if (keep[j]) out[len++] = winner[j];
    };
    if (qual.empty()) {
        if (!any) {
            std::copy(rep, rep + n, out);
            return n;
        }
        columns(0, n);
        return len;
    }
    int64_t prev = 0;
    std::vector<std::pair<int32_t, int64_t>> freq;   // (length, count)
    for (const int64_t p : qual) {
        columns(prev, p);
        freq.clear();
        for (int64_t ui = 0; ui < U; ++ui) {
            const int32_t l = ins_len[ui * (n + 1) + p];
            if (l <= 0) continue;
            auto it = std::find_if(freq.begin(), freq.end(),
                                   [l](const std::pair<int32_t, int64_t>& f) {
                                       return f.first == l;
                                   });
            if (it == freq.end()) freq.emplace_back(l, 1);
            else ++it->second;
        }
        std::pair<int32_t, int64_t> mode = freq[0];
        for (const auto& f : freq)
            if (f.second > mode.second) mode = f;
        for (int64_t ui = 0; ui < U; ++ui) {
            if (ins_len[ui * (n + 1) + p] == mode.first) {
                const int8_t* u = codes + unit_off[u0 + ui] +
                                  ins_qi[ui * (n + 1) + p];
                std::copy(u, u + mode.first, out + len);
                len += mode.first;
                break;
            }
        }
        prev = p;
    }
    columns(prev, n);
    if (len == 0) {
        std::copy(rep, rep + n, out);
        return n;
    }
    return len;
}

}  // namespace

// Plain C entry point for ctypes.  n_reads reads; read r owns units
// read_units[r] .. read_units[r + 1] - 1 of the batch, unit u the codes
// codes[unit_off[u] : unit_off[u + 1]] (every unit non-empty, at least two
// a read), its representative is its unit rep[r] (an index within the
// read), and unit u's run entries are run_cnt[u] uint32 at address
// run_addr[u] (unused at a representative).  Read r's consensus goes to
// out + unit_off[read_units[r]] (its units' codes bound its length) and its
// length to out_len[r].  Returns -1 when all went well, else the index of
// the first read whose input is inconsistent (a representative outside the
// read, or run entries that do not fit its units).
extern "C" int64_t star_vote(int64_t n_reads, const int8_t* codes,
                             const int64_t* unit_off,
                             const int64_t* read_units, const int64_t* rep,
                             const uint64_t* run_addr,
                             const int64_t* run_cnt, int8_t* out,
                             int64_t* out_len, int threads) {
    std::vector<int64_t> bad(std::max(1, threads), -1);
    auto work = [&](int t, int64_t r0, int64_t r1) {
        for (int64_t rd = r0; rd < r1; ++rd) {
            const int64_t u0 = read_units[rd], u1 = read_units[rd + 1];
            int64_t len = -1;
            if (u1 - u0 >= 2 && rep[rd] >= 0 && rep[rd] < u1 - u0)
                len = vote_read(codes, unit_off, u0, u1, rep[rd], run_addr,
                                run_cnt, out + unit_off[u0]);
            out_len[rd] = len;
            if (len < 0 && bad[t] < 0) bad[t] = rd;
        }
    };
    const int T = static_cast<int>(
        std::max<int64_t>(1, std::min<int64_t>(threads, n_reads)));
    if (T == 1) {
        work(0, 0, n_reads);
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < T; ++t)
            pool.emplace_back(work, t, n_reads * t / T,
                              n_reads * (t + 1) / T);
        for (auto& th : pool) th.join();
    }
    for (const int64_t b : bad)
        if (b >= 0) return b;
    return -1;
}
