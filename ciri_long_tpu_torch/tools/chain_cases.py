"""Anchor rows for the chaining DP and reads for the tandem screen at their
edges (tests/test_torch_chain.py and tests/test_torch_period.py hold the
plain versions to the JAX package on them, tests/test_torch_cuda.py the
kernels to the plain versions and the native chain core), and reads wider
than the screen's widest bucket for the lag-range kernels (``wide_cases``),
their word and segment edges (``lag_edge_cases``), full-length reads that
fill the card (``full_reads``) and reads with codes outside 0..5, which
take their value route (``odd_cases``).

Chain rows are (r, q, ctg) int64 arrays sorted by (r, q), r global, with
contigs of CONTIG bases (ctg = r // CONTIG) or, for rows whose gaps span
more, one contig; ``local`` gives the contig-local r the kernels take.
"""

import numpy as np

CONTIG = 150_000


def local(rows):
    """(r - contig start, q, ctg) for each (r, q, ctg) row."""
    return [(r - ctg * CONTIG, q, ctg) for r, q, ctg in rows]


def _row(r, q, one_contig=False):
    order = np.lexsort((q, r))
    r = np.asarray(r, np.int64)[order]
    return (r, np.asarray(q, np.int64)[order],
            np.zeros(len(r), np.int64) if one_contig else r // CONTIG)


def random_rows(rng, B, A):
    """B rows of A // 2 .. A anchors, colinear with jitter so that chains
    exist (tests/test_chain_device.py's generator)."""
    rows = []
    for _ in range(B):
        n = int(rng.integers(A // 2, A))
        r = np.sort(rng.integers(0, 40_000, n))
        rows.append(_row(r, (r // 4 + rng.integers(-30, 30, n)).clip(0)))
    return rows


def edge_rows(rng):
    """Rows at the DP's edges, in this order: a chain across a contig
    change; steps with dr < dq and dr >= dq; g over 65 535 then gaps of
    exactly max_gap_r (200 000) and one past it; a gap of exactly max_gap_q
    (5 000) and one past it (each jump behind a 40-anchor chain whose f of
    600 lets it win); rows of A = 1, 2, 64, 65 and 8192 anchors; a perfect
    diagonal at spacing 5, where every anchor's two nearest predecessors
    tie; and two copies of one chain 100 kb apart, whose f values tie."""
    rows = []
    r = rng.integers(CONTIG - 10_000, CONTIG + 10_000, 120)
    rows.append(_row(r, np.sort(rng.integers(0, 4_000, 120))))
    dr = rng.integers(1, 60, 200)
    dq = np.where(rng.random(200) < 0.5, dr + rng.integers(1, 40, 200),
                  np.maximum(1, dr - rng.integers(0, 40, 200)))
    rows.append(_row(np.cumsum(dr), np.cumsum(dq)))
    base = 15 * np.arange(40, dtype=np.int64)
    rows.append(_row(
        np.concatenate([base, base[-1] + np.cumsum([70_000, 200_000,
                                                   200_001])]),
        np.concatenate([base, base[-1] + np.array([15, 30, 45])]), True))
    r = np.concatenate([base, base[-1] + 5_000 + base,
                        [2 * base[-1] + 5_000 + 5_001]])
    rows.append(_row(r, r, True))
    for A in (1, 2, 64, 65, 8192):
        r = np.sort(rng.integers(0, 40 * A + 10, A))
        rows.append(_row(r, (r // 4 + rng.integers(-30, 30, A)).clip(0)))
    d = 5 * np.arange(200, dtype=np.int64)
    rows.append(_row(d, d))
    c = np.sort(rng.integers(0, 3_000, 150))
    cq = (c // 2 + rng.integers(-5, 5, 150)).clip(0)
    rows.append(_row(np.concatenate([c, c + 100_000]),
                     np.concatenate([cq, cq]), True))
    return rows


def dp_cases(rng, gap_r=200_000, gap_q=5_000, k=15):
    """{name: row} at the edges of csrc/chain_dp.cu's schedule: rows of 0,
    1, 2, 64 and 65 anchors; one of 9 000 (over SMEM_ROW); anchors copied
    40 and 70 times in a row, so that a step's candidates tie across its
    whole window (the newest, the one a step older, the window's far end
    at 64 back) and the smallest j must win; a step whose only candidate
    scores exactly k (taken by no one); contig changes inside a row; gaps
    of max_gap_r and max_gap_q less one, exactly, and plus one, each behind
    a 40-anchor chain."""
    cases = {'empty': _row([], [])}
    for A in (1, 2, 64, 65, 9_000):
        r = np.sort(rng.integers(0, 40 * A + 10, A))
        cases['anchors_{}'.format(A)] = _row(
            r, (r // 4 + rng.integers(-30, 30, A)).clip(0))
    for m in (40, 70):
        d = np.repeat(20 * np.arange(12, dtype=np.int64), m)
        cases['copies_{}'.format(m)] = _row(d, d, True)
    # (0, 0) then (2, 1): alpha = 1, pen = log2(2) = 1, cand = k + 1 - 1
    unit = np.array([0, 2], np.int64)
    r = np.concatenate([unit + 40 * t for t in range(30)])
    q = np.concatenate([np.array([0, 1]) + 40 * t for t in range(30)])
    cases['cand_is_k'] = _row(r, q, True)
    r = np.sort(rng.integers(CONTIG - 3_000, CONTIG + 3_000, 300))
    r = np.concatenate([r, r + CONTIG])
    cases['contig_changes'] = _row(r, np.sort(rng.integers(0, 9_000, 600)))
    base = 15 * np.arange(40, dtype=np.int64)
    for name, gap in (('gap_r', gap_r), ('gap_q', gap_q)):
        for delta in (-1, 0, 1):
            jump = gap + delta
            if name == 'gap_r':
                r = np.append(base, base[-1] + jump)
                q = np.append(base, base[-1] + 15)
            else:
                r = np.append(base, base[-1] + jump + 20)
                q = np.append(base, base[-1] + jump)
            cases['{}_{:+d}'.format(name, delta)] = _row(r, q, True)
    return cases


def forest(rng, n, root_p=0.1, f_lo=15, f_hi=60, ints=False):
    """A synthetic (f float64 [n], pre int32 [n]) row for the extraction:
    pre[v] a random anchor of the 64 before v (-1 with probability
    ``root_p``, and for v = 0), f uniform in [f_lo, f_hi) (integers with
    ``ints``, so that many tie)."""
    pre = np.full(n, -1, np.int32)
    for v in range(1, n):
        if rng.random() >= root_p:
            pre[v] = v - int(rng.integers(1, min(64, v) + 1))
    f = (rng.integers(f_lo, f_hi, n).astype(np.float64) if ints
         else rng.uniform(f_lo, f_hi, n))
    return f, pre


def extract_cases(rng):
    """{name: (rows [(f, pre)], min_score, min_anchors, max_chains)} at the
    edges of csrc/chain_dp.cu's extraction: integer f tied everywhere;
    paths shorter than min_anchors (roots every few anchors), which still
    consume their anchors; rows of many disjoint chains that reach
    max_chains; a row with no candidate and an empty row; a row of 9 000
    anchors (over SMEM_ROW) and one of exactly SMEM_ROW; one chain 8 192
    deep (pre = v - 1) whose every anchor is a candidate; brooms, where
    many candidate tips hang off one trunk and share its ancestors; and
    min_anchors 1 with 127 chains."""
    cases = {}
    cases['tied_f'] = ([forest(rng, n, 0.05, 20, 40, True)
                        for n in (31, 200, 700)], 30.0, 3, 10)
    cases['short_paths'] = ([forest(rng, n, 0.4) for n in (100, 600)],
                            30.0, 3, 10)
    chains = []
    for m in (40, 60):
        pre = np.arange(-1, 5 * m - 1, dtype=np.int32)
        pre[::5] = -1                       # m chains of 5
        f = rng.uniform(15, 60, 5 * m)
        f[4::5] += 100                      # each chain's tip first
        chains.append((f, pre))
    cases['max_chains'] = (chains, 30.0, 3, 14)
    f, pre = forest(rng, 300)
    cases['no_candidate'] = ([(f, pre), (np.zeros(0), np.zeros(0, np.int32))],
                             100.0, 3, 10)
    cases['over_smem_row'] = ([forest(rng, 9_000, 0.02),
                               forest(rng, 8_192, 0.02)], 30.0, 3, 10)
    deep = np.arange(-1, 8_191, dtype=np.int32)
    cases['deep_chain'] = ([(np.linspace(30, 9000, 8_192), deep)], 30.0, 3,
                           10)
    brooms = []
    for n in (500, 3_000):
        pre = np.full(n, -1, np.int32)
        f = rng.uniform(15, 25, n)
        trunk = 0
        for v in range(1, n):
            if rng.random() < 0.3:          # the trunk grows
                pre[v], trunk = trunk, v
            else:                           # a tip off a recent trunk node
                pre[v] = max(trunk - int(rng.integers(0, 8)), v - 64)
                f[v] = rng.uniform(30, 90)
        brooms.append((f, pre))
    cases['brooms'] = (brooms, 30.0, 3, 10)
    cases['one_anchor_chains'] = ([forest(rng, 800, 0.3)], 30.0, 1, 127)
    return cases


def extract_csr(rows):
    """(offs int64 [R + 1], f float64 [N], pre int32 [N]) of (f, pre)
    rows."""
    offs = np.zeros(len(rows) + 1, np.int64)
    offs[1:] = np.cumsum([len(f) for f, _ in rows])
    f = np.concatenate([f for f, _ in rows]).astype(np.float64)
    pre = np.concatenate([p for _, p in rows]).astype(np.int32)
    return offs, f, pre


def long_row(rng, A=20_000):
    """One row longer than the extraction's shared-memory rows
    (ops/chain.py::SMEM_ROW), the route through global scratch."""
    r = np.sort(rng.integers(0, 40 * A, A))
    return _row(r, (r // 4 + rng.integers(-30, 30, A)).clip(0))


def csr(rows):
    """Rows as (offs int64 [R + 1], r, q, ctg concatenated int64)."""
    offs = np.zeros(len(rows) + 1, np.int64)
    offs[1:] = np.cumsum([len(row[0]) for row in rows])
    cols = [np.concatenate([row[i] for row in rows]).astype(np.int64)
            if rows else np.zeros(0, np.int64) for i in range(3)]
    return (offs, *cols)


def tandem(rng, L, period, noise=0.0):
    """L codes of a random unit of ``period`` repeated, ``noise`` of them
    replaced by random bases."""
    unit = rng.integers(0, 4, period).astype(np.int8)
    x = np.resize(unit, L).copy()
    flip = rng.random(L) < noise
    x[flip] = rng.integers(0, 4, int(flip.sum()))
    return x


def bucket_reads(rng, b, min_period=30):
    """Reads for screen bucket ``b``: tandem at random periods, random, and
    N-poisoned tandem (four of each, lengths in the bucket), then (index 12)
    a read of b - 24 codes whose period lies between L / 2 and b / 2, and
    for the smallest bucket (index 13) one of 2 * min_period - 1 codes."""
    lo = 2 * min_period if b == 512 else b // 2 + 1
    reads = []
    for _ in range(4):
        L = int(rng.integers(lo, b + 1))
        p = int(rng.integers(min_period, max(min_period + 1, L // 2)))
        reads.append(tandem(rng, L, p, noise=0.03))
        reads.append(rng.integers(0, 4, L).astype(np.int8))
        x = tandem(rng, L, p)
        x[rng.integers(0, L, 5)] = 4
        reads.append(x)
    L = b - 24
    reads.append(tandem(rng, L, L // 2 + 6))
    if b == 512:
        reads.append(tandem(rng, 2 * min_period - 1, min_period))
    return reads


def low_complexity_reads(rng, L=4_000):
    """{name: codes} the screen's pair route must hand to its lag route or
    count exactly all the same: a poly-A, a di- and a trinucleotide repeat,
    a perfect repeat of period 50, each L long, a read of L Ns and one whose
    every eleventh code is N (no valid 11-mer), and a random read with a
    poly-A tail of 120."""
    out = {'poly_a': np.zeros(L, np.int8)}
    for name, p in (('dinucleotide', 2), ('trinucleotide', 3),
                    ('period_50', 50)):
        out[name] = tandem(rng, L, p)
    out['all_n'] = np.full(L, 4, np.int8)
    x = rng.integers(0, 4, L).astype(np.int8)
    x[::11] = 4
    out['no_valid_window'] = x
    out['poly_a_tail'] = np.concatenate([rng.integers(0, 4, L - 120),
                                         np.zeros(120)]).astype(np.int8)
    return out


def screen_launches(rng):
    """{name: (reads int8 [B, W], lengths int32 [B], max_lag int32 [B])}:
    screen launches at the kernel's edges.  Each low_complexity_reads read
    beside a random and a tandem read at width 4 096 and lag range 2 048;
    every bucket's reads at random lag ranges in one launch of width 4 096;
    reads shorter than k = 11 at width 10; a width (100) that is no
    multiple of 16; and 16 384 reads of 60-512 codes at width 512."""
    out = {}
    for name, x in low_complexity_reads(rng).items():
        reads = [x, rng.integers(0, 4, 3_000).astype(np.int8),
                 tandem(rng, 3_500, 240, noise=0.02)]
        mat, lens = pad(reads, 4096)
        out[name] = (mat, lens, np.full(3, 2048, np.int32))
    reads = [x for b in (512, 1024, 2048, 4096) for x in bucket_reads(rng, b)]
    mat, lens = pad(reads, 4096)
    out['mixed_lags'] = (mat, lens, rng.integers(1, 2049, len(reads))
                         .astype(np.int32))
    reads = [rng.integers(0, 4, L).astype(np.int8) for L in range(0, 11)]
    mat, lens = pad(reads, 10)
    out['short_width'] = (mat, lens, np.full(len(reads), 5, np.int32))
    reads = [tandem(rng, int(L), 30 + t % 20, noise=0.02) if t % 2
             else rng.integers(0, 4, int(L)).astype(np.int8)
             for t, L in enumerate(rng.integers(60, 101, 40))]
    mat, lens = pad(reads, 100)
    out['width_100'] = (mat, lens, np.full(len(reads), 50, np.int32))
    reads = [tandem(rng, int(L), int(rng.integers(30, 200)), noise=0.03)
             if t % 3 == 0 else rng.integers(0, 4, int(L)).astype(np.int8)
             for t, L in enumerate(rng.integers(60, 513, 16_384))]
    mat, lens = pad(reads, 512)
    out['many_reads'] = (mat, lens, np.full(len(reads), 256, np.int32))
    return out


def wide_cases(rng, widths=(4_097, 16_384)):
    """{name: (reads int8 [B, W], [(lag_offset, max_lag)])} at each width
    over the screen's widest bucket, 4 096, for the lag-range
    kernels (tandem_counts, lag_profile): a tandem read of period 240, a
    poly-A, a random read, one poisoned with N every 41 codes, one that
    stops 3 codes short of the width and an all-PAD row; over 2 048 lags
    from 0 cut into 1, 2 and 4 ranges, a range across the reads' end and
    one past it."""
    out = {}
    for W in widths:
        reads = [tandem(rng, W, 240, noise=0.02), np.zeros(W - 7, np.int8),
                 rng.integers(0, 4, W).astype(np.int8),
                 rng.integers(0, 4, W).astype(np.int8),
                 rng.integers(0, 4, W - 3).astype(np.int8),
                 np.zeros(0, np.int8)]
        reads[3][5::41] = 4
        mat, _ = pad(reads, W)
        ranges = [(t * 2048 // n, 2048 // n) for n in (1, 2, 4)
                  for t in range(n)]
        out['wide W={}'.format(W)] = (mat, ranges + [(W - 300, 600),
                                                     (W + 10, 64)])
    return out


def lag_edge_cases(rng, widths=(120, 4_097, 4_127)):
    """{name: (reads int8 [B, W], [(lag_offset, max_lag)])} at the edges of
    csrc/lag_planes.h's words and segments, at each width: a tandem read of
    period 37, a random read, one with N every 41 codes, one that stops 3
    codes short of the width, a poly-A run and an all-PAD row; lags 31-34
    and 63-66 (across words), 2 100 lags from 0 (across the chunk of 2 048),
    a range from 1 500 (its partners' words apart from the segment's) and
    one across the reads' end."""
    out = {}
    for W in widths:
        reads = [tandem(rng, W, 37, noise=0.02),
                 rng.integers(0, 4, W).astype(np.int8),
                 rng.integers(0, 4, W).astype(np.int8),
                 rng.integers(0, 4, W - 3).astype(np.int8),
                 np.zeros(W // 3, np.int8), np.zeros(0, np.int8)]
        reads[2][5::41] = 4
        mat, _ = pad(reads, W)
        out['lag edges W={}'.format(W)] = (mat, [
            (30, 4), (62, 4), (0, 2_100), (1_500, 600), (W - 40, 64)])
    return out


def full_reads(rng, B=256, W=8_192):
    """B reads of W codes each, no PAD: every other one a rolling-circle
    read (a random unit of 200-1 500 codes repeated, 5 % of the codes
    replaced), the rest random.  The lag-range kernels' grid-filling
    shape, int8 [B, W]."""
    mat = rng.integers(0, 4, (B, W)).astype(np.int8)
    for b in range(0, B, 2):
        mat[b] = tandem(rng, W, int(rng.integers(200, 1_501)), noise=0.05)
    return mat


def odd_cases(rng):
    """{name: (reads int8 [B, W], [(lag_offset, max_lag)], k)}: reads with
    codes outside 0..5, whose negative codes are valid to JAX and whose
    ids wrap, at widths 8 and 4 097 (both tandem_counts launch paths): at 8
    the two rows where ids from the codes' low bits and JAX's ids disagree
    at lag 4 (k = 2: JAX counts 0 and 1), beside a row of codes 0..5; at
    4 097 those rows at the start of wider reads, a tandem read with a few
    negative codes and a code 9, and a clean random read."""
    small = np.array([[-1, 0, 5, 5, 3, 0, 5, 5], [1, -4, 5, 5, 0, 0, 5, 5],
                      [0, 1, 2, 3, 0, 1, 2, 4]], np.int8)
    W = 4_097
    wide = np.full((4, W), 5, np.int8)
    wide[:2, :8] = small[:2]
    wide[0, 8:3_000] = rng.integers(0, 4, 2_992)
    wide[2, :W - 3] = tandem(rng, W - 3, 53, noise=0.01)
    wide[2, rng.integers(0, W - 3, 12)] = -2
    wide[2, 700] = 9
    wide[3] = rng.integers(0, 4, W)
    return {'odd W=8': (small, [(0, 6), (2, 3)], 2),
            'odd W=4097': (wide, [(0, 64), (1_000, 600)], 11)}


def pad(reads, W):
    """Reads as a [B, W] int8 matrix padded with 5, and their lengths."""
    mat = np.full((len(reads), W), 5, np.int8)
    for t, x in enumerate(reads):
        mat[t, :len(x)] = x
    return mat, np.array([len(x) for x in reads], np.int32)
