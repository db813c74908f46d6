"""Anchor rows for the chaining DP and reads for the tandem screen at their
edges (tests/test_torch_chain.py and tests/test_torch_period.py hold the
plain versions to the JAX package on them, tests/test_torch_cuda.py the
kernels to the plain versions and the native chain core).

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


def pad(reads, W):
    """Reads as a [B, W] int8 matrix padded with 5, and their lengths."""
    mat = np.full((len(reads), W), 5, np.int8)
    for t, x in enumerate(reads):
        mat[t, :len(x)] = x
    return mat, np.array([len(x) for x in reads], np.int32)
