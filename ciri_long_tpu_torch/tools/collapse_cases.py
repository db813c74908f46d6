"""Seeded inputs for collapse's two kernels, csrc/edit_distance.cu and
csrc/sw_traceback.cu, with their edge cases.

``edit_cases`` gives (label, a, b, alen, blen) batches: random codes with N
and PAD, lengths 0-300 and an odd batch; empty rows; one-base rows; long
near-equal pairs over many 32-row strips; junction-curation pairs (20 codes
against at most 50); rows where N against N decides the distance; every
pair of lengths in BOUNDARY (the edges of a 32-bit word and of a warp's 32
words); a fused round that mixes junction-curation pairs (one word, the
kernel's thread route) with HPC-like pairs of ~500 x ~700 (its warp route).
``tb_cases`` gives (label, qs, rs, (match, mismatch, gap_open,
gap_extend)) job lists: a random fuzz under three scorings; doubled reads
holding a mutated junction window (collapse's rotation step); jobs that
score 0 and empty jobs; N bases; equal-score ties (a window twice in the
query, an exact copy of a doubled read); references longer than one strip;
one-base jobs; PAD codes inside the query; references at the edges of a
strip (m 33, 63, 64, 65) against queries shorter and longer than 32, and of
300 (more strips than a block's warps); jobs whose direction bytes exceed a
block's shared memory (the kernel's global route) beside small ones.  The
CPU tests, the card's tests and chip_smoke.py share them.
"""

import numpy as np

from ciri_long_tpu_torch.tools.simulate import mutate
from ciri_long_tpu_torch.utils.seq import encode_seq

N = 4
PAD = 5
JUNC = (10, 4, 8, 2)            # collapse's JUNC_SCORE
# lengths at the edges of the edit kernel's 32-bit word and 32-word group
BOUNDARY = (0, 1, 31, 32, 33, 63, 64, 65, 1023, 1024, 1025)
# strip edges of the traceback kernel's 32 reference rows a warp
STRIP_EDGES = (33, 63, 64, 65)


def _rand(rng, n, high=4):
    return rng.integers(0, high, int(n)).astype(np.int8)


def _pad(rows, width=None):
    width = max([len(x) for x in rows] + [1]) if width is None else width
    out = np.full((len(rows), width), PAD, np.int8)
    for i, x in enumerate(rows):
        out[i, :len(x)] = x
    return out, np.array([len(x) for x in rows], np.int32)


def _dna(rng, n):
    return ''.join(rng.choice(list('ACGT'), size=int(n)))


def edit_cases(rng):
    cases = []
    # random codes A..PAD, lengths 0-300, an odd batch, empty rows
    B = 101
    a = rng.integers(0, 6, (B, 300)).astype(np.int8)
    b = rng.integers(0, 6, (B, 300)).astype(np.int8)
    alen = rng.integers(0, 301, B).astype(np.int32)
    blen = rng.integers(0, 301, B).astype(np.int32)
    alen[:3] = 0
    blen[3:6] = 0
    alen[6] = blen[6] = 0
    cases.append(('random codes, lengths 0-300, odd B', a, b, alen, blen))
    # one-base rows against 0-4 bases
    a, alen = _pad([_rand(rng, 1, 5) for _ in range(10)])
    b, blen = _pad([_rand(rng, k % 5, 5) for k in range(10)])
    cases.append(('one-base rows', a, b, alen, blen))
    # long near-equal pairs: many strips, the handoff row in use
    xs = [encode_seq(_dna(rng, n)) for n in (1500, 777, 64, 33, 1200)]
    ys = [encode_seq(mutate(rng, ''.join('ACGT'[c] for c in x), sub=0.05,
                            ins=0.03, dele=0.03)) for x in xs]
    a, alen = _pad(xs)
    b, blen = _pad(ys)
    cases.append(('long near-equal pairs', a, b, alen, blen))
    # junction curation: 20 genome codes against a junction substring
    B = 2501
    junc = _rand(rng, 50)
    xs, ys = [], []
    for _ in range(B):
        st = int(rng.integers(0, 40))
        x = junc[st:st + 20].copy()
        x[rng.random(len(x)) < 0.2] = int(rng.integers(0, 4))
        xs.append(x)
        qb = int(rng.integers(0, 50))
        ys.append(junc[qb:int(rng.integers(qb, 51))])
    a, alen = _pad(xs)
    b, blen = _pad(ys)
    cases.append(('junction curation pairs', a, b, alen, blen))
    # N against N: equal codes, so they match
    xs = [rng.choice([0, N], size=int(rng.integers(1, 80))).astype(np.int8)
          for _ in range(33)]
    ys = [rng.choice([1, N], size=int(rng.integers(1, 80))).astype(np.int8)
          for _ in range(33)]
    a, alen = _pad(xs)
    b, blen = _pad(ys)
    cases.append(('N against N', a, b, alen, blen))
    # every pair of BOUNDARY lengths, codes A..N, y a mutated copy of x
    xs, ys = [], []
    for n in BOUNDARY:
        for m in BOUNDARY:
            x = _rand(rng, n, 5)
            y = np.resize(x, m) if n else _rand(rng, m, 5)
            y[rng.random(m) < 0.1] = N
            xs.append(x)
            ys.append(y)
    a, alen = _pad(xs)
    b, blen = _pad(ys)
    cases.append(('boundary lengths', a, b, alen, blen))
    # a fused round: junction-curation pairs and HPC-like pairs, interleaved
    xs, ys = [], []
    junc = _rand(rng, 50)
    for k in range(240):
        if k % 6 == 0:
            x = encode_seq(_dna(rng, rng.integers(450, 560)))
            xs.append(x)
            ys.append(encode_seq(mutate(
                rng, ''.join('ACGT'[c] for c in x) + _dna(rng, 180),
                sub=0.05, ins=0.04, dele=0.04)))
        else:
            st = int(rng.integers(0, 30))
            xs.append(junc[st:st + 20].copy())
            ys.append(junc[int(rng.integers(0, 20)):int(rng.integers(20, 51))])
    a, alen = _pad(xs)
    b, blen = _pad(ys)
    cases.append(('fused round of one-word and multi-word pairs', a, b,
                  alen, blen))
    return cases


def tb_cases(rng):
    cases = []
    qs, rs = [], []
    for _ in range(40):
        qs.append(_rand(rng, rng.integers(1, 400), 5))
        rs.append(_rand(rng, rng.integers(1, 60), 5))
    for scores in [JUNC, (1, 1, 1, 1), (2, 4, 4, 2)]:
        cases.append(('random fuzz', qs, rs, scores))
    # collapse's rotation step: doubled reads around a mutated window
    qs, rs = [], []
    for _ in range(25):
        junc = _dna(rng, 50)
        read = mutate(rng, _dna(rng, 150) + junc + _dna(rng, 150), sub=0.05,
                      ins=0.03, dele=0.03)
        qs.append(encode_seq(read * 2))
        rs.append(encode_seq(junc))
    cases.append(('junction-like doubled reads', qs, rs, JUNC))
    # no positive cell, empty query, empty reference
    qs = [np.zeros(30, np.int8), np.zeros(0, np.int8), encode_seq('ACGTACGT'),
          np.full(5, N, np.int8)]
    rs = [np.full(20, 1, np.int8), encode_seq('ACGT'), np.zeros(0, np.int8),
          encode_seq('ACGTA')]
    cases.append(('score 0 and empty jobs', qs, rs, (1, 1, 1, 1)))
    # N codes: 0 against anything, tie-heavy
    qs, rs = [], []
    for _ in range(15):
        qs.append(rng.choice(5, size=int(rng.integers(20, 200))).astype(
            np.int8))
        rs.append(rng.choice(5, size=int(rng.integers(5, 50)),
                             p=[0.22, 0.22, 0.22, 0.22, 0.12]).astype(np.int8))
    cases.append(('N bases', qs, rs, JUNC))
    # equal-score ties: the window twice in the query, a doubled read
    # against an exact piece of itself, repeats of one base
    qs, rs = [], []
    for _ in range(12):
        junc = _rand(rng, 40)
        qs.append(np.concatenate([_rand(rng, 30), junc, _rand(rng, 17), junc,
                                  _rand(rng, 9)]))
        rs.append(junc)
        read = _rand(rng, 120)
        qs.append(np.concatenate([read, read]))
        rs.append(read[50:100])
    qs.append(np.zeros(60, np.int8))
    rs.append(np.zeros(7, np.int8))
    cases.append(('equal-score ties', qs, rs, JUNC))
    # references of more than one 32-row strip, queries of any length
    qs, rs = [], []
    for m in (33, 50, 64, 65, 100, 130):
        r = _rand(rng, m)
        q = np.concatenate([_rand(rng, 70), r, _rand(rng, 45)])
        q = encode_seq(mutate(rng, ''.join('ACGT'[c] for c in q), sub=0.04,
                              ins=0.02, dele=0.02))
        qs.append(q)
        rs.append(r)
    cases.append(('references over one strip', qs, rs, JUNC))
    # one-base jobs
    qs = [np.array([c], np.int8) for c in (0, 1, 4, 0, 2)]
    rs = [np.array([c], np.int8) for c in (0, 2, 0, 4, 2)]
    cases.append(('one-base jobs', qs, rs, (1, 1, 1, 1)))
    # PAD codes inside the query score NEG
    qs, rs = [], []
    for _ in range(10):
        q = _rand(rng, rng.integers(40, 300))
        q[rng.random(len(q)) < 0.05] = PAD
        qs.append(q)
        rs.append(q[10:50].copy())
    cases.append(('PAD inside the query', qs, rs, JUNC))
    # references at strip edges, queries under and over 32 codes; and one
    # of more strips than a block's warps
    qs, rs = [], []
    for m in STRIP_EDGES + (300,):
        for n in (7, 31, 90, 400):
            r = _rand(rng, m)
            st = int(rng.integers(0, m - n)) if n < m else 0
            qs.append(r[st:st + n].copy() if n < 32 else np.concatenate(
                [_rand(rng, n // 2), r, _rand(rng, n - n // 2)]))
            rs.append(r)
    cases.append(('strip edges and strip groups', qs, rs, JUNC))
    # direction bytes over a block's shared memory beside small jobs
    qs, rs = [], []
    for n, m in ((4000, 50), (60, 40), (1100, 300), (700, 33)):
        r = _rand(rng, m)
        q = np.concatenate([_rand(rng, n // 2), r, _rand(rng, n - n // 2)])
        qs.append(encode_seq(mutate(rng, ''.join('ACGT'[c] for c in q),
                                    sub=0.04, ins=0.02, dele=0.02)))
        rs.append(r)
    cases.append(('over the shared-memory budget', qs, rs, JUNC))
    return cases
