"""A numpy emulation of csrc/poa_align.cu's schedule against the JAX
package, on the CPU.

The kernel cannot run here, so its arrangement is emulated step for step
and held to ciri_long_tpu/ops/poa_batch.py::poa_align_batch (exact): the
launch shape (C columns a thread, T threads, by the longest sequence), the
tiles of T * C columns, pass A over the predecessors in CSR order (an empty
list as the source row) with the first-maximum slots of M and F, the
source's slot np, the E terms from the prefix maxima of Hpre - k e composed
as the block composes them (a lane's run, the lanes before it by an
inclusive shuffle scan shifted by one, the warps before it through shared
memory, the tiles before by a carry), the direction word case << 14 | slot,
the thread that owns column n keeping the first maximum, and the walk over
the packed words.  Run at the kernel's own shapes and at narrow blocks
(T = 32, 64 with C = 1, 2) so that rows span several tiles and warps.
"""

import numpy as np
import pytest

from ciri_long_tpu.ops.poa_batch import poa_align_batch as jax_align
from ciri_long_tpu_torch.ops.poa_batch import SCORES
from ciri_long_tpu_torch.tools import poa_cases as pc

NEG = -(1 << 28)
LOW = -(1 << 30)
STOP, GAPSEQ, MATCH, GAPGRAPH = 0, 1, 2, 3
SLOT_BITS = 14


def launch_shape(nmax):
    """csrc/poa_align.cu::launch_shape."""
    W = nmax + 1
    C = 1 if W <= 256 else 2 if W <= 512 else 4 if W <= 1024 else 8
    threads = -(-W // C)
    return C, min(256, -(-threads // 32) * 32)


def _source_h(j, s):
    m, x, o1, e1, o2, e2 = s
    jj = np.asarray(j, np.int64)
    return np.where(jj == 0, 0, np.maximum(o1 + (jj - 1) * e1,
                                           o2 + (jj - 1) * e2))


def _exclusive_block_max(g, T):
    """The maximum of g over the lanes and warps before each thread, as the
    kernel gets it: a warp's inclusive shuffle scan shifted up one lane
    (LOW in lane 0), then the totals of the warps before it."""
    warps = g.reshape(T // 32, 32)
    inc = np.maximum.accumulate(warps, axis=1)
    lanes = np.concatenate([np.full((T // 32, 1), LOW), inc[:, :-1]], 1)
    totals = inc[:, -1]
    before = np.concatenate([[LOW], np.maximum.accumulate(totals)[:-1]])
    return np.maximum(lanes, before[:, None]).reshape(T), totals.max()


def emulate_job(bases, offs, preds, seq, nv, n, C, T, s=SCORES):
    """One block: (score, pairs in forward order)."""
    m, x, o1, e1, o2, e2 = s
    W = n + 1
    span = T * C
    H = np.full((nv + 1, W), NEG, np.int64)
    F1 = np.full((nv + 1, W), NEG, np.int64)
    F2 = np.full((nv + 1, W), NEG, np.int64)
    dirw = np.zeros((nv + 1, W), np.int64)
    H[0] = _source_h(np.arange(W), s)
    owner = (n % span) // C
    best, best_row = int(H[0, n]), 0
    for i in range(1, nv + 1):
        b = bases[i - 1]
        lo, hi = offs[i - 1], offs[i]
        rows = list(preds[lo:hi]) if hi > lo else [0]
        carry1 = carry2 = LOW
        for t0 in range(0, W, span):
            cols = np.arange(t0, t0 + span)
            live = cols < W
            jc = np.minimum(cols, W - 1)
            # pass A, predecessors in caller order, strict > keeps the first
            for k, pr in enumerate(rows):
                h = H[pr, jc]
                hl = np.where(jc > 0, H[pr, np.maximum(jc - 1, 0)], NEG)
                v1 = np.maximum(F1[pr, jc] + e1, h + o1)
                v2 = np.maximum(F2[pr, jc] + e2, h + o2)
                v = np.maximum(v1, v2)
                if k == 0:
                    f1p, f2p, fv, mrow = v1, v2, v, hl
                    pf = np.zeros(span, np.int64)
                    pm = np.zeros(span, np.int64)
                else:
                    f1p, f2p = np.maximum(f1p, v1), np.maximum(f2p, v2)
                    pf = np.where(v > fv, k, pf)
                    fv = np.maximum(fv, v)
                    pm = np.where(hl > mrow, k, pm)
                    mrow = np.maximum(mrow, hl)
            hs = _source_h(np.maximum(jc - 1, 0), s)
            pm = np.where(hs > mrow, len(rows), pm)
            mrow = np.maximum(mrow, hs)
            sc = np.where(seq[np.maximum(jc - 1, 0)] == b, m, x)
            mrow = np.where(jc == 0, NEG, mrow + sc)
            pm = np.where(jc == 0, 0, pm)
            hpre = np.maximum(mrow, np.maximum(f1p, f2p))
            hpre = np.where(jc == 0, np.maximum(hpre, 0), hpre)
            g1 = np.where(live, hpre - cols * e1, LOW)
            g2 = np.where(live, hpre - cols * e2, LOW)
            # the scan over the threads' runs, then the carry
            x1, tot1 = _exclusive_block_max(g1.reshape(T, C).max(1), T)
            x2, tot2 = _exclusive_block_max(g2.reshape(T, C).max(1), T)
            m1 = np.maximum(x1, carry1)
            m2 = np.maximum(x2, carry2)
            carry1, carry2 = max(carry1, tot1), max(carry2, tot2)
            # pass B, a thread's columns in order
            for tid in range(T):
                for c in range(C):
                    j = t0 + tid * C + c
                    if j >= W:
                        continue
                    q = tid * C + c
                    e1v = m1[tid] + o1 + (j - 1) * e1 if j > 0 else NEG
                    e2v = m2[tid] + o2 + (j - 1) * e2 if j > 0 else NEG
                    m1[tid] = max(m1[tid], hpre[q] - j * e1)
                    m2[tid] = max(m2[tid], hpre[q] - j * e2)
                    hv = max(hpre[q], e1v, e2v)
                    is_e = hv in (e1v, e2v)
                    is_m = hv == mrow[q]
                    is_f = hv in (f1p[q], f2p[q])
                    cs = GAPSEQ if is_e else MATCH if is_m else \
                        GAPGRAPH if is_f else STOP
                    slot = pm[q] if is_m and not is_e else pf[q]
                    H[i, j], F1[i, j], F2[i, j] = hv, f1p[q], f2p[q]
                    dirw[i, j] = (cs << SLOT_BITS) | slot
                    if j == n and tid == owner and hv > best:
                        best, best_row = hv, i
    # thread 0's walk over the packed words
    pairs = []
    i, j, stopped = best_row, n, False
    while j > 0:
        cs, k = GAPSEQ, 0
        if not stopped and i > 0:
            cs, k = dirw[i, j] >> SLOT_BITS, dirw[i, j] & ((1 << SLOT_BITS)
                                                           - 1)
        if cs == STOP:
            stopped = True
            continue
        if cs == GAPSEQ:
            j -= 1
            pairs.append((-1, j))
            continue
        lo, np_ = offs[i - 1], offs[i] - offs[i - 1]
        if cs == MATCH:
            j -= 1
            pairs.append((i - 1, j))
            i = preds[lo + k] if k < np_ else 0
        else:
            pairs.append((i - 1, -1))
            i = preds[lo + k] if np_ > 0 else 0
    return best, pairs[::-1]


def _dense(offs, preds, Vmax):
    B = offs.shape[0]
    P = max(1, int(np.diff(offs, axis=1).max(initial=0)))
    pr = np.zeros((B, Vmax, P), np.int32)
    npred = np.ones((B, Vmax), np.int32)
    for b in range(B):
        for i in range(Vmax):
            lo, hi = offs[b, i], offs[b, i + 1]
            if hi > lo:
                pr[b, i, :hi - lo] = preds[lo:hi]
                npred[b, i] = hi - lo
    return pr, npred


def _check(arrays, shape=None):
    bases, offs, preds, seqs, nv, ns = arrays
    C, T = shape or launch_shape(seqs.shape[1])
    pr, npred = _dense(offs, preds, bases.shape[1])
    score, aln, acnt = jax_align(bases, nv, pr, npred, seqs, ns, SCORES)
    cap = aln.shape[1]
    for b in range(len(nv)):
        got = emulate_job(bases[b], offs[b], preds, seqs[b], int(nv[b]),
                          int(ns[b]), C, T)
        assert got[0] == int(score[b])
        assert got[1] == [tuple(p) for p in aln[b, cap - acnt[b]:]]


@pytest.mark.parametrize("shape", [None, (1, 32), (2, 32), (1, 64)],
                         ids=['launch', 'C1T32', 'C2T32', 'C1T64'])
def test_emulation_matches_jax(rng, shape):
    for label, arrays in pc.poa_cases(rng):
        if np.diff(arrays[1], axis=1).max(initial=0) <= 8:
            _check(arrays, shape)


def test_emulation_at_the_wide_launch_shapes(rng):
    """Sequences at the edges of the run widths C = 2, 4 (the real launch
    shapes), on small graphs."""
    for n in (255, 256, 511, 512, 700):
        g = pc.backbone(rng.integers(0, 4, 12))
        seq = rng.integers(0, 4, n).astype(np.int8)
        _check(pc.batch([g], [seq]))


def test_launch_shape_rule():
    assert launch_shape(0) == (1, 32)
    assert launch_shape(255) == (1, 256)
    assert launch_shape(256) == (2, 160)
    assert launch_shape(1023) == (4, 256)
    assert launch_shape(1024) == (8, 160)
    assert launch_shape(2600) == (8, 256)
