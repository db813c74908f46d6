"""A numpy emulation of csrc/poa_align.cu's schedule against the JAX
package, on the CPU.

The kernel cannot run here, so its arrangement is emulated step for step
and held to ciri_long_tpu/ops/poa_batch.py::poa_align_batch (exact): the
plan (ops/poa_batch.py::poa_plan: C columns a lane, warps, ring depth,
spill rows), warp w on rows w + 1, w + 1 + K, ..., each in chunks of 32 C
columns that wait for the row before's progress counter, pass A over the
predecessors in CSR order (an empty list as the source row) with the
first-maximum rows of M and F, each predecessor taken where the kernel
takes it (the source inline, the ring up to ``depth`` rows back, the spill
copy beyond; the column left of a lane's run a shuffle, or for lane 0 the
diagonal term lane 31 carried from the chunk before), the E terms from the
prefix maxima of Hpre - k e (a lane's run, an inclusive shuffle scan
shifted by one lane, the chunks before by a carry), the direction word
case << 30 | row, each warp's first maximum of column n folded at the end,
and warp 0's walk, a round of 32 lanes' loads serving one step or more.

The warps run concurrently: a scheduler interleaves their chunks, each
split into its reads (after its wait) and its writes with the counter
(seeded random turns, lowest warp first or highest first), so that a read
of a ring slot that does not hold the row asked for fails, as does a write
over a row some reader has not read yet.  Run at the kernel's own shapes,
at narrow blocks (one warp of 1 or 2 columns a lane, two and four warps)
and at ring depths 1, 2 and 3, which spill.  A ring one slot short, a plan
without spill rows and chunks that do not wait must fail.
"""

import functools

import numpy as np
import pytest

from ciri_long_tpu.ops.poa_batch import poa_align_batch as jax_align
from ciri_long_tpu_torch.ops.poa_batch import (SCORES, launch_shape,
                                               padded_width, poa_plan)
from ciri_long_tpu_torch.tools import poa_cases as pc

NEG = -(1 << 28)
LOW = -(1 << 30)
STOP, GAPSEQ, MATCH, GAPGRAPH = 0, 1, 2, 3
CASE_SHIFT = 30
WALK_RUN = 16


def _source_h(j, s):
    m, x, o1, e1, o2, e2 = s
    jj = np.asarray(j, np.int64)
    return np.where(jj == 0, 0, np.maximum(o1 + (jj - 1) * e1,
                                           o2 + (jj - 1) * e2))


def _edges(offs, preds, nv):
    """(row i, predecessor p) of every list entry of one job."""
    o = np.asarray(offs[:nv + 1], np.int64)
    rows = np.repeat(np.arange(1, nv + 1), np.diff(o))
    return rows, np.asarray(preds[o[0]:o[-1]], np.int64)


def plan_rows(offs, preds, nv, Vmax, depth):
    """sidx [Vmax + 1] of one job under a ring of ``depth`` rows:
    poa_plan's rule (a row is spilled when a successor reaches it from
    farther)."""
    rows, p = _edges(offs, preds, nv)
    far = np.unique(p[(p > 0) & (rows - p > depth)])
    sidx = np.full(Vmax + 1, -1, np.int64)
    sidx[far] = np.arange(len(far))
    return sidx


class Ring:
    """``slots`` rows of (H, V1, V2) over Wp columns in shared memory, each
    column tagged with the row that wrote it."""

    def __init__(self, slots, Wp):
        self.val = np.zeros((max(slots, 1), 3, Wp), np.int64)
        self.row = np.full((max(slots, 1), Wp), -1)

    def read(self, slot, p, cols):
        assert (self.row[slot, cols] == p).all(), \
            'ring slot {} holds rows {} where row {} was asked for'.format(
                slot, sorted(set(self.row[slot, cols].tolist())), p)
        return self.val[slot][:, cols]

    def write(self, slot, i, cols, values):
        self.val[slot][:, cols] = values
        self.row[slot, cols] = i


def scan_chunk(hpre, cols, carry, s):
    """The E terms' scan of one chunk (hpre and cols [32, C]): a lane's
    run, an inclusive shuffle scan shifted by one lane, then the chunks
    before (``carry``, a pair).  Returns the (m1, m2) each lane starts its
    pass B from and the carry past the chunk."""
    m, x, o1, e1, o2, e2 = s
    s1 = np.maximum.accumulate((hpre - cols * e1).max(1))
    s2 = np.maximum.accumulate((hpre - cols * e2).max(1))
    m1 = np.maximum(np.concatenate([[LOW], s1[:-1]]), carry[0])
    m2 = np.maximum(np.concatenate([[LOW], s2[:-1]]), carry[1])
    return m1, m2, (max(carry[0], int(s1[-1])), max(carry[1], int(s2[-1])))


def pass_b(hpre, cols, m1, m2, s):
    """E and H along each lane's run from the (m1, m2) it starts from:
    (e1, e2, h) [32, C].  Column 0 takes no guard: from LOW its E lies
    below any Hpre there."""
    m, x, o1, e1, o2, e2 = s
    e1v, e2v, hv = (np.zeros_like(hpre) for _ in range(3))
    for c in range(hpre.shape[1]):
        j = cols[:, c]
        e1v[:, c] = m1 + o1 + (j - 1) * e1
        e2v[:, c] = m2 + o2 + (j - 1) * e2
        m1 = np.maximum(m1, hpre[:, c] - j * e1)
        m2 = np.maximum(m2, hpre[:, c] - j * e2)
        hv[:, c] = np.maximum(hpre[:, c], np.maximum(e1v[:, c], e2v[:, c]))
    return e1v, e2v, hv


class Block:
    """One block of the kernel on one job: K warps, each a list of chunk
    events run by ``run``."""

    def __init__(self, bases, offs, preds, seq, nv, n, nmax, C, T, depth,
                 sidx, slots=None, wait=True, s=SCORES):
        self.bases, self.offs, self.preds = bases, offs, preds
        self.seq = np.asarray(seq, np.int64)
        self.nv, self.n, self.C, self.K = nv, n, C, T // 32
        self.W, self.Wp = n + 1, padded_width(nmax)
        self.nch = -(-self.W // (32 * C))
        self.depth, self.sidx, self.wait, self.s = depth, sidx, wait, s
        self.slots = depth if slots is None else slots
        self.ring = Ring(self.slots, self.Wp)
        self.spill = {}                 # slot -> (row tags, values [3, Wp])
        self.dirw = np.zeros((nv + 1, self.Wp), np.int64)
        self.done = [0] * self.K        # each warp's published progress
        self.read_done = set()          # (row, chunk) whose reads are done
        self.best = [(LOW, -1)] * self.K

    def plist(self, i):
        lo, hi = self.offs[i - 1], self.offs[i]
        return [int(p) for p in self.preds[lo:hi]] if hi > lo else [0]

    def ready(self, i, ch):
        """Whether row i may take chunk ch: row i - 1 has published it."""
        if i == 1 or not self.wait:
            return True
        return self.done[(i - 2) % self.K] >= (i - 2) * self.nch + ch + 1

    def read(self, w, i, ch, carry, mn, pmn):
        """A chunk's reads and its arithmetic: what its writes store."""
        m, x, o1, e1, o2, e2 = s = self.s
        C, W, Wp, n = self.C, self.W, self.Wp, self.n
        c0 = ch * 32 * C + np.arange(32) * C
        live = c0 < W
        cols = c0[:, None] + np.arange(C)
        lcols = cols[live].ravel()
        code = np.where((cols >= 1) & (cols <= n), self.seq[np.clip(
            cols - 1, 0, max(n - 1, 0))] if n else 5, 5)
        mnext, pmnext = NEG, 0
        for k, p in enumerate(self.plist(i)):
            if p == 0:
                h = _source_h(cols, s)
                v1 = np.maximum(NEG + e1, h + o1)
                v2 = np.maximum(NEG + e2, h + o2)
            else:
                if i - p <= self.depth:
                    vals = np.zeros((3, Wp), np.int64)
                    vals[:, lcols] = self.ring.read(p % self.slots, p,
                                                    lcols)
                else:
                    key = int(self.sidx[p])
                    assert key >= 0 and key in self.spill, \
                        'row {} was not spilled'.format(p)
                    tags, vals = self.spill[key]
                    assert (tags[lcols] == p).all()
                at = np.minimum(cols, Wp - 1)
                h, v1, v2 = (np.where(live[:, None], vals[q][at], NEG)
                             for q in range(3))
            hl = np.concatenate([h[:1, C - 1], h[:-1, C - 1]])
            hlc = np.concatenate([hl[:, None], h[:, :-1]], 1)
            if k == 0:
                f1p, f2p = v1.copy(), v2.copy()
                pf = np.full((32, C), p)
                mrow, pm = hlc.copy(), np.full((32, C), p)
            else:
                v = np.maximum(v1, v2)
                pf = np.where(v > np.maximum(f1p, f2p), p, pf)
                f1p, f2p = np.maximum(f1p, v1), np.maximum(f2p, v2)
                pm = np.where(hlc > mrow, p, pm)
                mrow = np.maximum(mrow, hlc)
            if k == 0 or h[31, C - 1] > mnext:
                mnext, pmnext = int(h[31, C - 1]), p
        mrow[0, 0], pm[0, 0] = mn, pmn
        # the source, the scores, Hpre
        hs = _source_h(np.maximum(cols - 1, 0), s)
        pm = np.where(hs > mrow, 0, pm)
        mrow = np.maximum(mrow, hs) + np.where(code == self.bases[i - 1], m,
                                               x)
        mrow = np.where(cols == 0, NEG, mrow)
        pm = np.where(cols == 0, 0, pm)
        hpre = np.maximum(mrow, np.maximum(f1p, f2p))
        hpre = np.where(cols == 0, np.maximum(hpre, 0), hpre)
        m1, m2, carry = scan_chunk(hpre, cols, carry, s)
        e1v, e2v, hv = pass_b(hpre, cols, m1, m2, s)
        is_e = (hv == e1v) | (hv == e2v)
        is_m = hv == mrow
        is_f = (hv == f1p) | (hv == f2p)
        cs = np.where(is_e, GAPSEQ, np.where(is_m, MATCH, np.where(
            is_f, GAPGRAPH, STOP)))
        word = (cs << CASE_SHIFT) | np.where(is_m & ~is_e, pm, pf)
        hit = (cols == n) & (hv > self.best[w][0])
        if hit.any():
            self.best[w] = (int(hv[hit][0]), i)
        values = np.stack([hv[live].ravel(),
                           np.maximum(f1p + e1, hv + o1)[live].ravel(),
                           np.maximum(f2p + e2, hv + o2)[live].ravel()])
        self.read_done.add((i, ch))
        return (lcols, word[live].ravel(), values), carry, mnext, pmnext

    def write(self, w, i, ch, lcols, word, values):
        """A chunk's writes, then its counter."""
        self.dirw[i, lcols] = word
        if self.depth > 0:
            old = i - self.slots
            for r in range(max(old + 1, 1), i):
                if old > 0 and old in self.plist(r) and r - old <= \
                        self.depth:
                    assert (r, ch) in self.read_done, \
                        'ring slot {} written over row {} before row {} ' \
                        'read it'.format(i % self.slots, old, r)
            self.ring.write(i % self.slots, i, lcols, values)
        if self.sidx[i] >= 0:
            tags, vals = self.spill.setdefault(
                int(self.sidx[i]), (np.full(self.Wp, -1),
                                    np.zeros((3, self.Wp), np.int64)))
            tags[lcols] = i
            vals[:, lcols] = values
        self.done[w] = (i - 1) * self.nch + ch + 1

    def warp(self, w):
        """Warp w's events: ('read', row, chunk) and ('write', ...), each
        yielded before it runs."""
        for i in range(w + 1, self.nv + 1, self.K):
            carry, mn, pmn = (LOW, LOW), NEG, 0
            for ch in range(self.nch):
                yield 'read', i, ch
                out, carry, mnext, pmnext = self.read(w, i, ch, carry, mn,
                                                      pmn)
                yield 'write', i, ch
                self.write(w, i, ch, *out)
                mn, pmn = mnext, pmnext

    def run(self, order='random', seed=0):
        """The warps' events interleaved: at each turn a warp whose next
        event may run (a read waits for its row before) runs it; ``order``
        picks among them at random, the lowest warp or the highest."""
        rng = np.random.default_rng(seed)
        gens = [self.warp(w) for w in range(self.K)]
        nxt = [next(g, None) for g in gens]
        while any(e is not None for e in nxt):
            can = [w for w, e in enumerate(nxt) if e is not None and (
                e[0] == 'write' or self.ready(e[1], e[2]))]
            assert can, 'the warps wait on each other'
            w = can[int(rng.integers(len(can)))] if order == 'random' \
                else can[0] if order == 'low' else can[-1]
            nxt[w] = next(gens[w], None)
        end = (int(_source_h(self.n, self.s)), 0)
        for b, r in self.best:
            if r >= 0 and (b > end[0] or (b == end[0] and r < end[1])):
                end = (b, r)
        return end


def emulate_job(bases, offs, preds, seq, nv, n, nmax, C, T, depth, sidx,
                slots=None, wait=True, order='random', seed=0,
                walk_stats=None):
    """One block: (score, pairs in forward order).  ``slots`` overrides the
    ring's slot count (rows in slot row % slots); ``wait`` False lets a
    chunk run before the row before has published it."""
    block = Block(bases, offs, preds, seq, nv, n, nmax, C, T, depth, sidx,
                  slots, wait)
    best, end_row = block.run(order, seed)
    pairs = emulate_walk(block.dirw, offs, preds, end_row, n, walk_stats)
    assert len(pairs) <= nv + nmax + 1
    return best, pairs


def emulate_walk(dirw, offs, preds, i, j, stats=None):
    """Warp 0's walk from (i, j): each round every lane loads the word of
    (i, j), lanes 1-15 (i, j - lane), lanes 16-31 (p_k, j - 1) and (p_k, j)
    of predecessor k < 8; the step's word, then the next step's while a
    lane holds it.  Pairs in forward order."""
    back = []
    stopped = False
    rounds = steps = 0
    while j > 0 and i > 0 and not stopped:
        lo, np_ = offs[i - 1], offs[i] - offs[i - 1]
        cand = []
        for lane in range(1, 32):
            if lane < WALK_RUN:
                cr, cc = i, j - lane
            else:
                k = (lane - WALK_RUN) >> 1
                cr = int(preds[lo + k]) if k < np_ else 0
                cc = j - 1 + (lane & 1)
            cand.append((cr, cc, int(dirw[cr, cc]) if cr > 0 and cc > 0
                         else 0))
        w = int(dirw[i, j])
        rounds += 1
        while True:
            cs = w >> CASE_SHIFT
            if cs == STOP:
                stopped = True
                break
            steps += 1
            if cs == GAPSEQ:
                j -= 1
                back.append((-1, j))
            else:
                pair_i = i - 1
                if cs == MATCH:
                    j -= 1
                back.append((pair_i, j if cs == MATCH else -1))
                i = w & ((1 << CASE_SHIFT) - 1)
            if j == 0 or i == 0:
                break
            hit = [c for c in cand if c[0] == i and c[1] == j]
            if not hit:
                break
            w = hit[0][2]
    back.extend((-1, jj) for jj in range(j - 1, -1, -1))
    if stats is not None:
        stats['rounds'] = stats.get('rounds', 0) + rounds
        stats['steps'] = stats.get('steps', 0) + steps
    return back[::-1]


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


def _jax(arrays):
    bases, offs, preds, seqs, nv, ns = arrays
    pr, npred = _dense(offs, preds, bases.shape[1])
    score, aln, acnt = jax_align(bases, nv, pr, npred, seqs, ns, SCORES)
    cap = aln.shape[1]
    return [(int(score[b]), [tuple(p) for p in aln[b, cap - acnt[b]:]])
            for b in range(len(nv))]


@functools.lru_cache(maxsize=None)
def _cases():
    """tools/poa_cases.py's cases (one seed for the module) with JAX's
    answers."""
    return [(label, arrays, _jax(arrays))
            for label, arrays in pc.poa_cases(np.random.default_rng(20261017))]


def _check(arrays, want, shape=None, depth=None, slots=None, spill=True,
           wait=True, order='random', walk_stats=None):
    """Every job of a batch through the emulation, against JAX's answers.
    ``shape`` (C, T) forces the block; ``depth`` the ring."""
    bases, offs, preds, seqs, nv, ns = arrays
    Vmax, nmax = bases.shape[1], seqs.shape[1]
    plan = poa_plan(offs, preds, nv, ns, Vmax, nmax, depth=depth,
                    shape=shape)
    for b in range(len(nv)):
        sidx = plan_rows(offs[b], preds, int(nv[b]), Vmax, plan.depth)
        if not spill:
            sidx[:] = -1
        got = emulate_job(bases[b], offs[b], preds, seqs[b], int(nv[b]),
                          int(ns[b]), nmax, plan.cols, 32 * plan.warps,
                          plan.depth, sidx, slots, wait, order, seed=b,
                          walk_stats=walk_stats)
        assert got == want[b]


SHAPES = [None, (1, 32), (2, 32), (1, 64), (1, 128)]
SHAPE_IDS = ['launch', 'C1T32', 'C2T32', 'C1T64', 'C1T128']


@pytest.mark.parametrize("depth", [None, 1, 2, 3],
                         ids=['plan', 'D1', 'D2', 'D3'])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_emulation_matches_jax(shape, depth):
    """Every case at the launch shape and at narrow blocks, under the
    plan's ring depth and at depths 1-3 (rows reached from farther are
    spilled), the warps' turns at random."""
    for label, arrays, want in _cases():
        _check(arrays, want, shape, depth)


@pytest.mark.parametrize("order", ['low', 'high'])
def test_warp_turns_do_not_matter(order):
    """The lowest or the highest ready warp always first: the same
    answers at two and four warps."""
    for label, arrays, want in _cases():
        _check(arrays, want, (1, 64), 2, order=order)
        _check(arrays, want, (1, 128), None, order=order)


def test_emulation_at_the_wide_launch_shapes(rng):
    """Sequences at the edges of the run widths C = 2, 4, 8 (the real
    launch shapes), on small graphs, under the plan's depth and a ring of
    2."""
    for n in (511, 512, 700, 1100, 2100):
        graphs, seqs = zip(*[pc._fused(rng, 30, 3) for _ in range(2)])
        seqs = [np.resize(s, n) for s in seqs]
        arrays = pc.batch(graphs, seqs)
        want = _jax(arrays)
        _check(arrays, want)
        _check(arrays, want, depth=2)


@pytest.mark.parametrize("scores", [SCORES, (10, -4, -24, -1, -8, -2)],
                         ids=['collapse', 'pieces_swapped'])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_chunk_scan_carries_the_row(C, scores):
    """scan_chunk and pass_b chunk by chunk give H = max(Hpre, E1, E2) of
    the whole row (the plain prefix maxima), on rows whose E terms come
    from chunks back (Hpre falling along the row, a peak early); under
    collapse's scores the long gaps take the second piece, with the pieces
    swapped the first."""
    m, x, o1, e1, o2, e2 = scores
    rng = np.random.default_rng(C)
    nch = 5
    j = np.arange(nch * 32 * C)
    for _ in range(20):
        row = -3 * j + rng.integers(-20, 20, len(j))
        row[rng.integers(0, 64 * C)] = int(rng.integers(0, 300))
        carry, got = (LOW, LOW), []
        for ch in range(nch):
            cols = (ch * 32 * C + np.arange(32) * C)[:, None] + np.arange(C)
            m1, m2, carry = scan_chunk(row[cols], cols, carry, scores)
            got.append(pass_b(row[cols], cols, m1, m2, scores)[2].ravel())
        before1 = np.concatenate([[LOW], np.maximum.accumulate(
            row - j * e1)[:-1]])
        before2 = np.concatenate([[LOW], np.maximum.accumulate(
            row - j * e2)[:-1]])
        e1v = np.where(j > 0, before1 + o1 + (j - 1) * e1, NEG)
        e2v = np.where(j > 0, before2 + o2 + (j - 1) * e2, NEG)
        assert np.array_equal(np.concatenate(got), np.maximum(
            row, np.maximum(e1v, e2v)))


def test_launch_shape_rule():
    assert launch_shape(0) == (1, 32)
    assert launch_shape(255) == (1, 256)
    assert launch_shape(511) == (1, 512)
    assert launch_shape(750) == (2, 384)
    assert launch_shape(1023) == (2, 512)
    assert launch_shape(1024) == (4, 288)
    assert launch_shape(2600) == (8, 256)


def test_plan_covers_every_lookback():
    """poa_plan's default depth spills nothing on the cases (the ring
    reaches every predecessor), its flags are plan_rows', and a forced
    small depth spills exactly the rows reached from beyond it; the long
    back edges and the in-degree 130 star take the spill at depth 2."""
    spilled = {}
    for label, arrays, _ in _cases():
        bases, offs, preds, seqs, nv, ns = arrays
        Vmax, nmax = bases.shape[1], seqs.shape[1]
        auto = poa_plan(offs, preds, nv, ns, Vmax, nmax)
        assert auto.spill_rows == 0 and auto.sidx is None, label
        assert (auto.cols, 32 * auto.warps) == launch_shape(nmax)
        for depth in (1, 2, 3):
            plan = poa_plan(offs, preds, nv, ns, Vmax, nmax, depth=depth)
            flags = [plan_rows(offs[b], preds, int(nv[b]), Vmax, depth)
                     for b in range(len(nv))]
            assert plan.spill_rows == max((f >= 0).sum() for f in flags)
            if plan.spill_rows:
                assert np.array_equal(plan.sidx.numpy(), np.stack(flags))
            spilled[label, depth] = plan.spill_rows
    assert spilled['long back edges', 2] > 0
    assert spilled['in-degree 12 and 130', 2] > 0


def test_spill_flags_off_fail():
    """Without the spill rows a small ring loses the rows reached from
    beyond it: the emulation must fail on the long back edges."""
    label, arrays, want = next(c for c in _cases()
                               if c[0] == 'long back edges')
    with pytest.raises(AssertionError, match='not spilled'):
        _check(arrays, want, depth=2, spill=False)


def test_ring_slot_reused_one_row_early_fails():
    """A ring of depth - 1 slots under a plan of ``depth`` reuses a slot
    one row early: a read finds another row in it, or a write lands over a
    row not read yet, and the emulation must fail."""
    label, arrays, want = next(c for c in _cases()
                               if c[0] == 'fused graphs')
    with pytest.raises(AssertionError, match='ring slot'):
        _check(arrays, want, depth=3, slots=2)
    with pytest.raises(AssertionError, match='ring slot'):
        _check(arrays, want, shape=(1, 128), depth=3, slots=2)


def test_chunk_without_its_wait_fails():
    """A chunk that does not wait for the row before's counter reads a
    ring slot not written yet: the emulation must fail (the highest ready
    warp first runs the rows out of order)."""
    label, arrays, want = next(c for c in _cases()
                               if c[0] == 'fused graphs')
    with pytest.raises(AssertionError, match='ring slot'):
        _check(arrays, want, shape=(1, 128), wait=False, order='high')


def test_walk_rounds_serve_more_than_one_step():
    """The walk's speculative loads: on the fused graphs a round serves
    more than one step on average."""
    label, arrays, want = _cases()[0]
    stats = {}
    _check(arrays, want, walk_stats=stats)
    assert stats['steps'] > 1.5 * stats['rounds']
