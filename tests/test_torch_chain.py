"""The port's chaining (ops/chain.py, X2) against the JAX package on the CPU.

- A: ``chain_dp_plain`` bit-equal (f and pre) to the JAX package's host
  ``GenomeAligner._chain_dp`` in the form this tree has: the native core
  (std::log2 table) when ``ciri_long_tpu._chaincore`` is built, else its
  numpy twin (np.log2); the plain DP takes the matching table.  Random rows
  of tests/test_chain_device.py's generator and tools/chain_cases.py's edge
  rows: contig changes, both gap directions, g over 65 535, gaps at exactly
  max_gap_r and max_gap_q, A = 1, 2, 64, 65 and 8192, tied candidates and
  tied scores.
- B: ``chain_extract_plain`` equal to the JAX ``backtrack_chains`` on the
  same (f, pre), truncation and short-path rejects included.
- C: the JAX package's float32 device program (``chain_extract_batch`` run
  on the CPU) against the port's float64 chains.
- D: the port's ``map_batch`` on its card branch (the CUDA call replaced by
  the plain route) against its host route and the JAX ``map_batch``, with
  the host chain core made to fail; ``_map_many`` on the card sends a single
  read through it too, every anchor kept.
- E: csrc/chain_dp.cu's schedule emulated lane by lane (``emulate_dp``: the
  older window reduced by pushes into the steps each lane owns, the terms
  queued AHEAD steps, the newest candidate set against that best last)
  bit-equal to ``chain_dp_plain`` and to the JAX host ``_chain_dp`` on
  random rows, the edge rows and tools/chain_cases.py's ``dp_cases``
  (ties across the whole window, a candidate scoring exactly k, empty and
  one-anchor rows, gaps at the limits less one, at and past them).
- F: csrc/chain_dp.cu's extraction emulated (``emulate_extract``: each
  anchor's owner, the first candidate in greedy order at or below it in
  the pre forest, by two doubling passes, the largest f below each anchor
  and then the smallest index with that f, whose folds run in a random
  order as the block's threads race; the owners' counts; the chains and
  their ids by counting) equal to ``chain_extract_plain``, the JAX
  ``backtrack_chains`` and, on DP rows, the JAX ``chain_extract_batch``,
  on tools/chain_cases.py's ``extract_cases`` (tied f, short paths,
  max_chains reached, no candidate, rows over SMEM_ROW, a chain 8 192
  deep, brooms of candidates sharing ancestors); and the invariant it
  rests on, the serial greedy's used set closed under pre after every
  walk.
"""

import ctypes
import ctypes.util

import numpy as np
import pytest
import torch

from ciri_long_tpu.io.genome import Genome as JaxGenome
from ciri_long_tpu.models.aligner import GenomeAligner as JaxAligner
from ciri_long_tpu.ops import chain as jchain
from ciri_long_tpu_torch.io.genome import Genome
from ciri_long_tpu_torch.models import aligner as taligner
from ciri_long_tpu_torch.models.aligner import GenomeAligner
from ciri_long_tpu_torch.ops import chain as tchain
from ciri_long_tpu_torch.pipeline import find_bsj as tfb
from ciri_long_tpu_torch.tools import chain_cases as cases
from ciri_long_tpu_torch.tools.world import _write_fasta
from tests.test_chain_device import _random_anchor_batch
from tests.test_pipeline_call import make_rolling_read, rand_seq
from tests.test_poa import mutate

torch.set_num_threads(1)

K = 15
GAP_R, GAP_Q = 200_000, 5_000
N_TABLE = tchain.table_size(GAP_R, GAP_Q)


def _jax_table():
    """log2(g + 1) as the JAX package's host _chain_dp takes it here."""
    try:
        from ciri_long_tpu import _chaincore  # noqa: F401
    except ImportError:
        return np.log2(np.arange(N_TABLE, dtype=np.float64) + 1.0)
    libm = ctypes.CDLL(ctypes.util.find_library('m'))
    libm.log2.argtypes = [ctypes.c_double]
    libm.log2.restype = ctypes.c_double
    return np.array([libm.log2(g + 1.0) for g in range(N_TABLE)])


@pytest.fixture(scope='module')
def jal():
    return JaxAligner(JaxGenome.from_dict({'c': 'ACGT' * 500}))


def _plain_dp(rows, table, k=K):
    offs, r, q, c = cases.csr(rows)
    f, pre = tchain.chain_dp_plain(
        torch.from_numpy(offs), *(torch.from_numpy(x.astype(np.int32))
                                  for x in (r, q, c)),
        torch.from_numpy(table), k, 64, GAP_R, GAP_Q)
    return offs, f.numpy(), pre.numpy()


def test_chain_dp_plain_bit_equal_to_jax_host(jal, rng):
    """Case A: f and pre bit-equal to the JAX host _chain_dp on random and
    edge rows (tools/chain_cases.py; the float64 host route is the
    arbiter)."""
    rows = cases.random_rows(rng, 8, 512) + cases.edge_rows(rng)
    offs, f, pre = _plain_dp(cases.local(rows), _jax_table())
    for b, (r, q, c) in enumerate(rows):
        fj, pj = jal._chain_dp(r, q, c, GAP_R, GAP_Q)
        lo, hi = offs[b], offs[b + 1]
        assert np.array_equal(f[lo:hi].view(np.int64), fj.view(np.int64)), b
        assert np.array_equal(pre[lo:hi], pj), b
    # the edges were reached: a chain across the contig change refused;
    # both gap directions; g past the native table and max_gap_r taken, one
    # past it refused; max_gap_q taken, one past it refused; ties of the
    # diagonal resolved to the smallest j
    pre_of = [jal._chain_dp(*rows[t], GAP_R, GAP_Q)[1] for t in range(19)]
    c = rows[8][2]
    assert c.any() and not c.all()
    assert all(c[j] == c[i] for i, j in enumerate(pre_of[8]) if j >= 0)
    steps = np.diff(rows[9][1]) - np.diff(rows[9][0])
    assert (steps > 0).any() and (steps <= 0).any()
    assert pre_of[10][40:].tolist() == [39, 40, -1]
    assert pre_of[11][40] == 39 and pre_of[11][-1] == -1
    assert [len(rows[t][0]) for t in range(12, 17)] == [1, 2, 64, 65, 8192]
    assert pre_of[17][3:].tolist() == list(range(200 - 3))


DP_AHEAD = 8          # csrc/chain_dp.cu's AHEAD


def _dp_term(lg, j, t, k, gap_r, gap_q):
    """csrc/chain_dp.cu's term_of and pen_of for anchors j and t, in its
    float64 operations (skip from an int32 max, 0.5 * (g + lg) for the
    core's 0.5 * g + 0.5 * lg): (alpha, pen), pen inf where j is not
    admissible."""
    (rj, qj, cj), (rt, qt, ct) = j, t
    dr, dq = rt - rj, qt - qj
    ok = 0 < dr <= gap_r and 0 < dq <= gap_q and cj == ct
    g = abs(dr - dq) if ok else 0
    lgv = np.float64(lg[g])
    skip = np.float64(0.1) * np.float64(max(dq, 2 * k) - 2 * k)
    lt = lgv if dr >= dq else np.float64(0.5) * (np.float64(g) + lgv)
    return min(dq, dr, k), (float(lt + skip) if ok else np.inf)


def emulate_dp(r, q, c, lg, k=K, gap_r=GAP_R, gap_q=GAP_Q):
    """csrc/chain_dp.cu's chain_dp_kernel on one row, lane by lane, in
    float64: (f, pre).  Slot s of lane l owns the steps t = l + 32 s (mod
    64); step i's f comes from its newest candidate (i - 1, whose terms
    its owner broadcast) against the best of the older window, which lane
    (i & 31)'s slot pushed up as each f arrived (strict >, so the smallest
    j keeps a tie) and broadcast a step earlier; the terms of each push were
    made DP_AHEAD steps before it from the anchors the slots held then."""
    n = len(r)
    row = [(int(a), int(b), int(x)) for a, b, x in zip(r, q, c)]

    def anchor(a):
        return row[a] if a < n else (0, 0, 0)

    held = [[anchor(l + 32 * s) for s in range(2)] for l in range(32)]
    pref = [[anchor(l + 64) for l in range(32)],
            [anchor(l + 96) for l in range(32)]]

    def terms_step(v):
        if v % 32 == 0 and v > 0:
            pref[0], pref[1] = pref[1], [anchor(v + 96 + l)
                                         for l in range(32)]
        held[v & 31][(v >> 5) & 1] = pref[0][v & 31]
        j = anchor(v)
        return ([[_dp_term(lg, j, held[l][s], k, gap_r, gap_q)
                  for s in range(2)] for l in range(32)],
                _dp_term(lg, j, anchor(v + 1), k, gap_r, gap_q))

    queue = [terms_step(u) for u in range(DP_AHEAD)]
    best = [[(-np.inf, -1)] * 2 for _ in range(32)]
    al_c, pe_c, old, f_prev = 0, np.inf, (float(k), -1), 0.0
    f = np.zeros(n)
    pre = np.zeros(n, np.int64)
    for i in range(n):
        u = i % DP_AHEAD
        terms, newest = queue[u]
        bo = best[(i + 1) & 31][((i + 1) >> 5) & 1]
        cand = (f_prev + al_c) - pe_c
        f[i], pre[i] = (cand, i - 1) if cand > old[0] else old
        f_prev = f[i]
        for lane in range(32):
            for s in range(2):
                d = (lane + 32 * s - i) & 63
                alpha, pen = terms[lane][s]
                cand = (f[i] + alpha) - pen
                if d == 0 or (d >= 2 and cand > best[lane][s][0]):
                    best[lane][s] = (cand, i)
        al_c, pe_c = newest
        old = bo if bo[0] > k else (float(k), -1)
        queue[u] = terms_step(i + DP_AHEAD)
    return f, pre


@pytest.mark.parametrize('group', ['random', 'edges', 'dp_cases'])
def test_dp_kernel_schedule_bit_equal(jal, rng, group):
    """Case E: the kernel's schedule (emulate_dp) bit-equal, f and pre, to
    chain_dp_plain and to the JAX host _chain_dp row by row."""
    if group == 'random':
        rows = cases.random_rows(rng, 6, 600)
    elif group == 'edges':
        rows = cases.edge_rows(rng)
    else:
        named = cases.dp_cases(rng, GAP_R, GAP_Q, K)
        rows = list(named.values())
    table = _jax_table()
    offs, f, pre = _plain_dp(cases.local(rows), table)
    for b, (r, q, c) in enumerate(cases.local(rows)):
        fe, pe = emulate_dp(r, q, c, table)
        lo, hi = offs[b], offs[b + 1]
        assert fe.tobytes() == f[lo:hi].tobytes(), b
        assert np.array_equal(pe, pre[lo:hi]), b
        if len(r):
            fj, pj = jal._chain_dp(*rows[b], GAP_R, GAP_Q)
            assert fe.tobytes() == fj.tobytes(), b
            assert np.array_equal(pe, pj), b
    if group == 'dp_cases':
        # the planted ties went to the window's smallest j: its far end (64
        # back) while the copies fill it, else the first copy; k itself is
        # no take
        f70, p70 = emulate_dp(*cases.local([named['copies_70']])[0], table)
        assert p70[140] == 140 - 64 and p70[141] == 141 - 64
        f40, p40 = emulate_dp(*cases.local([named['copies_40']])[0], table)
        assert p40[40] == 0 and p40[79] == 79 - 64 and p40[80] == 40
        fk, pk = emulate_dp(*cases.local([named['cand_is_k']])[0], table)
        assert pk[1] == -1 and fk[1] == float(K)


def _backtrack_rows(rng, B, A, round_f=False):
    rs, qs, cs, val = _random_anchor_batch(rng, B, A)
    f, pre = jchain.chain_scores_batch(rs, qs, cs, val, 15)
    f = np.asarray(f).astype(np.float64)
    if round_f:
        f = np.round(f)                  # exact ties everywhere
    pre = np.asarray(pre)
    n = val.sum(axis=1)
    offs = np.zeros(B + 1, np.int64)
    offs[1:] = np.cumsum(n)
    fc = np.concatenate([f[b, :n[b]] for b in range(B)])
    pc = np.concatenate([pre[b, :n[b]] for b in range(B)]).astype(np.int32)
    return f, pre, val, offs, fc, pc


def _assert_same_chains(got, want, exact=True):
    assert len(got) == len(want)
    for b, (gc, wc) in enumerate(zip(got, want)):
        assert len(gc) == len(wc), (b, len(gc), len(wc))
        for (gi, gs), (wi, ws) in zip(gc, wc):
            np.testing.assert_array_equal(gi, wi)
            assert gs == ws if exact else abs(gs - ws) < 1e-3


def _f_keys(f):
    """csrc/chain_dp.cu's f_key: float64 as uint64 in f's order (the sign
    bit flipped for f >= 0, every bit for f < 0)."""
    b = np.asarray(f, np.float64).view(np.uint64)
    neg = (b >> np.uint64(63)).astype(bool)
    return np.where(neg, ~b, b | np.uint64(1 << 63))


def _doubling(pre, fold, rng):
    """One doubling pass: each round folds every v into its ancestor
    anc[v] (``fold(v, a)``, in place, in a random order of v as the
    block's threads race) and sets anc[v] = anc[anc[v]] from the round
    before, until no anchor has an ancestor left.  Returns the rounds."""
    n = len(pre)
    anc = np.asarray(pre, np.int64).copy()
    rounds = 0
    while (anc >= 0).any():
        nxt = np.full(n, -1)
        for v in rng.permutation(n):
            a = anc[v]
            if a >= 0:
                fold(v, a)
                nxt[v] = anc[a]
        anc = nxt
        rounds += 1
    return rounds


def emulate_extract(f, pre, min_score, min_anchors, max_chains, rng):
    """csrc/chain_dp.cu's chain_extract_kernel on one row: (cid int8 [n],
    scores [max_chains], nch, rounds).  Pass 1 folds top[v], the largest f
    key of the candidates (f >= min_score) at or below v, up the pre
    forest by doubling; pass 2 folds own[v], the smallest index of those
    candidates whose key is top[v], only between anchors of equal top.
    Then each owner's anchors are counted, the owners of themselves with
    at least min_anchors are the chains, a chain's id is the count of
    chains before it in greedy order (top descending, index ascending),
    and ids past max_chains write nothing."""
    n = len(f)
    cand = np.asarray(f) >= min_score
    key = _f_keys(f)
    top = np.where(cand, key, np.uint64(0))

    def fold_top(v, a):
        top[a] = max(top[a], top[v])

    rounds = _doubling(pre, fold_top, rng)
    none = n + 1
    own = np.where(cand & (key == top), np.arange(n), none)

    def fold_own(v, a):
        if own[v] != none and top[v] == top[a]:
            own[a] = min(own[a], own[v])

    assert _doubling(pre, fold_own, rng) == rounds
    cnt = np.bincount(own[own != none], minlength=n)
    chains = [c for c in range(n) if own[c] == c and cnt[c] >= min_anchors]
    ids = {}
    scores = np.zeros(max_chains)
    for c in chains:
        i = sum(top[d] > top[c] or (top[d] == top[c] and d < c)
                for d in chains)
        if i < max_chains:
            ids[c] = i
            scores[i] = f[c]
    cid = np.array([ids.get(o, -1) for o in own], np.int8)
    return cid, scores, min(len(chains), max_chains), rounds


def _emulated(offs, f, pre, min_score, min_anchors, max_chains, seed=0):
    """emulate_extract over CSR rows, in chain_extract_plain's outputs."""
    rng = np.random.default_rng(seed)
    R = len(offs) - 1
    cid = np.full(len(f), -1, np.int8)
    scores = np.zeros((R, max_chains))
    nch = np.zeros(R, np.int32)
    rounds = []
    for b in range(R):
        lo, hi = offs[b], offs[b + 1]
        cid[lo:hi], scores[b], nch[b], rd = emulate_extract(
            f[lo:hi], pre[lo:hi], min_score, min_anchors, max_chains, rng)
        rounds.append(rd)
    return cid, scores, nch, rounds


@pytest.mark.parametrize('min_anchors,max_chains,round_f', [
    (3, 10, False), (8, 2, False), (3, 10, True), (1, 127, True)])
def test_chain_extract_plain_equals_jax_backtrack(rng, min_anchors,
                                                  max_chains, round_f):
    """Case B: the greedy on the same (f, pre) as the JAX backtrack_chains,
    with truncation (small max_chains), short-path rejects (high
    min_anchors) and exact ties (f rounded); the kernel's schedule
    (emulate_extract, case F) gives the same outputs."""
    f, pre, val, offs, fc, pc = _backtrack_rows(rng, 6, 256, round_f)
    want = jchain.backtrack_chains(f, pre, val, 30.0, min_anchors,
                                   max_chains)
    cid, scores, nch = tchain.chain_extract_plain(
        torch.from_numpy(offs), torch.from_numpy(fc), torch.from_numpy(pc),
        30.0, min_anchors, max_chains)
    got = tchain.decode_chain_ids(offs, cid.numpy(), scores.numpy(),
                                  nch.numpy())
    _assert_same_chains(got, want)
    assert sum(len(c) for c in want) > 0
    emul = _emulated(offs, fc, pc, 30.0, min_anchors, max_chains)
    for a, b in zip(emul, (cid, scores, nch)):
        assert np.array_equal(a, b.numpy())


def _padded(rows):
    """(f, pre, valid) [R, A] of (f, pre) rows, for the JAX greedy."""
    A = max(1, max(len(fr) for fr, _ in rows))
    f = np.zeros((len(rows), A))
    pre = np.full((len(rows), A), -1, np.int64)
    valid = np.zeros((len(rows), A), bool)
    for b, (fr, pr) in enumerate(rows):
        f[b, :len(fr)] = fr
        pre[b, :len(pr)] = pr
        valid[b, :len(fr)] = True
    return f, pre, valid


@pytest.mark.parametrize('case', list(cases.extract_cases(
    np.random.default_rng(0))))
def test_extract_kernel_schedule_equal(case):
    """Case F: the extraction's schedule equals chain_extract_plain and the
    JAX backtrack_chains on each extract_cases case, in the rounds the
    deepest path asks (ceil(log2(depth + 1)))."""
    rows, min_score, min_anchors, max_chains = cases.extract_cases(
        np.random.default_rng(7))[case]
    offs, f, pre = cases.extract_csr(rows)
    want = tchain.chain_extract_plain(
        torch.from_numpy(offs), torch.from_numpy(f), torch.from_numpy(pre),
        min_score, min_anchors, max_chains)
    *emul, rounds = _emulated(offs, f, pre, min_score, min_anchors,
                              max_chains, seed=len(case))
    for a, b in zip(emul, want):
        assert np.array_equal(a, b.numpy())
    got = tchain.decode_chain_ids(offs, *(x.numpy() for x in want))
    _assert_same_chains(got, jchain.backtrack_chains(
        *_padded(rows), min_score, min_anchors, max_chains))
    for (fr, pr), rd in zip(rows, rounds):
        depth = np.zeros(len(pr), np.int64)
        for v, p in enumerate(pr):
            depth[v] = depth[p] + 1 if p >= 0 else 0
        assert rd == int(depth.max(initial=0)).bit_length()
    if case == 'max_chains':
        assert (want[2] == max_chains).all()
        assert ((want[0] >= 0).sum() == 5 * max_chains * len(rows))
    if case == 'no_candidate':
        assert (want[2] == 0).all() and (want[0] == -1).all()
    if case == 'over_smem_row':
        assert len(rows[0][0]) > tchain.SMEM_ROW


def test_extract_schedule_on_dp_rows_matches_jax_program(rng):
    """Case F on the DP's own rows: the schedule on the port's float64 (f,
    pre) equals the JAX chain_extract_batch (its float32 device program,
    run on the CPU), row by row where the two DPs give the same candidate
    order and predecessors (case C's rule, none differ here): the chains'
    anchors exact, their scores within the float32 program's rounding
    (relative 1e-5; its f sums up to ~700 float32 adds)."""
    B, A, min_score = 8, 512, 30.0
    rs, qs, cs, val = _random_anchor_batch(rng, B, A)
    packed, jscores, jnch = jchain.chain_extract_batch(
        rs, qs, cs, val, min_score, 15, max_chains=10, min_anchors=3)
    want = jchain.decode_chains(packed, jscores, jnch)
    rows = [(rs[b][val[b]], qs[b][val[b]], cs[b][val[b]]) for b in range(B)]
    offs, f64, pre64 = _plain_dp(rows, tchain.log2_table(N_TABLE), k=15)
    cid, scores, nch, _ = _emulated(offs, f64, pre64, min_score, 3, 10)
    got = tchain.decode_chain_ids(offs, cid, scores, nch)
    assert [len(c) for c in got] == [len(c) for c in want]
    for gc, wc in zip(got, want):
        for (gi, gs), (wi, ws) in zip(gc, wc):
            np.testing.assert_array_equal(gi, wi)
            assert abs(gs - ws) <= 1e-5 * abs(ws)
    assert sum(len(c) for c in want) > 0


@pytest.mark.parametrize('group', ['random', 'extract_cases'])
def test_greedy_used_set_is_ancestor_closed(rng, group):
    """The invariant the extraction kernel rests on: after every walk of
    the serial greedy, each used anchor's predecessor is used (or -1), and
    each walk consumes exactly the anchors whose first candidate below
    them in greedy order is the walk's own."""
    if group == 'random':
        f, pre, val, offs, fc, pc = _backtrack_rows(rng, 6, 256, True)
        rows = [(fc[offs[b]:offs[b + 1]], pc[offs[b]:offs[b + 1]])
                for b in range(6)]
        params = [(30.0, 3)] * 6
    else:
        named = cases.extract_cases(np.random.default_rng(3))
        rows = [row for rs, *_ in named.values() for row in rs]
        params = [(ms, ma) for rs, ms, ma, _ in named.values() for _ in rs]
    walks = 0
    for (fr, pr), (min_score, _) in zip(rows, params):
        n = len(fr)
        used = np.zeros(n, bool)
        owner = np.full(n, -1)
        for c in np.argsort(-fr, kind='stable'):
            if fr[c] < min_score:
                break
            v = c
            while v >= 0 and owner[v] < 0:
                owner[v] = c
                v = pr[v]
            while v >= 0:                  # mark first candidates below
                v = pr[v]
        for c in np.argsort(-fr, kind='stable'):
            if fr[c] < min_score:
                break
            if used[c]:
                continue
            path = []
            v = c
            while v >= 0 and not used[v]:
                used[v] = True
                path.append(v)
                v = pr[v]
            walks += 1
            mine = used & (pr >= 0)
            assert used[pr[mine]].all()
            assert sorted(path) == np.flatnonzero(owner == c).tolist()
    assert walks > 50



def test_chain_extract_batch_matches_jax_float32_program(rng):
    """Case C: JAX's float32 device program (chain_extract_batch on the
    CPU) against the port's float64 chains.  The float64 host route is the
    arbiter: the two may differ only on rows whose float32 and float64
    candidate orders differ (pre or the stable descending-f order of the
    candidates), so the test finds those rows by recomputing both, compares
    every other row chain for chain, and asserts that at these sizes no
    row's orders differ."""
    B, A, min_score = 8, 512, 30.0
    rs, qs, cs, val = _random_anchor_batch(rng, B, A)
    packed, jscores, jnch = jchain.chain_extract_batch(
        rs, qs, cs, val, min_score, 15, max_chains=10, min_anchors=3)
    want = jchain.decode_chains(packed, jscores, jnch)
    f32, pre32 = (np.asarray(x) for x in
                  jchain.chain_scores_batch(rs, qs, cs, val, 15))
    rows = [(rs[b][val[b]], qs[b][val[b]], cs[b][val[b]]) for b in range(B)]
    offs, r, q, c = cases.csr(rows)
    out = tchain.chain_extract_batch(offs, r, q, c, min_score, 15,
                                     min_anchors=3, device='cpu')
    got = tchain.decode_chain_ids(offs, *out)
    _offs, f64, pre64 = _plain_dp(rows, tchain.log2_table(N_TABLE), k=15)
    differ = []
    for b in range(B):
        n = int(val[b].sum())
        lo = offs[b]
        a32, a64 = f32[b, :n], f64[lo:lo + n]
        o32 = [i for i in np.argsort(-a32, kind='stable') if a32[i] >= min_score]
        o64 = [i for i in np.argsort(-a64, kind='stable') if a64[i] >= min_score]
        if o32 != o64 or not np.array_equal(pre32[b, :n], pre64[lo:lo + n]):
            differ.append(b)
            continue
        _assert_same_chains([got[b]], [want[b]], exact=False)
    assert differ == []


def _world(rng, tmp_path):
    chr1 = rand_seq(rng, 40_000)
    _write_fasta(tmp_path / 'g.fa', 'chr1', chr1)
    seqs = [mutate(rng, chr1[st:st + 700], sub=0.03)
            for st in (100, 5000, 12_345, 29_000)]
    seqs.append(chr1[8000:8400] + chr1[20_000:20_500])     # two hits
    seqs.append(rand_seq(rng, 300))                         # no hit
    unit = chr1[30_000:30_420]
    seqs += [make_rolling_read(rng, unit, copies=3.0 + 0.4 * i,
                               rot=37 * i, noise=0.03) for i in range(4)]
    return tmp_path / 'g.fa', seqs


def _hit_key(h):
    return (h.ctg, h.strand, h.q_st, h.q_en, h.r_st, h.r_en, h.mlen, h.blen,
            list(h.cigar), h.is_primary, h.mapq, float(h.score))


def _card_branch(monkeypatch):
    """The port's card route with the CUDA call replaced by the plain
    version, and the host chain core made to fail.  Returns the calls."""
    calls = []
    real = tchain.chain_extract_batch

    def fake(*args, device, **kw):
        assert device.type == 'cuda'
        calls.append(len(args[0]) - 1)
        return real(*args, device='cpu', **kw)

    def host_core(*_a, **_k):
        raise AssertionError('the card route reached the host chain core')

    monkeypatch.setattr(taligner, 'resolve_device',
                        lambda d: torch.device('cuda', 0))
    monkeypatch.setattr(tchain, 'chain_extract_batch', fake)
    monkeypatch.setattr(tchain, 'backtrack_chains', host_core)
    monkeypatch.setattr(GenomeAligner, '_chain_dp', host_core)
    return calls


def test_map_batch_card_branch_matches_host_and_jax(rng, tmp_path,
                                                    monkeypatch):
    """Case D: the card branch's hits equal the host route's and the JAX
    map_batch's; one chain_extract_batch serves every row, and the host
    chain core is never reached."""
    ref, seqs = _world(rng, tmp_path)
    jal = JaxAligner(JaxGenome(str(ref)))
    al = GenomeAligner(Genome(str(ref)))
    want = [[_hit_key(h) for h in hits] for hits in jal.map_batch(seqs)]
    host = [[_hit_key(h) for h in hits]
            for hits in al.map_batch(seqs, device='cpu')]
    calls = _card_branch(monkeypatch)
    card = [[_hit_key(h) for h in hits]
            for hits in al.map_batch(seqs, device='cuda')]
    assert card == host == want
    assert sum(len(w) for w in want) >= 8
    assert len(calls) == 1 and calls[0] >= len(seqs)


def test_map_many_takes_the_card_for_one_read(rng, tmp_path, monkeypatch):
    """On the card _map_many sends a single read through map_batch too, with
    every anchor kept (map()'s rows); its hits equal the CPU route's
    (map())."""
    ref, seqs = _world(rng, tmp_path)
    al = GenomeAligner(Genome(str(ref)))
    ctx = type('Ctx', (), {'aligner': al})()
    want = [tfb._map_many(ctx, [s], torch.device('cpu')) for s in seqs]
    seen = []
    real = GenomeAligner.map_batch

    def spy(self, batch, max_anchors=8192, device='cuda'):
        seen.append(max_anchors)
        return real(self, batch, max_anchors, device)

    calls = _card_branch(monkeypatch)
    monkeypatch.setattr(GenomeAligner, 'map_batch', spy)
    got = [tfb._map_many(ctx, [s], torch.device('cuda', 0)) for s in seqs]
    assert [[_hit_key(h) for h in hits[0]] for hits in got] == \
        [[_hit_key(h) for h in hits[0]] for hits in want]
    assert seen == [None] * len(seqs)
    assert len(calls) >= len(seqs) - 1      # the 300-base read may have none
    assert tfb._map_many(ctx, [], torch.device('cuda', 0)) == []


def test_extract_plan_layout():
    """Rows up to SMEM_ROW share a power-of-two shared-memory cap; longer
    rows get their own power-of-two regions of global scratch."""
    cap, goff, slots = tchain.extract_plan([1, 5, 64, 65], 'cpu')
    assert (cap, goff.tolist(), slots) == (128, [-1] * 4, 0)
    cap, goff, slots = tchain.extract_plan(
        [3, tchain.SMEM_ROW, tchain.SMEM_ROW + 1, 20_000], 'cpu')
    assert cap == tchain.SMEM_ROW
    assert goff.tolist() == [-1, -1, 0, 16384]
    assert slots == 16384 + 32768
    assert tchain.extract_plan([0], 'cpu')[0] == 1


def test_log2_table_is_the_host_routes(monkeypatch):
    """The CPU route's table follows the port's host chain core: libm's
    log2 when the native core is built, np.log2 for its numpy twin."""
    import sys

    import ciri_long_tpu_torch
    monkeypatch.delattr(ciri_long_tpu_torch, '_chaincore', raising=False)
    monkeypatch.setitem(sys.modules, 'ciri_long_tpu_torch._chaincore', None)
    tchain._TABLES.clear()
    t = tchain.log2_table(70_000)
    assert np.array_equal(t, np.log2(np.arange(70_000) + 1.0))
    monkeypatch.setitem(sys.modules, 'ciri_long_tpu_torch._chaincore',
                        object())
    tchain._TABLES.clear()
    t = tchain.log2_table(1025)
    libm = ctypes.CDLL(ctypes.util.find_library('m'))
    libm.log2.argtypes = [ctypes.c_double]
    libm.log2.restype = ctypes.c_double
    assert t.tolist() == [libm.log2(g + 1.0) for g in range(1025)]
    tchain._TABLES.clear()


@pytest.mark.parametrize('offs', [[1, 3, 5], [0, 4, 3, 5], [0, 2, 4],
                                  [0, 3, 6]],
                         ids=['start', 'decreasing', 'short', 'past_end'])
def test_chain_extract_batch_refuses_bad_offsets(offs):
    """Row offsets that do not run from 0 to N without decreasing would send
    both kernels outside their columns: refused before any launch."""
    r = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError, match='offsets'):
        tchain.chain_extract_batch(np.array(offs), r, r, np.zeros(5), 30.0,
                                   15, device='cpu')
