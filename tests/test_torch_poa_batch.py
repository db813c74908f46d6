"""The port's graph alignment of collapse's POA rounds (ROADMAP X6) against
the JAX package on the CPU.

- ops/poa_batch.py::poa_align_batch_plain equals ciri_long_tpu/ops/
  poa_batch.py::poa_align_batch (XLA on the CPU, as tests/test_poa_batch.py
  runs it) in scores, pairs and counts, on tools/poa_cases.py's seeded
  graphs (fused mutated reads of tens to hundreds of bases) for the general
  program and its ring programs at lookback 4, 8 and 16; in-degrees above
  its 8 slots are held against the JAX package's host ``_align_to_graph``;
- ops/poa.py::_flatten_graph (CSR) equals the JAX flattening (slots);
- ops/poa.py::poa_consensus_many_plain equals the JAX package's
  ``poa_consensus_many(jobs, use_device=True)`` and the port's ``poa``,
  byte for byte, on the cases of tests/test_poa_batch.py (identical
  copies, SEGMENTS, single and empty jobs, fuzz, indel-heavy, mixed
  lengths), and ``poa_consensus_many(device='cpu')`` equals ``poa``.
Exact throughout (integers and bytes).  The CUDA kernel and round loop
are held to these by the ``cuda`` tests of tests/test_torch_cuda.py.
"""

import importlib

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops.poa_batch import poa_align_batch as jax_align
from ciri_long_tpu_torch.ops.poa_batch import (SCORES, batch_arrays,
                                               check_batch, poa_align_batch,
                                               poa_align_batch_plain,
                                               split_inputs)
from ciri_long_tpu_torch.tools import poa_cases as pc
from tests.test_poa import SEGMENTS, mutate

# the modules (each package's ops/__init__ may bind ``poa`` the function)
jpoa = importlib.import_module('ciri_long_tpu.ops.poa')
tpoa = importlib.import_module('ciri_long_tpu_torch.ops.poa')

torch.set_num_threads(1)


def _dense(offs, preds, Vmax):
    """JAX's [B, Vmax, P] slots and npred from CSR."""
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


def _plain(arrays):
    return [t.numpy() for t in poa_align_batch_plain(
        *(torch.from_numpy(a) for a in arrays))]


def _equal_to_jax(arrays, lookback=None):
    bases, offs, preds, seqs, nv, ns = arrays
    pr, npred = _dense(offs, preds, bases.shape[1])
    want = jax_align(bases, nv, pr, npred, seqs, ns, SCORES,
                     lookback=lookback)
    got = _plain(arrays)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _narrow_cases(rng):
    return [(label, arrays) for label, arrays in pc.poa_cases(rng)
            if np.diff(arrays[1], axis=1).max(initial=0) <= 8]


def test_plain_matches_jax_general(rng):
    cases = _narrow_cases(rng)
    assert len(cases) >= 7
    for label, arrays in cases:
        _equal_to_jax(arrays)


def _ring_graph(rng, V, L, extra=0.35):
    """A topologically ranked DAG: a backbone and random back edges of at
    most L ranks (tests/test_poa_batch.py::_rand_graph as CSR)."""
    bases = rng.integers(0, 4, V).astype(np.int32)
    offs = [0]
    preds = []
    for i in range(V):
        ps = [i] if i else [0]
        while i and len(ps) < 8 and rng.random() < extra:
            pr = i + 1 - int(rng.integers(1, min(L, i + 1) + 1))
            if pr not in ps:
                ps.append(pr)
        preds += sorted(ps)
        offs.append(len(preds))
    return bases, np.array(offs, np.int32), np.array(preds, np.int32)


@pytest.mark.parametrize("L", [4, 8, 16])
def test_plain_matches_jax_ring(rng, L):
    graphs = [_ring_graph(rng, int(rng.integers(5, 48)), L)
              for _ in range(5)]
    seqs = [rng.integers(0, 4, int(rng.integers(3, 40))).astype(np.int8)
            for _ in graphs]
    arrays = batch_arrays(graphs, seqs)
    _, offs, preds, _, nv, _ = arrays
    pr, npred = _dense(offs, preds, arrays[0].shape[1])
    from ciri_long_tpu.ops.poa_batch import max_lookback
    assert all(max_lookback(pr[b, :nv[b]], npred[b, :nv[b]]) <= L
               for b in range(len(graphs)))
    _equal_to_jax(arrays, lookback=L)
    # the ring cases of the card's real graphs: fused reads
    cases = _narrow_cases(rng)[:1]
    for _, arrays in cases:
        bases, offs, preds, seqs, nv, ns = arrays
        pr, npred = _dense(offs, preds, bases.shape[1])
        if all(max_lookback(pr[b, :nv[b]], npred[b, :nv[b]]) <= L
               for b in range(len(nv))):
            _equal_to_jax(arrays, lookback=L)


def _jax_graph(g):
    """The JAX package's _Graph with the port graph's nodes and edges (in
    the same insertion order)."""
    jg = jpoa._Graph()
    for b in g.base:
        jg.new_node(b)
    jg.ring = [list(r) for r in g.ring]
    jg.in_edges = [dict(e) for e in g.in_edges]
    jg.out_edges = [dict(e) for e in g.out_edges]
    jg.support = list(g.support)
    return jg


@pytest.mark.parametrize("k", [12, 130])
def test_plain_matches_host_align_high_indegree(rng, k):
    """In-degrees above the JAX program's 8 slots (and above an int8 slot):
    the JAX package's host alignment decides."""
    for _ in range(3):
        g = pc.star_graph(rng, k, int(rng.integers(5, 40)))
        seq = rng.integers(0, 4, int(rng.integers(1, 30))).astype(np.int8)
        order = g.topo_order()
        rank = {v: r for r, v in enumerate(order)}
        score, aln = jpoa._align_to_graph(_jax_graph(g), seq, *SCORES)
        want = [(rank[v] if v is not None else -1,
                 p if p is not None else -1) for v, p in aln]
        s, a, c = _plain(pc.batch([g], [seq]))
        assert int(s[0]) == score
        assert [tuple(x) for x in a[0, a.shape[1] - c[0]:]] == want


def test_flatten_matches_jax(rng):
    g = pc.fused_graph([mutate(rng, SEGMENTS[0]) for _ in range(5)])
    order, bases, offs, preds = tpoa._flatten_graph(g)
    jorder, jbases, jpreds, jnpred = jpoa._flatten_graph(_jax_graph(g), 8)
    assert order == jorder
    assert np.array_equal(bases, jbases)
    assert np.array_equal(np.diff(offs), jnpred)
    for i in range(len(order)):
        assert list(preds[offs[i]:offs[i + 1]]) == \
            list(jpreds[i, :jnpred[i]])


def test_batch_checks_and_split(rng):
    """split_inputs gives back a batch laid one array after another (the
    round loop's kept launch); check_batch refuses lengths past the batch's
    shapes and an in-degree past the direction word's slot field."""
    graphs = [pc._fused(rng, n, 3)[0] for n in (30, 70, 5)]
    seqs = [rng.integers(0, 4, n).astype(np.int8) for n in (20, 0, 44)]
    arrays = pc.batch(graphs, seqs)
    bases, offs, preds, seqs_a, nv, ns = arrays
    B, V, n = len(nv), bases.shape[1], seqs_a.shape[1]
    again = split_inputs(np.concatenate([a.ravel() for a in arrays]), B, V,
                         n, len(preds))
    for x, y in zip(again, arrays):
        assert x.shape == y.shape and np.array_equal(x, y)
    check_batch(offs, nv, ns, V, n)
    with pytest.raises(ValueError, match='nv must lie'):
        check_batch(offs, nv + 1, ns, V, n)
    with pytest.raises(ValueError, match='nv must lie'):
        check_batch(offs, nv, ns + n, V, n)
    star = pc.batch([pc.star_graph(rng, 4, 2)], [seqs[0]])
    check_batch(star[1], star[4], star[5], star[0].shape[1],
                star[3].shape[1])
    with pytest.raises(ValueError, match='predecessor lists'):
        check_batch(star[1] * 10000, star[4], star[5], star[0].shape[1],
                    star[3].shape[1])


def test_auto_takes_plain_on_cpu(rng):
    _, arrays = _narrow_cases(rng)[0]
    got = [t.numpy() for t in poa_align_batch(
        *(torch.from_numpy(a) for a in arrays))]
    for g, w in zip(got, _plain(arrays)):
        assert np.array_equal(g, w)


def _jobs_equal(jobs):
    want = [tpoa.poa(seqs, 2, False, *SCORES)[0] for seqs in jobs]
    jax_want = jpoa.poa_consensus_many(jobs, use_device=True)
    got = tpoa.poa_consensus_many_plain(jobs)

    def norm(xs):
        return [x if isinstance(x, str) else
                (x.dtype.str, np.asarray(x).tolist()) for x in xs]
    assert norm(tpoa.poa_consensus_many(jobs, device='cpu')) == norm(want)
    assert norm(got) == norm(want) == norm(jax_want), [
        (i, g, w) for i, (g, w) in enumerate(zip(got, want)) if
        norm([g]) != norm([w])][:3]


@pytest.mark.parametrize("case", ["identical", "segments", "single_empty",
                                  "codes"])
def test_consensus_many_plain_fixed_cases(case):
    jobs = {
        'identical': [["ACGTACGTTGCAGGGCATCGATCG"] * 5],
        'segments': [SEGMENTS],
        'single_empty': [["ACGT"], ["ACGTAC", ""], [""], ["", "GGGT", "GGAT"],
                         []],
        'codes': [[np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int8)] * 3,
                  [np.zeros(0, np.int8)]],
    }[case]
    _jobs_equal(jobs)


def test_consensus_many_plain_fuzz(rng):
    jobs = []
    for _ in range(8):
        template = "".join(rng.choice(list("ACGTN"),
                                      size=int(rng.integers(20, 220))))
        k = int(rng.integers(2, 9))
        sub = float(rng.uniform(0.0, 0.12))
        jobs.append([mutate(rng, template, sub=sub, ins=sub / 2,
                            dele=sub / 2) for _ in range(k)])
    _jobs_equal(jobs)


def test_consensus_many_plain_indel_heavy(rng):
    jobs = []
    for _ in range(5):
        template = "".join(rng.choice(list("ACGT"),
                                      size=int(rng.integers(30, 120))))
        jobs.append([mutate(rng, template, sub=0.05, ins=0.12, dele=0.12)
                     for _ in range(int(rng.integers(2, 6)))])
    _jobs_equal(jobs)


def test_consensus_many_plain_mixed_lengths(rng):
    t1 = "".join(rng.choice(list("ACGT"), size=40))
    t2 = "".join(rng.choice(list("ACGT"), size=300))
    jobs = [[mutate(rng, t1) for _ in range(3)],
            [mutate(rng, t2) for _ in range(4)],
            [mutate(rng, t1) for _ in range(7)]]
    _jobs_equal(jobs)


def test_consensus_many_cuda_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        tpoa.poa_consensus_many([["ACGT"]], device='cuda')
