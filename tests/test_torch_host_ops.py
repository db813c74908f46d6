"""The port's host modules against the JAX package on the CPU.

``ops/chain.py`` (host half), ``ops/poa.py`` (host half), ``ops/traceback.py``
and ``ops/ccs.py`` of ``ciri_long_tpu_torch`` run on the same numpy-seeded
inputs as their ``ciri_long_tpu`` twins and must give identical results:
chains anchor for anchor and score for score, consensus strings byte for
byte, alignments field for field.  (The chaining's device form, X2, has its
own tests: tests/test_torch_chain.py.)
"""

import importlib

import numpy as np
import pytest
import torch

from ciri_long_tpu_torch.ops import ccs as tccs
from ciri_long_tpu_torch.ops import chain as tchain
from ciri_long_tpu_torch.ops import poa as tpoa
from ciri_long_tpu_torch.ops import traceback as ttb
from tests.test_pipeline_call import make_rolling_read, rand_seq
from tests.test_poa import SEGMENTS, mutate

torch.set_num_threads(1)

# by module path: ciri_long_tpu/ops/__init__.py re-exports a function
# named ``poa`` that shadows the submodule under attribute access
jccs, jchain, jpoa, jtb = (importlib.import_module('ciri_long_tpu.ops.' + m)
                           for m in ('ccs', 'chain', 'poa', 'traceback'))

K = 15


def _anchors(rng, B, A):
    """Colinear-ish anchor rows with jitter (so real chains exist), padded
    with non-chainable monotone garbage."""
    rs = np.zeros((B, A), np.int64)
    qs = np.zeros((B, A), np.int64)
    cs = np.zeros((B, A), np.int64)
    val = np.zeros((B, A), bool)
    for b in range(B):
        n = int(rng.integers(A // 2, A))
        r = np.sort(rng.integers(0, 40_000, n)).astype(np.int64)
        q = (r // 4 + rng.integers(-30, 30, n)).clip(0).astype(np.int64)
        order = np.lexsort((q, r))
        rs[b, :n], qs[b, :n] = r[order], q[order]
        val[b, :n] = True
        rs[b, n:] = rs[b, n - 1] + np.arange(A - n) * 1_000_000
    return rs, qs, cs, val


def _same_chains(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for (gi, gs), (wi, ws) in zip(g_row, w_row):
            np.testing.assert_array_equal(gi, wi)
            assert gs == ws


@pytest.mark.parametrize('min_anchors,max_chains', [(3, 10), (8, 2)])
def test_backtrack_and_decode_chains_match_jax(rng, min_anchors, max_chains):
    rs, qs, cs, val = _anchors(rng, 6, 256)
    f, pre = (np.asarray(x) for x in jchain.chain_scores_batch(
        rs, qs, cs, val, K))
    got = tchain.backtrack_chains(f, pre, val, 30.0, min_anchors, max_chains)
    _same_chains(got, jchain.backtrack_chains(f, pre, val, 30.0, min_anchors,
                                              max_chains))
    assert sum(len(row) for row in got) > 0


def _poa_jobs(rng):
    jobs = [SEGMENTS, ['ACGTACGTTGCAGGGCATCGATCG'] * 4, ['ACGT'],
            ['', 'GGGT', 'GGAT']]
    for _ in range(5):
        template = ''.join(rng.choice(list('ACGTN'),
                                      size=int(rng.integers(20, 160))))
        sub = float(rng.uniform(0.0, 0.12))
        jobs.append([mutate(rng, template, sub=sub, ins=sub / 2,
                            dele=sub / 2)
                     for _ in range(int(rng.integers(2, 7)))])
    return jobs


def test_poa_consensus_many_matches_jax_host_branch(rng):
    jobs = _poa_jobs(rng)
    want = jpoa.poa_consensus_many(jobs, use_device=False)
    assert tpoa.poa_consensus_many(jobs, device='cpu') == want
    assert [tpoa.poa(seqs)[0] for seqs in jobs] == want


def test_poa_python_graph_matches_jax(rng):
    for seqs in _poa_jobs(rng):
        codes = [tpoa.encode_seq(s) for s in seqs]
        np.testing.assert_array_equal(
            tpoa._poa_python(codes, 10, -4, -8, -2, -24, -1),
            jpoa._poa_python(codes, 10, -4, -8, -2, -24, -1))


def _codes(rng, n, hi=4):
    return rng.integers(0, hi, n).astype(np.int8)


def _as_list(x):
    return x if x is None else [
        v.tolist() if isinstance(v, np.ndarray) else v for v in x]


def test_traceback_aligners_match_jax(rng):
    for _ in range(8):
        r = _codes(rng, int(rng.integers(40, 200)), hi=5)
        q = r[int(rng.integers(0, 20)):].copy()
        flip = rng.random(len(q)) < 0.1
        q[flip] = (q[flip] + 1) % 4
        q = np.delete(q, rng.integers(0, len(q), 3))
        for params in [(1, 1, 1, 1), (2, 4, 4, 2)]:
            assert _as_list(ttb.sw_traceback(q, r, *params)) == \
                _as_list(jtb.sw_traceback(q, r, *params))
        assert ttb.banded_global_cigar(q, r) == jtb.banded_global_cigar(q, r)
        assert _as_list(ttb.extend_align(q, r)) == \
            _as_list(jtb.extend_align(q, r))


def test_splice_junction_align_matches_jax(rng):
    """ref_gap is the query gap's length plus the intron's; the query
    carries substitutions and a 1 bp shift across the junction."""
    for _ in range(6):
        donor = _codes(rng, 40)
        acceptor = _codes(rng, 40)
        intron = int(rng.integers(30, 80))
        ref_gap = np.concatenate([donor, _codes(rng, intron), acceptor])
        qg = np.concatenate([donor[:-1], acceptor[:1], acceptor])
        flip = rng.random(len(qg)) < 0.08
        qg[flip] = (qg[flip] + 1) % 4
        assert ttb.splice_junction_align(qg, ref_gap, intron) == \
            jtb.splice_junction_align(qg, ref_gap, intron)


def test_find_consensus_matches_jax(rng):
    unit = rand_seq(rng, 400)
    reads = [make_rolling_read(rng, unit, copies=2.5 + 0.5 * i,
                               rot=int(rng.integers(0, 400)), noise=0.03)
             for i in range(4)]
    reads.append(rand_seq(rng, 900))                    # no repeat
    for read in reads:
        assert tccs.find_consensus(read) == jccs.find_consensus(read)
    assert tccs.find_consensus(reads[0])[1] is not None
