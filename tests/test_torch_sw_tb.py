"""The port's batched SW with traceback (ops/sw_tb_batch.py) against the JAX
package on the CPU, tuple for tuple: the plain PyTorch version
``sw_traceback_batch_plain`` against JAX ``sw_traceback_batch`` (its XLA
program on the CPU) and against the port's host ``sw_traceback``, on the
cases of tests/test_tb_batch.py (a random fuzz under three scorings,
junction-like doubled reads, no hit and empty jobs, N bases, mixed query
lengths, the rotation through ``find_alignment_pos``) and on
tools/collapse_cases.py's (ties, references over one strip, one-base jobs,
PAD in the query, references at strip edges and over a block's warps, jobs
over a block's shared memory); the CPU entry point ``sw_traceback_batch``;
the (length, op) runs ``tb_results`` reads against the per-op walk they
merge; and ``tb_plan``'s routes."""

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops.sw_tb_batch import sw_traceback_batch as jax_batch
from ciri_long_tpu.ops.traceback import sw_traceback as jax_host
from ciri_long_tpu_torch.ops import sw_tb_batch as tb
from ciri_long_tpu_torch.ops.traceback import sw_traceback
from ciri_long_tpu_torch.tools.collapse_cases import JUNC, tb_cases
from ciri_long_tpu_torch.utils.seq import encode_seq
from tests.test_poa import mutate


def plain(qs, rs, scores):
    args = (torch.from_numpy(x) for x in tb.pack_jobs(qs, rs))
    return tb.tb_results(*tb.sw_traceback_batch_plain(*args, *scores))


def _check(qs, rs, scores):
    got = plain(qs, rs, scores)
    host = [sw_traceback(q, r, *scores) for q, r in zip(qs, rs)]
    assert got == host
    assert got == [jax_host(q, r, *scores) for q, r in zip(qs, rs)]
    assert got == jax_batch(qs, rs, *scores)
    assert tb.sw_traceback_batch(qs, rs, *scores, device='cpu') == host
    return got


@pytest.mark.parametrize('scores', [JUNC, (1, 1, 1, 1), (2, 4, 4, 2)])
def test_random_fuzz(rng, scores):
    qs, rs = [], []
    for _ in range(40):
        qs.append(rng.integers(0, 5, int(rng.integers(1, 400))).astype(np.int8))
        rs.append(rng.integers(0, 5, int(rng.integers(1, 60))).astype(np.int8))
    got = _check(qs, rs, scores)
    assert sum(g is not None for g in got) > 30


def _junction_reads(rng, n, flank):
    junc = ''.join(rng.choice(list('ACGT'), size=50))
    reads = [mutate(rng, ''.join(rng.choice(list('ACGT'), size=flank)) + junc
                    + ''.join(rng.choice(list('ACGT'), size=flank)),
                    sub=0.05, ins=0.03, dele=0.03) for _ in range(n)]
    return junc, reads


def test_junction_like(rng):
    qs, rs = [], []
    for _ in range(25):
        junc, (read,) = _junction_reads(rng, 1, 150)
        qs.append(encode_seq(read * 2))
        rs.append(encode_seq(junc))
    _check(qs, rs, JUNC)


def test_no_hit_and_empty():
    qs = [np.zeros(30, np.int8), np.zeros(0, np.int8), encode_seq('ACGTACGT')]
    rs = [np.full(20, 1, np.int8), encode_seq('ACGT'), np.zeros(0, np.int8)]
    assert _check(qs, rs, (1, 1, 1, 1)) == [None, None, None]


def test_n_bases(rng):
    qs, rs = [], []
    for _ in range(15):
        qs.append(rng.choice(5, size=int(rng.integers(20, 200))).astype(
            np.int8))
        rs.append(rng.choice(5, size=int(rng.integers(5, 50)),
                             p=[0.22, 0.22, 0.22, 0.22, 0.12]).astype(np.int8))
    _check(qs, rs, JUNC)


def test_mixed_lengths(rng):
    qs = [rng.integers(0, 4, n).astype(np.int8)
          for n in (10, 100, 300, 600, 1500, 3000)]
    rs = [rng.integers(0, 4, 50).astype(np.int8) for _ in qs]
    _check(qs, rs, JUNC)


COLLAPSE_CASES = [c for c in tb_cases(np.random.default_rng(11))
                  if c[0] in ('equal-score ties', 'references over one strip',
                              'one-base jobs', 'PAD inside the query',
                              'strip edges and strip groups',
                              'over the shared-memory budget')]


@pytest.mark.parametrize('case', COLLAPSE_CASES,
                         ids=[c[0] for c in COLLAPSE_CASES])
def test_collapse_cases(case):
    _, qs, rs, scores = case
    _check(qs, rs, scores)


def test_rotation_parity_through_find_alignment_pos(rng):
    """The collapse call site: rotations from the plain version's cigars
    equal the host path's, read for read."""
    from ciri_long_tpu_torch.models.hits import find_alignment_pos
    from ciri_long_tpu_torch.ops.traceback import cigar_to_string
    from ciri_long_tpu_torch.pipeline.collapse import _AlnView

    junc, reads = _junction_reads(rng, 30, 100)
    qs = [encode_seq(s * 2) for s in reads]
    rs = [encode_seq(junc)] * len(reads)
    got = plain(qs, rs, JUNC)
    assert got == jax_batch(qs, rs, *JUNC)
    placed = 0
    for q, r, tb_plain in zip(qs, rs, got):
        tb_host = sw_traceback(q, r, *JUNC)
        assert tb_plain == tb_host
        if tb_host is None:
            continue
        pos = []
        for _, qb, _, rb, _, cigar in (tb_host, tb_plain):
            aln = _AlnView(ref_begin=rb, query_begin=qb,
                           cigar_string=cigar_to_string(cigar))
            pos.append(find_alignment_pos(aln, len(junc) // 2))
        assert pos[0] == pos[1]
        placed += pos[0] is not None
    assert placed > 20


def test_chunks_cover_the_jobs_under_the_budget(monkeypatch):
    qs = [np.zeros(n, np.int8) for n in (1000, 10, 5000, 20, 300, 7000)]
    rs = [np.zeros(m, np.int8) for m in (50, 40, 64, 0, 33, 50)]
    monkeypatch.setattr(tb, 'MEM_BUDGET', 400_000)
    chunks = list(tb._chunks(qs, rs))
    assert [lo for lo, _ in chunks] == [0] + [hi for _, hi in chunks[:-1]]
    assert chunks[-1][1] == len(qs) and len(chunks) > 1
    for lo, hi in chunks:
        W = max(len(q) for q in qs[lo:hi])
        used = sum(tb.code_bytes(len(q), len(r))
                   for q, r in zip(qs[lo:hi], rs[lo:hi])) + 8 * (hi - lo) * W
        assert hi - lo == 1 or used <= tb.MEM_BUDGET


def per_op_results(out, runs):
    """The host tuples by the per-op walk: each run expanded into its ops,
    then merged one op at a time, as tb_results did before the kernel
    wrote runs."""
    out, runs = out.numpy(), runs.numpy()
    cap = runs.shape[1]
    res = []
    for b in range(out.shape[0]):
        score, qb, qe, rb, re_, cnt = (int(x) for x in out[b])
        if score <= 0:
            res.append(None)
            continue
        ops = [int(op) for length, op in runs[b, cap - cnt:]
               for _ in range(int(length))]
        cigar = []
        for op in ops:
            if cigar and cigar[-1][1] == op:
                cigar[-1] = (cigar[-1][0] + 1, op)
            else:
                cigar.append((1, op))
        res.append((score, qb, qe, rb, re_, cigar))
    return res


ALL_CASES = tb_cases(np.random.default_rng(3))


@pytest.mark.parametrize('case', ALL_CASES,
                         ids=['{} {}'.format(c[0], c[3]) for c in ALL_CASES])
def test_runs_give_the_per_op_walk(case):
    _, qs, rs, scores = case
    q, r, n, m = (torch.from_numpy(x) for x in tb.pack_jobs(qs, rs))
    out, runs = tb.sw_traceback_batch_plain(q, r, n, m, *scores)
    assert runs.shape == (len(qs), tb._cap(q.shape[1], r.shape[1]), 2)
    got = tb.tb_results(out, runs)
    assert got == per_op_results(out, runs)
    cap = runs.shape[1]
    for b, res in enumerate(got):
        cnt = int(out[b, 5])
        assert not runs[b, :cap - cnt].any()       # 0 outside the runs
        if res is not None:                        # merged: no equal pair
            ops = [op for _, op in res[5]]
            assert all(x != y for x, y in zip(ops, ops[1:]))
            assert cnt == len(res[5])


def test_plan_routes_jobs_by_their_direction_bytes():
    n = np.array([1552, 4000, 0, 60, 1100, 3600], np.int32)
    m = np.array([50, 50, 20, 40, 300, 64], np.int32)
    plan = tb.tb_plan(n, m, 4000, 300, 'cpu')
    assert [p.route for p in plan] == ['tb_smem', 'tb_global']
    smem, glob = plan
    assert smem.jobs.tolist() == [0, 2, 3]
    assert glob.jobs.tolist() == [1, 4, 5]
    # 1552 x 50: two warps, 100 KB of direction bytes (1583 steps a strip
    # in 50 chunks of 32), two blocks a SM
    assert smem.warps == 2 and smem.smem == tb.RING_BYTES + 2 * 1600 * 32
    assert 2 * smem.smem <= tb.TB_SMEM
    assert glob.warps == tb.MAX_WARPS and glob.strips == 10
    sizes = [int(tb.code_bytes(a, b)) for a, b in zip(n[[1, 4, 5]],
                                                      m[[1, 4, 5]])]
    assert glob.code_off.tolist() == [0, sizes[0], sizes[0] + sizes[1]]
    assert glob.code_bytes == sum(sizes)
    assert all(s > tb.SMEM_CODES for s in sizes)
    assert list(tb.global_bytes(n, m)) == [0, sizes[0], 0, 0] + sizes[1:]
