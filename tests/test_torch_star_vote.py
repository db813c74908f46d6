"""The center-star column vote in the port's host C++ (csrc/star_vote.cpp,
ops/star_vote.py) against the JAX package's
``ciri_long_tpu/ops/ccs.py::center_star_consensus(units, cigars=...)``.
Every comparison is exact (codes: no tolerance).

- seeded reads of mutated copies of a unit, their cigars from the JAX
  ``banded_global_cigar`` to the median-length representative;
- reads built from chosen cigars at the vote's edges: insertion slots where
  two lengths tie (the first seen wins) or one length leads, columns the
  deletion wins, half-vote ties (an even split the representative breaks),
  N codes, one-base units, reads whose every column is dropped (the
  representative comes back) and slots at both ends;
- ``star_vote_plain`` (the port's own center_star_consensus) on the same
  batches, the vote over threads, a read whose runs do not fit its units;
- ``find_ccs_reads`` on the card's route (the kernel's plain version patched
  in) with megabatches of a few reads voted on a thread pool while the next
  is aligned, the same files as ``--device cpu``.
"""

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops.ccs import center_star_consensus as jax_star
from ciri_long_tpu.ops.traceback import banded_global_cigar
from ciri_long_tpu_torch.ops import nw_tb_batch as ntb
from ciri_long_tpu_torch.ops.ccs import star_rep_index
from ciri_long_tpu_torch.ops.star_vote import (star_batch, star_vote,
                                               star_vote_plain)
from ciri_long_tpu_torch.pipeline import find_ccs as tfc
from ciri_long_tpu_torch.utils import dispatch
from tests.test_nw_tb_batch import _mutated_pair
from tests.test_torch_nw_tb import _ccs_reads


def _entries(cigar):
    return np.array([ln << 4 | op for ln, op in cigar], np.uint32)


def _batch(reads):
    """StarBatch of ``reads``: (units, cigars with None at the
    representative); the run entries in buffers the batch keeps."""
    keep, runs, reps = [], [], []
    for units, cigars in reads:
        reps.append(star_rep_index(units))
        row = []
        for cig in cigars:
            if cig is None:
                row.append(None)
                continue
            e = _entries(cig)
            keep.append(e)
            row.append((e.ctypes.data if len(e) else 0, len(e)))
        runs.append(row)
    batch = star_batch([u for u, _ in reads], reps, runs)
    return batch._replace(keep=tuple(keep))


def _check(reads, threads=1):
    batch = _batch(reads)
    got = star_vote(batch, threads=threads)
    want = [np.asarray(jax_star(units, cigars=cigars), np.int8)
            for units, cigars in reads]
    assert len(got) == len(want)
    for t, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == np.int8
        assert np.array_equal(a, b), t
    plain = star_vote_plain(batch)
    for a, b in zip(plain, want):
        assert np.array_equal(a, b)
    return got


def _aligned(units):
    """(units, their JAX cigars to the median-length representative)."""
    rep_i = star_rep_index(units)
    return units, [None if ui == rep_i else
                   banded_global_cigar(u, units[rep_i])[1]
                   for ui, u in enumerate(units)]


def test_vote_matches_jax_on_seeded_reads(rng):
    reads = []
    for _ in range(40):
        U = int(rng.integers(3, 13))
        n = int(rng.integers(30, 500))
        base = rng.integers(0, 4, n).astype(np.int8)
        units = [base.copy()]
        for _ in range(U - 1):
            units.append(_mutated_pair(rng, n, sub=0.05, ins=0.04,
                                       dele=0.04)[0])
        units = [u for u in units if len(u)]
        reads.append(_aligned(units))
    _check(reads)


def _build(rng, rep, plan):
    """A unit and its cigar against ``rep`` from ``plan``: per column of
    rep, 'M' (copy), 'X' (another base), 'N', 'D' (skip), with insertions
    ``ins`` {slot: codes} before column slot (slot n: after the last)."""
    ops, codes, ins = plan
    unit, cigar = [], []

    def push(op, length):
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + length, op)
        else:
            cigar.append((length, op))

    for j in range(len(rep) + 1):
        if j in ins:
            unit.extend(ins[j])
            push(1, len(ins[j]))
        if j == len(rep):
            break
        op = ops[j]
        if op == 'D':
            push(2, 1)
            continue
        unit.append(rep[j] if op == 'M' else 4 if op == 'N'
                    else codes[j] if codes is not None
                    else (rep[j] + 1 + int(rng.integers(0, 3))) % 4)
        push(0, 1)
    return np.array(unit, np.int8), cigar


def _balanced(plan, n):
    """``plan`` with its unit brought to n codes: the columns an insertion
    adds deleted from the end, the codes a deletion takes inserted after the
    last column."""
    ops, codes, ins = plan
    extra = sum(len(v) for v in ins.values()) - ops.count('D')
    ops, ins = list(ops), dict(ins)
    for j in range(n - 1, -1, -1):
        if extra <= 0:
            break
        if ops[j] != 'D':
            ops[j] = 'D'
            extra -= 1
    if extra < 0:
        ins[n] = list(ins.get(n, [])) + [0] * -extra
    return ops, codes, ins


def _read(rng, rep, plans):
    """A read whose other units follow ``plans`` (brought to the
    representative's length) and whose representative is ``rep``, placed
    where star_rep_index (the median length, stable) picks it."""
    built = [_build(rng, rep, _balanced(p, len(rep))) for p in plans]
    for at in range(len(built) + 1):
        units = [u for u, _ in built]
        units.insert(at, rep)
        if star_rep_index(units) == at:
            cigars = [c for _, c in built]
            cigars.insert(at, None)
            return units, cigars
    raise AssertionError('rep is not the median length')


@pytest.mark.parametrize('case', ['ins_tie', 'ins_lead', 'del_wins',
                                  'half_vote', 'n_codes', 'one_base',
                                  'all_dropped', 'slots_at_ends'])
def test_vote_edges_match_jax(rng, case):
    rep = rng.integers(0, 4, 12).astype(np.int8)
    M = ['M'] * 12
    if case == 'ins_tie':
        # slot 5: lengths 2, 3, 2, 3 (a tie: 2 first); slot 9: 3, 1, 1, 3,
        # then the tie the other way
        plans = [(M, None, {5: [1, 1], 9: [2, 2, 2]}),
                 (M, None, {5: [3, 3, 3], 9: [0]}),
                 (M, None, {5: [2, 2]}),
                 (M, None, {5: [0, 0, 0], 9: [1]}),
                 (M, None, {9: [3, 3, 3]})]
        # lengths of 12 codes around the representative's 12
        reads = [_read(rng, rep, plans)]
        plans2 = [(M, None, {3: [1, 1, 1]}), (M, None, {3: [2, 2]}),
                  (M, None, {3: [0, 0, 0]}), (M, None, {3: [3, 3]})]
        reads.append(_read(rng, rep, plans2))
    elif case == 'ins_lead':
        plans = [(M, None, {4: [0, 1]}), (M, None, {4: [2]}),
                 (M, None, {4: [3, 3]}), (M, None, {4: [1, 1]})]
        reads = [_read(rng, rep, plans)]
    elif case == 'del_wins':
        D = M[:3] + ['D'] * 4 + M[7:]
        plans = [(D, None, {}), (D, None, {}), (D, None, {}),
                 (M, None, {})]
        reads = [_read(rng, rep, plans)]
    elif case == 'half_vote':
        # U = 4: the representative and one unit against two others
        X = ['X'] * 12
        alt = ((rep + 1) % 4).astype(np.int8)
        plans = [(M, None, {}), (X, alt, {}), (X, alt, {})]
        reads = [_read(rng, rep, plans)]
        # and a deletion tie: two delete, two keep
        D = ['D'] * 6 + M[6:]
        reads.append(_read(rng, rep, [(D, None, {}), (D, None, {}),
                                      (M, None, {})]))
    elif case == 'n_codes':
        rep = rep.copy()
        rep[[2, 7]] = 4
        N = M[:4] + ['N'] * 4 + M[8:]
        plans = [(N, None, {}), (N, None, {6: [4, 4]}), (M, None, {6: [4]}),
                 (N, None, {6: [4, 4]})]
        reads = [_read(rng, rep, plans)]
    elif case == 'one_base':
        rep = rep[:1]
        reads = [_read(rng, rep, [(['M'], None, {}), (['X'], None, {})]),
                 _read(rng, rep, [(['M'], None, {0: [2]}),
                                  (['D'], None, {1: [3]}),
                                  (['D'], None, {0: [1]})])]
    elif case == 'all_dropped':
        D = ['D'] * 12
        # every column won by the deletion, inserts at different slots
        plans = [(D, None, {0: [1] * 12}), (D, None, {12: [2] * 12})]
        reads = [_read(rng, rep, plans)]
        # and the same with a slot the majority shares
        reads.append(_read(rng, rep, [(D, None, {4: [3] * 12}),
                                      (D, None, {4: [0] * 12})]))
    else:
        assert case == 'slots_at_ends'
        plans = [(M, None, {0: [1], 12: [2, 2]}),
                 (M, None, {0: [3], 12: [0, 0]}),
                 (M, None, {0: [0, 0], 12: [1]}), (M, None, {})]
        reads = [_read(rng, rep, plans)]
    got = _check(reads)
    if case == 'all_dropped':
        assert np.array_equal(got[0], rep)


def test_vote_over_threads_and_its_errors(rng):
    reads = []
    for _ in range(30):
        n = int(rng.integers(20, 200))
        base = rng.integers(0, 5, n).astype(np.int8)
        units = [base] + [_mutated_pair(rng, n, sub=0.05, ins=0.05,
                                        dele=0.05)[0] for _ in range(4)]
        reads.append(_aligned([u for u in units if len(u)]))
    one = _check(reads)
    many = _check(reads, threads=4)
    assert all(np.array_equal(a, b) for a, b in zip(one, many))
    assert star_vote(_batch([])) == []
    # run entries that consume more of the unit than it has
    units, cigars = reads[3]
    k = next(i for i, c in enumerate(cigars) if c is not None)
    cigars = list(cigars)
    cigars[k] = [(len(units[k]) + 5, 0)]
    with pytest.raises(ValueError, match='read 1'):
        star_vote(_batch([reads[0], (units, cigars)]))


def test_card_route_votes_megabatches_on_a_pool(rng, tmp_path, monkeypatch):
    reads_fa = tmp_path / 'reads.fa'
    _ccs_reads(rng, reads_fa)
    cpu = tfc.find_ccs_reads(str(reads_fa), str(tmp_path / 'cpu'), 'p',
                             device='cpu')
    card = torch.device('cuda', 0)
    real_screen = tfc.screen_keep
    monkeypatch.setattr(tfc, 'resolve_device', lambda d: card)
    monkeypatch.setattr(tfc, 'screen_keep', lambda *a: real_screen(
        *a[:-1], device='cpu'))
    monkeypatch.setattr(ntb, 'resolve_device', lambda d: card)
    monkeypatch.setattr(ntb, 'upload', lambda arrays, device: [
        torch.from_numpy(np.ascontiguousarray(x)) for x in arrays])
    monkeypatch.setattr(ntb, 'nw_traceback_cuda',
                        lambda q, r, launch, *s: ntb.nw_launch_plain(
                            q, r, launch, *s))
    voted = []
    real_vote = tfc.star_vote

    def vote(batch, *a, **kw):
        out = real_vote(batch, *a, **kw)
        want = star_vote_plain(batch)
        assert all(np.array_equal(x, y) for x, y in zip(out, want))
        voted.append(len(out))
        return out

    monkeypatch.setattr(tfc, 'star_vote', vote)
    monkeypatch.setattr(tfc, 'MEGA_CHUNK', 4)
    monkeypatch.setenv('CIRI_SELECT_THREADS', '3')
    dispatch.reset_launches()
    cuda = tfc.find_ccs_reads(str(reads_fa), str(tmp_path / 'cuda'), 'p',
                              device='cuda')
    assert cuda == cpu
    for name in ('tmp/p.ccs.fa', 'tmp/p.raw.fa'):
        assert ((tmp_path / 'cuda' / name).read_bytes()
                == (tmp_path / 'cpu' / name).read_bytes())
    assert len(voted) >= 4 and sum(voted) >= 12
    assert dispatch.ROUTES['nw_host'] == 0
