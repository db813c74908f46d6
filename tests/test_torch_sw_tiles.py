"""The tiled route of the port's SW kernel, on the CPU.

csrc/sw_score_ends.cu's tiled route gives each (row, tile) one warp: tile k
owns reference columns [k*T, (k+1)*T) and sweeps from ``halo`` columns
before them (ops/sw.py::_tile_plan), and a merge takes the best record by
the contract's order.  The kernel runs only on the card
(tests/test_torch_cuda.py); here its design is held exact: an emulation
that scores each tile's slice with the port's plain ``sw_score_ends`` and
merges the records equals the JAX package's ``sw_score_ends`` (XLA on the
CPU) on tools/sw_cases.py's rows, at a small T and at the plan's own T.
A halo of Lq/2 fails on some row, so the rows reach into the halo.
Integer DP: tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import sw as jsw
from ciri_long_tpu_torch.ops import sw as tsw
from ciri_long_tpu_torch.tools.sw_cases import tile_cases

torch.set_num_threads(1)

BIG = (10, 4, 8, 2)
CLIP = (1, 1, 1, 1)
PARAMS = [CLIP, BIG, (2, 3, 5, 1)]
QUERY_LENGTHS = [1, 31, 32, 33, 54, 65]
SMALL_T = 64
NO_J = np.iinfo(np.int32).max


def _tile_emulation(q, r, params, T, halo):
    """(score, q_end, r_end) of the tiled route, from the plain scorer: one
    record per tile (its best over all the columns it sweeps), the records
    merged by score desc, r_end asc, q_end asc."""
    p = tsw.SWParams(*params)
    Lr = r.shape[1]
    recs = []
    for own in range(0, Lr, T):
        lo = max(0, own - halo)
        s, i, j = (t.numpy() for t in tsw.sw_score_ends(
            torch.from_numpy(q),
            torch.from_numpy(np.ascontiguousarray(r[:, lo:own + T])), p))
        recs.append((s, i, np.where(s > 0, j + lo, NO_J)))
    out = []
    for b in range(q.shape[0]):
        s, neg_j, neg_i = max((int(rec[0][b]), -int(rec[2][b]),
                               -int(rec[1][b])) for rec in recs)
        out.append((s, -neg_i, -neg_j) if s > 0 else (0, -1, -1))
    return [np.array(col, np.int32) for col in zip(*out)]


def _jax(q, r, params):
    return [np.asarray(t) for t in jsw.sw_score_ends(q, r,
                                                      jsw.SWParams(*params))]


@functools.lru_cache(maxsize=None)
def _case(Lq, params, T):
    """Seeded rows at a few tiles of width T past one halo, Lr not a
    multiple of T, and the JAX package's answer on them."""
    halo = tsw._tile_halo(Lq, tsw.SWParams(*params))
    Lr = halo + 3 * T + 37
    rng = np.random.default_rng(1000 * Lq + 10 * sum(params) + T)
    q, r = tile_cases(rng, 16, Lq, Lr, T, tsw.SWParams(*params))
    return q, r, halo, _jax(q, r, params)


@pytest.mark.parametrize('shape,params', [
    ((512, 1024, 4096), BIG),          # the bench shape
    ((512, 1024, 1024), BIG),          # the square
    ((4096, 32, 128), BIG),            # the short reference
    ((8, 256, 512), CLIP),             # chip_smoke's K2 case
    ((64, 2048, 512), CLIP),           # K4
    ((4, 8192, 16384), BIG),           # K3
    ((64, 28, 16384), (1, 1, 1, 0)),   # gap_extend 0
    ((64, 28, 16384), (0, 1, 1, 1)),   # match 0
])
def test_tile_plan_leaves_other_shapes_to_the_wavefront(shape, params):
    _, Lq, Lr = shape
    assert tsw._tile_plan(Lq, Lr, tsw.SWParams(*params)) is None


@pytest.mark.parametrize('Lq,params,plan', [
    (28, CLIP, (256, 57)), (54, CLIP, (448, 109)),
    (28, BIG, (704, 169)), (54, BIG, (1312, 325))])
def test_tile_plan_takes_the_main_path_shapes(Lq, params, plan):
    """call's launches (SWParams(1,1,1,1)) and phase 5's main-path shapes
    under (10,4,8,2), all at Lr 16 384."""
    assert tsw._tile_plan(Lq, 16384, tsw.SWParams(*params)) == plan
    T, halo = plan
    assert T % 32 == 0 and T >= 4 * halo and 16384 >= 2 * T


@pytest.mark.parametrize('params', PARAMS)
@pytest.mark.parametrize('Lq', QUERY_LENGTHS)
def test_tile_emulation_matches_jax(Lq, params):
    q, r, halo, want = _case(Lq, params, SMALL_T)
    got = _tile_emulation(q, r, params, SMALL_T, halo)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (want[0][4::8] == 0).all() and (want[0][5::8] == 0).all()
    assert (want[0] > 0).sum() >= 8


@pytest.mark.parametrize('params', [CLIP, BIG])
@pytest.mark.parametrize('Lq', [28, 54])
def test_tile_emulation_at_the_plan_width_matches_jax(Lq, params):
    p = tsw.SWParams(*params)
    T, halo = tsw._tile_plan(Lq, 1 << 20, p)
    Lr = 2 * T + 37
    assert tsw._tile_plan(Lq, Lr, p) == (T, halo)
    q, r = tile_cases(np.random.default_rng(Lq), 16, Lq, Lr, T, p)
    want = _jax(q, r, params)
    for a, b in zip(_tile_emulation(q, r, params, T, halo), want):
        np.testing.assert_array_equal(a, b)


def test_a_short_halo_fails():
    """With a halo of Lq/2 the same emulation misses on some row: the
    planted rows need more than that."""
    wrong = 0
    for Lq in QUERY_LENGTHS[1:]:
        for params in PARAMS:
            q, r, _, want = _case(Lq, params, SMALL_T)
            got = _tile_emulation(q, r, params, SMALL_T, Lq // 2)
            wrong += int((np.stack(got) != np.stack(want)).any(axis=0).sum())
    assert wrong > 0
