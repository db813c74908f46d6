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

``emulate_tiles`` runs the kernel's own schedule: each tile's window is a
row of the wavefront's emulation (tests/test_torch_sw_wave.py::
emulate_wave) with one warp, R query rows a lane, chunks masked at the
window's edges, the window cut to its real width (a window with no code in
0..4 does no sweep) and the best folded on the whole (score, j, i); the
records are merged in the contract's order.  It equals JAX on
tools/sw_cases.py's tile_edge_cases at every real query length 1-65 and at
the edges of 32 R rows, under three SWParams.  Integer DP: tolerance 0.
"""

import functools

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import sw as jsw
from ciri_long_tpu_torch.ops import sw as tsw
from ciri_long_tpu_torch.tools.sw_cases import (TILE_SPECIAL,
                                                tile_edge_cases, tile_cases)
from tests.test_torch_sw_wave import emulate_wave, real_lengths

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
    ((8, 400, 8192), (200, 1, 1000, 1000)),  # Lq * match over 2^16
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


def emulate_tiles(q, r, params, T, halo, R):
    """(score, q_end, r_end) of the tiled route's schedule with R rows a
    lane, and the number of windows that did no sweep: every (row, tile)
    window PAD-padded to the widest (the cut to its real width makes the
    padding inert) and swept by emulate_wave with K = 1, the records (j
    global, none as (0, -1, INT_MAX)) merged by score desc, r_end asc,
    q_end asc."""
    B, Lr = r.shape
    owned = range(0, Lr, T)
    starts = [max(0, k - halo) for k in owned]
    ends = [min(k + T, Lr) for k in owned]
    n = len(starts)
    win = np.full((B * n, max(e - s for s, e in zip(starts, ends))), 5,
                  np.int8)
    for t, (lo, hi) in enumerate(zip(starts, ends)):
        win[t::n, :hi - lo] = r[:, lo:hi]
    s, i, j = emulate_wave(np.repeat(q, n, 0), win,
                           np.tile(params, (B * n, 1)), R, 1)
    j = np.where(s > 0, j + np.tile(starts, B), NO_J)
    s, i, j = (x.reshape(B, n).astype(np.int64) for x in (s, i, j))
    out = []
    for b in range(B):
        best, neg_j, neg_i = max(zip(s[b], -j[b], -i[b]))
        out.append((best, -neg_i, -neg_j) if best > 0 else (0, -1, -1))
    skipped = int((real_lengths(win) == 0).sum())
    return [np.array(col, np.int32) for col in zip(*out)], skipped


# (R, the query's padded length, its rows' real lengths): each R at the
# lengths the rule gives it (1-32, 33-64, 65 on), the edges of 32 R rows
# and, at R = 4, a query of two strips; short rows under each shape too
SCHEDULES = [(1, 32, tuple(range(1, 33))),
             (2, 64, tuple(range(33, 65)) + (1, 31, 32)),
             (4, 129, (65, 127, 128, 129, 1, 33, 64, 96))]


@pytest.mark.parametrize('params', PARAMS)
@pytest.mark.parametrize('R,Lq,lqs', SCHEDULES)
def test_tile_schedule_matches_jax(R, Lq, lqs, params):
    """The kernel's schedule equals JAX on tile_edge_cases: real lengths
    under one padded shape, references cut inside, at the end of, at the
    start of and before a tile's window, all-PAD, N and mid-row PAD rows,
    twins in two tiles and in neighbouring query rows."""
    p = tsw.SWParams(*params)
    assert tsw._tile_rows(Lq) == R
    halo = tsw._tile_halo(Lq, p)
    Lr = halo + 3 * SMALL_T + 37
    rng = np.random.default_rng(100 * R + sum(params))
    q, r = tile_edge_cases(rng, lqs, Lq, Lr, SMALL_T, halo)
    got, skipped = emulate_tiles(q, r, np.array(params), SMALL_T, halo, R)
    want = _jax(q, r, params)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert skipped > 0
    assert sorted(set(real_lengths(q[:len(lqs)]))) == sorted(set(lqs))
    special = dict(zip(TILE_SPECIAL, range(len(lqs), len(q))))
    for kind in ('lr_inside', 'lr_at_start', 'lr_before', 'pad_ref'):
        assert real_lengths(r[special[kind]:special[kind] + 1])[0] < Lr
    s, i, j = want
    b = special['twins_tiles']
    m = min(24, Lq, SMALL_T // 2)
    assert (s[b], j[b]) == (m * p.match,
                          SMALL_T * (j[b] // SMALL_T) + m - m // 2 - 1)
    b = special['twins_rows']
    m = max(1, min(8, Lq - 3))
    assert (s[b], i[b]) == (m * p.match, Lq - min(m + 3, Lq) + m - 1)


@pytest.mark.parametrize('Lq,R', [(1, 1), (28, 1), (32, 1), (33, 2),
                                  (54, 2), (64, 2), (65, 4), (300, 4)])
def test_tile_rows_rule(Lq, R):
    """R query rows a lane: the wavefront's rule, halved while half as many
    rows still hold the query in one strip; the plan's handoff row fits a
    block beside that R's score table."""
    assert tsw._tile_rows(Lq) == R
    p = tsw.SWParams(*CLIP)
    plan = tsw._tile_plan(Lq, 1 << 20, p)
    T, halo = plan
    assert (T + halo) * 8 + tsw._tile_static_bytes(R) <= tsw.BLOCK_SMEM


def test_packed_best_is_the_first_maximum():
    """The tiles' packed best (csrc/sw_score_ends.cu, PACK): the largest
    int32 key m * 2^15 + (2^15 - 1 - d) over a row's steps is its largest
    M at the smallest step d, as the strict > of the unpacked best gives,
    for any M in [-2^16, 2^16) (what _tile_plan allows) and d < 2^15."""
    rng = np.random.default_rng(5)
    for t in range(300):
        n = int(rng.integers(1, 2000))
        top = 1 << 16
        near = int(rng.integers(-top + 3, top - 3))   # ties at one value
        m = (rng.integers(-top, top, n) if t % 2
             else rng.integers(-3, 3, n) + near)
        d = np.sort(rng.choice(1 << 15, n, replace=False))
        key = m.astype(np.int64) * (1 << 15) + ((1 << 15) - 1 - d)
        assert key.min() >= -2 ** 31 and key.max() < 2 ** 31
        k = key.max()
        first = int(np.argmax(m == m.max()))
        assert (k >> 15, (1 << 15) - 1 - (k & ((1 << 15) - 1))) == \
            (m.max(), d[first])
