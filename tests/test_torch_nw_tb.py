"""The port's center-star polish, banded NW with traceback (ops/nw_tb_batch.py,
ROADMAP X4), against the JAX package on the CPU.  Every comparison is exact
(integer scores and cigars: no tolerance).

- ``nw_traceback_plain`` (the planes walked by ``walk_plane``) equal to the
  JAX program ``_build_kernel`` (jit on the CPU) in both scores and the
  decoded cigar, at each pair's first band and at the next two of its
  ladder, on tests/test_nw_tb_batch.py's cases: near-identical pairs,
  identical and one-base pairs, length skew with N codes, unrelated pairs
  (with pairs that need one and two doublings), and a 3 000-base pair;
- ``nw_traceback_batch`` on the CPU equal pair by pair to the JAX
  ``banded_global_cigar`` on the same cases and on empty sides, the 3 000-base
  pair (which the JAX package sends to its host aligner) included;
- csrc/nw_traceback.cu's schedule emulated in numpy (``emulate_launch``: 32
  lanes of neighbouring columns, the three sweeps a row, the carry from the
  lanes' exclusive prefix max by shuffles, the planes and run buffers at
  nw_plan's offsets) equal to ``nw_launch_plain`` on tools/nw_cases.py, all
  cases in one launch and each alone, and the plain route equal to the JAX
  ``banded_global_cigar`` there;
- ``nw_plan``'s grouping under the byte budget and its row placement;
- ``find_ccs_reads`` on the card's route (resolve_device answering cuda, the
  uploads kept on the CPU, the kernel's wrapper patched to the plain
  version) writing the same tmp/*.ccs.fa and tmp/*.raw.fa as ``--device
  cpu`` and the JAX package's ``find_ccs_reads``, no pair aligned on the host.
"""

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import nw_tb_batch as jntb
from ciri_long_tpu.ops.traceback import banded_global_cigar
from ciri_long_tpu.pipeline.find_ccs import find_ccs_reads as jax_find_ccs
from ciri_long_tpu_torch.ops import nw_tb_batch as ntb
from ciri_long_tpu_torch.pipeline import find_ccs as tfc
from ciri_long_tpu_torch.tools.nw_cases import drifted, nw_cases
from ciri_long_tpu_torch.utils import dispatch
from tests.test_nw_tb_batch import _mutated_pair
from tests.test_pipeline_call import make_rolling_read, rand_seq

torch.set_num_threads(1)

SCORES = (2, 4, 4, 2)
NEG, HALF_NEG = ntb.NEG, ntb.HALF_NEG


def _pairs(case, rng):
    """tests/test_nw_tb_batch.py's inputs (its generators, this test's
    seed) and the two doubling cases of tools/nw_cases.py."""
    if case == 'near_identical':
        return [_mutated_pair(rng, int(rng.integers(30, 600)))
                for _ in range(30)]
    if case == 'identical_and_tiny':
        r = rng.integers(0, 4, 100).astype(np.int8)
        return [(r.copy(), r.copy()), (r[:1], r[:1].copy()),
                (np.array([1, 2, 3], np.int8), np.array([3, 2, 1], np.int8))]
    if case == 'skew_and_n':
        pairs = []
        for _ in range(12):
            q, r = _mutated_pair(rng, int(rng.integers(50, 300)), sub=0.05,
                                 ins=0.15, dele=0.02)
            q[rng.integers(0, len(q), max(1, len(q) // 20))] = 4
            pairs.append((q, r))
        pairs.append((rng.integers(0, 4, 60).astype(np.int8),
                      rng.integers(0, 4, 360).astype(np.int8)))
        pairs.append((rng.integers(0, 4, 360).astype(np.int8),
                      rng.integers(0, 4, 60).astype(np.int8)))
        return pairs
    if case == 'unrelated':
        pairs = [(rng.integers(0, 5, int(rng.integers(30, 250))
                               ).astype(np.int8),
                  rng.integers(0, 5, int(rng.integers(30, 250))
                               ).astype(np.int8)) for _ in range(10)]
        # one doubling and two
        return pairs + [drifted(rng, 200, (24,)), drifted(rng, 300, (24, 24))]
    assert case == 'long_3000'
    return [_mutated_pair(rng, 3000)]


CASES = ('near_identical', 'identical_and_tiny', 'skew_and_n', 'unrelated',
         'long_3000')


def _jax_at_band(pairs, bands):
    """The JAX program at each pair's traceback band (its check band
    min(2 band, max(n, m))): (s1, s2, cigar or None where its run buffer of
    256 entries overflowed)."""
    n = np.array([len(q) for q, _ in pairs])
    m = np.array([len(r) for _, r in pairs])
    bands = np.asarray(bands)
    lo1, hi1 = ntb.band_edges(n, m, bands)
    lo2, hi2 = ntb.band_edges(n, m, np.minimum(2 * bands, np.maximum(n, m)))
    N = -(-int(n.max()) // 64) * 64
    W = -(-int(max((hi1 - lo1).max(), (hi2 - lo2).max()) + 1) // 64) * 64
    kernel = jntb._kernel_for(N, W, 256, SCORES)
    B = len(pairs)
    qs = np.full((B, N), 5, np.int8)
    rp1 = np.full((B, N + 2 * W + 2), 5, np.int8)
    rp2 = np.full((B, N + 2 * W + 2), 5, np.int8)
    for b, (q, r) in enumerate(pairs):
        qs[b, :len(q)] = q
        rp1[b, W - lo1[b]:W - lo1[b] + len(r)] = r
        rp2[b, W - lo2[b]:W - lo2[b] + len(r)] = r
    i32 = lambda x: np.asarray(x, np.int32)   # noqa: E731
    s1, s2, ops, pos, ok = (np.asarray(x) for x in kernel(
        qs, rp1, rp2, i32(n), i32(m), i32(lo1), i32(hi1), i32(lo2),
        i32(hi2)))
    cigars = [jntb._decode_runs(ops[b, int(pos[b]):]) if ok[b] else None
              for b in range(B)]
    return s1, s2, cigars


def _cigar(entries):
    return [(int(e) >> 4, int(e) & 15) for e in entries]


def _plain_at_band(pairs, bands):
    """nw_traceback_plain at each pair's band: (s1, s2, cigars)."""
    n = np.array([len(q) for q, _ in pairs])
    m = np.array([len(r) for _, r in pairs])
    bands = np.asarray(bands)
    lo, hi = ntb.band_edges(n, m, bands)
    lo2, hi2 = ntb.band_edges(n, m, np.minimum(2 * bands, np.maximum(n, m)))
    q = np.full((len(pairs), n.max()), 5, np.int8)
    r = np.full((len(pairs), m.max()), 5, np.int8)
    for b, (x, y) in enumerate(pairs):
        q[b, :len(x)] = x
        r[b, :len(y)] = y
    planes, s1, s2 = ntb.nw_traceback_plain(
        *(torch.from_numpy(np.asarray(x)) for x in
          (q, r, n, m, lo, hi, lo2, hi2)), *SCORES)
    planes = planes.numpy()
    cigars = []
    for b in range(len(pairs)):
        path = ntb.walk_plane(planes[b, :n[b] + 1, :hi[b] - lo[b] + 1],
                              int(n[b]), int(m[b]), int(lo[b]))
        cigars.append(_cigar(path))
    return s1.numpy(), s2.numpy(), cigars


@pytest.mark.parametrize('case', CASES)
def test_plain_matches_jax_program_along_the_ladder(rng, case):
    pairs = _pairs(case, rng)
    n = np.array([len(q) for q, _ in pairs])
    m = np.array([len(r) for _, r in pairs])
    big = np.maximum(n, m)
    band = np.abs(n - m) + ntb.FIRST_BAND
    for step in range(3):
        want = _jax_at_band(pairs, band)
        got = _plain_at_band(pairs, band)
        assert np.array_equal(got[0], want[0]), (case, step)
        assert np.array_equal(got[1], want[1]), (case, step)
        compared = 0
        for b, cig in enumerate(want[2]):
            if cig is not None:
                assert got[2][b] == cig, (case, step, b)
                compared += 1
        assert compared >= len(pairs) // 2
        band = np.minimum(2 * band, big)


@pytest.mark.parametrize('case', CASES + ('empty_sides',))
def test_batch_matches_jax_banded_global_cigar(rng, case):
    if case == 'empty_sides':
        r = rng.integers(0, 4, 50).astype(np.int8)
        pairs = [(np.zeros(0, np.int8), r), (r, np.zeros(0, np.int8)),
                 (np.zeros(0, np.int8), np.zeros(0, np.int8)), (r, r)]
    else:
        pairs = _pairs(case, rng)
    before = dispatch.ROUTES['nw_escalate']
    got = ntb.nw_traceback_batch([q for q, _ in pairs],
                                 [r for _, r in pairs], device='cpu')
    for t, (q, r) in enumerate(pairs):
        assert got[t] == banded_global_cigar(q, r), (case, t)
    if case == 'unrelated':
        # the drifted pairs: one doubling, then two
        assert dispatch.ROUTES['nw_escalate'] - before >= 3


def _sub(a, b):
    s = np.where(a == b, SCORES[0], -SCORES[1])
    return np.where((a >= 5) | (b >= 5), NEG, np.where((a == 4) | (b == 4),
                                                       0, s))


def _shfl_down(x, fill):
    """__shfl_down_sync(x, 1) over the lanes (axis 0); lane 31 gets
    ``fill``."""
    return np.concatenate([x[1:], np.full((1,) + x.shape[1:], fill,
                                          x.dtype)])


def _shfl_up(x, fill):
    """__shfl_up_sync(x, 1); lane 0 gets ``fill``."""
    return np.concatenate([np.full((1,) + x.shape[1:], fill, x.dtype),
                           x[:-1]])


def emulate_pass(q, r, n, m, lo, hi, codes, C, warps=1):
    """One pass of csrc/nw_traceback.cu for one pair on ``warps`` warps,
    lane l of warp k owning columns [(32 k + l) C, ... + C) (reg_pass for C
    <= 8, a block class with warps > 1, wide_pass's order of work for wider
    C, the same values): row 0 masked to W; then each row takes H and F at
    c + 1 of the row above within the lane and, past its last column, from
    the next lane's first (a shuffle, or the next warp's lane 0 through
    shared memory; NEG past the last lane), sweeps its columns for F and
    Ht, takes the carry of the prefix max from the lanes' maxima shifted up
    one lane and scanned in five shuffle steps within the warp, then from
    the maxima of the warps before it, sweeps again for E and H, and forms
    the codes with E at c - 1 from the previous lane's last column; the r
    codes slide one column a row, each warp's lane 31 loading its last.  The
    codes go out packed, each lane's C nibbles at byte (32 k + l) C / 2 of
    the row when that is below S = plane_stride(W).  Returns (plane bytes
    [n + 1, S] or None, score at (n, m))."""
    _, _, go, ge = SCORES
    W = hi - lo + 1
    S = ntb.plane_stride(W)
    lanes = 32 * warps
    cols = np.arange(lanes * C).reshape(lanes, C)
    lane = np.arange(32)

    def rcode(j):
        return np.where((j >= 1) & (j <= m), r[np.clip(j - 1, 0, m - 1)], 5)

    def store(code):
        """Lanes' C nibbles to a row of S bytes (bytes l C / 2 < S)."""
        nib = code.ravel()
        byte = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
        return byte[:S]

    j = cols + lo
    ok = (cols < W) & (j >= 0) & (j <= m)
    h = np.where(ok, np.where(j == 0, 0, -go - (j - 1) * ge), NEG)
    f = np.full((lanes, C), NEG, np.int64)
    rc = rcode(cols + 1 + lo)
    plane = np.zeros((n + 1, S), np.uint8) if codes else None
    if codes:
        jl = j - 1
        el = np.where((cols >= 1) & (jl >= 1) & (jl <= m),
                      -go - (jl - 1) * ge, NEG)
        hh = -go - (j - 1) * ge
        stay = (j > 1) & (cols >= 1) & (hh == el - ge)
        plane[0] = store(np.where((cols < W) & (j >= 1) & (j <= m),
                                  1 | (stay << 2), 0))
    for i in range(1, n + 1):
        qi = int(q[i - 1])
        base = i + lo
        jlo = max(0, base)
        cl, ch = max(1, jlo) - base, min(m, i + hi) - base
        cj0 = -base if jlo == 0 else -1
        edge = -go - (i - 1) * ge
        hup = np.concatenate([h[:, 1:], _shfl_down(h[:, :1], NEG)], 1)
        fup = np.concatenate([f[:, 1:], _shfl_down(f[:, :1], NEG)], 1)
        rnx = _shfl_down(rc[:, :1], 0)[:, 0]
        valid = (cols >= cl) & (cols <= ch)
        is_j0 = cols == cj0
        fv = np.maximum(fup - ge, hup - go)
        ht = np.maximum(h + _sub(qi, rc), fv)
        ht = np.where(is_j0, edge, np.where(valid, ht, NEG))
        fv = np.where(is_j0, edge, np.where(valid, fv, NEG))
        fs = (i > 1) & (cols <= W - 2) & (fv == fup - ge) & (fup > HALF_NEG)
        # the kernel's g has no Ht > NEG / 2 test (its E tests the carry)
        g = ht + ge * cols
        agg = g.max(axis=1).reshape(warps, 32)
        run = np.concatenate([np.full((warps, 1), NEG), agg[:, :-1]], 1)
        for o in (1, 2, 4, 8, 16):
            up = np.concatenate([np.full((warps, o), NEG), run[:, :-o]], 1)
            run = np.where(lane >= o, np.maximum(run, up), run)
        tot = np.maximum(run[:, 31], agg[:, 31])
        carry = np.concatenate([[NEG], np.maximum.accumulate(tot)[:-1]])
        run = np.maximum(run, carry[:, None]).ravel()
        e = np.full((lanes, C), NEG, np.int64)
        for k in range(C):
            c = cols[:, k]
            e[:, k] = np.where(run > HALF_NEG, run - go - (c - 1) * ge, NEG)
            run = np.maximum(run, g[:, k])
        e = np.where(valid, e, NEG)
        hv = np.where(valid | is_j0, np.where(is_j0, edge, np.maximum(ht, e)),
                      NEG)
        e = np.where(is_j0, NEG, e)
        if codes:
            jj = cols + base
            in_cell = valid | is_j0
            left = np.concatenate([_shfl_up(e[:, -1:], NEG), e[:, :-1]], 1)
            case = np.where((hv == e) & (jj > 0), 1,
                            np.where(hv == fv, 2, 3))
            es = (jj > 1) & (cols >= 1) & (e == left - ge) & \
                (left > HALF_NEG)
            plane[i] = store(np.where(in_cell, case | (es << 2) | (fs << 3),
                                      0))
        h, f = hv, fv
        last = rcode(cols[:, -1] + i + 1 + lo)
        rc = np.concatenate([rc[:, 1:], np.where(
            np.arange(lanes) % 32 == 31, last, rnx)[:, None]], 1)
    c_nm = m - n - lo
    return plane, int(h.ravel()[c_nm])


def walk_tiles(flat, n, m, lo, W, tile_rows=32, tile_bytes=32):
    """csrc/nw_traceback.cu's walk_warp over a plane's bytes (numpy uint8,
    plane_stride(W) a row): a tile of ``tile_rows`` rows x ``tile_bytes``
    bytes staged around the path's cell (rows i0 down, bytes from b0 =
    max(0, c // 2 - tile_bytes // 2) rounded down to 16), walked until the
    path leaves it, then staged again.  Returns (run entries in path order,
    or None where walk_plane gives None; the tiles staged)."""
    S = ntb.plane_stride(W)
    rows = np.asarray(flat, np.uint8).reshape(n + 1, S)
    i, j, state, cur, length = n, m, 0, -1, 0
    runs, tiles = [], 0
    while True:
        c = j - i - lo
        if i < 0 or j < 0 or not 0 <= c < W:
            return None, tiles
        i0, b0 = i, max(0, c // 2 - tile_bytes // 2) & ~15
        tile = np.zeros((tile_rows, tile_bytes), np.uint8)
        for k in range(tile_rows):
            if i0 - k >= 0:   # the bytes past the row are the next row's
                src = rows[i0 - k, b0:b0 + tile_bytes]
                tile[k, :len(src)] = src
        tiles += 1
        while i > 0 or j > 0:
            cc = j - i - lo
            if i < 0 or j < 0 or not 0 <= cc < W:
                return None, tiles
            b = cc // 2 - b0
            if i0 - i >= tile_rows or not 0 <= b < tile_bytes:
                break
            code = (int(tile[i0 - i, b]) >> (4 * (cc & 1))) & 15
            if state == 0:
                case = code & 3
                if case == 0:
                    return None, tiles
                if case != 3:
                    state = case
                    continue
                op, i, j = 0, i - 1, j - 1
            elif state == 1:
                op, state, j = 2, (code >> 2) & 1, j - 1
            else:
                op, state, i = 1, 2 if (code >> 3) & 1 else 0, i - 1
            if op == cur:
                length += 1
            else:
                if length:
                    runs.append(length << 4 | cur)
                cur, length = op, 1
        else:
            if length:
                runs.append(length << 4 | cur)
            return np.array(runs[::-1], np.uint32), tiles


def emulate_launch(q, r, launch):
    """nw_traceback_cuda's outputs by emulate_pass, task by task of each
    width class at the plan's offsets, with the warp's staged walk."""
    geom = launch.geom.numpy().astype(np.int64)
    offs = launch.offs.numpy()
    tasks = launch.tasks.numpy()
    out = np.zeros((len(geom), 3), np.int32)
    runs = np.zeros(max(1, launch.run_entries), np.uint32)
    planes = np.zeros(launch.plane_bytes, np.uint8)
    for cls in launch.classes:
        for task in tasks[cls.start:cls.start + cls.count]:
            k = task >> 1
            n, m, lo, hi, lo2, hi2 = geom[k]
            qk = q[offs[k, 0]:offs[k, 0] + n].astype(np.int64)
            rk = r[offs[k, 1]:offs[k, 1] + m].astype(np.int64)
            C, warps = (8, cls.warps) if cls.kind == 1 else (cls.C, 1)
            if task & 1:
                _, out[k, 1] = emulate_pass(qk, rk, n, m, lo2, hi2, False,
                                            C, warps)
                continue
            plane, out[k, 0] = emulate_pass(qk, rk, n, m, lo, hi, True, C,
                                            warps)
            planes[offs[k, 2]:offs[k, 2] + plane.size] = plane.ravel()
            path, _ = walk_tiles(plane, n, m, lo, hi - lo + 1)
            end = offs[k, 3] + n + m
            runs[end - len(path):end] = path
            out[k, 2] = len(path)
    return out, runs.view(np.int32), planes


def _launch_inputs(pairs, force=None, band=None):
    """Flat codes and one launch of the pairs at their first band (or at
    ``band``) under ``force``."""
    n = np.array([len(q) for q, _ in pairs])
    m = np.array([len(r) for _, r in pairs])
    q = np.concatenate([x for x, _ in pairs])
    r = np.concatenate([y for _, y in pairs])
    (launch,) = ntb.nw_plan(n, m, np.abs(n - m) + ntb.FIRST_BAND
                            if band is None else band,
                            np.cumsum(n) - n, np.cumsum(m) - m, 'cpu',
                            budget=1 << 40, force=force)
    return q, r, launch


_NW_CASES = nw_cases(np.random.default_rng(44))
# every width class: the plan's own, each register class forced, the wide
# class with its rows in shared memory and in global scratch
_FORCES = ntb.FORCES


def _check_launch(q, r, launch, label):
    want = [t.numpy() for t in ntb.nw_launch_plain(
        torch.from_numpy(q), torch.from_numpy(r), launch, *SCORES)]
    got = emulate_launch(q, r, launch)
    for a, b, name in zip(got, want, ('out', 'runs', 'planes')):
        assert np.array_equal(a, b), (label, name)


@pytest.mark.parametrize('case,force', [
    pytest.param(case, force, id=case if force is None
                 else '{}-{}'.format(case, force))
    for force in _FORCES for case in ['all'] + list(_NW_CASES)])
def test_kernel_schedule_matches_plain_on_nw_cases(case, force):
    pairs = ([p for ps in _NW_CASES.values() for p in ps] if case == 'all'
             else _NW_CASES[case])
    if case == 'all':   # the longest pair alone makes the emulation slow
        pairs = [p for p in pairs if len(p[0]) < 1000]
    elif force is not None and case in ('widest_longest', 'mixed'):
        pairs = [p for p in pairs if len(p[0]) < 400]
    q, r, launch = _launch_inputs(pairs, force)
    routes = {c.route for c in launch.classes}
    if force in ntb.REG_CLASSES:
        # first bands are at least 33 wide (C = 1 holds none): the same
        # pairs also at narrow bands, W = |n - m| + 2 band + 1 <= 32 where
        # |n - m| allows
        n = np.array([len(x) for x, _ in pairs])
        m = np.array([len(y) for _, y in pairs])
        narrow = np.maximum(0, (31 - np.abs(n - m)) // 2)
        _, _, small = _launch_inputs(pairs, force, narrow)
        _check_launch(q, r, small, (case, force, 'narrow'))
        routes |= {c.route for c in small.classes}
        # (widest_longest keeps one pair here, |n - m| = 340: wide only)
        assert 'nw_c{}'.format(force) in routes or case == 'widest_longest'
    elif force in ('global', 'block'):
        assert routes == {'nw_' + force}
    _check_launch(q, r, launch, (case, force))
    if force is None:
        # the plain route's ladder ends where the JAX host aligner does
        res = ntb.nw_traceback_batch([x for x, _ in pairs],
                                     [y for _, y in pairs], device='cpu')
        for t, (x, y) in enumerate(pairs):
            assert res[t] == banded_global_cigar(x, y), (case, t)


def _walk_case(rng, kind):
    """(plane codes [n + 1, W], n, m, lo) of one pair's traceback band: its
    plane by nw_traceback_plain, a path the tiles must follow."""
    if kind == 'drift_right':      # a long insertion: c climbs past a tile
        r = rng.integers(0, 4, 300).astype(np.int8)
        q = np.concatenate([r[:100], rng.integers(0, 4, 90).astype(np.int8),
                            r[100:]])
    elif kind == 'drift_left':     # a long deletion: c falls
        r = rng.integers(0, 4, 400).astype(np.int8)
        q = np.concatenate([r[:150], r[250:]])
    elif kind == 'long':
        q, r = _mutated_pair(rng, 1200)
    elif kind == 'one_row':
        q, r = np.array([2], np.int8), rng.integers(0, 4, 70).astype(np.int8)
    else:
        assert kind == 'unrelated'
        q = rng.integers(0, 5, 150).astype(np.int8)
        r = rng.integers(0, 5, 170).astype(np.int8)
    n, m = len(q), len(r)
    band = max(abs(n - m) + ntb.FIRST_BAND, 8)
    lo, hi = ntb.band_edges(n, m, band)
    planes, _, _ = ntb.nw_traceback_plain(
        *(torch.from_numpy(np.asarray(x)[None]) for x in (q, r)),
        *(torch.tensor([v]) for v in (n, m, lo, hi, lo, hi)), *SCORES)
    return planes[0].numpy(), n, m, int(lo)


@pytest.mark.parametrize('kind', ['drift_right', 'drift_left', 'long',
                                  'one_row', 'unrelated', 'bad_plane'])
def test_staged_walk_matches_walk_plane(rng, kind):
    plane, n, m, lo = _walk_case(rng, 'unrelated' if kind == 'bad_plane'
                                 else kind)
    W = plane.shape[1]
    if kind == 'bad_plane':        # a cell with no case halfway down
        plane = plane.copy()
        path = ntb.walk_plane(plane, n, m, lo)
        plane[n // 2] = 0
    packed = ntb.pack_plane(plane)
    assert np.array_equal(ntb.unpack_plane(packed.ravel(), n, W), plane)
    want = ntb.walk_plane(plane, n, m, lo)
    got, tiles = walk_tiles(packed.ravel(), n, m, lo, W)
    if want is None:
        assert got is None
        assert kind == 'bad_plane' and path is not None
        return
    assert np.array_equal(got, want)
    steps = sum(int(e) >> 4 for e in want)
    # a tile holds 32 rows: the walk stages one at least every 32 rows, and
    # again where the path leaves the tile's 64 columns
    assert -(-n // 32) <= tiles <= steps


def test_nw_plan_groups_pairs_under_the_budget():
    n = np.array([100, 200, 50, 400, 30])
    m = np.array([110, 190, 50, 300, 31])
    band = np.abs(n - m) + ntb.FIRST_BAND
    W = 2 * band + np.abs(n - m) + 1
    S = ntb.plane_stride(W)
    assert S.tolist() == [16 * ntb.plane_cols(w) for w in W.tolist()]
    assert ntb.plane_cols(np.array([1, 32, 33, 64, 65, 257, 600])).tolist() \
        == [1, 1, 2, 2, 4, 16, 32]
    plane = (n + 1) * S
    launches = ntb.nw_plan(n, m, band, np.zeros(5), np.zeros(5), 'cpu',
                           budget=int(plane[:2].sum()))
    assert [list(x.pairs) for x in launches] == [[0, 1], [2], [3], [4]]
    assert [x.plane_bytes for x in launches] == [int(plane[:2].sum()),
                                                 *map(int, plane[2:])]
    first = launches[0]
    assert first.offs[:, 2].tolist() == [0, int(plane[0])]
    assert first.offs[:, 3].tolist() == [0, 210]
    assert first.run_entries == 210 + 390
    assert first.geom.dtype == torch.int32 and first.offs.dtype == torch.int64
    assert first.tasks.dtype == torch.int32
    # each pass lands in the class of its own width: the traceback pass of
    # pair 3 (W 333) and its check pass (min(2 band, 400): W 565) are wide
    big = np.maximum(n, m)
    W2 = 2 * np.minimum(2 * band, big) + np.abs(n - m) + 1
    for x in launches:
        tasks = x.tasks.numpy()
        assert sorted(tasks.tolist()) == list(range(2 * len(x.pairs)))
        assert sum(c.count for c in x.classes) == len(tasks)
        for c in x.classes:
            for t in tasks[c.start:c.start + c.count]:
                p = x.pairs[t >> 1]
                w = (W2 if t & 1 else W)[p]
                assert c.C == ntb.plane_cols(w)
                assert c.route == ('nw_c{}'.format(c.C) if c.C <= 8
                                   else 'nw_block')
                assert c.warps == (ntb.REG_WARPS if c.C <= 8 else c.C // 8)
            # the longest pass of a class first
            rows = n[x.pairs[tasks[c.start:c.start + c.count] >> 1]]
            assert list(rows) == sorted(rows, reverse=True)
    assert [c.route for c in launches[2].classes] == ['nw_block', 'nw_block']
    assert [c.C for c in launches[2].classes] == [32, 16]
    # past the block classes (W > 8 192): the rows in global scratch; the
    # check band (10 + 10 + 1 columns) in C = 1
    (gl,) = ntb.nw_plan([10], [10], [4200], [0], [0], 'cpu')
    assert [(c.route, c.C, c.warps) for c in gl.classes] == [
        ('nw_global', 512, ntb.WIDE_WARPS), ('nw_c1', 1, ntb.REG_WARPS)]
    (blk,) = ntb.nw_plan(n, m, band, np.zeros(5), np.zeros(5), 'cpu',
                         force='block')
    assert {c.route for c in blk.classes} == {'nw_block'}
    assert min(c.C for c in blk.classes) == 16
    # two wide classes in global scratch, each with its rows' offset
    (g,) = ntb.nw_plan([10, 10], [9000, 18000], [9000, 18000], [0, 0],
                       [0, 0], 'cpu')
    assert [(c.kind, c.count) for c in g.classes] == [(2, 2), (2, 2)]
    assert g.rows_ints == sum(c.count * ntb.ROW_INTS * 32 * (c.C + 1)
                              for c in g.classes)
    assert g.classes[1].rows_off == 2 * ntb.ROW_INTS * 32 * (
        g.classes[0].C + 1)
    (forced,) = ntb.nw_plan(n, m, band, np.zeros(5), np.zeros(5), 'cpu',
                            force='global')
    assert {c.route for c in forced.classes} == {'nw_global'}
    assert all(c.C >= 8 for c in forced.classes)
    (forced,) = ntb.nw_plan(n, m, band, np.zeros(5), np.zeros(5), 'cpu',
                            force=8)
    assert {c.C for c in forced.classes} == {8, 16, 32}
    with pytest.raises(ValueError, match='force'):
        ntb.nw_plan([10], [10], [16], [0], [0], 'cpu', force=3)


def test_collect_runs_leaves_the_cigars_in_the_run_buffers(rng):
    pairs = _NW_CASES['two_doublings'] + _NW_CASES['one_base'] + [
        (np.zeros(0, np.int8), np.ones(5, np.int8))]
    h = ntb.nw_traceback_submit([q for q, _ in pairs], [r for _, r in pairs],
                                device='cpu')
    res = ntb.nw_traceback_collect_runs(h)
    assert len(res.score) == len(pairs)
    for t, (q, r) in enumerate(pairs):
        score, cigar = banded_global_cigar(q, r)
        assert res.score[t] == score and res.cigar(t) == cigar
        assert res.count[t] == len(cigar)
        # the address lies in a buffer the result keeps alive
        assert any(b.ctypes.data <= int(res.addr[t]) < b.ctypes.data
                   + b.nbytes for b in res.keep)


def test_wrapper_raises_on_cpu_tensors():
    pairs = [drifted(np.random.default_rng(3), 80, (20,))]
    q, r, launch = _launch_inputs(pairs)
    with pytest.raises(ValueError, match='CUDA device'):
        ntb.nw_traceback_cuda(torch.from_numpy(q), torch.from_numpy(r),
                              launch)


def _ccs_reads(rng, path):
    """Rolling-circle reads of tests/test_pipeline_call.py's planted
    520-base circRNA unit (its make_rolling_read) and of shorter units,
    reads of two units (the host's POA path), linear reads."""
    unit = rand_seq(rng, 520)
    with open(path, 'w') as f:
        for i in range(8):
            f.write('>w{}\n{}\n'.format(i, make_rolling_read(
                rng, unit, copies=2.6 + 0.5 * i, rot=(i * 53) % 520,
                noise=0.03)))
        for i in range(6):
            u = rand_seq(rng, int(rng.integers(80, 400)))
            f.write('>c{}\n{}\n'.format(i, make_rolling_read(
                rng, u, copies=3.2 + 0.4 * i, noise=0.04)))
        f.write('>two\n{}\n'.format(make_rolling_read(
            rng, rand_seq(rng, 300), copies=2.1, noise=0.02)))
        for i in range(4):
            f.write('>l{}\n{}\n'.format(i, rand_seq(rng, 900)))


def test_find_ccs_reads_card_route_matches_cpu_and_jax(rng, tmp_path,
                                                      monkeypatch):
    reads_fa = tmp_path / 'reads.fa'
    _ccs_reads(rng, reads_fa)
    monkeypatch.setenv('CIRI_CCS_DEVICE', '0')
    jres = jax_find_ccs(str(reads_fa), str(tmp_path / 'jax'), 'p',
                        use_device_screen=False)
    dispatch.reset_launches()
    cpu = tfc.find_ccs_reads(str(reads_fa), str(tmp_path / 'cpu'), 'p',
                             device='cpu')
    host_pairs = dispatch.ROUTES['nw_host']

    card = torch.device('cuda', 0)
    launches = []

    def wrapper(q, r, launch, *scores):
        assert launch.geom.device.type == 'cpu'
        launches.append(len(launch.pairs))
        return ntb.nw_launch_plain(q, r, launch, *scores)

    real_screen = tfc.screen_keep
    monkeypatch.setattr(tfc, 'resolve_device', lambda d: card)
    monkeypatch.setattr(tfc, 'screen_keep', lambda *a: real_screen(
        *a[:-1], device='cpu'))
    monkeypatch.setattr(ntb, 'resolve_device', lambda d: card)
    monkeypatch.setattr(ntb, 'upload', lambda arrays, device: [
        torch.from_numpy(np.ascontiguousarray(x)) for x in arrays])
    monkeypatch.setattr(ntb, 'nw_traceback_cuda', wrapper)
    dispatch.reset_launches()
    cuda = tfc.find_ccs_reads(str(reads_fa), str(tmp_path / 'cuda'), 'p',
                              device='cuda')
    assert cuda == cpu == jres
    for name in ('tmp/p.ccs.fa', 'tmp/p.raw.fa'):
        want = (tmp_path / 'jax' / name).read_bytes()
        assert (tmp_path / 'cpu' / name).read_bytes() == want
        assert (tmp_path / 'cuda' / name).read_bytes() == want
    assert jres[1] >= 12
    # every star pair went through the wrapper on the card's route, none
    # through a host aligner; the cpu route aligned the same pairs itself
    assert host_pairs > 0 and len(launches) >= 1
    assert sum(launches) == host_pairs + dispatch.ROUTES['nw_escalate']
    assert dispatch.ROUTES['nw_host'] == 0
