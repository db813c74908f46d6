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


def emulate_pass(q, r, n, m, lo, hi, codes):
    """csrc/nw_traceback.cu's nw_pass for one pair: lane l owns columns
    [l C, l C + C), C = ceil(W / 32); a row is sweep 1 (F and Ht from the
    row above), the lanes' exclusive prefix max by five shuffle steps,
    sweep 2 (E from the lane's carry, column by column, then H) and sweep 3
    (the codes).  Returns (plane [n + 1, W] or None, score at (n, m))."""
    _, _, go, ge = SCORES
    W = hi - lo + 1
    C = -(-W // 32)
    cols = np.arange(32 * C).reshape(32, C)
    inside = cols < W
    lane = np.arange(32)

    def at(row, c):
        return np.where((c >= 0) & (c < W), row[np.clip(c, 0, W - 1)], NEG)

    j = cols + lo
    ok = inside & (j >= 0) & (j <= m)
    h0 = np.where(ok, np.where(j == 0, 0, -go - (j - 1) * ge), NEG)
    Hp = np.full(W, NEG, np.int64)
    Fp = np.full(W, NEG, np.int64)
    Hp[cols[inside]] = h0[inside]
    plane = np.zeros((n + 1, W), np.uint8) if codes else None
    if codes:
        jl = j - 1
        el = np.where((cols >= 1) & (jl >= 1) & (jl <= m),
                      -go - (jl - 1) * ge, NEG)
        stay = (j > 1) & (cols >= 1) & (h0 == el - ge)
        plane[0, cols[inside]] = np.where(ok & (j >= 1), 1 | (stay << 2),
                                          0)[inside]
    score = NEG
    for i in range(1, n + 1):
        jlo, jhi = max(0, i + lo), min(m, i + hi)
        jmin, edge = max(1, jlo), -go - (i - 1) * ge
        j = cols + i + lo
        valid = inside & (j >= jmin) & (j <= jhi)
        is_j0 = inside & (j == 0) & (jlo == 0)
        rj = np.where((j >= 1) & (j <= m), r[np.clip(j - 1, 0, m - 1)], 5)
        d = at(Hp, cols) + _sub(int(q[i - 1]), rj)
        f = np.maximum(at(Fp, cols + 1) - ge, at(Hp, cols + 1) - go)
        ht = np.where(is_j0, edge, np.where(valid, np.maximum(d, f), NEG))
        f = np.where(is_j0, edge, np.where(valid, f, NEG))
        g = np.where(inside & (ht > HALF_NEG), ht + ge * cols, NEG)
        incl = g.max(axis=1)
        for o in (1, 2, 4, 8, 16):
            up = np.concatenate([incl[:o], incl[:-o]])
            incl = np.where(lane >= o, np.maximum(incl, up), incl)
        run = np.concatenate([[NEG], incl[:-1]])
        e = np.full((32, C), NEG, np.int64)
        for k in range(C):
            c = cols[:, k]
            e[:, k] = np.where(run > HALF_NEG, run - go - (c - 1) * ge, NEG)
            run = np.maximum(run, g[:, k])
        e = np.where(valid, e, NEG)
        h = np.where(valid | is_j0, np.where(is_j0, edge, np.maximum(ht, e)),
                     NEG)
        e = np.where(is_j0, NEG, e)
        Hn, Fn, En = (np.full(W, NEG, np.int64) for _ in range(3))
        Hn[cols[inside]], Fn[cols[inside]] = h[inside], f[inside]
        En[cols[inside]] = e[inside]
        if codes:
            in_cell = valid | is_j0
            case = np.where((h == e) & (j > 0) & in_cell, 1,
                            np.where((h == f) & in_cell, 2, 3))
            el = at(En, cols - 1)
            es = (j > 1) & (cols >= 1) & (e == el - ge) & (el > HALF_NEG)
            fup = at(Fp, cols + 1)
            fs = (i > 1) & (cols <= W - 2) & (f == fup - ge) & \
                (fup > HALF_NEG)
            plane[i, cols[inside]] = np.where(
                in_cell, case | (es << 2) | (fs << 3), 0)[inside]
        if i == n:
            score = int(Hn[m - n - lo])
        Hp, Fp = Hn, Fn
    return plane, score


def emulate_launch(q, r, launch):
    """nw_traceback_cuda's outputs by emulate_pass, pair by pair at the
    plan's offsets, with lane 0's walk."""
    geom = launch.geom.numpy().astype(np.int64)
    offs = launch.offs.numpy()
    out = np.zeros((len(geom), 3), np.int32)
    runs = np.zeros(max(1, launch.run_entries), np.uint32)
    planes = np.zeros(max(1, launch.plane_bytes), np.uint8)
    for k, (n, m, lo, hi, lo2, hi2) in enumerate(geom):
        qk = q[offs[k, 0]:offs[k, 0] + n].astype(np.int64)
        rk = r[offs[k, 1]:offs[k, 1] + m].astype(np.int64)
        plane, out[k, 0] = emulate_pass(qk, rk, n, m, lo, hi, True)
        _, out[k, 1] = emulate_pass(qk, rk, n, m, lo2, hi2, False)
        planes[offs[k, 2]:offs[k, 2] + plane.size] = plane.ravel()
        path = ntb.walk_plane(plane, n, m, lo)
        end = offs[k, 3] + n + m
        runs[end - len(path):end] = path
        out[k, 2] = len(path)
    return out, runs.view(np.int32), planes


def _launch_inputs(pairs):
    """Flat codes and one launch of the pairs at their first band."""
    n = np.array([len(q) for q, _ in pairs])
    m = np.array([len(r) for _, r in pairs])
    q = np.concatenate([x for x, _ in pairs])
    r = np.concatenate([y for _, y in pairs])
    (launch,) = ntb.nw_plan(n, m, np.abs(n - m) + ntb.FIRST_BAND,
                            np.cumsum(n) - n, np.cumsum(m) - m, 'cpu',
                            budget=1 << 40)
    return q, r, launch


_NW_CASES = nw_cases(np.random.default_rng(44))


@pytest.mark.parametrize('case', ['all'] + list(_NW_CASES))
def test_kernel_schedule_matches_plain_on_nw_cases(case):
    pairs = ([p for ps in _NW_CASES.values() for p in ps] if case == 'all'
             else _NW_CASES[case])
    if case == 'all':   # the longest pair alone makes the emulation slow
        pairs = [p for p in pairs if len(p[0]) < 1000]
    q, r, launch = _launch_inputs(pairs)
    want = [t.numpy() for t in ntb.nw_launch_plain(
        torch.from_numpy(q), torch.from_numpy(r), launch, *SCORES)]
    got = emulate_launch(q, r, launch)
    for a, b, name in zip(got, want, ('out', 'runs', 'planes')):
        assert np.array_equal(a, b), (case, name)
    # the plain route's ladder ends where the JAX host aligner does
    res = ntb.nw_traceback_batch([x for x, _ in pairs], [y for _, y in pairs],
                                 device='cpu')
    for t, (x, y) in enumerate(pairs):
        assert res[t] == banded_global_cigar(x, y), (case, t)


def test_nw_plan_groups_pairs_under_the_budget():
    n = np.array([100, 200, 50, 400, 30])
    m = np.array([110, 190, 50, 300, 31])
    band = np.abs(n - m) + ntb.FIRST_BAND
    W = 2 * band + np.abs(n - m) + 1
    plane = (n + 1) * W
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
    # the check band min(2 band, max(n, m)) sets the rows' width
    assert launches[2].wcap == 2 * min(2 * 116, 400) + 100 + 1
    assert all(x.warps == ntb.MAX_WARPS and not x.rows_global
               for x in launches)
    # a band too wide for one warp's rows in shared memory: global scratch
    big = ntb.ROW_SMEM // (ntb.ROW_INTS * 4)
    (wide,) = ntb.nw_plan([10], [big], [big], [0], [0], 'cpu')
    assert wide.rows_global and wide.warps == ntb.MAX_WARPS
    (forced,) = ntb.nw_plan(n, m, band, np.zeros(5), np.zeros(5), 'cpu',
                            rows='global')
    assert forced.rows_global
    with pytest.raises(ValueError, match='shared memory'):
        ntb.nw_plan([10], [big], [big], [0], [0], 'cpu', rows='shared')


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
