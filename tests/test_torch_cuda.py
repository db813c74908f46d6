"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card: the SW scorer of ``call`` and ``collapse`` (csrc/sw_score_ends.cu,
both routes, the wavefront under every plan it takes), the
harness's row scan and chained wavefront (csrc/sw_rowscan.cu,
csrc/sw_chain.cu), the int16 probes (csrc/int16_probe.cu, one launch a
probe and all six in one) and collapse's native SW and edit-distance
rounds over row views (csrc/sw_score_ends.cu::sw_rows_run,
csrc/edit_distance.cu::edit_rows_run) against the torch path, with their
counters under ``collapse --device cuda``, and collapse's edit distance,
SW with traceback
and POA graph alignment (csrc/edit_distance.cu, csrc/sw_traceback.cu,
csrc/poa_align.cu and its round loop, alone and from threads at once),
with ``collapse --device cuda`` raising when a kernel cannot be built, and
call's chaining DP and extraction and tandem screen (csrc/chain_dp.cu,
also against the native chain core once ``setup.py build_ext --inplace``
has built it, on random rows and tools/chain_cases.py's ``dp_cases``, and
csrc/screen_keep.cu and the mesh's lag-range counts csrc/tandem_counts.cu,
with their route per read, on its ``screen_launches`` and, past 4 096
codes, its ``wide_cases``; the lag profile csrc/lag_profile.cu; both on
csrc/lag_planes.h's word and segment edges and, for reads with codes
outside 0..5, on their value route;
chain_scores_batch),
and the center-star polish's banded NW (csrc/nw_traceback.cu, along the
band ladder on tools/nw_cases.py in every width class: C = 1, 2, 4, 8 with
the rows in registers, the wide classes with the rows in shared and global
memory; with its %globaltimer stamps and in a CUDA graph) and its host vote
under find_ccs_reads.  Marked
``cuda``; each test skips when no GPU is visible.  Imports only torch,
numpy and the port (the card's machine has no JAX), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ciri_long_tpu_torch.misc import int16_probe, kexp
from ciri_long_tpu_torch.ops import edit, poa_batch, sw
from ciri_long_tpu_torch.ops import poa as poa_mod
from ciri_long_tpu_torch.ops import sw_tb_batch as tb
from ciri_long_tpu_torch.ops.rows import (Rows, concat_rows, padded,
                                          repeat_row, row_groups, rows_of)
from ciri_long_tpu_torch.tools.collapse_cases import edit_cases, tb_cases
from ciri_long_tpu_torch.tools.poa_cases import poa_cases, star_graph
from ciri_long_tpu_torch.tools.simulate import mutate
from ciri_long_tpu_torch.tools.sw_cases import WAVE_LR, tile_cases, wave_cases
from ciri_long_tpu_torch.utils.dispatch import LAUNCHES, ROUTES

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the SW kernel has no CPU mode)')
    return torch.device('cuda')


def _codes(rng, B, L):
    x = rng.integers(0, 5, (B, L)).astype(np.int8)
    for b in range(B):
        x[b, int(rng.integers(1, L + 1)):] = 5
    return x


@pytest.mark.parametrize("params", [(1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1)])
@pytest.mark.parametrize("shape", [(7, 1, 1), (9, 33, 65), (5, 100, 31),
                                   (64, 64, 700)])
def test_kernel_matches_plain(dev, params, shape):
    rng = np.random.default_rng(1000 * sum(params) + sum(shape))
    B, Lq, Lr = shape
    q = _codes(rng, B, Lq)
    r = _codes(rng, B, Lr)
    q[0, Lq // 2] = 5
    r[min(1, B - 1)] = 5
    qt = torch.from_numpy(q).to(dev)
    rt = torch.from_numpy(r).to(dev)
    p = sw.SWParams(*params)
    got = sw.sw_score_ends_cuda(qt, rt, p)
    want = sw.sw_score_ends(qt, rt, p)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# the main path's shapes, and B * tiles not a multiple of a block's warps
TILE_SHAPES = [(64, 28, 16384), (128, 54, 16384), (37, 33, 5000)]


def _equal(got, want):
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("params", [(1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1)])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_both_routes_match_plain_on_tile_cases(dev, params, shape):
    """tools/sw_cases.py's rows (plants across tile edges, gapped plants,
    twins, N and PAD at edges, all-PAD rows): the tiled route, the routed
    call (which takes it) and the wavefront, each exact."""
    B, Lq, Lr = shape
    p = sw.SWParams(*params)
    plan = sw._tile_plan(Lq, Lr, p)
    assert plan is not None
    rng = np.random.default_rng(sum(shape) + 7 * sum(params))
    q, r = (torch.from_numpy(x).to(dev)
            for x in tile_cases(rng, B, Lq, Lr, plan[0], p))
    want = sw.sw_score_ends(q, r, p)
    before = dict(ROUTES)
    _equal(sw.sw_score_ends_tiled_cuda(q, r, p), want)
    _equal(sw.sw_score_ends_cuda(q, r, p), want)
    assert ROUTES['tiled'] == before['tiled'] + 2
    _equal(sw.sw_score_ends_wave_cuda(q, r, p), want)
    assert ROUTES['wave'] == before['wave'] + 1
    assert (want[0] > 0).sum() > B // 2


@pytest.mark.parametrize("shape", [(5, 300, 5000), (3, 1000, 17000)])
def test_tiled_route_with_large_shared_rows(dev, shape):
    """Long queries, whose four warps' handoff rows pass 48 KB of shared
    memory (300: 97 KB a block) or leave room for two warps a block
    (1000: 80 KB a warp)."""
    B, Lq, Lr = shape
    p = sw.SWParams(1, 1, 1, 1)
    T, _ = sw._tile_plan(Lq, Lr, p)
    rng = np.random.default_rng(Lq)
    q, r = (torch.from_numpy(x).to(dev)
            for x in tile_cases(rng, B, Lq, Lr, T, p))
    _equal(sw.sw_score_ends_tiled_cuda(q, r, p), sw.sw_score_ends(q, r, p))


def test_tiled_route_refuses_what_the_plan_refuses(dev):
    q = torch.randint(0, 4, (4, 40), dtype=torch.int8, device=dev)
    r = torch.randint(0, 4, (4, 300), dtype=torch.int8, device=dev)
    p = sw.SWParams()
    assert sw._tile_plan(40, 300, p) is None
    with pytest.raises(ValueError, match='no tile plan'):
        sw.sw_score_ends_tiled_cuda(q, r, p)
    before = dict(ROUTES)
    _equal(sw.sw_score_ends_cuda(q, r, p), sw.sw_score_ends(q, r, p))
    assert ROUTES == dict(before, wave=before['wave'] + 1)


@pytest.mark.parametrize("params", [(1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1)])
@pytest.mark.parametrize("Lr", WAVE_LR)
def test_wave_route_matches_plain_on_wave_cases(dev, params, Lr):
    """tools/sw_cases.py's wavefront rows (every real query length at an
    edge of a lane's rows, a strip or a group of strips; N, mid-row PAD,
    all-PAD rows, equal-score twins across warps): the routed call and the
    forced wavefront, each exact, each counted once in ROUTES['wave']."""
    p = sw.SWParams(*params)
    rng = np.random.default_rng(Lr + 11 * sum(params))
    q, r = (torch.from_numpy(x).to(dev) for x in wave_cases(rng, Lr))
    assert sw._tile_plan(q.shape[1], Lr, p) is None
    want = sw.sw_score_ends(q, r, p)
    before = dict(ROUTES)
    _equal(sw.sw_score_ends_cuda(q, r, p), want)
    _equal(sw.sw_score_ends_wave_cuda(q, r, p), want)
    assert ROUTES == dict(before, wave=before['wave'] + 2)
    assert (want[0] > 0).sum() > q.shape[0] // 3


WAVE_PLANS = [sw.WavePlan(R, K, P, edge)
              for R in (1, 2, 4)
              for K, P in ((1, 1), (1, 3), (1, 8), (2, 1), (3, 1), (8, 1))
              for edge in ('smem', 'global')]


@pytest.mark.parametrize("plan", WAVE_PLANS, ids=lambda x: '-'.join(
    map(str, x)))
def test_wave_plans_match_plain(dev, plan):
    """Every R, K, rows a block and handoff row the kernel takes, forced on
    the wavefront rows against 130 columns (rows of up to 17 strips of 64:
    several groups at every K)."""
    p = sw.SWParams(10, 4, 8, 2)
    q, r = (torch.from_numpy(x).to(dev)
            for x in wave_cases(np.random.default_rng(sum(plan[:3])), 130))
    _equal(sw.sw_score_ends_wave_cuda(q, r, p, plan),
           sw.sw_score_ends(q, r, p))


def test_wave_handoff_row_in_global_memory(dev):
    """A reference whose handoff row (8 bytes a column) does not fit a
    block's shared memory, under a query of two groups of strips."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 5, (2, 1100)).astype(np.int8)
    r = rng.integers(0, 5, (2, 30000)).astype(np.int8)
    r[1, 17000:18100] = q[1]
    assert sw._wave_plan(2, 1100, 30000).edge == 'global'
    qt, rt = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
    p = sw.SWParams(10, 4, 8, 2)
    _equal(sw.sw_score_ends_cuda(qt, rt, p), sw.sw_score_ends(qt, rt, p))


def test_wave_fused_round_of_mixed_lengths(dev):
    """collapse's fused rounds: rows of mixed real lengths PAD-suffixed to
    one shape, each swept only to its own lengths."""
    rng = np.random.default_rng(5)
    q = np.full((96, 1500), 5, np.int8)
    r = np.full((96, 1500), 5, np.int8)
    for b in range(96):
        lq, lr = rng.integers(1, 1501, 2)
        q[b, :lq] = rng.integers(0, 5, lq)
        r[b, :lr] = rng.integers(0, 5, lr)
    qt, rt = torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)
    p = sw.SWParams(10, 4, 8, 2)
    _equal(sw.sw_score_ends_cuda(qt, rt, p), sw.sw_score_ends(qt, rt, p))


def test_wave_bench_shape(dev):
    rng = np.random.default_rng(7)
    qt, rt = (torch.from_numpy(rng.integers(0, 4, shape).astype(np.int8)).to(
        dev) for shape in ((512, 1024), (512, 4096)))
    p = sw.SWParams(10, 4, 8, 2)
    assert sw._wave_plan(512, 1024, 4096) == sw.WavePlan(4, 8, 1, 'none')
    _equal(sw.sw_score_ends_cuda(qt, rt, p), sw.sw_score_ends(qt, rt, p))


def test_wave_refuses_plans_it_cannot_launch(dev):
    q = torch.randint(0, 4, (2, 1100), dtype=torch.int8, device=dev)
    r = torch.randint(0, 4, (2, 30000), dtype=torch.int8, device=dev)
    p = sw.SWParams()
    for plan in (sw.WavePlan(3, 2, 1, 'none'), sw.WavePlan(2, 2, 2, 'none'),
                 sw.WavePlan(2, 9, 1, 'none'),
                 sw.WavePlan(4, 2, 1, 'none'),     # 9 strips, no handoff row
                 sw.WavePlan(4, 8, 1, 'smem')):    # 240 KB of handoff row
        with pytest.raises(RuntimeError, match='launch failed'):
            sw.sw_score_ends_wave_cuda(q, r, p, plan)


def test_auto_launches_kernel_for_cuda_tensors(dev):
    q = torch.randint(0, 4, (3, 20), dtype=torch.int8, device=dev)
    before = LAUNCHES['sw_score_ends']
    res = sw.sw_align_batch(q.cpu().numpy(), q.cpu().numpy(), sw.SWParams(),
                            dev)
    assert LAUNCHES['sw_score_ends'] == before + 2   # ends + begins
    assert (res.score == 20).all() and (res.query_begin == 0).all()


def test_kernel_rejects_bad_inputs(dev):
    q = torch.zeros((2, 8), dtype=torch.int8, device=dev)
    p = sw.SWParams()
    with pytest.raises(TypeError):
        sw.sw_score_ends_cuda(q.int(), q, p)
    with pytest.raises(ValueError):
        sw.sw_score_ends_cuda(q.t(), q.t(), p)
    with pytest.raises(ValueError):
        sw.sw_score_ends_cuda(q, q.cpu(), p)
    with pytest.raises(ValueError):
        sw.sw_score_ends_cuda(q, q[:1], p)


SHAPES = [(7, 1, 1), (9, 33, 65), (5, 100, 31), (64, 64, 700), (4, 40, 3000),
          (2, 70, 16384)]


def _case(dev, params, shape, B_mult=1):
    rng = np.random.default_rng(1000 * sum(params) + sum(shape) + B_mult)
    B, Lq, Lr = shape
    B = -(-B // B_mult) * B_mult
    q = _codes(rng, B, Lq)
    r = _codes(rng, B, Lr)
    q[0, Lq // 2] = 5
    r[min(1, B - 1)] = 5
    return torch.from_numpy(q).to(dev), torch.from_numpy(r).to(dev)


@pytest.mark.parametrize("params", [(1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1)])
@pytest.mark.parametrize("shape", SHAPES)
def test_rowscan_matches_plain(dev, params, shape):
    qt, rt = _case(dev, params, shape)
    p = sw.SWParams(*params)
    before = LAUNCHES['sw_rowscan']
    got = kexp.sw_rowscan(qt, rt, p)
    want = sw.sw_score_ends(qt, rt, p)
    torch.cuda.synchronize()
    assert LAUNCHES['sw_rowscan'] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("params", [(1, 1, 1, 1), (10, 4, 8, 2)])
@pytest.mark.parametrize("shape", SHAPES)
def test_chain_matches_plain(dev, C, params, shape):
    qt, rt = _case(dev, params, shape, B_mult=C)
    p = sw.SWParams(*params)
    before = LAUNCHES['sw_chain']
    got = kexp.sw_chain(qt, rt, p, C)
    want = sw.sw_score_ends(qt, rt, p)
    torch.cuda.synchronize()
    assert LAUNCHES['sw_chain'] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_harness_kernels_reject_bad_inputs(dev):
    q = torch.zeros((6, 8), dtype=torch.int8, device=dev)
    p = sw.SWParams()
    with pytest.raises(ValueError, match='divisible'):
        kexp.sw_chain_cuda(q, q, p, 4)
    with pytest.raises(ValueError, match='reference columns'):
        kexp.sw_rowscan_cuda(q, torch.zeros(
            (6, kexp.ROWSCAN_MAX_LR + 1), dtype=torch.int8, device=dev), p)
    with pytest.raises(ValueError, match="kernel's limits"):
        kexp.sw_chain_cuda(torch.zeros((2, 70000), dtype=torch.int8,
                                       device=dev),
                           torch.zeros((2, 70000), dtype=torch.int8,
                                       device=dev), p, 2)
    with pytest.raises(TypeError):
        kexp.sw_rowscan_cuda(q.int(), q, p)
    with pytest.raises(TypeError):
        kexp.sw_chain_cuda(q.int(), q, p, 2)


# (B, Lq, Lr, C, plan): every R, K of 1 to 8, several streams a block,
# keys and handoff rows in global memory, Lq far above Lr
CHAIN_PLANS = [
    (8, 100, 90, 2, kexp.ChainPlan(1, 4, 1, 'smem', 'none')),
    (8, 300, 90, 4, kexp.ChainPlan(2, 3, 1, 'smem', 'smem')),
    (8, 300, 90, 4, kexp.ChainPlan(4, 1, 5, 'global', 'global')),
    (12, 700, 33, 3, kexp.ChainPlan(4, 2, 1, 'global', 'smem')),
    (16, 40, 7, 16, kexp.ChainPlan(1, 1, 8, 'smem', 'global')),
    (6, 1, 1, 1, kexp.ChainPlan(1, 1, 8, 'smem', 'none')),
]


@pytest.mark.parametrize("case", CHAIN_PLANS)
def test_chain_plans_match_plain(dev, case):
    B, Lq, Lr, C, plan = case
    for params in [(1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1)]:
        qt, rt = _case(dev, params, (B, Lq, Lr))
        p = sw.SWParams(*params)
        _equal(kexp.sw_chain_cuda(qt, rt, p, C, plan),
               sw.sw_score_ends(qt, rt, p))


@pytest.mark.parametrize("width", kexp.ROWSCAN_WIDTHS)
@pytest.mark.parametrize("shape", [(9, 33, 65), (6, 100, 700),
                                   (3, 70, 4100), (2, 40, 16384)])
def test_rowscan_widths_match_plain(dev, width, shape):
    plan = kexp.rowscan_plan(shape[0], shape[2], width)
    for params in [(1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1)]:
        qt, rt = _case(dev, params, shape)
        p = sw.SWParams(*params)
        _equal(kexp.sw_rowscan_cuda(qt, rt, p, plan),
               sw.sw_score_ends(qt, rt, p))


@pytest.mark.parametrize("probe", int16_probe.PROBES, ids=lambda p: p.name)
def test_int16_probe_matches_plain(dev, probe):
    """On the TPU probe's input, on negative lanes and on lanes that wrap."""
    for label, x in int16_probe.probe_cases(probe, dev):
        before = LAUNCHES['int16_probe']
        got = int16_probe.int16_probe(probe, x)
        want = probe.plain(x)
        torch.cuda.synchronize()
        assert LAUNCHES['int16_probe'] == before + 1
        assert got.dtype == want.dtype and torch.equal(got, want), label


@pytest.mark.parametrize("case", [0, 1, 2])
def test_int16_probes_in_one_launch_match_plain(dev, case):
    xs = [int16_probe.probe_cases(p, dev)[case][1]
          for p in int16_probe.PROBES]
    before = LAUNCHES['int16_probe_all']
    got = int16_probe.int16_probe_all(xs)
    torch.cuda.synchronize()
    assert LAUNCHES['int16_probe_all'] == before + 1
    for probe, x, g in zip(int16_probe.PROBES, xs, got):
        want = probe.plain(x)
        assert g.dtype == want.dtype and torch.equal(g, want), probe.name


def test_time_launches_in_a_graph_leaves_the_host_out(dev):
    probe = int16_probe.PROBES[0]
    x = int16_probe.probe_input(probe, dev)
    calls = []

    def step():
        calls.append(1)
        int16_probe.int16_probe_cuda(probe, x)

    ms = kexp.time_launches(step, 20, dev, graph=True)
    assert len(calls) == 21                  # one warm-up, 20 captured
    assert 0 < ms < kexp.time_launches(step, 20, dev)


def test_peak_cell_rate_bounds_the_sw_kernels(dev):
    rate = kexp.peak_cell_rate(dev)
    B, Lq, Lr = 64, 64, 4096
    qt, rt = _case(dev, (10, 4, 8, 2), (B, Lq, Lr))
    for fn in (sw.sw_score_ends_cuda, kexp.sw_rowscan_cuda):
        _, ms = kexp.gcups(fn, qt, rt, kexp.PARAMS, 3, graph=True)
        assert kexp.sw_bound(B, Lq, Lr, rate)[0] < ms


def test_harness_and_probe_entry_points(dev, capsys):
    line = kexp.main(['--chain', '2', '--B', '8', '--Lq', '70', '--Lr', '90',
                      '--iters', '2'])
    assert line['variant'] == {'family': 'chain', 'chain': 2}
    assert line['bound_by'] == 'operations' and line['ms'] > 0
    int16_probe.main([])
    assert capsys.readouterr().out.count(': OK ') == 6


EDIT_CASES = [c[0] for c in edit_cases(np.random.default_rng(0))]
TB_CASES = ['{} {}'.format(c[0], c[3]) for c in tb_cases(
    np.random.default_rng(0))]


@pytest.mark.parametrize("label", EDIT_CASES)
def test_edit_distance_matches_plain(dev, label):
    """Every case in one launch, each pair on its route (the boundary
    lengths and the fused round run both routes in that launch)."""
    case = dict((c[0], c[1:]) for c in edit_cases(np.random.default_rng(0)))
    args = [torch.from_numpy(x).to(dev) for x in case[label]]
    a, b, alen, blen = case[label]
    _, n_thread = edit.edit_rows_plan(
        edit._padded_rows(a, np.clip(alen, 0, a.shape[1])),
        edit._padded_rows(b, np.clip(blen, 0, b.shape[1])))
    n_warp = len(alen) - n_thread
    before, routes = LAUNCHES['edit_distance'], dict(ROUTES)
    got = edit.edit_distance_auto(*args)
    want = edit.edit_distance_batch_plain(*args)
    torch.cuda.synchronize()
    assert LAUNCHES['edit_distance'] == before + 1
    assert ROUTES['edit_thread'] == routes['edit_thread'] + (n_thread > 0)
    assert ROUTES['edit_warp'] == routes['edit_warp'] + (n_warp > 0)
    if label in ('boundary lengths',
                 'fused round of one-word and multi-word pairs'):
        assert n_thread > 0 and n_warp > 0
    assert torch.equal(got, want)
    host = edit.edit_distance_batch(*(a.cpu().numpy() for a in args),
                                    device='cpu')
    assert np.array_equal(got.cpu().numpy(), host)
    assert np.array_equal(edit.edit_distance_batch(
        *(a.cpu().numpy() for a in args), device=dev), host)


@pytest.mark.parametrize("label", TB_CASES)
def test_sw_traceback_matches_plain(dev, label):
    from ciri_long_tpu_torch.ops.traceback import sw_traceback
    case = dict(('{} {}'.format(c[0], c[3]), c[1:])
                for c in tb_cases(np.random.default_rng(0)))
    qs, rs, scores = case[label]
    packed = tb.pack_jobs(qs, rs)
    args = [torch.from_numpy(x).to(dev) for x in packed]
    plan = tb.tb_plan(packed[2], packed[3], packed[0].shape[1],
                      packed[1].shape[1], dev)
    before, routes = LAUNCHES['sw_traceback'], dict(ROUTES)
    got = tb.sw_traceback_auto(*args, *scores)
    want = tb.sw_traceback_batch_plain(*args, *scores)
    torch.cuda.synchronize()
    assert LAUNCHES['sw_traceback'] == before + len(plan)
    for route in ('tb_smem', 'tb_global'):
        assert ROUTES[route] == routes[route] + sum(
            p.route == route for p in plan)
    if label.startswith('over the shared-memory budget'):
        assert [p.route for p in plan] == ['tb_smem', 'tb_global']
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert tb.tb_results(*got) == tb.tb_results(*want)
    assert tb.sw_traceback_batch(qs, rs, *scores, device=dev) == \
        [sw_traceback(q, r, *scores) for q, r in zip(qs, rs)]


def test_sw_traceback_batch_chunks_under_its_budget(dev, monkeypatch):
    """Jobs on the global route (each over a block's shared memory) split
    into chunks of global scratch under MEM_BUDGET, one launch each."""
    rng = np.random.default_rng(1)
    qs = [rng.integers(0, 4, int(n)).astype(np.int8)
          for n in rng.integers(3600, 6000, 30)]
    rs = [q[40:90].copy() for q in qs]
    assert all(tb.global_bytes(len(q), len(r)) for q, r in zip(qs, rs))
    want = tb.sw_traceback_batch(qs, rs, 10, 4, 8, 2, device=dev)
    monkeypatch.setattr(tb, 'MEM_BUDGET', 600_000)
    chunks = len(list(tb._chunks(qs, rs)))
    assert chunks > 5
    before, routes = LAUNCHES['sw_traceback'], dict(ROUTES)
    assert tb.sw_traceback_batch(qs, rs, 10, 4, 8, 2, device=dev) == want
    assert LAUNCHES['sw_traceback'] == before + chunks
    assert ROUTES['tb_global'] == routes['tb_global'] + chunks


def test_collapse_kernels_time_in_a_graph_with_their_plans(dev):
    """chip_smoke.py times recorded traceback launches as CUDA graph
    replays: with its plan given, the wrapper reads nothing back from the
    card.  (The edit distance's one host driver is a native round that
    syncs; chip_smoke.py times its rounds by wall.)"""
    _, qs, rs, scores = tb_cases(np.random.default_rng(0))[-1]
    packed = tb.pack_jobs(qs, rs)
    targs = [torch.from_numpy(x).to(dev) for x in packed]
    tplan = tb.tb_plan(packed[2], packed[3], packed[0].shape[1],
                       packed[1].shape[1], dev)
    assert kexp.time_launches(
        lambda: tb.sw_traceback_cuda(*targs, *scores, plan=tplan), 3, dev,
        graph=True) > 0


def test_collapse_kernels_reject_bad_inputs(dev):
    a = torch.zeros((3, 8), dtype=torch.int8, device=dev)
    n = torch.full((3,), 8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        edit.edit_distance_cuda(a.int(), a, n, n)
    with pytest.raises(TypeError):
        edit.edit_distance_cuda(a, a, n.long(), n)
    with pytest.raises(ValueError):
        edit.edit_distance_cuda(a, a.cpu(), n, n)
    with pytest.raises(ValueError):
        edit.edit_distance_cuda(a.t(), a.t(), n[:1].expand(8), n[:1].expand(8))
    with pytest.raises(ValueError):
        edit.edit_distance_cuda(a, a[:2], n, n)
    with pytest.raises(ValueError, match='codes must be 0..7'):
        edit.edit_distance_cuda(a, a + 8, n, n)
    with pytest.raises(TypeError):
        tb.sw_traceback_cuda(a.int(), a, n, n)
    with pytest.raises(ValueError):
        tb.sw_traceback_cuda(a, a, n[:2], n)
    with pytest.raises(ValueError):
        tb.sw_traceback_cuda(a, a, n, n, 1, 1, 1, 2)
    with pytest.raises(ValueError):
        tb.sw_traceback_cuda(a, a.t().contiguous().t(), n, n)


def test_collapse_raises_when_a_kernel_cannot_be_built(dev, tmp_path,
                                                       monkeypatch):
    """No host fallback on the cuda route: with the loader failing,
    ``collapse --device cuda`` raises (the skill world's collapse reaches
    every kernel)."""
    from ciri_long_tpu_torch.cli.main import main
    from ciri_long_tpu_torch.ops import _build
    from ciri_long_tpu_torch.tools.world import sample_list, skill_world

    ref, reads = skill_world(str(tmp_path / 'w'))
    main(['call', '-i', reads, '-o', str(tmp_path / 'call'), '-r', ref, '-p',
          'v', '-t', '1', '--device', 'cpu'])
    lst = sample_list(str(tmp_path / 's.lst'),
                      [('v', str(tmp_path / 'call' / 'v.cand_circ.fa'))])
    main(['collapse', '-i', lst, '-o', str(tmp_path / 'ok'), '-r', ref, '-p',
          'v', '--device', 'cuda'])
    assert (tmp_path / 'ok' / 'v.info').read_text().count('\n') == 1

    def unbuilt(source, symbols):
        raise RuntimeError('nvcc failed (1) building ' + source)

    monkeypatch.setattr(_build, 'load', unbuilt)
    with pytest.raises(RuntimeError, match='nvcc failed'):
        main(['collapse', '-i', lst, '-o', str(tmp_path / 'bad'), '-r', ref,
              '-p', 'v', '--device', 'cuda'])


# -- collapse's native SW and edit rounds over row views ---------------------

ROUND_CASES = ('junction', 'reads', 'pairs', 'mixed', '40k rows')


def _round_jobs(name):
    """A fused round's SW jobs (q, r, params) and edit jobs (a, b) of
    ops/rows.py::Rows at collapse's shapes: ``junction`` curate_junction's
    (a 50-code junction against 2 500 20-code genome pieces; its edit job
    on the same pieces and slices of the junction), ``reads`` the head-
    anchor and template SWs (150 reads of 300-6 000 codes against one 50-
    code row and one template), ``pairs`` cluster_sequence's edit job (the
    1 225 pairs of 50 sequences of 100-900 codes), ``mixed`` all of them
    in one round, ``40k rows`` sixteen junction jobs."""
    rng = np.random.default_rng(ROUND_CASES.index(name) + 11)

    def codes(n):
        return rng.integers(0, 5, int(n)).astype(np.int8)

    def junction():
        junc = codes(rng.integers(40, 60))
        refs = rows_of([codes(20) for _ in range(2500)])
        qb = rng.integers(0, 20, 2500).astype(np.int32)
        xs = Rows(junc, qb, rng.integers(0, len(junc) - qb).astype(np.int32))
        return [(repeat_row(junc, 2500), refs, (10, 4, 8, 2))], [(refs, xs)]

    def reads():
        rs = rows_of([codes(n) for n in rng.integers(300, 6000, 150)])
        return [(rs, repeat_row(codes(50), 150), (10, 4, 8, 2)),
                (rs, repeat_row(codes(1200), 150), (10, 4, 8, 2))], []

    def pairs():
        seqs = rows_of([codes(n) for n in rng.integers(100, 900, 50)])
        i, j = np.triu_indices(50, 1)
        return [], [(Rows(seqs.codes, seqs.off[i], seqs.lens[i]),
                     Rows(seqs.codes, seqs.off[j], seqs.lens[j]))]

    if name == 'mixed':
        parts = [junction(), reads(), pairs(), junction()]
    elif name == '40k rows':
        parts = [junction() for _ in range(16)]
    else:
        parts = [{'junction': junction, 'reads': reads,
                  'pairs': pairs}[name]()]
    return ([job for p in parts for job in p[0]],
            [job for p in parts for job in p[1]])


@pytest.mark.parametrize('name', ROUND_CASES)
def test_native_rounds_match_the_torch_path(dev, name):
    """One native SW round and one native edit round over a fused round's
    jobs give each job's answers of the torch path on its rows padded
    (sw_align_batch: the scorer, _reverse_prefix's gather, the scorer) and
    the plain edit distance's on the card and the host core's, and count
    their launches."""
    sw_jobs, edit_jobs = _round_jobs(name)
    if sw_jobs:
        params = [sw.SWParams(*p) for p in dict.fromkeys(
            p for _, _, p in sw_jobs)]
        n = [len(q.lens) for q, _, _ in sw_jobs]
        pid = np.repeat([params.index(sw.SWParams(*p))
                         for _, _, p in sw_jobs], n)
        q = concat_rows([j[0] for j in sw_jobs])
        r = concat_rows([j[1] for j in sw_jobs])
        before, rows_before = LAUNCHES['sw_score_ends'], LAUNCHES['fused_rows']
        phases = {}
        got = sw.sw_align_rows(q, r, pid, params, dev, phases)
        groups = row_groups(q.lens, r.lens, pid)[1]
        assert LAUNCHES['sw_score_ends'] == before + 2 * len(groups)
        assert LAUNCHES['fused_rows'] == rows_before + 3
        assert set(phases) == set(sw.ROW_PHASES)
        at = 0
        for (jq, jr, p), k in zip(sw_jobs, n):
            want = sw.sw_align_batch(padded(jq)[0], padded(jr)[0],
                                     sw.SWParams(*p), dev)
            assert np.array_equal(got[:, at:at + k], np.stack(want)), name
            at += k
    if edit_jobs:
        a = concat_rows([j[0] for j in edit_jobs])
        b = concat_rows([j[1] for j in edit_jobs])
        before, routes = LAUNCHES['edit_distance'], dict(ROUTES)
        got = edit.edit_distance_rows(a, b, dev)
        order, n_thread = edit.edit_rows_plan(a, b)
        assert LAUNCHES['edit_distance'] == before + 1
        assert ROUTES['edit_thread'] == routes['edit_thread'] + (n_thread > 0)
        assert ROUTES['edit_warp'] == routes['edit_warp'] + (
            len(order) > n_thread)
        assert np.array_equal(got, edit.edit_distance_rows_plain(a, b, dev)), \
            name
        assert np.array_equal(got, edit.edit_distance_batch(
            padded(a)[0], padded(b)[0], a.lens, b.lens, device='cpu')), name


def test_native_edit_round_refuses_codes_outside_0_to_7(dev):
    a = rows_of([np.array([0, 1, 2, 8], np.int8), np.array([3], np.int8)])
    b = rows_of([np.array([1, 2], np.int8), np.array([0, 9], np.int8)])
    with pytest.raises(ValueError, match='codes must be 0..7'):
        edit.edit_distance_rows(a, b, dev)
    # a code outside every row is not read
    ok = Rows(a.codes, a.off, np.array([3, 1], np.int32))
    got = edit.edit_distance_rows(ok, Rows(b.codes, b.off,
                                           np.array([2, 1], np.int32)), dev)
    assert got.tolist() == [1, 1]


def test_native_round_counters_match_the_fuser(dev, tmp_path, monkeypatch):
    """``collapse --device cuda`` of a four-locus cohort: every fused
    round took the native call (fuser.native.* sum to the fuser's rounds),
    fuser.rows.* count every row submitted, and the native phases lie
    inside the rounds' fuser.run.* spans."""
    import json
    import threading

    from ciri_long_tpu_torch.cli.main import main
    from ciri_long_tpu_torch.pipeline import collapse as tcl
    from ciri_long_tpu_torch.tools.world import make_world, sample_list

    ref, reads, _ = make_world(str(tmp_path / 'w'), genome_kb=300, loci=4,
                               depth=12, linear=20, seed=3)
    main(['call', '-i', reads, '-o', str(tmp_path / 'call'), '-r', ref,
          '-p', 'co', '-t', '1', '--device', 'cuda'])
    lst = sample_list(str(tmp_path / 's.lst'),
                      [('co', str(tmp_path / 'call' / 'co.cand_circ.fa'))])
    rows = {'sw': 0, 'edit': 0}
    lock = threading.Lock()
    real_sw, real_edit = tcl._sw_rows, tcl._edit_rows

    def sw_rows(q, r, params=tcl.JUNC_SW, device='cuda'):
        with lock:
            rows['sw'] += len(q.lens)
        return real_sw(q, r, params, device)

    def edit_rows(a, b, device='cuda'):
        with lock:
            rows['edit'] += len(a.lens)
        return real_edit(a, b, device)

    monkeypatch.setattr(tcl, '_sw_rows', sw_rows)
    monkeypatch.setattr(tcl, '_edit_rows', edit_rows)
    out = tmp_path / 'col'
    main(['collapse', '-i', lst, '-o', str(out), '-r', ref, '-p', 'co',
          '--device', 'cuda'])
    summary = json.loads((out / 'co.json').read_text())
    c, spans = summary['counters'], summary['spans']
    fired = sum(v for k, v in c.items() if k.startswith('fuser.fire.'))
    assert fired > 0
    assert c['fuser.native.sw'] + c['fuser.native.edit'] == fired
    assert c['fuser.rows.sw'] == rows['sw'] > 0
    assert c['fuser.rows.edit'] == rows['edit'] > 0
    assert summary['kernels']['fused_rows'] == \
        3 * c['fuser.native.sw'] + c['fuser.native.edit']
    run_ns = {k: 1e9 * spans['fuser.run.' + k]['thread_seconds']
              for k in ('sw', 'edit')}
    for phase in sw.ROW_PHASES:
        assert 0 <= c['fuser.ns.' + phase] <= sum(run_ns.values()), phase
    assert sum(c['fuser.ns.' + p] for p in sw.ROW_PHASES) <= \
        sum(run_ns.values())


# -- collapse's POA graph alignment (csrc/poa_align.cu) ---------------------

def test_poa_align_matches_plain(dev):
    """tools/poa_cases.py's cases, each launch exact against the plain
    version on the card: scores, pair counts and every pair."""
    for label, arrays in poa_cases(np.random.default_rng(7), wide=True):
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        before = LAUNCHES['poa_align']
        got = poa_batch.poa_align_batch(*args)
        want = poa_batch.poa_align_batch_plain(*args)
        torch.cuda.synchronize()
        assert LAUNCHES['poa_align'] == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), label


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_poa_align_forced_ring_depths(dev, depth):
    """Every case under a forced ring depth (poa_plan(depth=)): 0 leaves
    every predecessor but the source to the spill copy, 1-3 spill the rows
    reached from farther; at the launch shape and at blocks of one and
    four warps of one column a lane (shape=); exact against the plain
    version.  The long back edges and the in-degree 130 star take the
    spill at depth 2."""
    for label, arrays in poa_cases(np.random.default_rng(7), wide=True):
        bases, offs, preds, seqs, nv, ns = arrays
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        want = poa_batch.poa_align_batch_plain(*args)
        for shape in (None, (1, 32), (1, 128)):
            plan = poa_batch.poa_plan(offs, preds, nv, ns, bases.shape[1],
                                      seqs.shape[1], dev, depth=depth,
                                      shape=shape)
            if depth == 2 and label in ('long back edges',
                                        'in-degree 12 and 130'):
                assert plan.spill_rows > 0, label
            got = poa_batch.poa_align_batch_cuda(*args, plan=plan)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), (label, depth, shape)


def test_poa_align_takes_any_in_degree(dev):
    """A node of 2^14 predecessors aligns exactly: any in-degree is
    taken."""
    from ciri_long_tpu_torch.tools.poa_cases import batch

    rng = np.random.default_rng(15)
    g = star_graph(rng, 1 << 14, 3)
    arrays = batch([g], [np.array([0, 1, 2, 3], np.int8)])
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    got = poa_batch.poa_align_batch_cuda(*args)
    want = poa_batch.poa_align_batch_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_poa_align_stamps_split_rows_and_walk(dev):
    """stamps= gets each block's start, end of rows and end of walk, in
    order, and leaves the output as it is."""
    arrays = poa_cases(np.random.default_rng(16))[0][1]
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    stamps = torch.zeros((len(arrays[4]), 3), dtype=torch.int64,
                         device=dev)
    got = poa_batch.poa_align_batch_cuda(*args, stamps=stamps)
    want = poa_batch.poa_align_batch_cuda(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    t = stamps.cpu().numpy()
    assert (t[:, 0] > 0).all() and (np.diff(t, axis=1) >= 0).all()


def _poa_jobs(rng, n_jobs, lo=20, hi=400):
    jobs = []
    for _ in range(n_jobs):
        t = ''.join(rng.choice(list('ACGTN'), size=int(rng.integers(lo, hi))))
        sub = float(rng.uniform(0.0, 0.12))
        jobs.append([mutate(rng, t, sub=sub, ins=sub / 2, dele=sub / 2)
                     for _ in range(int(rng.integers(2, 12)))])
    return jobs + [[''], [], ['ACGT'], ['', 'GGGT', 'GGAT'],
                   [np.array([0, 1, 2, 3, 0, 1], np.int8)] * 3]


def _norm(xs):
    return [x if isinstance(x, str) else (x.dtype.str, x.tolist())
            for x in xs]


def test_poa_round_loop_matches_host(dev):
    """ops/poa.py::poa_consensus_many on the card equals poa() per job and
    the plain rounds, byte for byte; it counts one launch a round and their
    device time."""
    from ciri_long_tpu_torch.utils.dispatch import DEVICE_MS

    jobs = _poa_jobs(np.random.default_rng(11), 10)
    before, ms = LAUNCHES['poa_align'], DEVICE_MS['poa_align']
    stats = {}
    got = poa_mod.poa_consensus_many(jobs, device='cuda', stats=stats)
    rounds = max(len([s for s in job if len(s)]) for job in jobs) - 1
    assert LAUNCHES['poa_align'] == before + rounds
    assert stats['launches'] == rounds
    assert DEVICE_MS['poa_align'] - ms == pytest.approx(stats['device_ms'])
    assert 0 < stats['largest_ms'] <= stats['device_ms']
    assert _norm(got) == _norm([poa_mod.poa(j)[0] for j in jobs])
    assert _norm(got) == _norm(poa_mod.poa_consensus_many_plain(jobs))


def test_poa_launch_inputs_replays_the_largest_round(dev):
    """poa_launch_inputs keeps the largest launch of an earlier call: its
    batch has the stats' shape and cells, the round loop's plan (C++
    plan_launch) has poa_plan's depth and spill rows, and the kernel on it
    equals the plain version."""
    jobs = _poa_jobs(np.random.default_rng(14), 6, 100, 600)
    stats = {}
    want = poa_mod.poa_consensus_many(jobs, device='cuda', stats=stats)
    got, arrays = poa_mod.poa_launch_inputs(jobs, stats, device='cuda')
    assert _norm(got) == _norm(want)
    bases, offs, preds, seqs, nv, ns = arrays
    assert bases.shape == (stats['largest_jobs'], stats['largest_vmax'])
    assert seqs.shape[1] == stats['largest_nmax']
    assert len(preds) == stats['largest_preds']
    assert int(((nv + 1) * (ns + 1)).sum()) == stats['largest_cells']
    plan = poa_batch.poa_plan(offs, preds, nv, ns, bases.shape[1],
                              seqs.shape[1], dev)
    assert (plan.depth, plan.spill_rows) == (stats['largest_depth'],
                                             stats['largest_spill_rows'])
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    for a, b in zip(poa_batch.poa_align_batch_cuda(*args),
                    poa_batch.poa_align_batch_plain(*args)):
        assert torch.equal(a, b)


def test_poa_round_loop_spills_long_rows(dev):
    """Sequences of 9 000 codes: 8 columns a lane, a ring of two rows of
    108 KB, so the round loop's plan spills the rows reached from farther;
    every consensus equals poa()."""
    rng = np.random.default_rng(17)
    t = ''.join(rng.choice(list('ACGT'), size=9000))
    jobs = [[mutate(rng, t, sub=0.03, ins=0.03, dele=0.03)
             for _ in range(4)]]
    stats = {}
    got = poa_mod.poa_consensus_many(jobs, device='cuda', stats=stats)
    assert stats['largest_depth'] <= 2 and stats['largest_spill_rows'] > 0
    assert _norm(got) == _norm([poa_mod.poa(j)[0] for j in jobs])


def test_poa_round_loop_from_threads(dev):
    """Sixteen threads drive the round loop at once (collapse's cluster
    threads, each on its own stream): every result equals poa()."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(12)
    batches = [_poa_jobs(rng, 3, 100, 900) for _ in range(16)]
    with ThreadPoolExecutor(16) as pool:
        got = list(pool.map(
            lambda jobs: poa_mod.poa_consensus_many(jobs, device='cuda'),
            batches))
    for jobs, out in zip(batches, got):
        assert _norm(out) == _norm([poa_mod.poa(j)[0] for j in jobs])


def test_profile_puts_each_poa_kernel_in_its_rounds_device_wait(dev,
                                                                 tmp_path):
    """``--profile``'s trace (cli/main.py::_device_trace, every thread):
    each ``poa_align`` kernel's launch call lies inside one
    ``poa.device_wait`` event of its thread (the launch found by the
    kernel's correlation id), and the kernel inside that event once the
    trace's device clock is brought onto its host clock
    (``_device_clock_shift``), each within 50 us; the round loop's phase
    counters stay under its calls' wall time."""
    import json
    import logging
    import time
    from concurrent.futures import ThreadPoolExecutor

    from ciri_long_tpu_torch.cli.main import _device_trace
    from ciri_long_tpu_torch.utils import dispatch

    rng = np.random.default_rng(21)
    batches = [_poa_jobs(rng, 3, 100, 900) for _ in range(4)]
    poa_mod.poa_consensus_many(batches[0], device='cuda')   # build, warm
    dispatch.reset_launches()
    walls = []

    def run(jobs):
        # as on collapse's cluster threads: a span on the thread lets the
        # trace name its CUDA runtime calls by the thread's id
        with dispatch.state('poa.rounds'):
            t0 = time.perf_counter_ns()
            poa_mod.poa_consensus_many(jobs, device='cuda')
            walls.append(time.perf_counter_ns() - t0)

    with _device_trace(str(tmp_path), 'p', dev, logging.getLogger('test')):
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(run, batches))
        torch.cuda.synchronize()
    counted = dispatch.counters()
    phases = sum(counted['poa.ns.' + p] for p in poa_mod.PHASES)
    assert 0 < phases <= sum(walls)
    events = json.loads((tmp_path / 'p.trace.json').read_text())[
        'traceEvents']
    waits = {}
    for e in events:
        if e.get('name') == 'poa.device_wait':
            waits.setdefault(e['tid'], []).append((e['ts'],
                                                   e['ts'] + e['dur']))
    launches = {e['args']['correlation']: e for e in events
                if e.get('cat') == 'cuda_runtime'
                and 'correlation' in e.get('args', {})}
    kernels = [e for e in events if e.get('cat') == 'kernel'
               and 'poa_align_kernel' in e.get('name', '')]
    assert len(kernels) == dispatch.LAUNCHES['poa_align'] > 0
    assert sum(map(len, waits.values())) == len(kernels)
    pairs = sorted(((launches[k['args']['correlation']], k)
                    for k in kernels), key=lambda p: p[0]['ts'])
    shift = _device_clock_shift([la['ts'] for la, _ in pairs],
                                [k['ts'] - la['ts'] for la, k in pairs])
    for (launch, k), off in zip(pairs, shift):
        rounds = [w for w in waits[launch['tid']]
                  if w[0] - 50 <= launch['ts'] <= w[1] + 50]
        assert len(rounds) == 1
        lo, hi = rounds[0]
        start = k['ts'] - off
        assert lo - 50 <= start and start + k['dur'] <= hi + 50


def _device_clock_shift(launch_us, lag_us, window_us=1e4):
    """How far a torch.profiler trace shows each kernel after its true
    start on the host's clock.  The trace maps the card's clock onto the
    host's with a drift (up to ~400 ppm, and jumps of ~1 ms at its clock
    syncs, seen on the H100), so a kernel can show before its own launch
    call.  No kernel starts before its launch, and one of the kernels
    launched near another waited next to nothing: the shift is the least
    start-after-launch among the kernels launched within ``window_us``
    before it, or after it, whichever is larger (the side of a sync
    that it is on).  ``launch_us`` sorted."""
    t = np.asarray(launch_us, np.float64)
    lag = np.asarray(lag_us, np.float64)
    lo = np.searchsorted(t, t - window_us, 'left')
    hi = np.searchsorted(t, t + window_us, 'right')
    return [max(lag[a:i + 1].min(), lag[i:b].min())
            for i, (a, b) in enumerate(zip(lo, hi))]


def test_poa_rejects_bad_inputs(dev):
    """More nodes than the direction word's row field holds (a batch of
    expanded tensors, never copied); a predecessor after its node; a ring
    deeper than shared memory; wrong types and shapes."""
    from ciri_long_tpu_torch.tools.poa_cases import batch

    rng = np.random.default_rng(13)
    g = star_graph(rng, 40, 3)
    arrays = batch([g], [np.array([0, 1, 2], np.int8)])
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    V = poa_batch.MAX_ROW + 1
    huge = (torch.zeros((1, 1), dtype=torch.uint8, device=dev).expand(1, V),
            torch.zeros((1, 1), dtype=torch.int32, device=dev).expand(
                1, V + 1), *args[2:])
    with pytest.raises(ValueError, match='row field'):
        poa_batch.poa_align_batch_cuda(*huge)
    late = args[2].clone()
    late[0] = 7
    with pytest.raises(ValueError, match='before its node'):
        poa_batch.poa_align_batch_cuda(args[0], args[1], late, *args[3:])
    with pytest.raises(ValueError, match='does not fit'):
        poa_batch.poa_plan(*(arrays[k] for k in (1, 2, 4, 5)),
                           arrays[0].shape[1], arrays[3].shape[1], dev,
                           depth=100000)
    with pytest.raises(ValueError, match='no block'):
        poa_batch.poa_plan(*(arrays[k] for k in (1, 2, 4, 5)),
                           arrays[0].shape[1], arrays[3].shape[1], dev,
                           shape=(8, 512))
    with pytest.raises(TypeError):
        poa_batch.poa_align_batch_cuda(args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError):
        poa_batch.poa_align_batch_cuda(args[0], args[1][:, :-1], *args[2:])


# call's chaining (csrc/chain_dp.cu, X2) and tandem screen
# (csrc/screen_keep.cu, X3)

GAPS = (200_000, 5_000)


def _chain_rows(seed):
    from ciri_long_tpu_torch.tools import chain_cases
    rng = np.random.default_rng(seed)
    return (chain_cases.random_rows(rng, 40, 600)
            + chain_cases.edge_rows(rng) + [chain_cases.long_row(rng)])


def _chain_on_card(dev, rows, k=15):
    from ciri_long_tpu_torch.ops import chain
    from ciri_long_tpu_torch.tools import chain_cases
    offs, r, q, c = chain_cases.csr(chain_cases.local(rows))
    cols = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in (r, q, c)]
    offs_d = torch.from_numpy(offs).to(dev)
    return offs, offs_d, cols, chain.chain_dp_cuda(offs_d, *cols, k)


def test_chain_dp_matches_plain(dev):
    """The DP kernel bit-equal (f and pre) to the plain version under the
    same table, on random rows, every edge row and a row of 20 000
    anchors."""
    from ciri_long_tpu_torch.ops import chain
    before = LAUNCHES['chain_dp']
    offs, offs_d, cols, (f, pre) = _chain_on_card(dev, _chain_rows(21))
    table = chain.card_log2_table(chain.table_size(*GAPS), dev)
    fp, pp = chain.chain_dp_plain(offs_d, *cols, table, 15)
    torch.cuda.synchronize()
    assert torch.equal(f.view(torch.int64), fp.view(torch.int64))
    assert torch.equal(pre, pp)
    assert LAUNCHES['chain_dp'] == before + 1


def test_chain_dp_matches_native_core(dev):
    """f and pre bit-equal to the port's native chain core
    (native/chaincore.cpp, built by ``setup.py build_ext --inplace``) row
    by row, and the card's log2 table equal to libm's."""
    from ciri_long_tpu_torch.ops import chain
    from ciri_long_tpu_torch.tools import chain_cases
    core = pytest.importorskip('ciri_long_tpu_torch._chaincore')
    rows = _chain_rows(22)
    offs, _o, _c, (f, pre) = _chain_on_card(dev, rows)
    f, pre = f.cpu().numpy(), pre.cpu().numpy()
    for b, (r, q, c) in enumerate(chain_cases.local(rows)):
        fb, pb = core.chain(r, q, c, 15, 64, *GAPS)
        lo, hi = offs[b], offs[b + 1]
        assert np.frombuffer(fb, np.float64).tobytes() == f[lo:hi].tobytes()
        assert np.array_equal(np.frombuffer(pb, np.int64), pre[lo:hi])
    n = chain.table_size(*GAPS)
    card = chain.card_log2_table(n, dev).cpu().numpy()
    assert card.tobytes() == chain._libm_log2_table(n).tobytes()


@pytest.mark.parametrize('min_anchors,max_chains', [(3, 10), (8, 2),
                                                    (1, 127)])
def test_chain_extract_matches_plain_and_host(dev, min_anchors, max_chains):
    """The extraction kernel equal to the plain version and to the host
    backtrack_chains row by row, shared-memory rows and the global-scratch
    row alike."""
    from ciri_long_tpu_torch.ops import chain
    offs, offs_d, _cols, (f, pre) = _chain_on_card(dev, _chain_rows(23))
    plan = chain.extract_plan(np.diff(offs), dev)
    assert plan[2] > 0                       # the 20 000-anchor row
    before = LAUNCHES['chain_extract']
    got = chain.chain_extract_cuda(offs_d, f, pre, 30.0, min_anchors,
                                   max_chains, plan)
    want = chain.chain_extract_plain(offs_d.cpu(), f.cpu(), pre.cpu(), 30.0,
                                     min_anchors, max_chains)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert LAUNCHES['chain_extract'] == before + 1
    chains = chain.decode_chain_ids(offs, *(t.cpu().numpy() for t in got))
    fc, pc = f.cpu().numpy(), pre.cpu().numpy()
    for b in range(len(offs) - 1):
        lo, hi = offs[b], offs[b + 1]
        host = chain.backtrack_chains(fc[None, lo:hi], pc[None, lo:hi],
                                      np.ones((1, hi - lo), bool), 30.0,
                                      min_anchors, max_chains)[0]
        assert len(host) == len(chains[b])
        for (hi_, hs), (gi, gs) in zip(host, chains[b]):
            assert np.array_equal(hi_, gi) and hs == gs
    assert sum(len(c) for c in chains) > 40


def test_chain_extract_batch_on_the_card(dev):
    """The numpy entry point on the card equals it on the CPU (where the
    plain version takes log2_table), and refuses positions past int32."""
    from ciri_long_tpu_torch.ops import chain
    from ciri_long_tpu_torch.tools import chain_cases
    rows = _chain_rows(24)[:45]
    offs, r, q, c = chain_cases.csr(chain_cases.local(rows))
    got = chain.chain_extract_batch(offs, r, q, c, 30.0, 15, device='cuda')
    want = chain.chain_extract_batch(offs, r, q, c, 30.0, 15, device='cpu')
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match='int32'):
        chain.chain_extract_batch(offs, r + 2 ** 31, q, c, 30.0, 15,
                                  device='cuda')


def test_chain_kernels_reject_bad_inputs(dev):
    from ciri_long_tpu_torch.ops import chain
    offs, offs_d, cols, (f, pre) = _chain_on_card(dev, _chain_rows(25)[:3])
    with pytest.raises(TypeError):
        chain.chain_dp_cuda(offs_d, cols[0].long(), *cols[1:], 15)
    with pytest.raises(ValueError):
        chain.chain_dp_cuda(offs_d.cpu(), *cols, 15)
    with pytest.raises(ValueError, match='window'):
        chain.chain_dp_cuda(offs_d, *cols, 15, window=32)
    plan = chain.extract_plan(np.diff(offs), dev)
    with pytest.raises(ValueError, match='int8'):
        chain.chain_extract_cuda(offs_d, f, pre, 30.0, 3, 200, plan)
    with pytest.raises(ValueError, match='another launch'):
        chain.chain_extract_cuda(offs_d, f, pre, 30.0, 3, 10,
                                 chain.extract_plan([5], dev))
    r, q, c = (x.cpu().numpy() for x in cols)
    with pytest.raises(ValueError, match='offsets'):
        chain.chain_extract_batch(offs[::-1], r, q, c, 30.0, 15,
                                  device='cuda')


@pytest.mark.parametrize('b', [512, 1024, 2048, 4096])
def test_screen_keep_matches_plain(dev, b):
    """csrc/screen_keep.cu equal to the plain screen on each bucket's
    reads (tandem, random, N-poisoned, a period between L / 2 and b / 2, a
    read under 2 * MIN_PERIOD), at the bucket's lag range and, padded to
    the widest bucket, at each read's own."""
    from ciri_long_tpu_torch.ops import period
    from ciri_long_tpu_torch.tools import chain_cases
    rng = np.random.default_rng(b)
    mat, lens = chain_cases.pad(chain_cases.bucket_reads(rng, b), b)
    wide, _ = chain_cases.pad(chain_cases.bucket_reads(
        np.random.default_rng(b), b) + [rng.integers(0, 4, 4096)], 4096)
    wide_lens = np.append(lens, 4096).astype(np.int32)
    for m, n, lags in ((mat, lens, np.full(len(lens), b // 2)),
                       (wide, wide_lens,
                        [period.screen_bucket(int(x)) // 2
                         for x in wide_lens])):
        args = [torch.from_numpy(np.ascontiguousarray(x, dt)).to(dev)
                for x, dt in ((m, np.int8), (n, np.int32),
                              (lags, np.int32))]
        before = LAUNCHES['screen_keep']
        got = period.screen_keep_cuda(*args)
        want = period.screen_keep_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert want.any() and not want.all()
        assert LAUNCHES['screen_keep'] == before + 1


DP_CASES = ('all', 'empty', 'anchors_1', 'anchors_2', 'anchors_64',
            'anchors_65', 'anchors_9000', 'copies_40', 'copies_70',
            'cand_is_k', 'contig_changes', 'gap_r_-1', 'gap_r_+0',
            'gap_r_+1', 'gap_q_-1', 'gap_q_+0', 'gap_q_+1')


@pytest.mark.parametrize('case', DP_CASES)
def test_chain_dp_edge_rows(dev, case):
    """The DP kernel on each of tools/chain_cases.py's dp_cases rows alone
    and on all of them in one launch: f and pre bit-equal to the plain
    version and, once built, to the native chain core row by row."""
    from ciri_long_tpu_torch.ops import chain
    from ciri_long_tpu_torch.tools import chain_cases
    named = chain_cases.dp_cases(np.random.default_rng(31), *GAPS)
    rows = list(named.values()) if case == 'all' else [named[case]]
    offs, offs_d, cols, (f, pre) = _chain_on_card(dev, rows)
    table = chain.card_log2_table(chain.table_size(*GAPS), dev)
    fp, pp = chain.chain_dp_plain(offs_d, *cols, table, 15)
    torch.cuda.synchronize()
    assert torch.equal(f.view(torch.int64), fp.view(torch.int64))
    assert torch.equal(pre, pp)
    try:
        from ciri_long_tpu_torch import _chaincore as core
    except ImportError:
        return
    f, pre = f.cpu().numpy(), pre.cpu().numpy()
    for b, (r, q, c) in enumerate(chain_cases.local(rows)):
        fb, pb = core.chain(r, q, c, 15, 64, *GAPS)
        lo, hi = offs[b], offs[b + 1]
        assert np.frombuffer(fb, np.float64).tobytes() == f[lo:hi].tobytes()
        assert np.array_equal(np.frombuffer(pb, np.int64), pre[lo:hi])


SCREEN_CASES = ('poly_a', 'dinucleotide', 'trinucleotide', 'period_50',
                'all_n', 'no_valid_window', 'poly_a_tail', 'mixed_lags',
                'short_width', 'width_100', 'many_reads')


@pytest.mark.parametrize('case', SCREEN_CASES)
def test_screen_keep_edge_launches(dev, case):
    """csrc/screen_keep.cu equal to the plain screen on each of
    tools/chain_cases.py's screen launches (low-complexity reads, reads all
    N or with no valid window, reads under k, a width no multiple of 16,
    mixed lag ranges, 16 384 reads), each read on the route
    screen_routes_plain gives it."""
    from ciri_long_tpu_torch.ops import period
    from ciri_long_tpu_torch.tools import chain_cases
    mat, lens, lags = chain_cases.screen_launches(
        np.random.default_rng(37))[case]
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (mat, lens, lags)]
    routes = torch.full((len(mat),), 7, dtype=torch.uint8, device=dev)
    got = period.screen_keep_cuda(*args, routes=routes)
    want = period.screen_keep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert np.array_equal(routes.cpu().numpy().astype(bool),
                          period.screen_routes_plain(mat, lags))


def test_screen_keep_rejects_bad_inputs(dev):
    from ciri_long_tpu_torch.ops import period
    reads = torch.full((2, 512), 5, dtype=torch.int8, device=dev)
    lens = torch.tensor([100, 200], dtype=torch.int32, device=dev)
    lags = torch.tensor([256, 256], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match='W <='):
        period.screen_keep_cuda(
            torch.full((2, 5000), 5, dtype=torch.int8, device=dev), lens,
            lags)
    with pytest.raises(TypeError):
        period.screen_keep_cuda(reads, lens.long(), lags)
    with pytest.raises(ValueError):
        period.screen_keep_cuda(reads, lens[:1], lags)
    with pytest.raises(ValueError, match='routes'):
        period.screen_keep_cuda(reads, lens, lags,
                                routes=torch.zeros(2, dtype=torch.int32,
                                                   device=dev))


@pytest.mark.parametrize('span', [(0, 2048), (1024, 1024), (100, 3000)])
@pytest.mark.parametrize('case', ['poly_a', 'dinucleotide', 'period_50',
                                  'no_valid_window', 'mixed_lags',
                                  'short_width', 'width_100'])
def test_tandem_counts_edge_launches(dev, case, span):
    """csrc/tandem_counts.cu equal to tandem_counts_plain on
    tools/chain_cases.py's screen launches at lag offsets 0, 100 and 1 024
    (2 048, 1 024 and 3 000 lags), every read on the bit planes (routes
    0)."""
    from ciri_long_tpu_torch.ops import period
    from ciri_long_tpu_torch.tools import chain_cases
    mat = chain_cases.screen_launches(np.random.default_rng(37))[case][0]
    offset, M = span
    x = torch.from_numpy(np.ascontiguousarray(mat)).to(dev)
    routes = torch.full((len(mat),), 7, dtype=torch.uint8, device=dev)
    got = period.tandem_counts_cuda(x, M, 11, offset, routes=routes)
    want = period.tandem_counts_plain(x, M, 11, offset)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not routes.any()


@pytest.mark.parametrize('k', [12, 13, 15])
def test_tandem_counts_lag_route_at_k(dev, k):
    """Low-complexity reads (the lag route of the sorted keys' earlier
    design) at k = 12, 13 and 15 (the top k-run level), equal to the plain
    version."""
    from ciri_long_tpu_torch.ops import period
    from ciri_long_tpu_torch.tools import chain_cases
    launches = chain_cases.screen_launches(np.random.default_rng(37))
    mat = np.concatenate([launches[c][0] for c in ('poly_a', 'dinucleotide',
                                                    'period_50')])
    x = torch.from_numpy(mat).to(dev)
    routes = torch.zeros(len(mat), dtype=torch.uint8, device=dev)
    got = period.tandem_counts_cuda(x, 3000, k, 100, routes=routes)
    assert torch.equal(got, period.tandem_counts_plain(x, 3000, k, 100))
    assert not routes.any()


def test_tandem_counts_hash_collision(dev):
    """Two distinct 11-mers with one hash, 40 apart in a random read: the
    pair route walks them together and counts nothing at lag 40."""
    from ciri_long_tpu_torch.ops import period
    rng = np.random.default_rng(5)
    seen, pair = {}, None
    while pair is None:
        kid = int(rng.integers(0, 4 ** 11))
        h = ((kid * 2654435761) & 0xffffffff) >> period.POS_BITS
        if h in seen and seen[h] != kid:
            pair = (seen[h], kid)
        seen[h] = kid
    mat = np.full((1, 200), 5, np.int8)
    mat[0, :190] = rng.integers(0, 4, 190)
    for at, kid in zip((60, 100), pair):
        mat[0, at:at + 11] = [(kid >> (2 * (10 - j))) & 3 for j in range(11)]
    x = torch.from_numpy(mat).to(dev)
    got = period.tandem_counts_cuda(x, 64)
    assert torch.equal(got, period.tandem_counts_plain(x, 64))
    assert int(got[0, 39]) == 0


def test_tandem_counts_rejects_bad_inputs(dev):
    """Bad types, k and route buffers are refused; a read wider than 4 096
    codes is not (the kernel takes any width)."""
    from ciri_long_tpu_torch.ops import period
    wide = torch.full((2, 4097), 5, dtype=torch.int8, device=dev)
    assert not period.tandem_counts_cuda(wide, 8).any()
    with pytest.raises(ValueError, match='k in 1..15'):
        period.tandem_counts_cuda(wide, 8, k=16)
    reads = torch.full((2, 512), 5, dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        period.tandem_counts_cuda(reads.int(), 8)
    with pytest.raises(ValueError, match='routes'):
        period.tandem_counts_cuda(reads, 8, routes=torch.zeros(
            2, dtype=torch.int32, device=dev))


@pytest.mark.parametrize('W', [4_097, 16_384])
def test_tandem_counts_wide_route(dev, W):
    """Reads wider than 4 096 codes (one launch each, every read on the
    bit planes, routes 0), equal to tandem_counts_plain over
    tools/chain_cases.py's wide_cases lag ranges, at k = 11 and 15."""
    from ciri_long_tpu_torch.ops import period
    from ciri_long_tpu_torch.tools import chain_cases
    mat, ranges = chain_cases.wide_cases(np.random.default_rng(41), (W,))[
        'wide W={}'.format(W)]
    x = torch.from_numpy(mat).to(dev)
    for k in (11, 15):
        for offset, M in ranges:
            routes = torch.zeros(len(mat), dtype=torch.uint8, device=dev)
            before = LAUNCHES['tandem_counts']
            got = period.tandem_counts_cuda(x, M, k, offset, routes=routes)
            want = period.tandem_counts_plain(x, M, k, offset)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (k, offset, M)
            assert not routes.any()
            assert LAUNCHES['tandem_counts'] == before + 1
    assert int(period.tandem_counts_plain(x, 2048, 11)[0].sum()) > 0


def _profile_cases():
    """(label, reads, [(lag_offset, max_lag)]) for lag_profile: the dry
    run's 2 x 192 x 32, edge reads at 120 and 4 096 codes, and
    tools/chain_cases.py's wide_cases."""
    from ciri_long_tpu_torch.tools import chain_cases
    rng = np.random.default_rng(43)
    cases = [('dryrun', rng.integers(0, 4, (2, 192)).astype(np.int8),
              [(0, 32), (32, 32)])]
    for W, ranges in ((120, [(0, 32), (100, 40), (200, 8)]),
                      (4096, [(0, 2048), (1000, 300), (4000, 200)])):
        mat = np.full((4, W), 5, np.int8)
        mat[0] = np.resize(rng.integers(0, 4, 37), W)
        mat[1, :W // 2] = rng.integers(0, 6, W // 2)
        mat[2, :9] = 2
        cases.append(('edge W={}'.format(W), mat, ranges))
    for label, (mat, ranges) in chain_cases.wide_cases(rng).items():
        cases.append((label, mat, ranges))
    return cases


def test_lag_profile_matches_plain(dev):
    """csrc/lag_profile.cu bit-equal to lag_profile_plain (its float32
    fractions' bits) on every case, each launch counted."""
    from ciri_long_tpu_torch.ops import period
    for label, mat, ranges in _profile_cases():
        x = torch.from_numpy(mat).to(dev)
        for offset, M in ranges:
            before = LAUNCHES['lag_profile']
            got = period.lag_profile_cuda(x, M, offset)
            want = period.lag_profile_plain(x, M, offset)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (label, offset, M)
            assert LAUNCHES['lag_profile'] == before + 1
    got = period.lag_profile(mat, 64, 10, pad_lags=74)
    assert np.array_equal(got, period.lag_profile(mat, 64, 10, device='cpu'))


def _lag_edge_cases():
    from ciri_long_tpu_torch.tools import chain_cases
    return list(chain_cases.lag_edge_cases(
        np.random.default_rng(21)).items())


@pytest.mark.parametrize('case', range(3))
def test_lag_kernels_at_word_edges(dev, case):
    """csrc/lag_planes.h's edges (tools/chain_cases.py's lag_edge_cases:
    lags across words and the chunk of 2 048, partners' words apart from
    the segment's, W of 120, 4 097 and 4 127, N every 41 codes, a read 3
    codes short): tandem_counts_cuda equal to tandem_counts_plain at k = 1,
    2, 3, 5, 8, 11 and 15 (each k-run level at both ends),
    lag_profile_cuda bit-equal to lag_profile_plain."""
    from ciri_long_tpu_torch.ops import period
    label, (mat, ranges) = _lag_edge_cases()[case]
    x = torch.from_numpy(mat).to(dev)
    for offset, M in ranges:
        for k in (1, 2, 3, 5, 8, 11, 15):
            got = period.tandem_counts_cuda(x, M, k, offset)
            want = period.tandem_counts_plain(x, M, k, offset)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (label, k, offset, M)
        got = period.lag_profile_cuda(x, M, offset)
        want = period.lag_profile_plain(x, M, offset)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
            label, offset, M)


@pytest.mark.parametrize('name', ['odd W=8', 'odd W=4097'])
def test_odd_codes_take_the_value_route(dev, name):
    """Reads with codes outside 0..5 (negative codes, valid to JAX, whose
    ids wrap; a code 9) at widths 8 and 4 097: each such read on the value
    route (routes 1) and counted once a
    launch in ROUTES['tandem_value'] and ['lag_value'], both kernels
    equal to their plain versions; lag 4 of the two small rows counts 0 and
    1 at k = 2, as JAX's."""
    from ciri_long_tpu_torch.ops import period
    from ciri_long_tpu_torch.tools import chain_cases
    from ciri_long_tpu_torch.utils.dispatch import settle_routes
    mat, ranges, k = chain_cases.odd_cases(np.random.default_rng(5))[name]
    x = torch.from_numpy(mat).to(dev)
    odd = ((mat < 0) | (mat > 5)).any(axis=1)
    for kk in (k, 1):
        for offset, M in ranges:
            settle_routes()
            before = dict(ROUTES)
            routes = torch.full((len(mat),), 7, dtype=torch.uint8, device=dev)
            got = period.tandem_counts_cuda(x, M, kk, offset, routes=routes)
            want = period.tandem_counts_plain(x, M, kk, offset)
            prof = period.lag_profile_cuda(x, M, offset)
            prof_want = period.lag_profile_plain(x, M, offset)
            settle_routes()
            assert torch.equal(got, want), (kk, offset, M)
            assert torch.equal(prof.view(torch.int32),
                               prof_want.view(torch.int32)), (offset, M)
            r = routes.cpu().numpy()
            assert np.array_equal(r, odd.astype(np.uint8))
            assert (ROUTES['tandem_value']
                    == before['tandem_value'] + int(odd.sum()))
            assert ROUTES['lag_value'] == before['lag_value'] + int(odd.sum())
    if name == 'odd W=8':
        got = period.tandem_counts_cuda(x, 6, 2)
        assert got[:2, 3].tolist() == [0, 1]


def test_lag_profile_rejects_bad_inputs(dev):
    from ciri_long_tpu_torch.ops import period
    reads = torch.full((2, 64), 5, dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        period.lag_profile_cuda(reads.int(), 8)
    with pytest.raises(ValueError, match='max_lag'):
        period.lag_profile_cuda(reads, 0)
    with pytest.raises(ValueError, match='contiguous'):
        period.lag_profile_cuda(reads.t(), 8)
    assert not period.lag_profile_cuda(reads, 8).any()


def test_chain_scores_batch_on_the_card(dev):
    """chain_scores_batch on the card equal to the CPU route (the same
    float64 DP, table aside: the card's libm table, the CPU's when the
    native chain core is built), with non-prefix valid masks; a window
    other than 64 is refused on both."""
    from ciri_long_tpu_torch.ops import chain
    rng = np.random.default_rng(47)
    B, A = 5, 300
    q = np.sort(rng.integers(0, 4000, (B, A)), axis=1)
    r = q + rng.integers(0, 4, (B, A)) + 1000
    ctg = (rng.random((B, A)) < 0.1).astype(np.int32)
    valid = rng.random((B, A)) < 0.85
    got = chain.chain_scores_batch(r, q, ctg, valid, 15, device=dev)
    want = chain.chain_scores_batch(r, q, ctg, valid, 15, device='cpu')
    assert np.array_equal(got[1], want[1])
    assert np.allclose(got[0], want[0], rtol=0, atol=1e-4)
    assert (got[1][~valid] == -1).all() and (got[0][~valid] == 15).all()
    with pytest.raises(ValueError, match='window'):
        chain.chain_scores_batch(r, q, ctg, valid, 15, window=32, device=dev)


def test_call_stages_chain_and_screen_on_the_card(dev, tmp_path):
    """On the verification world: map_batch on the card gives the host
    route's hits, and find_ccs_reads on the card the CPU route's files,
    each having launched its kernels."""
    from ciri_long_tpu_torch.io.fastx import read_fastx
    from ciri_long_tpu_torch.io.genome import Genome
    from ciri_long_tpu_torch.models.aligner import GenomeAligner
    from ciri_long_tpu_torch.pipeline.find_ccs import find_ccs_reads
    from ciri_long_tpu_torch.tools.world import skill_world
    skill_world(str(tmp_path))
    reads = [s for _, s in read_fastx(str(tmp_path / 'reads.fa'))]
    al = GenomeAligner(Genome(str(tmp_path / 'genome.fa')))
    before = dict(LAUNCHES)
    key = [[(h.ctg, h.strand, h.q_st, h.q_en, h.r_st, h.r_en, h.mlen,
             h.cigar, h.mapq, h.score) for h in hits]
           for hits in al.map_batch(reads, device='cuda')]
    assert key == [[(h.ctg, h.strand, h.q_st, h.q_en, h.r_st, h.r_en,
                     h.mlen, h.cigar, h.mapq, h.score) for h in hits]
                   for hits in al.map_batch(reads, device='cpu')]
    out = [find_ccs_reads(str(tmp_path / 'reads.fa'), str(tmp_path / d),
                          'p', device=d) for d in ('cuda', 'cpu')]
    assert out[0] == out[1]
    for name in ('p.ccs.fa', 'p.raw.fa'):
        assert (tmp_path / 'cuda' / 'tmp' / name).read_bytes() == \
            (tmp_path / 'cpu' / 'tmp' / name).read_bytes()
    for name in ('chain_dp', 'chain_extract', 'screen_keep'):
        assert LAUNCHES[name] == before[name] + 1


NW_CASES = ('all', 'one_base', 'band_covers_first', 'j0_edge', 'e_f_ties',
            'long_gaps', 'n_codes', 'one_doubling', 'two_doublings',
            'widest_longest', 'mixed')


NW_FORCES = (None, 1, 2, 4, 8, 'block', 'global')


@pytest.mark.parametrize('force', NW_FORCES)
@pytest.mark.parametrize('case', NW_CASES)
def test_nw_traceback_matches_plain(dev, case, force, monkeypatch):
    """csrc/nw_traceback.cu on tools/nw_cases.py's cases (all in one batch
    and each alone), each pass in the class the plan gives it and forced
    into each class, along each pair's band ladder: every launch's out, runs
    and planes equal to nw_launch_plain's, and the batch's (score, cigar)
    equal to the native banded_global_cigar once built."""
    import functools
    from ciri_long_tpu_torch.ops import nw_tb_batch as ntb
    from ciri_long_tpu_torch.tools.nw_cases import nw_cases
    named = nw_cases(np.random.default_rng(44))
    pairs = ([p for ps in named.values() for p in ps] if case == 'all'
             else named[case])
    kernel = ntb.nw_traceback_cuda
    seen = set()

    def checked(q, r, launch, *scores):
        got = kernel(q, r, launch, *scores)
        want = ntb.nw_launch_plain(q, r, launch, *scores)
        torch.cuda.synchronize()
        for a, b, name in zip(got, want, ('out', 'runs', 'planes')):
            assert torch.equal(a, b), (name, (a != b).nonzero()[:5].tolist())
        seen.update(c.route for c in launch.classes)
        return got

    monkeypatch.setattr(ntb, 'nw_traceback_cuda', checked)
    monkeypatch.setattr(ntb, 'nw_plan', functools.partial(ntb.nw_plan,
                                                          force=force))
    res = ntb.nw_traceback_batch([q for q, _ in pairs], [r for _, r in pairs],
                                 device='cuda')
    if force in ('block', 'global'):
        assert seen == {'nw_' + force}
    try:
        from ciri_long_tpu_torch import _nwcore  # noqa: F401
    except ImportError:
        return
    from ciri_long_tpu_torch.ops.traceback import banded_global_cigar
    for t, (q, r) in enumerate(pairs):
        assert res[t] == banded_global_cigar(q, r), t


@pytest.mark.parametrize('C', [1, 2, 4, 8])
def test_nw_traceback_register_classes_at_narrow_bands(dev, C):
    """Each register class launched on its own at bands narrow enough for
    it (first bands are at least 33 wide, so C = 1 only runs here), with
    the stamps: out, runs and planes equal to nw_launch_plain's, and every
    task's stamps in order."""
    from ciri_long_tpu_torch.ops import nw_tb_batch as ntb
    from ciri_long_tpu_torch.tools.nw_cases import nw_cases
    pairs = [p for ps in nw_cases(np.random.default_rng(44)).values()
             for p in ps if len(p[0]) < 1000]
    n = np.array([len(q) for q, _ in pairs])
    m = np.array([len(r) for _, r in pairs])
    band = np.maximum(0, (32 * C - 1 - np.abs(n - m)) // 4)
    q = torch.from_numpy(np.concatenate([x for x, _ in pairs])).to(dev)
    r = torch.from_numpy(np.concatenate([y for _, y in pairs])).to(dev)
    (launch,) = ntb.nw_plan(n, m, band, np.cumsum(n) - n, np.cumsum(m) - m,
                            dev, budget=1 << 40, force=C)
    assert 'nw_c{}'.format(C) in {c.route for c in launch.classes}
    stamps = torch.zeros((2 * len(pairs), 3), dtype=torch.int64, device=dev)
    got = ntb.nw_traceback_cuda(q, r, launch, stamps=stamps)
    want = ntb.nw_launch_plain(q, r, launch)
    for a, b, name in zip(got, want, ('out', 'runs', 'planes')):
        assert torch.equal(a, b), (name, (a != b).nonzero()[:5].tolist())
    st = stamps.cpu().numpy()
    assert (st[:, 0] > 0).all() and (np.diff(st, axis=1) >= 0).all()


def test_nw_traceback_in_a_graph(dev):
    """A launch of several classes (streams forked from the caller's and
    joined back) captured in a CUDA graph and replayed: the same outputs."""
    from ciri_long_tpu_torch.misc.kexp import time_launches
    from ciri_long_tpu_torch.ops import nw_tb_batch as ntb
    from ciri_long_tpu_torch.tools.nw_cases import nw_cases
    pairs = nw_cases(np.random.default_rng(44))['mixed']
    n = np.array([len(q) for q, _ in pairs])
    m = np.array([len(r) for _, r in pairs])
    q = torch.from_numpy(np.concatenate([x for x, _ in pairs])).to(dev)
    r = torch.from_numpy(np.concatenate([y for _, y in pairs])).to(dev)
    (launch,) = ntb.nw_plan(n, m, np.abs(n - m) + 16, np.cumsum(n) - n,
                            np.cumsum(m) - m, dev)
    assert len(launch.classes) > 1
    outs = []
    ms = time_launches(lambda: outs.append(ntb.nw_traceback_cuda(q, r,
                                                                 launch)),
                       3, dev, graph=True)
    assert ms > 0
    want = ntb.nw_launch_plain(q, r, launch)
    for a, b in zip(outs[-1], want):
        assert torch.equal(a, b)


def test_nw_traceback_rejects_bad_inputs(dev):
    from ciri_long_tpu_torch.ops import nw_tb_batch as ntb
    q = torch.zeros(10, dtype=torch.int8, device=dev)
    (launch,) = ntb.nw_plan([10], [10], [16], [0], [0], dev)
    with pytest.raises(TypeError):
        ntb.nw_traceback_cuda(q.int(), q, launch)
    with pytest.raises(ValueError, match='one CUDA device'):
        ntb.nw_traceback_cuda(q.cpu(), q, launch)
    with pytest.raises(ValueError, match='gap_open >= gap_extend'):
        ntb.nw_traceback_cuda(q, q, launch, 2, 4, 1, 2)
    bad = launch._replace(geom=launch.geom.long())
    with pytest.raises(ValueError, match='nw_plan'):
        ntb.nw_traceback_cuda(q, q, bad)
    bad = launch._replace(tasks=launch.tasks[:1])
    with pytest.raises(ValueError, match='nw_plan'):
        ntb.nw_traceback_cuda(q, q, bad)
    with pytest.raises(ValueError, match='stamps'):
        ntb.nw_traceback_cuda(q, q, launch, stamps=torch.zeros(
            (1, 3), dtype=torch.int64, device=dev))
    bad = launch._replace(classes=tuple(c._replace(C=3)
                                        for c in launch.classes))
    with pytest.raises(RuntimeError, match='launch failed'):
        ntb.nw_traceback_cuda(q, q, bad)


def test_find_ccs_polishes_on_the_card(dev, tmp_path):
    """find_ccs_reads on the card aligns every center-star pair there (no
    pair on the host) and writes the CPU route's files."""
    from ciri_long_tpu_torch.pipeline.find_ccs import find_ccs_reads
    from ciri_long_tpu_torch.tools.world import skill_world
    skill_world(str(tmp_path))
    before, host = LAUNCHES['nw_traceback'], ROUTES['nw_host']
    out = find_ccs_reads(str(tmp_path / 'reads.fa'), str(tmp_path / 'cuda'),
                         'p', device='cuda')
    assert LAUNCHES['nw_traceback'] > before
    assert ROUTES['nw_host'] == host
    assert sum(ROUTES['nw_c{}'.format(C)] for C in (1, 2, 4, 8)) > 0
    assert out == find_ccs_reads(str(tmp_path / 'reads.fa'),
                                 str(tmp_path / 'cpu'), 'p', device='cpu')
    for name in ('p.ccs.fa', 'p.raw.fa'):
        assert (tmp_path / 'cuda' / 'tmp' / name).read_bytes() == \
            (tmp_path / 'cpu' / 'tmp' / name).read_bytes()
