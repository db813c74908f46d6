"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card: the SW scorer of ``call`` and ``collapse`` (csrc/sw_score_ends.cu,
both routes, the wavefront under every plan it takes), the
harness's row scan and chained wavefront (csrc/sw_rowscan.cu,
csrc/sw_chain.cu), the int16 probes (csrc/int16_probe.cu, one launch a
probe and all six in one) and collapse's edit distance, SW with traceback
and POA graph alignment (csrc/edit_distance.cu, csrc/sw_traceback.cu,
csrc/poa_align.cu and its round loop, alone and from threads at once),
with ``collapse --device cuda`` raising when a kernel cannot be built.  Marked
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
    _, n_thread = edit.edit_plan(*case[label], dev)
    n_warp = len(case[label][2]) - n_thread
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
    """chip_smoke.py times recorded launches as CUDA graph replays: with
    their plans given, neither wrapper reads back from the card."""
    a, b, alen, blen = edit_cases(np.random.default_rng(0))[-1][1:]
    args = [torch.from_numpy(x).to(dev) for x in (a, b, alen, blen)]
    plan = edit.edit_plan(a, b, alen, blen, dev)
    assert kexp.time_launches(
        lambda: edit.edit_distance_cuda(*args, plan=plan), 3, dev,
        graph=True) > 0
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
    batch has the stats' shape and cells, and the kernel on it equals the
    plain version."""
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
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    for a, b in zip(poa_batch.poa_align_batch_cuda(*args),
                    poa_batch.poa_align_batch_plain(*args)):
        assert torch.equal(a, b)


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


def test_poa_rejects_bad_inputs(dev):
    """An in-degree past the direction word's slot field; wrong types and
    shapes."""
    from ciri_long_tpu_torch.tools.poa_cases import batch

    rng = np.random.default_rng(13)
    g = star_graph(rng, poa_batch.MAX_INDEGREE + 1, 3)
    arrays = batch([g], [np.array([0, 1, 2], np.int8)])
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    with pytest.raises(ValueError, match='predecessor lists'):
        poa_batch.poa_align_batch_cuda(*args)
    with pytest.raises(TypeError):
        poa_batch.poa_align_batch_cuda(args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError):
        poa_batch.poa_align_batch_cuda(args[0], args[1][:, :-1], *args[2:])
