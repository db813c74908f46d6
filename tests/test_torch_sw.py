"""The port's SW scorer and batches against the JAX package on the CPU.

The plain PyTorch ``sw_score_ends`` is held to the JAX ``sw_score_ends``
(XLA scan), to ``tests/oracles.py::sw_oracle`` and to each Pallas route in
interpret mode; ``sw_align_batch``, ``sw_window_align`` and
``sw_window_align_many`` to their JAX twins.  Integer DP: tolerance 0.
Inputs are made with numpy from a seed and handed to both packages.
The CUDA kernel itself is checked on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import sw as jsw
from ciri_long_tpu.ops import sw_pallas
from ciri_long_tpu.utils.seq import pad_encoded
from ciri_long_tpu_torch.ops import sw as tsw
from tests.oracles import sw_oracle

torch.set_num_threads(1)

PARAMS = [(1, 1, 1, 1), (10, 4, 8, 2)]


def _plain(q, r, params):
    return [t.numpy() for t in tsw.sw_score_ends(
        torch.from_numpy(q), torch.from_numpy(r), tsw.SWParams(*params))]


def _jax(q, r, params):
    return [np.asarray(t) for t in jsw.sw_score_ends(q, r,
                                                      jsw.SWParams(*params))]


def _batch(rng, B, lq, lr, hi=5):
    qs = [rng.integers(0, hi, int(rng.integers(*lq))).astype(np.int8)
          for _ in range(B)]
    rs = [rng.integers(0, hi, int(rng.integers(*lr))).astype(np.int8)
          for _ in range(B)]
    return pad_encoded(qs)[0], pad_encoded(rs)[0]


def _special(rng):
    """Rows with N codes, PAD in the middle of a row, all-PAD rows."""
    q = rng.integers(0, 5, (8, 23)).astype(np.int8)
    r = rng.integers(0, 5, (8, 41)).astype(np.int8)
    q[0, 7] = 5                  # mid-row PAD in the query
    r[1, 10:13] = 5              # mid-row PAD in the reference
    r[2] = 5                     # all-PAD reference
    q[3] = 5                     # all-PAD query
    q[4, :] = 4                  # all N
    r[5, 30:] = 5                # PAD suffix
    q[6, 20:] = 5
    return q, r


@pytest.mark.parametrize("params", PARAMS)
def test_plain_matches_jax_scan_and_oracle(rng, params):
    q, r = _batch(rng, 12, (1, 30), (1, 70))
    got = _plain(q, r, params)
    want = _jax(q, r, params)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32
    for i in range(len(q)):
        assert tuple(int(x[i]) for x in got) == sw_oracle(q[i], r[i], *params)


@pytest.mark.parametrize("params", PARAMS)
def test_plain_matches_jax_on_pad_and_n_rows(rng, params):
    q, r = _special(rng)
    got = _plain(q, r, params)
    for a, b in zip(got, _jax(q, r, params)):
        np.testing.assert_array_equal(a, b)
    for i in range(len(q)):
        assert tuple(int(x[i]) for x in got) == sw_oracle(q[i], r[i], *params)
    assert tuple(int(x[2]) for x in got) == (0, -1, -1)
    assert tuple(int(x[3]) for x in got) == (0, -1, -1)


def _route_k1(q, r, p):
    plan = sw_pallas.chain_plan(q.shape[0], q.shape[1], r.shape[1], p)
    assert plan is not None and plan[0] >= 4
    return sw_pallas.sw_score_ends_chain(q, r, p, plan, interpret=True)


def _route_k2(q, r, p):
    assert sw_pallas.wave5_fits(q.shape[1], r.shape[1], p)
    return sw_pallas.sw_score_ends_wave5(q, r, p, interpret=True)


def _route_k3(q, r, p):
    return sw_pallas.sw_score_ends_wave(q, r, p, interpret=True)


def _route_k4(q, r, p):
    return sw_pallas._sw_score_ends_scan(q, r, p, interpret=True)


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("route", ["K1", "K2", "K3", "K4"])
def test_plain_matches_pallas_route(rng, route, params):
    """Each of the four TPU kernels (interpret mode) computes what the
    plain PyTorch scorer computes, N codes and PAD suffixes included."""
    fn = {'K1': _route_k1, 'K2': _route_k2, 'K3': _route_k3,
          'K4': _route_k4}[route]
    B = 13 if route == 'K1' else 6
    q, r = _batch(rng, B, (5, 24), (30, 70))
    got = _plain(q, r, params)
    want = [np.asarray(t) for t in fn(q, r, jsw.SWParams(*params))]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_plain_rejects_open_below_extend():
    q = torch.zeros((1, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        tsw.sw_score_ends(q, q, tsw.SWParams(1, 1, 1, 2))


def test_auto_takes_plain_for_cpu_and_kernel_refuses_cpu(rng):
    q, r = _batch(rng, 4, (3, 12), (5, 20))
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    p = tsw.SWParams(1, 1, 1, 1)
    for a, b in zip(tsw.sw_score_ends_auto(qt, rt, p),
                    tsw.sw_score_ends(qt, rt, p)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tsw.sw_score_ends_cuda(qt, rt, p)


def test_reverse_prefix_matches_jax(rng):
    x = rng.integers(0, 5, (5, 17)).astype(np.int8)
    end = np.array([-1, 0, 5, 16, 9], np.int32)
    got = tsw._reverse_prefix(torch.from_numpy(x), torch.from_numpy(end), 17)
    want = np.asarray(jsw._reverse_prefix(x, end, 17))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int8


def _as_tuple(res):
    return tuple(np.asarray(getattr(res, f)) for f in jsw.SWResult._fields)


@pytest.mark.parametrize("params", PARAMS)
def test_sw_align_batch_matches_jax(rng, params):
    q, r = _batch(rng, 9, (1, 40), (1, 90))
    q[0, 3] = 5
    r[1] = 5
    got = _as_tuple(tsw.sw_align_batch(q, r, tsw.SWParams(*params), 'cpu'))
    want = _as_tuple(jsw.sw_align_batch(q, r, jsw.SWParams(*params)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sw_align_batch_submit_collect_matches_batch(rng):
    q, r = _batch(rng, 5, (2, 20), (4, 40))
    p = tsw.SWParams(10, 4, 8, 2)
    got = _as_tuple(tsw.sw_align_batch_collect(
        tsw.sw_align_batch_submit(q, r, p, 'cpu')))
    for a, b in zip(got, _as_tuple(tsw.sw_align_batch(q, r, p, 'cpu'))):
        np.testing.assert_array_equal(a, b)


def _window_case(rng, Lr, Lq, plant_at):
    ref = rng.integers(0, 4, Lr).astype(np.int8)
    query = ref[plant_at:plant_at + Lq].copy()
    flip = rng.random(Lq) < 0.1
    query[flip] = (query[flip] + 1) % 4
    return query, ref


@pytest.mark.parametrize("Lr,plant_at", [(3000, 1200), (60_000, 33_000)])
def test_sw_window_align_matches_jax(rng, Lr, plant_at):
    """Short window (one batch row) and a ~60 kb window (the chunked
    route), clip scoring."""
    query, ref = _window_case(rng, Lr, 40, plant_at)
    got = tsw.sw_window_align(query, ref, tsw.SWParams(), device='cpu')
    want = jsw.sw_window_align(query, ref, jsw.SWParams())
    assert got == want
    assert got[0] > 0 and abs(got[3] - plant_at) <= 4


def test_sw_window_align_many_matches_jax(rng):
    pairs = [_window_case(rng, 60_000, 35, 20_000),
             _window_case(rng, 2500, 30, 700),
             _window_case(rng, 45_000, 25, 44_000),
             (rng.integers(0, 4, 30).astype(np.int8),
              np.full(40_000, 4, np.int8))]      # all-N window: no hit
    got = tsw.sw_window_align_many(pairs, tsw.SWParams(), device='cpu')
    want = jsw.sw_window_align_many(pairs, jsw.SWParams())
    assert got == want
    assert got[-1] == (0, -1, -1, -1, -1)
    for (query, ref), g in zip(pairs[:3], got[:3]):
        assert g == jsw.sw_window_align(query, ref, jsw.SWParams())
