"""The port's SW variant harness (ciri_long_tpu_torch/misc/kexp.py) on the
CPU, against the JAX package's harness and oracle.

- each design family's scorer with ``--device cpu`` (the plain version)
  against ``ciri_long_tpu.ops.sw.sw_score_ends``, kexp's own oracle, at
  kexp's check shape 300x517 with N, PAD suffixes, a mid-row PAD and an
  all-PAD row;
- one variant per family of the TPU harness, ``misc/kexp.py::make_call``
  loaded by path and run in Pallas interpret mode at its smallest shape,
  against the port's family on the same codes;
- the chain's stream layout: round trip, and the B % C error;
- the CLI, which prints one JSON line per run and raises without a card
  unless given ``--device cpu``.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import sw as jsw
from ciri_long_tpu_torch.misc import kexp
from ciri_long_tpu_torch.ops.sw import SWParams

REPO = Path(__file__).resolve().parent.parent
FAMILIES = [[], ['--r3'], ['--wave'], ['--chain', '2'], ['--chain', '4']]


def _codes(rng, B, L, high=5):
    x = rng.integers(0, high, (B, L)).astype(np.int8)
    for b in range(0, B, 3):
        x[b, int(rng.integers(L // 2, L + 1)):] = 5     # PAD suffix
    return x


@pytest.fixture(scope='module')
def check_case():
    """32 rows at kexp's check shape 300x517, and the oracle's answer."""
    rng = np.random.default_rng(1663)
    q = _codes(rng, 32, 300)
    r = _codes(rng, 32, 517)
    q[1, 150] = 5                 # mid-row PAD
    r[2, 200:203] = 5
    r[4] = 5                      # all-PAD row
    want = [np.asarray(x) for x in jsw.sw_score_ends(
        jnp.asarray(q), jnp.asarray(r), jsw.SWParams(*kexp.PARAMS))]
    return q, r, want


@pytest.mark.parametrize('flags', FAMILIES, ids=lambda f: ' '.join(f) or
                         'default')
def test_family_matches_jax_oracle(check_case, flags):
    q, r, want = check_case
    name, fn = kexp.family(kexp.parse_args(flags + ['--device', 'cpu']))
    assert name == {'': 'row', '--r3': 'row', '--wave': 'wave'}.get(
        (flags or [''])[0], 'chain')
    got = fn(torch.from_numpy(q), torch.from_numpy(r), kexp.PARAMS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int((want[0] > 0).sum()) >= 20


def _tpu_harness():
    spec = importlib.util.spec_from_file_location('kexp_tpu',
                                                  REPO / 'misc' / 'kexp.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TPU_ARGS = dict(btile=8, nomask7=False, packbest=False, tworow=False,
                r3=False, wave=False, wave2=False, wave3=False, wave5=False,
                unroll=2, chain=0, chain7=0, chain9=0, chain10=0, non=False,
                noroll=False, nobp=False, levels=None, interpret=True)


@pytest.mark.parametrize('tpu_flag,port_flags', [
    ('row', []), ('r3', ['--r3']), ('wave', ['--wave']),
    ('chain', ['--chain', '2'])])
def test_tpu_harness_interpret_matches_port_family(tpu_flag, port_flags):
    """kexp.make_call's variant (row: build_kernel, r3: build_kernel_r3,
    wave: build_kernel_wave, chain: build_kernel_chain with C=2) in
    interpret mode, 8 rows x 20 x 100, against the port's family."""
    tpu = _tpu_harness()
    kw = dict(TPU_ARGS)
    if tpu_flag == 'chain':
        kw['chain'] = 2
    elif tpu_flag != 'row':
        kw[tpu_flag] = True
    call = tpu.make_call(argparse.Namespace(**kw), tuple(kexp.PARAMS))
    rng = np.random.default_rng(len(tpu_flag))
    q = rng.integers(0, 5, (8, 20)).astype(np.int8)
    r = rng.integers(0, 5, (8, 100)).astype(np.int8)
    want = [np.asarray(x) for x in call(q, r)]
    _, fn = kexp.family(kexp.parse_args(port_flags + ['--device', 'cpu']))
    got = fn(torch.from_numpy(q), torch.from_numpy(r), kexp.PARAMS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (want[0] > 0).all()


@pytest.mark.parametrize('C', [1, 2, 3, 6])
def test_chain_layout_round_trip(C):
    rng = np.random.default_rng(C)
    B, Lq, Lr = 6, 7, 11
    q = torch.from_numpy(rng.integers(0, 5, (B, Lq)).astype(np.int8))
    r = torch.from_numpy(rng.integers(0, 7, (B, Lr)).astype(np.int8))
    qrows, stream = kexp.chain_layout(q, r, C)
    assert qrows.shape == (B // C, C * Lq) and qrows.is_contiguous()
    assert stream.shape == (B // C, C * (Lr + 1) + 1)
    assert stream.dtype == torch.int8 and stream.is_contiguous()
    # boundaries at k*(Lr+1) and at the end, nowhere else
    is_b = stream == kexp.BOUNDARY
    want_b = torch.zeros_like(is_b)
    want_b[:, ::Lr + 1] = True
    assert torch.equal(is_b, want_b)
    # job k of stream s is batch row s*C + k, queries and references
    assert torch.equal(qrows.reshape(B, Lq), q)
    jobs = stream[:, :-1].reshape(B, Lr + 1)[:, 1:]
    assert torch.equal(jobs, torch.clamp_max(r, 5))


def test_chain_needs_b_divisible_by_c():
    q = torch.zeros((6, 4), dtype=torch.int8)
    for C in (4, 0, -1):
        with pytest.raises(ValueError, match='divisible'):
            kexp.chain_layout(q, q, C)
        with pytest.raises(ValueError, match='divisible'):
            kexp.sw_chain(q, q, SWParams(), C)
    with pytest.raises(SystemExit):
        kexp.parse_args(['--chain', '2', '--wave'])


def test_check_raises_on_a_mismatch():
    def off_by_one(q, r, params):
        score, q_end, r_end = kexp.sw_score_ends(q, r, params)
        return score + (score > 50).int(), q_end, r_end

    with pytest.raises(AssertionError, match='MISMATCH score'):
        kexp.check(off_by_one, kexp.PARAMS, torch.device('cpu'),
                   np.random.default_rng(0), 64, 64, rows=4)


@pytest.mark.parametrize('flags', FAMILIES, ids=lambda f: ' '.join(f) or
                         'default')
def test_cli_prints_one_json_line(flags, capsys):
    line = kexp.main(flags + ['--device', 'cpu', '--B', '8', '--Lq', '40',
                              '--Lr', '90', '--iters', '2'])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == line
    assert line['variant']['family'] in ('row', 'wave', 'chain')
    assert line['device'] == 'cpu' and line['bound_ms'] is None
    assert line['ms'] > 0 and line['gcups'] > 0
    assert (line['B'], line['Lq'], line['Lr']) == (8, 40, 90)


def test_cli_runs_as_a_module_and_needs_a_card(tmp_path):
    cmd = [sys.executable, '-m', 'ciri_long_tpu_torch.misc.kexp']
    proc = subprocess.run(cmd + ['--wave', '--device', 'cpu', '--B', '4',
                                 '--Lq', '30', '--Lr', '70', '--iters', '1'],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout)['variant'] == {'family': 'wave',
                                                  'chain': 0}
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0 and not proc.stdout
        assert 'is_available' in proc.stderr


def test_bound_counts_operations_at_the_cards_rate():
    cells_per_s = 2.8e12
    ms, by = kexp.sw_bound(512, 1024, 4096, cells_per_s)
    assert by == 'operations'
    assert ms == pytest.approx(512 * 1024 * 4096 / cells_per_s * 1e3)
    ms, by = kexp.sw_bound(1, 1, 1, cells_per_s)
    assert by == 'bytes'
    assert ms == pytest.approx((2 + 12) / kexp.HBM_BYTES_PER_S * 1e3)


def test_time_launches_on_the_cpu_is_the_host_clock():
    calls = []
    ms = kexp.time_launches(lambda: calls.append(time.sleep(0.002)), 3,
                            torch.device('cpu'), graph=True)
    assert len(calls) == 4                       # one warm-up, three timed
    assert 2.0 <= ms < 200.0
    q = torch.zeros((2, 5), dtype=torch.int8)
    rate, ms = kexp.gcups(kexp.sw_rowscan, q, q, kexp.PARAMS, 2)
    assert rate == pytest.approx(2 * 5 * 5 / (ms * 1e-3) / 1e9)
