"""The port's int16 probes (ciri_long_tpu_torch/misc/int16_probe.py) on the
CPU, against the TPU probe's kernel bodies.

``misc/int16_probe.py`` is loaded by path (its probes run at import, fail
off the TPU inside its own ``try`` and only print); each of its six kernel
bodies then runs under ``pl.pallas_call(..., interpret=True)`` on the TPU
probe's input, and the port's plain version must give the same array.
That also pins ``pltpu.roll(x, 1, 1)`` to ``torch.roll(x, 1, dims=1)`` and
the bitcast's pair order.  The kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ciri_long_tpu_torch.misc import int16_probe

REPO = Path(__file__).resolve().parent.parent
BODIES = {'int16 add': 'k_add16', 'int16 max': 'k_max16',
          'int16 where': 'k_where16', 'int16 roll': 'k_roll16',
          'int8 add': 'k_add8', 'bitcast16->32': 'k_bitcast'}
JNP_TYPES = {torch.int16: jnp.int16, torch.int8: jnp.int8}


@pytest.fixture(scope='module')
def tpu_probe():
    spec = importlib.util.spec_from_file_location(
        'int16_probe_tpu', REPO / 'misc' / 'int16_probe.py')
    mod = importlib.util.module_from_spec(spec)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        spec.loader.exec_module(mod)
    assert printed.getvalue().count('PROBE ') == 6
    return mod


def _tpu_input(probe):
    dt = JNP_TYPES[probe.dtype]
    return jnp.arange(np.prod(probe.shape), dtype=dt).reshape(probe.shape) % 7


@pytest.mark.parametrize('probe', int16_probe.PROBES, ids=lambda p: p.name)
def test_plain_matches_tpu_kernel_body(tpu_probe, probe):
    """On the TPU probe's input, and on the negative and wrapping lanes of
    ``probe_cases``, which the card's check uses too."""
    x = _tpu_input(probe)
    np.testing.assert_array_equal(int16_probe.probe_input(probe).numpy(),
                                  np.asarray(x))
    out_shape = probe.shape[:2]
    out_dt = jnp.int32 if probe.index == 5 else x.dtype
    cases = int16_probe.probe_cases(probe)
    assert [int(c.min()) < 0 for _, c in cases] == [False, True, False]
    assert int(cases[2][1].max()) == torch.iinfo(probe.dtype).max
    for label, port_x in cases:
        want = np.asarray(pl.pallas_call(
            getattr(tpu_probe, BODIES[probe.name]),
            out_shape=jax.ShapeDtypeStruct(out_shape, out_dt),
            interpret=True)(jnp.asarray(port_x.numpy())))
        got = int16_probe.int16_probe(probe, port_x)
        assert got.dtype == {jnp.int16: torch.int16, jnp.int8: torch.int8,
                             jnp.int32: torch.int32}[jnp.dtype(out_dt).type]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=label)


def test_cli_prints_six_probes_on_the_cpu(capsys):
    outs = int16_probe.main(['--device', 'cpu'])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == 'device: cpu'
    assert lines[1:] == ['PROBE {}: OK {}'.format(
        p.name, np.asarray(outs[p.name]).ravel()[:4])
        for p in int16_probe.PROBES]
    assert lines[4] == 'PROBE int16 roll: OK [0 0 1 2]'


def test_kernel_wrapper_raises_off_the_card(monkeypatch):
    probe = int16_probe.PROBES[0]
    with pytest.raises(ValueError, match='CUDA'):
        int16_probe.int16_probe_cuda(probe, int16_probe.probe_input(probe))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        int16_probe.main([])
