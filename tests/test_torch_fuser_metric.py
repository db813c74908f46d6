"""The benchmark's reader of collapse's fused rounds,
``portbench/metrics/collapse.fuser_round_ms_per_kread.py``: the five
``fuser.ns.<phase>`` counters of each unit's summary JSON, in ms over the
window's thousands of reads, and nothing for a program that counts no
native round (the parent of the rounds) or a unit without a summary."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent / 'portbench'


def _reader():
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    path = BENCH / 'metrics' / 'collapse.fuser_round_ms_per_kread.py'
    spec = importlib.util.spec_from_file_location('fuser_round_reader', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rec(tmp_path, counters):
    units = []
    for i, c in enumerate(counters):
        out = tmp_path / str(i)
        out.mkdir()
        if c is not None:
            (out / 'cohort.json').write_text(json.dumps(
                {'spans': {}, 'counters': c}))
        units.append({'reads': 8000, 'out': str(out), 'prefix': 'cohort'})
    return {'entry': 'collapse', 'reads': 8000 * len(units), 'units': units}


PHASES = {'fuser.ns.pack': 2e6, 'fuser.ns.upload': 1e6,
          'fuser.ns.device_wait': 4e6, 'fuser.ns.download': 0.5e6,
          'fuser.ns.unpack': 0.5e6, 'fuser.native.sw': 3,
          'poa.ns.pack': 9e9}


@pytest.mark.parametrize('counters, want', [
    ([PHASES, PHASES], 2 * 8.0 / 16),
    ([PHASES, {'fuser.fire.linger': 4}], 8.0 / 16),
    ([{'fuser.fire.linger': 4}, {'poa.ns.pack': 1e9}], None),
    ([PHASES, None], None),
])
def test_fuser_round_reader(tmp_path, counters, want):
    got = _reader().read(_rec(tmp_path, counters))
    assert got == pytest.approx(want) if want is not None else got is None
