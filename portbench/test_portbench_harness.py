"""The harness's parts that need no card: the import rule, the metric
readers' arithmetic, the trace's reduction, and finding a new cell,
configuration and metric by name.

    python -m pytest portbench/ -q
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import run
import tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def test_forbidden_modules_compare_whole_top_level_names():
    names = ['ciri_long_tpu_torch', 'ciri_long_tpu_torch.ops.poa', 'jaxify',
             'jax', 'jax.numpy', 'jaxlib.xla', 'flax', 'ciri_long_tpu',
             'ciri_long_tpu.cli.main', 'numpy']
    assert run.forbidden_modules(names) == [
        'ciri_long_tpu', 'ciri_long_tpu.cli.main', 'flax', 'jax',
        'jax.numpy', 'jaxlib.xla']


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys, json\n'
         'print(json.dumps(sorted(sys.modules)))'],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH='{}:{}'.format(HERE, ROOT)))
    return json.loads(out.stdout.splitlines()[-1])


def test_the_harness_and_the_port_load_no_jax():
    loaded = _loaded_after(
        'import run, worlds, tracing, native\n'
        'import checks.outputs, checks.poa\n'
        'import ciri_long_tpu_torch.cli.main as m\n'
        'import ciri_long_tpu_torch.pipeline.collapse, '
        'ciri_long_tpu_torch.pipeline.find_bsj, '
        'ciri_long_tpu_torch.pipeline.find_ccs')
    assert 'ciri_long_tpu_torch.cli.main' in loaded
    assert run.forbidden_modules(loaded) == []


def test_the_references_load_nothing_of_the_program():
    loaded = _loaded_after('import worlds, checks.outputs, checks.poa')
    assert not [m for m in loaded if m.split('.')[0] in (
        'ciri_long_tpu', 'ciri_long_tpu_torch', 'jax', 'jaxlib', 'flax',
        'torch')]


def _rec(**kw):
    rec = {'entry': 'collapse', 'reads': 16000, 'window_s': 20.0,
           'setup_s': 31.5, 'spans': {}, 'units': [
               {'reads': 8000, 'launches': {'poa_align': 30,
                                            'sw_score_ends': 1},
                'device_ms': {'poa_align': 2.0}},
               {'reads': 8000, 'launches': {'poa_align': 29,
                                            'sw_score_ends': 1},
                'device_ms': {'poa_align': 6.0}}]}
    rec.update(kw)
    return rec


def _read(name, rec):
    return run.load_module(HERE / 'metrics' / (name + '.py')).read(rec)


@pytest.mark.parametrize('name, entry, extra, want', [
    ('collapse_reads_per_s', 'collapse', {}, 800.0),
    ('collapse_reads_per_s', 'call', {}, None),
    ('setup_s', 'collapse', {}, 31.5),
    ('collapse.correct_s_per_kread', 'collapse',
     {'spans': {'collapse.correct_reads': 8.0}}, 0.5),
    ('collapse.correct_s_per_kread', 'collapse', {}, None),
    ('kernel.launches_per_kread.collapse', 'collapse', {}, 61 / 16),
    ('kernel.poa_align_ms_per_kread', 'collapse', {}, 8.0 / 16),
    ('device.idle_pct.collapse', 'collapse',
     {'busy_s': 2.5, 'traced_s': 10.0}, 75.0),
    ('device.idle_pct.collapse', 'collapse',
     {'busy_s': 0.0, 'traced_s': 10.0}, None),
])
def test_metric_readers(name, entry, extra, want):
    got = _read(name, _rec(entry=entry, **extra))
    assert got == pytest.approx(want) if want is not None else got is None


def test_every_metric_has_a_reader_and_each_cell_reports_its_metrics():
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    assert {w['name'] for w in bench['workloads']} == {'collapse.cohort'}
    for m in bench['end_to_end'] + bench['per_layer']:
        assert (HERE / 'metrics' / (m['name'] + '.py')).exists()
    for cell in bench['workloads']:
        assert (HERE / 'traffic' / (cell['traffic'] + '.json')).exists()
        e2e = {m['name'] for m in run.cell_metrics(bench, cell['name'],
                                                   'end_to_end')}
        assert 'setup_s' in e2e and len(e2e) >= 2
        layer = run.cell_metrics(bench, cell['name'], 'per_layer')
        assert layer and all(m['moves'] in e2e for m in layer)


class _Event(SimpleNamespace):
    def name(self):
        return self.n

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.dev else DeviceType.CPU

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def is_user_annotation(self):
        return self.n in ('outer', 'inner')


def test_trace_reduction_unions_device_time_and_names_idle_gaps():
    ev = [_Event(n='k1', dev=True, s=100, e=300),
          _Event(n='k2', dev=True, s=200, e=400),   # overlaps k1
          _Event(n='k1', dev=True, s=700, e=800),
          _Event(n='outer', dev=False, s=0, e=1000),
          _Event(n='inner', dev=False, s=450, e=650),
          _Event(n='aten::add', dev=False, s=0, e=1000),
          _Event(n='outer', dev=True, s=0, e=1000)]   # its device image
    busy, br = tracing.reduce(ev, {'outer', 'inner'}, 0, 1000)
    assert busy == pytest.approx(400e-9)       # [100, 400) and [700, 800)
    assert br['device_ops'] == [['k1', 300e-9], ['k2', 200e-9]]
    # gaps [0,100) and [800,1000) in 'outer', [400,700) mid 550 in 'inner'
    assert dict(br['idle_gaps']) == pytest.approx(
        {'outer': 300e-9, 'inner': 300e-9})


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """Copy the harness, add a configuration, a traffic mix and a metric as
    new files, name them in BENCHMARK.json, and run the new cell (on the
    CPU, at a small size): no file of the harness is edited."""
    shutil.copytree(HERE, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    for name in ('native', 'ciri_long_tpu_torch'):
        os.symlink(ROOT / name, tmp_path / name)
    pb = tmp_path / 'portbench'
    cfg = json.loads((pb / 'configs' / 'cohort_collapse.json').read_text())
    cfg['world'].update(genome_kb=60, loci=3)
    (pb / 'configs' / 'tiny_cohort.json').write_text(json.dumps(cfg))
    mix = json.loads((pb / 'traffic' / 'two_samples.json').read_text())
    mix.update(reads=60)
    (pb / 'traffic' / 'tiny_cohort.json').write_text(json.dumps(mix))
    (pb / 'metrics' / 'collapse.runs.py').write_text(
        'def read(rec):\n    return float(len(rec["units"]))\n')
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'tiny_cohort', 'source': 'x',
                             'file': 'portbench/configs/tiny_cohort.json',
                             'reduced': []})
    bench['workloads'].append({'name': 'collapse.tiny',
                               'config': 'tiny_cohort',
                               'traffic': 'tiny_cohort', 'chips': 1,
                               'why': 'x'})
    bench['end_to_end'].append({'name': 'collapse.runs', 'unit': 'runs',
                                'better': 'higher', 'bound': 0.1,
                                'source': 'host_clock',
                                'workloads': ['collapse.tiny']})
    for m in bench['end_to_end']:
        if m['name'] == 'collapse_reads_per_s':
            m['workloads'].append('collapse.tiny')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    code = ('import json, run\n'
            'out = run.run_cell("collapse.tiny", 5, 0.1, False, '
            'device="cpu")\n'
            'print(json.dumps(out))\n')
    proc = subprocess.run(
        [sys.executable, '-c', code], cwd=tmp_path, capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH='{}:{}'.format(
            pb, tmp_path)), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out['correct'] and out['failed'] == 0
    assert set(out['metrics']) == {'collapse_reads_per_s', 'setup_s',
                                   'collapse.runs'}
    assert out['metrics']['collapse.runs']['value'] == out['attempted']
