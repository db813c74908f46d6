"""The spans, states and counters of ``utils/dispatch.py`` on the CPU.

- spans nest and sum over threads; states split the span that holds them;
- with no profiler recording, no ``record_function`` is entered; with one,
  each span is one, and the POA rounds' phase events written into a
  ``--profile`` trace land on that trace's clock;
- the fuser's dispatcher fires by linger while a registered thread is busy
  elsewhere, and its fire counters sum to its rounds;
- the readers of the four per-layer metrics of ``portbench/`` that read
  ``collapse``'s summary JSON.
"""

import importlib.util
import json
import logging
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ciri_long_tpu_torch.ops import poa as poa_mod
from ciri_long_tpu_torch.parallel.fuser import DeviceFuser
from ciri_long_tpu_torch.utils import dispatch
from ciri_long_tpu_torch.utils.dispatch import count, span, state, summary

PORTBENCH = Path(__file__).resolve().parent.parent / 'portbench'


def _run_threads(target, n):
    threads = [threading.Thread(target=target, name='t%d' % k)
               for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()


def test_spans_nest_and_sum_across_two_threads():
    dispatch.reset_launches()
    both = threading.Barrier(2)

    @span('t.decorated')
    def inner():
        time.sleep(0.01)

    def work():
        both.wait(timeout=10)
        with span('t.outer'):
            time.sleep(0.02)
            with span('t.inner'):
                inner()
        count('t.items', 3)

    _run_threads(work, 2)
    got = summary()
    outer, mid = got['spans']['t.outer'], got['spans']['t.inner']
    assert outer['calls'] == mid['calls'] == 2
    assert got['spans']['t.decorated']['calls'] == 2
    assert mid['thread_seconds'] >= 2 * 0.01
    assert outer['thread_seconds'] >= mid['thread_seconds'] + 2 * 0.02
    # side by side: the wall time covered is under the threads' sum
    assert 0.03 <= outer['seconds'] < outer['thread_seconds']
    assert got['counters']['t.items'] == 6
    for name in ('t0', 't1'):
        row = got['threads'][name]
        assert row['t.outer']['seconds'] >= row['t.inner']['seconds'] >= \
            row['t.decorated']['seconds'] > 0


def test_summary_while_another_thread_opens_spans():
    """``summary()`` reads the tables of threads that are still running:
    their spans keep growing while it reads, and it reads whole (start,
    end) pairs."""
    dispatch.reset_launches()
    errors = []

    def busy():
        try:
            for _ in range(50_000):
                with span('t.busy'):
                    pass
        except BaseException as exc:     # noqa: BLE001 (asserted below)
            errors.append(exc)

    thread = threading.Thread(target=busy)
    thread.start()
    seen = []
    while thread.is_alive():
        seen.append(summary()['spans'].get('t.busy', {}).get('calls', 0))
    thread.join()
    assert not errors
    assert len(seen) > 1 and seen == sorted(seen)
    got = summary()['spans']['t.busy']
    assert got['calls'] == 50_000
    assert 0 < got['seconds'] <= got['thread_seconds'] * (1 + 1e-9)


def _nested_states():
    with span('t.cluster'), state('t.host'):
        time.sleep(0.01)
        with state('t.wait'):
            time.sleep(0.02)
            with state('t.inner'):
                time.sleep(0.005)
        with state('t.wait'):
            pass
        time.sleep(0.01)


def test_states_split_the_span_that_holds_them(monkeypatch):
    dispatch.reset_launches()
    _run_threads(_nested_states, 2)
    got = summary()
    for name in ('t0', 't1'):
        row = got['threads'][name]
        parts = sum(row[s]['seconds'] for s in ('t.host', 't.wait',
                                                't.inner'))
        # the states lie inside the span and fill it but for the span's
        # own clock reads
        assert row['t.cluster']['seconds'] * 0.99 <= parts <= \
            row['t.cluster']['seconds']
        assert row['t.wait']['calls'] == 2 and row['t.host']['calls'] == 1
        assert row['t.inner']['seconds'] >= 0.005
        assert row['t.wait']['seconds'] >= 0.01
    # a state outside any span is a span of its own
    dispatch.reset_launches()
    with state('t.alone'):
        time.sleep(0.002)
    assert summary()['spans']['t.alone']['thread_seconds'] >= 0.002
    # on a clock that ticks once a read: the states take every tick of the
    # span but its own two reads, at its start and its end
    ticks = iter(range(10**6))
    monkeypatch.setattr(dispatch, 'time', type(
        'Clock', (), {'perf_counter_ns': staticmethod(lambda: next(ticks))}))
    dispatch.reset_launches()
    _nested_states()
    row = summary()['threads'][threading.current_thread().name]
    parts = sum(row[s]['seconds'] for s in ('t.host', 't.wait', 't.inner'))
    assert round((row['t.cluster']['seconds'] - parts) * 1e9) == 2


class _CountingRecord:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_no_record_function_unless_a_profiler_records(monkeypatch):
    monkeypatch.setattr(dispatch._profiler, 'record_function',
                        _CountingRecord)
    monkeypatch.setattr(_CountingRecord, 'entered', 0)
    assert not dispatch._profiler._is_profiler_enabled
    with span('t.off'):
        with state('t.state'):
            pass
    assert _CountingRecord.entered == 0
    monkeypatch.setattr(dispatch._profiler, '_is_profiler_enabled', True)
    with span('t.on'):
        with state('t.state'):
            pass
    assert _CountingRecord.entered == 2


def test_profile_trace_holds_spans_of_every_thread_and_the_poa_rounds(
        tmp_path):
    """``--profile``'s trace (cli/main.py::_device_trace) shows a worker
    thread's spans, and a POA round's phase events written on its clock
    fall inside the span that was open on that thread around them."""
    from ciri_long_tpu_torch.cli.main import _device_trace

    marks = {}

    def worker():
        with state('poa.rounds'):
            t0 = time.perf_counter_ns()
            time.sleep(0.002)
            stamps = np.array([t0 + k * 200_000 for k in range(7)],
                              np.int64)[None]
            poa_mod._ROUND_STAMPS.append((threading.get_native_id(),
                                          stamps))
            time.sleep(0.002)
        marks['tid'] = threading.get_native_id()

    with _device_trace(str(tmp_path), 'p', torch.device('cpu'),
                       logging.getLogger('test')):
        _run_threads(worker, 1)
    assert poa_mod._ROUND_STAMPS is None
    events = json.loads((tmp_path / 'p.trace.json').read_text())[
        'traceEvents']
    outer = [e for e in events if e.get('name') == 'poa.rounds']
    assert [e['tid'] for e in outer] == [marks['tid']]
    phases = [e for e in events if e.get('cat') == 'poa_round']
    assert [e['name'] for e in phases] == [
        'poa.' + p for p in poa_mod.PHASES]
    lo, hi = outer[0]['ts'], outer[0]['ts'] + outer[0]['dur']
    for e in phases:
        assert e['tid'] == marks['tid']
        assert e['dur'] == pytest.approx(200.0, rel=1e-3)
        assert lo - 50 <= e['ts'] and e['ts'] + e['dur'] <= hi + 50


def test_fuser_fires_by_linger_while_a_worker_is_busy_elsewhere():
    dispatch.reset_launches()
    linger = 0.03
    fuser = DeviceFuser({'k': lambda jobs: [j * 2 for j in jobs]},
                        linger_s=linger)
    busy = threading.Event()
    out = []

    def caller():
        fuser.register()
        try:
            busy.wait(timeout=10)
            out.extend(fuser.call('k', j) for j in (1, 2))
        finally:
            fuser.unregister()

    def elsewhere():
        fuser.register()
        try:
            busy.set()
            time.sleep(0.3)      # host work outside the fuser
        finally:
            fuser.unregister()

    threads = [threading.Thread(target=f) for f in (caller, elsewhere)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    fuser.close()
    assert out == [2, 4]
    got = summary()
    fired = {k: v for k, v in got['counters'].items()
             if k.startswith('fuser.fire.')}
    assert fired.get('fuser.fire.linger', 0) >= 1
    assert sum(fired.values()) == fuser.rounds == 2
    assert got['counters']['fuser.jobs.k'] == fuser.jobs == 2
    lingered = got['spans']['fuser.linger']
    assert lingered['thread_seconds'] >= linger
    assert got['spans']['fuser.run.k']['calls'] == 2
    assert got['threads']['ciri-fuser']['fuser.linger']['calls'] >= 1


def _reader(name):
    if str(PORTBENCH) not in sys.path:
        sys.path.insert(0, str(PORTBENCH))
    spec = importlib.util.spec_from_file_location(
        'reader_' + name.replace('.', '_'),
        PORTBENCH / 'metrics' / (name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _summary(spans, counters):
    return {'spans': {k: {'calls': 1, 'seconds': v, 'thread_seconds': v}
                      for k, v in spans.items()},
            'counters': counters}


@pytest.mark.parametrize('name, want', [
    ('collapse.fuser_linger_ms_per_kread', (0.5 + 1.5) * 1e3 / 4),
    ('collapse.poa_host_ms_per_kread', (15e6 + 15e6) / 1e6 / 4),
    ('collapse.pool_tail_s_per_kread', (2.0 + 6.0) / 4),
    ('collapse.cluster_host_s_per_kread', (10.0 + 30.0) / 4),
])
def test_summary_readers(tmp_path, name, want):
    phases = {'poa.ns.' + p: 3e6 for p in ('pack', 'plan', 'upload',
                                           'download', 'fuse')}
    phases['poa.ns.device_wait'] = 9e9
    units = []
    for k, scale in enumerate((1.0, 3.0)):
        out = tmp_path / str(k)
        out.mkdir()
        (out / 'cohort.json').write_text(json.dumps(_summary(
            {'fuser.linger': 0.5 * scale,
             'collapse.cluster_host': 10.0 * scale},
            dict(phases, **{'pool.tail_thread_s': 2.0 * scale}))))
        units.append({'reads': 2000, 'out': str(out), 'prefix': 'cohort'})
    rec = {'entry': 'collapse', 'reads': 4000, 'units': units}
    read = _reader(name)
    assert read(rec) == pytest.approx(want)
    # a program that writes no summary (or another entry) reads nothing
    (tmp_path / '1' / 'cohort.json').unlink()
    assert read(rec) is None
    assert read(dict(rec, entry='call')) is None
