#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``ciri_long_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU.  The cell is
an entry of ``workloads`` in ``BENCHMARK.json``; everything that belongs to
it is found by name: its configuration's file (``configs/``), its traffic
mix (``traffic/<traffic>.json``, which names the entry that drives the
program, ``entries/<entry>.py``, and the checks of its output,
``checks/<check>.py``) and a reader for each metric
(``metrics/<metric>.py``).

The run makes its world from ``--seed`` (``worlds.py::build_world``), runs
the entry's set-up (``setup_s``), then units of work back to back until
``--seconds`` have passed, the unit in flight finishing.  With ``--trace
0`` it reports the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, from a ``torch.profiler`` trace of the window and spans
around the program's layers.  Afterwards the checks recompute a sample of
what the window produced with their NumPy references.  The last line of
standard output is the result as JSON; the last lines of standard error
give each number compared beside its limit.  Without a CUDA device, or
with fewer than the cell asks for, it exits with 3 and prints no result.
"""

import argparse
import contextlib
import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import time
import traceback
from pathlib import Path

T0 = time.perf_counter()      # set-up is timed from the process's start

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

import native  # noqa: E402
import tracing  # noqa: E402
import worlds  # noqa: E402

# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ciri_long_tpu')
CACHE = ROOT / 'build' / 'portbench'


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is in FORBIDDEN, compared
    whole (``ciri_long_tpu_torch`` is not ``ciri_long_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split('.')[0] in FORBIDDEN)


def load_module(path):
    spec = importlib.util.spec_from_file_location(
        'portbench_' + path.stem.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell, kind):
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') that ``cell``
    reports: those whose ``workloads`` list it, or, without the key, every
    end-to-end metric and the per-layer metrics whose ``moves`` it
    reports."""
    e2e = {m['name'] for m in bench['end_to_end']
           if cell in m.get('workloads', [cell])}
    return [m for m in bench[kind]
            if cell in m.get('workloads', [cell])
            and (kind == 'end_to_end' or 'workloads' in m
                 or m['moves'] in e2e)]


def _unit_note(u):
    """A unit's work beside its time: launches and device ms by kernel."""
    launches = {k: v for k, v in u.get('launches', {}).items() if v}
    ms = {k: round(v, 3) for k, v in u.get('device_ms', {}).items()}
    return ', launches {}, device ms {}'.format(launches, ms) if u else ''


def _sync(device):
    if device.startswith('cuda'):
        import torch
        torch.cuda.synchronize()


def _used_bytes(device):
    import torch
    if not device.startswith('cuda'):
        return 0
    free, total = torch.cuda.mem_get_info()
    return total - free


def run_cell(name, seed, seconds, trace_on, device='cuda', cfg_over=None,
             mix_over=None, controls=False, t0=None, bench=None, work=None):
    """One run of cell ``name`` of ``bench`` (``BENCHMARK.json`` by
    default); returns the result as a dict (with ``controls``, also the
    readings of each check's control under ``control_checks``).
    ``cfg_over`` and ``mix_over`` update the configuration's world and the
    traffic mix (for tests at a small size).  Set-up is timed from ``t0``
    (``time.perf_counter()``; now by default).  The run works in ``work``
    (a fixed directory of the checkout's ``build/`` by default), which it
    empties before and after."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    bench = bench or worlds.load_json(ROOT / 'BENCHMARK.json')
    cell = next(w for w in bench['workloads'] if w['name'] == name)
    conf = next(c for c in bench['configs'] if c['name'] == cell['config'])
    cfg = dict(worlds.load_json(ROOT / conf['file'])['world'],
               **(cfg_over or {}))
    mix = dict(worlds.load_json(HERE / 'traffic' / (cell['traffic']
                                                    + '.json')),
               **(mix_over or {}))
    work = Path(work) if work else CACHE / 'work' / name
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    native.load_cores()
    world = worlds.build_world(str(work / 'world'), cfg, mix, seed)
    entry = load_module(HERE / 'entries' / (mix['entry'] + '.py'))
    unit = entry.setup(world, str(work), device, mix)
    _sync(device)
    setup_s = time.perf_counter() - t0

    kind = 'per_layer' if trace_on else 'end_to_end'
    wanted = cell_metrics(bench, name, kind)
    readers = {m['name']: load_module(HERE / 'metrics' / (m['name'] + '.py'))
               for m in wanted}
    checks = [importlib.import_module('checks.' + c).Check(seed, world)
              for c in mix['checks']]
    for c in checks:
        c.install()
    spans = None
    if trace_on:
        table = dict(entry.SPANS)
        for r in readers.values():
            table.update(getattr(r, 'SPANS', {}))
        spans = tracing.Spans(table)
        spans.install()
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.startswith('cuda'):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    if device.startswith('cuda'):
        torch.cuda.reset_peak_memory_stats()
    peak = _used_bytes(device)
    units, attempted, failed = [], 0, 0
    marker = (torch.profiler.record_function(tracing.WINDOW) if trace_on
              else contextlib.nullcontext())
    with marker:
        start = time.perf_counter()
        while True:
            attempted += 1
            t_unit = time.perf_counter()
            try:
                units.append(unit(attempted - 1))
            except Exception:
                failed += 1
                traceback.print_exc()
            print('unit {} took {:.3f} s{}'.format(
                attempted - 1, time.perf_counter() - t_unit,
                _unit_note(units[-1] if len(units) == attempted else {})),
                file=sys.stderr)
            peak = max(peak, _used_bytes(device))
            if time.perf_counter() - start >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - start
    rec = {'entry': mix['entry'], 'reads': sum(u['reads'] for u in units),
           'window_s': window_s, 'setup_s': setup_s, 'units': units,
           'spans': {}}
    breakdown = None
    if trace_on:
        prof.stop()
        spans.uninstall()
        rec['spans'] = dict(spans.seconds)
        events = prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == tracing.WINDOW
                    and e.device_type() != DeviceType.CUDA)
        rec['busy_s'], breakdown = tracing.reduce(
            events, set(spans.table), mark.start_ns(), mark.end_ns())
        rec['traced_s'] = (mark.end_ns() - mark.start_ns()) / 1e9
        del events, prof
    for c in checks:
        c.uninstall()
    if device.startswith('cuda'):
        peak = max(peak, torch.cuda.max_memory_reserved())
    del unit, entry
    gc.collect()
    if device.startswith('cuda'):
        torch.cuda.empty_cache()

    judged, control = {}, {}
    for c in checks:
        judged.update(c.judge(rec))
        if controls:
            control.update(c.judge(rec, control=True))
    correct = failed == 0 and all(v <= lim for v, lim in judged.values())
    metrics = {}
    for m in wanted:
        value = readers[m['name']].read(rec)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    dev = {'platform': 'gpu' if device.startswith('cuda') else 'cpu',
           'kind': (torch.cuda.get_device_name(0)
                    if device.startswith('cuda') else 'cpu'),
           'count': int(cell['chips']), 'memory_peak_bytes': int(peak)}
    if trace_on:
        dev.update(busy_s=rec['busy_s'], window_s=rec['traced_s'])
    out = {'correct': correct, 'attempted': attempted, 'failed': failed,
           'metrics': metrics, 'device': dev}
    if breakdown is not None:
        out['breakdown'] = breakdown
    if controls:
        out['control_checks'] = {k: {'value': v, 'limit': lim}
                                 for k, (v, lim) in control.items()}
    out['checks'] = {k: {'value': v, 'limit': lim}
                     for k, (v, lim) in judged.items()}
    shutil.rmtree(work, ignore_errors=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    os.environ['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE / 'torch_extensions')
    bench = worlds.load_json(ROOT / 'BENCHMARK.json')
    cell = next((w for w in bench['workloads']
                 if w['name'] == args.workload), None)
    if cell is None:
        sys.exit('unknown workload {!r}'.format(args.workload))
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell['chips'])):
        print('this cell needs {} CUDA device(s); found {}'.format(
            cell['chips'], torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        sys.exit(3)

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t0=T0)
    loaded = forbidden_modules()
    if loaded:
        print('the run loaded forbidden modules: ' + ', '.join(loaded),
              file=sys.stderr)
        sys.exit(4)
    sys.stdout.flush()
    for k, v in out['checks'].items():
        print('check {} = {!r} limit {!r}'.format(k, v['value'], v['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
