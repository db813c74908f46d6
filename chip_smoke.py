#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Drives ``ciri_long_tpu_torch`` on the card in phases, one JSON line each,
and exits non-zero if any phase fails (none is caught and skipped):

1. device and build: the card, the CUDA kernels built from csrc/, and the
   native host cores built from native/ (``setup.py build_ext --inplace``);
2. every SW kernel (sw_score_ends routed, and each of its two routes
   forced where it takes the shape; sw_rowscan, sw_chain C = 2 and 4)
   against one plain PyTorch output per case on the card, exact, at one
   shape per TPU route sw_score_ends replaces (K1 bench 512x1024x4096, K2
   8x256x512, K4 64x2048x512, K3 4x8192x16384) plus N codes, mid-row PAD,
   all-PAD rows and SWParams(1,1,1,1): (score, q_end, r_end), and for
   sw_score_ends the five sw_align_batch fields; then sw_score_ends's
   routes on tools/sw_cases.py's tile cases at the main path's
   64x28x16384 and 128x54x16384 and at 37x33x5000, under three SWParams;
3. kernel and plain GCUPS at the bench shape and the 1024x1024 square
   (the kernel's launches replayed from a CUDA graph, the plain version's
   wall, each launch fed by the previous one's scores);
4. ``call`` end to end on a seeded 2 Mb world (16 loci, depth 60, 240
   linear reads), ``--device cuda`` then ``--device cpu``: the kernel's
   launch count and the route of each launch (every launch whose shape
   ops/sw.py::_tile_plan accepts must take the tiled route),
   byte-identical cand_circ.fa, equal counters, reads/s, per-stage seconds
   and BSJ recall/precision against the simulated truth; then both routes
   against the plain version on the inputs the cuda run gave the kernel,
   and both timed on them;
5. the kernel-probe path: the SW variant harness
   (``python -m ciri_long_tpu_torch.misc.kexp``) for the row, wave and
   chain (C = 2, 4) families at the bench shape and the int16 probes
   (``...misc.int16_probe``), through their entry points, with the launch
   counts read around them; then each int16 probe exact against its plain
   version on the TPU probe's input, on negative lanes and on lanes that
   wrap; the card's peak rate for one SW cell update (csrc/op_rate.cu, the
   SW bound); and the times of every family beside the plain version and
   the bound at 512x1024x4096, 512x1024x1024, the main path's 64x28x16384
   and 128x54x16384, and 4096x32x128 (sw_score_ends routed and by each
   route that takes the shape; at the main path's shapes also the tiled
   route at tiles of one and two halos beside the rule's four), and of
   each probe.

The five CUDA sources build in parallel (one nvcc each) beside the native
host cores.  Then the card's ``nvidia-smi`` name and power limit, the
kernels line (sw_score_ends's entry also has ``main_ms`` and
``main_bound_ms`` at 128x54x16384), and last ``{"ok": true, "device":
{...}}``.  Without a CUDA
device it exits 2 and prints no result.  Its files go under
build/chip_smoke/.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, 'build', 'chip_smoke')
CSRC = 'ciri_long_tpu_torch/csrc/'
SOURCES = ('sw_score_ends.cu', 'sw_rowscan.cu', 'sw_chain.cu',
           'int16_probe.cu', 'op_rate.cu')
TILE_CASES = ((64, 28, 16384), (128, 54, 16384), (37, 33, 5000))
TILE_PARAMS = ((1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1))
TILE_RULES = (1, 2)        # tile widths in halos timed beside the rule's
REPLACES = {
    'sw_score_ends': ('ciri_long_tpu/ops/sw_pallas.py:355 _sw_chain_kernel '
                      '(K1); also :240 K2, :141 K3, :58 K4; misc/kexp.py:1534 '
                      'wave family (K6)'),
    'sw_rowscan': ('misc/kexp.py:1586 make_call row family, build_kernel:1065 '
                   'and build_kernel_r3:31 (K5)'),
    'sw_chain': ('misc/kexp.py:1462 make_call chain family, '
                 'build_kernel_chain:534, _chain7:694, _chain9:875, '
                 '_chain10:1222 (K7)'),
    'int16_probe': 'misc/int16_probe.py:41 run, kernel bodies :20-37 (K8)',
}
BENCH = (512, 1024, 4096)
TIMED = (('bench', BENCH), ('square', (512, 1024, 1024)),
         ('main64', (64, 28, 16384)), ('main128', (128, 54, 16384)),
         ('short', (4096, 32, 128)))


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def codes(rng, B, L, pad_suffix=False):
    """Random codes A/C/G/T/N with a random PAD suffix per row."""
    import numpy as np
    x = rng.integers(0, 5, (B, L)).astype(np.int8)
    if pad_suffix:
        for b in range(B):
            x[b, int(rng.integers(max(1, L // 2), L + 1)):] = 5
    return x


def phase_build(torch):
    from ciri_long_tpu_torch.misc.kexp import nvidia_smi
    from ciri_long_tpu_torch.ops import _build
    from ciri_long_tpu_torch.utils.dispatch import resolve_device

    dev = resolve_device('cuda')
    smi = nvidia_smi()
    t0 = time.perf_counter()
    native = subprocess.Popen(
        [sys.executable, 'setup.py', 'build_ext', '--inplace', '-j',
         str(os.cpu_count() or 1)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _build.build_all(SOURCES)
        kernel_s = time.perf_counter() - t0
    finally:
        native_log = native.communicate()[0]
    ptxas = {src: [ln.strip() for ln in
                   _build.BUILD_LOGS.get(src, '').splitlines()
                   if 'registers' in ln or 'spill' in ln or 'smem' in ln]
             for src in SOURCES}
    if native.returncode != 0:
        raise RuntimeError('native build failed:\n' + native_log[-6000:])
    native_s = time.perf_counter() - t0
    importlib.invalidate_caches()
    from ciri_long_tpu_torch.ops.sw import _alncore
    if _alncore() is None:
        raise RuntimeError('native host cores did not load after the build')
    emit('build', device=torch.cuda.get_device_name(dev), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         kernels_build_s=round(kernel_s, 3), ptxas=ptxas,
         native_build_s=round(native_s, 3))
    return dev, smi


def _max_err(got, want):
    return max(int((a.long() - b.long()).abs().max().item()) if a.numel()
               else 0 for a, b in zip(got, want))


def compare(torch, dev, q, r, params, label, kernels):
    """Each SW kernel of ``kernels`` ((name, fn) of sw_kernels) against
    one plain output of the case on the card, exact: (score, q_end, r_end),
    and for the first kernel also the five sw_align_batch fields.  Returns
    {name: max abs difference}."""
    from ciri_long_tpu_torch.ops.sw import _sw_align_fused, sw_score_ends
    qt = torch.as_tensor(q).to(dev).contiguous()
    rt = torch.as_tensor(r).to(dev).contiguous()
    want = sw_score_ends(qt, rt, params)
    errs = {name: _max_err(fn(qt, rt, params), want) for name, fn in kernels}
    name, fn = kernels[0]
    errs[name] = max(errs[name], _max_err(
        _sw_align_fused(qt, rt, params, score_fn=fn),
        _sw_align_fused(qt, rt, params, score_fn=sw_score_ends)))
    torch.cuda.synchronize(dev)
    emit('kernel_vs_plain', case=label, B=int(q.shape[0]),
         Lq=int(q.shape[1]), Lr=int(r.shape[1]), params=list(params),
         max_abs_err=errs, positive=int((want[0] > 0).sum().item()))
    if any(errs.values()):
        raise AssertionError('a kernel disagrees with plain on ' + label)
    return errs


def kernel_cases():
    """(label, q, r, params) of phase 2: one shape per TPU route K1-K4
    with PAD suffixes, a mid-row PAD and an all-PAD row, then N codes.
    Every B is a multiple of 4, so the chain takes each case with C = 2
    and 4."""
    import numpy as np
    from ciri_long_tpu_torch.ops.sw import SWParams

    rng = np.random.default_rng(20261016)
    big = SWParams(10, 4, 8, 2)
    clip = SWParams(1, 1, 1, 1)
    cases = []
    for label, B, Lq, Lr, params in [
            ('K1 chained wavefront (bench shape)', *BENCH, big),
            ('K2 wave5 small batch', 8, 256, 512, clip),
            ('K4 query-dominated scan', 64, 2048, 512, clip),
            ('K3 wave5 overflow', 4, 8192, 16384, big)]:
        q = codes(rng, B, Lq, pad_suffix=True)
        r = codes(rng, B, Lr, pad_suffix=True)
        q[0, Lq // 3] = 5          # mid-row PAD
        r[0, Lr // 2] = 5
        r[1] = 5                   # all-PAD row
        cases.append((label, q, r, params))
    q = codes(rng, 16, 70)
    r = codes(rng, 16, 333)
    q[:, 10] = 5
    r[:, 100:103] = 5
    r[3] = 5
    q[4] = 5
    cases.append(('N, mid-row PAD, all-PAD', q, r, clip))
    return cases


def tile_cases():
    """(label, q, r, params) of phase 2's tile cases: tools/sw_cases.py's
    rows planted around the tile edges _tile_plan gives each shape."""
    import numpy as np
    from ciri_long_tpu_torch.ops.sw import SWParams, _tile_plan
    from ciri_long_tpu_torch.tools.sw_cases import tile_cases as make

    rng = np.random.default_rng(4)
    cases = []
    for B, Lq, Lr in TILE_CASES:
        for params in (SWParams(*p) for p in TILE_PARAMS):
            q, r = make(rng, B, Lq, Lr, _tile_plan(Lq, Lr, params)[0],
                        params)
            cases.append(('tile cases', q, r, params))
    return cases


def phase_kernel(torch, dev):
    """Every SW kernel against one plain output per case, then
    sw_score_ends's routes on the tile cases; {name: max err}."""
    errs = {}
    runs = [(case, sw_kernels) for case in kernel_cases()]
    runs += [(case, sw_routes) for case in tile_cases()]
    for (label, q, r, params), kernels in runs:
        for name, err in compare(torch, dev, q, r, params, label,
                                 kernels(q.shape[1], r.shape[1],
                                         params)).items():
            errs[name] = max(errs.get(name, 0), err)
    return errs


def phase_time(torch, dev, smi):
    import numpy as np
    from ciri_long_tpu_torch.misc.kexp import gcups
    from ciri_long_tpu_torch.ops.sw import (SWParams, sw_score_ends,
                                            sw_score_ends_cuda)

    rng = np.random.default_rng(0)
    params = SWParams(10, 4, 8, 2)
    for name, (B, Lq, Lr) in [('bench', BENCH), ('square', (512, 1024, 1024))]:
        q = torch.from_numpy(rng.integers(0, 4, (B, Lq)).astype(np.int8))
        r = torch.from_numpy(rng.integers(0, 4, (B, Lr)).astype(np.int8))
        q, r = q.to(dev), r.to(dev)
        k_gcups, k_ms = gcups(sw_score_ends_cuda, q, r, params, 20,
                              graph=True)
        p_gcups, p_ms = gcups(sw_score_ends, q, r, params, 3)
        emit('kernel_time', shape=name, B=B, Lq=Lq, Lr=Lr,
             kernel_gcups=k_gcups, kernel_ms=k_ms, plain_gcups=p_gcups,
             plain_ms=p_ms, card=smi)


def run_call(device, world, out_dir):
    from ciri_long_tpu_torch.cli.main import main
    main(['call', '-i', world['reads'], '-o', out_dir, '-r', world['ref'],
          '-p', 'smoke', '-t', '1', '--device', device])
    with open(os.path.join(out_dir, 'smoke.json')) as f:
        return json.load(f)


def phase_call(torch, dev, smi):
    from ciri_long_tpu_torch.ops import sw
    from ciri_long_tpu_torch.tools.world import bsj_accuracy, make_world
    from ciri_long_tpu_torch.utils.dispatch import (CALL_KERNELS, ROUTES,
                                                    launch_counts,
                                                    reset_launches)

    shutil.rmtree(WORK, ignore_errors=True)
    ref, reads, truth = make_world(os.path.join(WORK, 'world'),
                                   genome_kb=2000, loci=16, depth=60,
                                   linear=240, seed=0)
    world = dict(ref=ref, reads=reads)
    with open(reads) as f:
        n_reads = sum(1 for ln in f if ln.startswith('>'))

    # record the inputs the main path hands the kernel (launch and route
    # counts are kept by the wrapper itself; the recorder only copies its
    # arguments)
    seen = []
    kernel = sw.sw_score_ends_cuda

    def recorder(query, ref_, params):
        seen.append((query.clone(), ref_.clone(), params))
        return kernel(query, ref_, params)

    sw.sw_score_ends_cuda = recorder
    try:
        reset_launches()
        t0 = time.perf_counter()
        gpu = run_call('cuda', world, os.path.join(WORK, 'out_cuda'))
        gpu_s = time.perf_counter() - t0
        launches = launch_counts(CALL_KERNELS)
        routes = dict(ROUTES)
    finally:
        sw.sw_score_ends_cuda = kernel
    t0 = time.perf_counter()
    cpu = run_call('cpu', world, os.path.join(WORK, 'out_cpu'))
    cpu_s = time.perf_counter() - t0

    cand = [Path(WORK, d, 'smoke.cand_circ.fa').read_bytes()
            for d in ('out_cuda', 'out_cpu')]
    counters = [{k: v for k, v in s.items() if k not in ('timing', 'kernels')}
                for s in (gpu, cpu)]
    recall, precision, n_called = bsj_accuracy(
        os.path.join(WORK, 'out_cuda', 'smoke.cand_circ.fa'), truth)
    shapes = [[int(q.shape[0]), int(q.shape[1]), int(r.shape[1]),
               list(p), sw._tile_plan(q.shape[1], r.shape[1], p) is not None]
              for q, r, p in seen]
    emit('call', reads=n_reads, genome_kb=2000, loci=16, depth=60,
         profile='nanopore', launches=launches, routes=routes,
         launch_shapes=shapes,
         summary_kernels=gpu['kernels'],
         cpu_summary_kernels=cpu['kernels'], cand_identical=cand[0] == cand[1],
         cand_bytes=len(cand[0]), counters_equal=counters[0] == counters[1],
         counters=counters[0], cuda_wall_s=gpu_s,
         cuda_reads_per_s=n_reads / gpu_s, cpu_wall_s=cpu_s,
         cpu_reads_per_s=n_reads / cpu_s, cuda_timing=gpu['timing'],
         cpu_timing=cpu['timing'], bsj_recall=recall,
         bsj_precision=precision, called_loci=n_called, tolerance_bp=5,
         card=smi)
    if launches['sw_score_ends'] <= 0 or gpu['kernels'] != launches:
        raise AssertionError('call did not go through the SW kernel')
    planned = sum(tiled for *_, tiled in shapes)
    if (len(seen) != launches['sw_score_ends'] or planned == 0
            or routes != {'tiled': planned, 'wave': len(seen) - planned}):
        raise AssertionError('call did not take the tiled route where its '
                             'plan applies: {} {}'.format(routes, shapes))
    if cpu['kernels'] != {'sw_score_ends': 0}:
        raise AssertionError('the --device cpu summary counts launches: '
                             '{}'.format(cpu['kernels']))
    if cand[0] != cand[1] or counters[0] != counters[1]:
        raise AssertionError('call differs between --device cuda and cpu')
    if not cand[0] or recall <= 0:
        raise AssertionError('call found no BSJ of the simulated truth')

    err = 0
    for t, (q, r, params) in enumerate(seen):
        routes_ = sw_routes(q.shape[1], r.shape[1], params)
        err = max([err] + list(compare(
            torch, dev, q.cpu().numpy(), r.cpu().numpy(), params,
            'main path launch {}'.format(t), routes_).values()))
    return launches['sw_score_ends'], err, seen


def phase_call_time(torch, dev, smi, seen):
    """Both routes of sw_score_ends on each input the main path gave it
    (a CUDA graph's replay of 10 launches each), summed over the launches.
    Returns {route name: ms}."""
    from ciri_long_tpu_torch.misc.kexp import gcups

    total = {}
    for t, (q, r, params) in enumerate(seen):
        times = {name: gcups(fn, q, r, params, 10, graph=True)[1]
                 for name, fn in sw_routes(q.shape[1], r.shape[1], params)}
        emit('call_sw_time', launch=t, B=int(q.shape[0]), Lq=int(q.shape[1]),
             Lr=int(r.shape[1]), params=list(params), ms=times, card=smi)
        for name, ms in times.items():
            total[name] = total.get(name, 0.0) + ms
    emit('call_sw_time', launches=len(seen), total_ms=total, card=smi)
    return total


def sw_routes(Lq, Lr, params):
    """(name, kernel) of sw_score_ends: routed, then the wavefront forced,
    then the tiled route forced where _tile_plan takes the shape."""
    from ciri_long_tpu_torch.ops.sw import (_tile_plan, sw_score_ends_cuda,
                                            sw_score_ends_tiled_cuda,
                                            sw_score_ends_wave_cuda)

    routes = [('sw_score_ends', sw_score_ends_cuda),
              ('sw_score_ends wave', sw_score_ends_wave_cuda)]
    if _tile_plan(Lq, Lr, params) is not None:
        routes.append(('sw_score_ends tiled', sw_score_ends_tiled_cuda))
    return routes


def sw_kernels(Lq, Lr, params):
    """(name, kernel) of every SW design family on the card."""
    from ciri_long_tpu_torch.misc.kexp import sw_chain_cuda, sw_rowscan_cuda

    return sw_routes(Lq, Lr, params) + [
        ('sw_rowscan', sw_rowscan_cuda),
        ('sw_chain C=2', lambda q, r, p: sw_chain_cuda(q, r, p, 2)),
        ('sw_chain C=4', lambda q, r, p: sw_chain_cuda(q, r, p, 4))]


def phase_probe_path():
    """The kernel-probe path through its entry points: the harness for each
    family at the bench shape, then the int16 probes.  Returns the launch
    counts of that run."""
    from ciri_long_tpu_torch.misc import int16_probe, kexp
    from ciri_long_tpu_torch.utils.dispatch import (launch_counts,
                                                    reset_launches)

    B, Lq, Lr = BENCH
    shape = ['--B', str(B), '--Lq', str(Lq), '--Lr', str(Lr), '--iters', '8']
    reset_launches()
    lines = [kexp.main(flags + shape) for flags in
             (['--r3'], ['--wave'], ['--chain', '2'], ['--chain', '4'])]
    int16_probe.main(['--device', 'cuda'])
    launches = launch_counts()
    emit('probe_path', launches=launches,
         kexp=[dict(l['variant'], gcups=l['gcups'], ms=l['ms'],
                    bound_ms=l['bound_ms']) for l in lines])
    if min(launches.values()) <= 0:
        raise AssertionError('the probe path missed a kernel: {}'.format(
            launches))
    return launches


def phase_probe_exact(torch, dev):
    """Every int16 probe against its plain version on each of its
    ``probe_cases`` (the TPU probe's input, negative lanes, wrapping lanes).
    Exact, or it raises; returns the max abs difference."""
    from ciri_long_tpu_torch.misc.int16_probe import (PROBES,
                                                      int16_probe_cuda,
                                                      probe_cases)

    worst = 0
    for probe in PROBES:
        for label, x in probe_cases(probe, dev):
            err = _max_err([int16_probe_cuda(probe, x)], [probe.plain(x)])
            emit('probe_exact', probe=probe.name, case=label,
                 shape=list(probe.shape), max_abs_err=err)
            worst = max(worst, err)
    if worst:
        raise AssertionError('an int16 probe disagrees with its plain version')
    return worst


def phase_probe_time(torch, dev, smi):
    """The card's peak cell rate in both forms (the SW bound), the SW
    families and the plain version at each TIMED shape with the harness's
    dependent launches, and the int16 probes with independent launches,
    each beside its bound.  Kernel and library times are a CUDA graph's
    replay (``kexp.time_launches``: the card's time without the host's
    cost per launch), plain times the wall of the calls."""
    import numpy as np
    from ciri_long_tpu_torch.misc.int16_probe import (PROBES,
                                                      int16_probe_cuda,
                                                      probe_input)
    from ciri_long_tpu_torch.misc.kexp import (HBM_BYTES_PER_S, PARAMS,
                                               cell_rate, gcups, sw_bound,
                                               time_launches)
    from ciri_long_tpu_torch.ops.sw import (_tile_plan, sw_score_ends,
                                            sw_score_ends_tiled_cuda)

    rates = {'dpx': cell_rate(dev, True), 'plain': cell_rate(dev, False)}
    rate = max(rates.values())
    emit('cell_rate', cells_per_s=rates,
         sms=torch.cuda.get_device_properties(dev).multi_processor_count,
         card=smi)
    rng = np.random.default_rng(1)
    sw = {}
    for shape, (B, Lq, Lr) in TIMED:
        q = torch.from_numpy(rng.integers(0, 4, (B, Lq)).astype(np.int8))
        r = torch.from_numpy(rng.integers(0, 4, (B, Lr)).astype(np.int8))
        q, r = q.to(dev), r.to(dev)
        plain_gcups, plain_ms = gcups(sw_score_ends, q, r, PARAMS, 2)
        bound_ms, bound_by = sw_bound(B, Lq, Lr, rate)
        sw[shape] = dict(plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        for name, fn in sw_kernels(Lq, Lr, PARAMS):
            k_gcups, k_ms = gcups(fn, q, r, PARAMS, 10, graph=True)
            sw[shape][name] = k_ms
            emit('probe_time', shape=shape, B=B, Lq=Lq, Lr=Lr, kernel=name,
                 ms=k_ms, gcups=k_gcups, plain_ms=plain_ms,
                 plain_gcups=plain_gcups, bound_ms=bound_ms,
                 bound_by=bound_by, bound_share=bound_ms / k_ms, card=smi)
        for halos in TILE_RULES if shape.startswith('main') else ():
            plan = _tile_plan(Lq, Lr, PARAMS, halos)
            k_gcups, k_ms = gcups(
                lambda q_, r_, p: sw_score_ends_tiled_cuda(q_, r_, p, plan),
                q, r, PARAMS, 10, graph=True)
            emit('tile_rule', shape=shape, B=B, Lq=Lq, Lr=Lr, halos=halos,
                 T=plan[0], halo=plan[1], ms=k_ms, gcups=k_gcups,
                 bound_ms=bound_ms, card=smi)
    probes = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for probe in PROBES:
        x = probe_input(probe, dev)
        t = dict(ms=time_launches(lambda: int16_probe_cuda(probe, x), 200,
                                  dev, graph=True),
                 plain_ms=time_launches(lambda: probe.plain(x), 200, dev),
                 library_ms=time_launches(lambda: probe.plain(x), 200, dev,
                                          graph=True),
                 bound_ms=2 * x.numel() * x.element_size()
                 / HBM_BYTES_PER_S * 1e3)
        emit('probe_time', probe=probe.name, shape=list(probe.shape),
             bound_by='bytes', card=smi, **t)
        for key, ms in t.items():
            probes[key] += ms
    return sw, probes


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch {}, CUDA build {})'.format(
            torch.__version__, torch.version.cuda), file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    dev, smi = phase_build(torch)
    errs = phase_kernel(torch, dev)
    phase_time(torch, dev, smi)
    launches, call_err, seen = phase_call(torch, dev, smi)
    phase_call_time(torch, dev, smi, seen)
    probe_launches = phase_probe_path()
    probe_err = phase_probe_exact(torch, dev)
    sw, probes = phase_probe_time(torch, dev, smi)

    bench = sw['bench']
    main = sw['main128']

    def entry(name, n, max_err, ms, plain_ms=bench['plain_ms'],
              bound=bench['bound_ms'], by=bench['bound_by'],
              library_ms=None):
        return {'name': name, 'route': 'cuda', 'source': CSRC + name + '.cu',
                'replaces': REPLACES[name], 'launches': n,
                'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
                'bound_ms': bound, 'bound_by': by, 'library_ms': library_ms}

    # SW kernels at the bench shape (phase 5 has every shape); no PyTorch
    # call computes SW, so no library time.  sw_score_ends is launched by
    # call (phase 4), the others by the probe path (phase 5).
    # sw_score_ends also at the main path's 128x54x16384 (its tiled route)
    kernels = [
        dict(entry('sw_score_ends', launches,
                   max([call_err] + [err for name, err in errs.items()
                                     if name.startswith('sw_score_ends')]),
                   bench['sw_score_ends']),
             main_ms=main['sw_score_ends'], main_bound_ms=main['bound_ms']),
        entry('sw_rowscan', probe_launches['sw_rowscan'], errs['sw_rowscan'],
              bench['sw_rowscan']),
        entry('sw_chain', probe_launches['sw_chain'],
              max(errs['sw_chain C=2'], errs['sw_chain C=4']),
              bench['sw_chain C=4']),
        # the six probes summed; the library time is the card's own time of
        # the plain versions, each one PyTorch call
        entry('int16_probe', probe_launches['int16_probe'], probe_err,
              probes['ms'], probes['plain_ms'], probes['bound_ms'], 'bytes',
              probes['library_ms']),
    ]
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
