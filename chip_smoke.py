#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Drives ``ciri_long_tpu_torch`` on the card in phases, one JSON line each,
and exits non-zero if any phase fails (none is caught and skipped):

1. device and build: the card, the CUDA kernel built from csrc/, and the
   native host cores built from native/ (``setup.py build_ext --inplace``);
2. kernel vs plain PyTorch on the card, exact, at one shape per TPU route
   it replaces (K1 bench 512x1024x4096, K2 8x256x512, K4 64x2048x512, K3
   4x8192x16384) plus N codes, mid-row PAD, all-PAD rows and
   SWParams(1,1,1,1): (score, q_end, r_end) and the five sw_align_batch
   fields;
3. kernel and plain GCUPS at the bench shape and the 1024x1024 square
   (CUDA events, each launch fed by the previous one's scores);
4. ``call`` end to end on a seeded 2 Mb world (16 loci, depth 60, 240
   linear reads), ``--device cuda`` then ``--device cpu``: the kernel's
   launch count, byte-identical cand_circ.fa, equal counters, reads/s,
   per-stage seconds and BSJ recall/precision against the simulated truth;
   then the kernel against the plain version on the inputs the cuda run
   gave it.

Then the card's ``nvidia-smi`` name and power limit, the kernels line, and
last ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2
and prints no result.  Its files go under build/chip_smoke/.
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
KERNEL_SOURCE = 'ciri_long_tpu_torch/csrc/sw_score_ends.cu'
REPLACES = ('ciri_long_tpu/ops/sw_pallas.py:355 _sw_chain_kernel (K1); '
            'also :240 K2, :141 K3, :58 K4')
BENCH = (512, 1024, 4096)


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def codes(rng, B, L, pad_suffix=False):
    """Random codes A/C/G/T/N with a random PAD suffix per row."""
    import numpy as np
    x = rng.integers(0, 5, (B, L)).astype(np.int8)
    if pad_suffix:
        for b in range(B):
            x[b, int(rng.integers(max(1, L // 2), L + 1)):] = 5
    return x


def phase_build(torch):
    from ciri_long_tpu_torch.ops import _build
    from ciri_long_tpu_torch.utils.dispatch import resolve_device

    dev = resolve_device('cuda')
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.build('sw_score_ends.cu')
    kernel_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             _build.BUILD_LOGS.get('sw_score_ends.cu', '').splitlines()
             if 'registers' in ln or 'spill' in ln]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, 'setup.py', 'build_ext',
                           '--inplace'], cwd=ROOT, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError('native build failed:\n' + proc.stdout[-3000:]
                           + proc.stderr[-3000:])
    native_s = time.perf_counter() - t0
    importlib.invalidate_caches()
    from ciri_long_tpu_torch.ops.sw import _alncore
    if _alncore() is None:
        raise RuntimeError('native host cores did not load after the build')
    emit('build', device=torch.cuda.get_device_name(dev), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         kernel_build_s=round(kernel_s, 3), ptxas=ptxas,
         native_build_s=round(native_s, 3))
    return dev, smi


def compare(torch, dev, q, r, params, label):
    """Kernel vs plain on the card: scores/ends and the five
    sw_align_batch fields, exact.  Returns the max abs difference."""
    from ciri_long_tpu_torch.ops.sw import (_sw_align_fused, sw_score_ends,
                                            sw_score_ends_cuda)
    qt = torch.as_tensor(q).to(dev).contiguous()
    rt = torch.as_tensor(r).to(dev).contiguous()
    got = sw_score_ends_cuda(qt, rt, params)
    want = sw_score_ends(qt, rt, params)
    got5 = _sw_align_fused(qt, rt, params, score_fn=sw_score_ends_cuda)
    want5 = _sw_align_fused(qt, rt, params, score_fn=sw_score_ends)
    torch.cuda.synchronize(dev)
    err = max(int((a.long() - b.long()).abs().max().item()) if a.numel()
              else 0 for a, b in zip(got + got5, want + want5))
    emit('kernel_vs_plain', case=label, B=int(q.shape[0]),
         Lq=int(q.shape[1]), Lr=int(r.shape[1]), params=list(params),
         max_abs_err=err, positive=int((got[0] > 0).sum().item()))
    if err != 0:
        raise AssertionError('kernel disagrees with plain on ' + label)
    return err


def phase_kernel(torch, dev):
    import numpy as np
    from ciri_long_tpu_torch.ops.sw import SWParams

    rng = np.random.default_rng(20261016)
    big = SWParams(10, 4, 8, 2)
    clip = SWParams(1, 1, 1, 1)
    err = 0
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
        err = max(err, compare(torch, dev, q, r, params, label))
    q = codes(rng, 16, 70)
    r = codes(rng, 16, 333)
    q[:, 10] = 5
    r[:, 100:103] = 5
    r[3] = 5
    q[4] = 5
    err = max(err, compare(torch, dev, q, r, clip, 'N, mid-row PAD, all-PAD'))
    return err


def gcups(torch, fn, q, r, params, n_iter):
    """Cells per second of ``fn`` over n_iter dependent launches."""
    carry = q.clone()
    score = fn(carry, r, params)[0]          # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        score = fn(carry, r, params)[0]
        # a genuine data dependency: codes 0-3 xor 1 stay 0-3
        carry = carry ^ (score & 1).to(torch.int8)[:, None]
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / n_iter
    B, Lq = q.shape
    return B * Lq * r.shape[1] / (ms * 1e-3) / 1e9, ms


def phase_time(torch, dev, smi):
    import numpy as np
    from ciri_long_tpu_torch.ops.sw import (SWParams, sw_score_ends,
                                            sw_score_ends_cuda)

    rng = np.random.default_rng(0)
    params = SWParams(10, 4, 8, 2)
    out = {}
    for name, (B, Lq, Lr) in [('bench', BENCH), ('square', (512, 1024, 1024))]:
        q = torch.from_numpy(rng.integers(0, 4, (B, Lq)).astype(np.int8))
        r = torch.from_numpy(rng.integers(0, 4, (B, Lr)).astype(np.int8))
        q, r = q.to(dev), r.to(dev)
        k_gcups, k_ms = gcups(torch, sw_score_ends_cuda, q, r, params, 20)
        p_gcups, p_ms = gcups(torch, sw_score_ends, q, r, params, 3)
        out[name] = dict(kernel_ms=k_ms, plain_ms=p_ms)
        emit('kernel_time', shape=name, B=B, Lq=Lq, Lr=Lr,
             kernel_gcups=k_gcups, kernel_ms=k_ms, plain_gcups=p_gcups,
             plain_ms=p_ms, card=smi)
    return out['bench']


def run_call(device, world, out_dir):
    from ciri_long_tpu_torch.cli.main import main
    main(['call', '-i', world['reads'], '-o', out_dir, '-r', world['ref'],
          '-p', 'smoke', '-t', '1', '--device', device])
    with open(os.path.join(out_dir, 'smoke.json')) as f:
        return json.load(f)


def phase_call(torch, dev, smi):
    from ciri_long_tpu_torch.ops import sw
    from ciri_long_tpu_torch.tools.world import bsj_accuracy, make_world
    from ciri_long_tpu_torch.utils.dispatch import (launch_counts,
                                                    reset_launches)

    shutil.rmtree(WORK, ignore_errors=True)
    ref, reads, truth = make_world(os.path.join(WORK, 'world'),
                                   genome_kb=2000, loci=16, depth=60,
                                   linear=240, seed=0)
    world = dict(ref=ref, reads=reads)
    with open(reads) as f:
        n_reads = sum(1 for ln in f if ln.startswith('>'))

    # record the inputs the main path hands the kernel (launch counts are
    # kept by the wrapper itself; the recorder only copies its arguments)
    seen = []
    kernel = sw.sw_score_ends_cuda

    def recorder(query, ref_, params):
        if len(seen) < 6:
            seen.append((query.clone(), ref_.clone(), params))
        return kernel(query, ref_, params)

    sw.sw_score_ends_cuda = recorder
    try:
        reset_launches()
        t0 = time.perf_counter()
        gpu = run_call('cuda', world, os.path.join(WORK, 'out_cuda'))
        gpu_s = time.perf_counter() - t0
        launches = launch_counts()
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
    emit('call', reads=n_reads, genome_kb=2000, loci=16, depth=60,
         profile='nanopore', launches=launches,
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
    if cpu['kernels'] != {'sw_score_ends': 0}:
        raise AssertionError('the --device cpu summary counts launches: '
                             '{}'.format(cpu['kernels']))
    if cand[0] != cand[1] or counters[0] != counters[1]:
        raise AssertionError('call differs between --device cuda and cpu')
    if not cand[0] or recall <= 0:
        raise AssertionError('call found no BSJ of the simulated truth')

    err = 0
    for t, (q, r, params) in enumerate(seen):
        err = max(err, compare(torch, dev, q.cpu().numpy(), r.cpu().numpy(),
                               params, 'main path launch {}'.format(t)))
    return launches['sw_score_ends'], err


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch {}, CUDA build {})'.format(
            torch.__version__, torch.version.cuda), file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    dev, smi = phase_build(torch)
    err = phase_kernel(torch, dev)
    bench = phase_time(torch, dev, smi)
    launches, call_err = phase_call(torch, dev, smi)
    print(smi)
    print(json.dumps({'kernels': [{
        'name': 'sw_score_ends', 'route': 'cuda', 'source': KERNEL_SOURCE,
        'replaces': REPLACES, 'launches': launches,
        'max_abs_err': max(err, call_err), 'ms': bench['kernel_ms'],
        'plain_ms': bench['plain_ms']}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
