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
   64x28x16384 and 128x54x16384 and at 37x33x5000, and on its wavefront
   cases (every real query length at an edge of the wavefront's schedule
   against references of 1, 63, 64, 65 and 130 columns, N, mid-row PAD,
   all-PAD rows, equal-score twins across warps), under three SWParams;
   then a reference too wide for the handoff row in shared memory and a
   fused round of mixed real lengths under one padded shape; then the
   harness's chain and row scan on tools/sw_cases.py's chain jobs (best
   cell in a job's first and last column, all-PAD jobs, twins, N rows,
   queries longer than the references) and wavefront rows at the edges of
   the row scan's runs and warps: the chain at C = 1, 2, 4 and B, the row
   scan by its rule and at every width W of ROWSCAN_WIDTHS;
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
   route at tiles of one and two halos beside the rule's four; at the
   wavefront's shapes also the wavefront at 1, 2 and 4 query rows a lane,
   ``wave_rows``; at every shape the chain at C = 2 and 4 by each R of
   1, 2 and 4, ``chain_rows``, and the row scan at each width W,
   ``rowscan_widths``), and of each probe; then the six probes in one
   launch (``int16_probe_all``) beside the six launches and the six
   PyTorch calls;
6. collapse's three kernels, csrc/edit_distance.cu, csrc/sw_traceback.cu
   and csrc/poa_align.cu, against their plain versions on
   tools/collapse_cases.py's and tools/poa_cases.py's cases (random codes
   with N and PAD, empty and one-base rows, equal-score ties, jobs that
   score 0, references and pairs longer than one strip, lengths at the
   edges of a word, of a warp's words and of a strip, a fused round of
   one-word and multi-word pairs, jobs over a block's shared memory; for
   the POA graphs of fused mutated reads, one-node graphs, empty
   sequences, identical copies, indel-heavy reads, in-degree 12 and 130,
   long back edges, mixed sizes and sequences at the edges of its run
   widths and tiles), exact, every route of each kernel launched (ROUTES);
7. ``collapse`` end to end on phase 4's cand_circ.fa, ``--device cuda``
   then ``--device cpu``: the launches of sw_score_ends (by route),
   edit_distance, sw_traceback and poa_align (all > 0 on cuda, all 0 on
   cpu), byte-identical .info, .reads, .expression and .isoforms, equal
   corrected clusters and counters (tmp/*.corrected.pkl), the wall of each
   run, the launches of each kernel's routes, and the seconds spent in its
   SW, edit-distance, traceback and POA calls (summed over its threads; the
   POA split into the junction consensus, ``poa``, and the sub-cluster
   consensus, ``poa_consensus_many``), the traceback calls split into their
   stages (pack, upload, plan, launch, download and wait, tb_results: wall
   and thread CPU seconds);
   then every edit and traceback launch and the four largest SW launches
   of the cuda run against the plain versions on their inputs; every
   sub-cluster job of the cuda run replayed through the native ``poa``,
   byte-identical; poa_align's device time summed over the run (CUDA
   events around each launch, in the run) and its largest launch, its
   inputs kept by replaying its call (ops/poa.py::poa_launch_inputs),
   checked against the plain version and timed beside it and the bound
   (operations or the direction words' bytes); then its SW
   launches split by route (wave, tiled): launches, summed device time (a
   CUDA graph's replay of each recorded input) and, at each route's
   largest launch, its shapes, ms, plain ms and bound;
8. ``collapse`` at full size, the cohort of benchmarks/collapse_bench.py's
   defaults (4000 reads of 16 loci on a 2 Mb genome, seed 0; its ``call``
   first), the checks of phase 7 and the walls; the card's rate for each
   kernel's update (csrc/op_rate.cu: the SW cell, the traceback cell, the
   edit distance's 32-row word and, for comparison, its DP cell); each
   kernel's device time summed over the launches the cuda run made (a CUDA
   graph's replay of each recorded input, with its route plan made
   beforehand) and, at its largest launch, its time, the plain version's
   and the bound, after that launch's check against the plain version;
   the SW launches split by route as in phase 7, the largest wavefront
   launch also at 1, 2 and 4 query rows a lane, and the wavefront launches'
   inputs saved to build/chip_smoke/cohort_wave_inputs.pt (what
   ``python3 -m ciri_long_tpu_torch.tools.wave_ab`` times in two
   checkouts).

The eight CUDA sources build in parallel (one nvcc each) beside the native
host cores.  Then the card's ``nvidia-smi`` name and power limit, the
kernels line (sw_score_ends's entry also has ``main_ms`` and
``main_bound_ms`` at 128x54x16384, its collapse launches and device
time and, for the cohort's wavefront launches, ``wave_device_ms`` summed
over them, ``wave_ms`` and ``wave_bound_ms`` at the largest, and the
wavefront's plans and times by rows a lane there and at the bench shape;
sw_rowscan's and sw_chain's entries also have their ms at every phase-5
shape, ``shapes_ms``, and their plan variants' ms, ``plans_ms``;
int16_probe_all's the one launch of phase 5; edit_distance's,
sw_traceback's and poa_align's numbers are those of their largest launch in
phase 8, with their route counts, edit_distance's ``cell_bound_ms`` the
bound of one DP cell an update, the measure of a cell-by-cell design, and
poa_align's device time summed over the cohort's launches and its phase-7
numbers), and last ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits 2 and prints no result.  Its files go under
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
WAVE_INPUTS = os.path.join(WORK, 'cohort_wave_inputs.pt')
CSRC = 'ciri_long_tpu_torch/csrc/'
SOURCES = ('sw_score_ends.cu', 'sw_rowscan.cu', 'sw_chain.cu',
           'int16_probe.cu', 'op_rate.cu', 'edit_distance.cu',
           'sw_traceback.cu', 'poa_align.cu')
TILE_CASES = ((64, 28, 16384), (128, 54, 16384), (37, 33, 5000))
TILE_PARAMS = ((1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1))
TILE_RULES = (1, 2)        # tile widths in halos timed beside the rule's
# query rows a lane of the wavefront timed at the bench shape and at
# collapse's largest wavefront launch
WAVE_R_TIMED = (1, 2, 4)
# a reference whose (H, F) handoff row, 8 bytes a column, passes a block's
# shared memory (232 448 bytes): the wavefront keeps it in global memory
WAVE_GLOBAL_LR = 30000
# rows enough that the wavefront gives each one warp (ops/sw.py::WAVE_FILL)
# while its query spans two strips: eight rows a block, a handoff row each
WAVE_MANY_ROWS = 4400
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
    'int16_probe_all': ('misc/int16_probe.py:41 run, kernel bodies :20-37 '
                        '(K8), all six probes in one launch'),
    'edit_distance': ('ciri_long_tpu/ops/edit.py:28 '
                      'edit_distance_batch_padded, an XLA program (X7)'),
    'sw_traceback': ('ciri_long_tpu/ops/sw_tb_batch.py:44 _align_one, :237 '
                     'sw_traceback_batch, an XLA program (X5)'),
    'poa_align': ('ciri_long_tpu/ops/poa_batch.py:39 _align_one, :194 '
                  '_align_one_win, :391 poa_align_batch, an XLA program '
                  '(X6)'),
}
# benchmarks/collapse_bench.py's defaults
COHORT = dict(reads=4000, genome_kb=2000, loci=16, seed=0)
COLLAPSE_FILES = ('info', 'reads', 'expression', 'isoforms')
# the routes of collapse's two kernels (utils/dispatch.py::ROUTES)
COLLAPSE_ROUTES = ('edit_thread', 'edit_warp', 'tb_smem', 'tb_global')
SW_CHECKED = 4             # the largest SW launches of a collapse run checked
PROBE_KERNELS = ('sw_score_ends', 'sw_rowscan', 'sw_chain', 'int16_probe',
                 'int16_probe_all')
BENCH = (512, 1024, 4096)
TIMED = (('bench', BENCH), ('square', (512, 1024, 1024)),
         ('main64', (64, 28, 16384)), ('main128', (128, 54, 16384)),
         ('short', (4096, 32, 128)))
# the harness's chain: C jobs a stream timed, and query rows a lane timed
# beside the rule's
CHAIN_C_TIMED = (2, 4)
CHAIN_R_TIMED = (1, 2, 4)
# phase 2's chain jobs (B, Lq, Lr): one strip and several, Lq far above
# Lr, a reference of one chunk and of several; every B divisible by 4
CHAIN_SHAPES = ((28, 40, 7), (64, 150, 33), (32, 1100, 300),
                (8, 70, 2000))
# phase 2's row-scan references: the edges of a warp's runs at each width
# and the widest reference the kernel takes
ROWSCAN_LRS = (1, 127, 129, 513, 1025, 4097, 16384)


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


def wave_cases():
    """(label, q, r, params) of phase 2's wavefront cases: tools/sw_cases.py's
    rows at every edge of the schedule (a lane's rows, a strip, a group of
    strips) against each WAVE_LR width under three SWParams; a reference
    whose handoff row (Lr * 8 bytes) does not fit a block's shared memory;
    rows enough for one warp a row with queries of two strips; a fused round
    of mixed real lengths under one padded shape."""
    import numpy as np
    from ciri_long_tpu_torch.ops.sw import SWParams
    from ciri_long_tpu_torch.tools.sw_cases import WAVE_LR
    from ciri_long_tpu_torch.tools.sw_cases import wave_cases as make

    rng = np.random.default_rng(20261018)
    cases = []
    for params in (SWParams(*p) for p in TILE_PARAMS):
        for Lr in WAVE_LR:
            q, r = make(rng, Lr)
            cases.append(('wave edges Lr {}'.format(Lr), q, r, params))
    q = codes(rng, 2, 1100)
    r = codes(rng, 2, WAVE_GLOBAL_LR)
    r[1, 17000:18100] = q[1]
    cases.append(('wave handoff row in global memory', q, r,
                  SWParams(10, 4, 8, 2)))
    q = codes(rng, WAVE_MANY_ROWS, 200, pad_suffix=True)
    r = codes(rng, WAVE_MANY_ROWS, 70, pad_suffix=True)
    cases.append(('wave one warp a row, rows of two strips', q, r,
                  SWParams(1, 1, 1, 1)))
    q = np.full((96, 1500), 5, np.int8)
    r = np.full((96, 1500), 5, np.int8)
    for b in range(96):
        lq, lr = rng.integers(1, 1501, 2)
        q[b, :lq] = rng.integers(0, 5, lq)
        r[b, :lr] = rng.integers(0, 5, lr)
    cases.append(('wave fused round of mixed lengths', q, r,
                  SWParams(10, 4, 8, 2)))
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


def probe_cases():
    """((label, q, r, params), kernels) of phase 2's cases for the
    harness's chain and row scan: tools/sw_cases.py's chain jobs at
    CHAIN_SHAPES through the chain, and its wavefront rows against
    ROWSCAN_LRS references through the row scan, under three SWParams."""
    import numpy as np
    from ciri_long_tpu_torch.ops.sw import SWParams
    from ciri_long_tpu_torch.tools.sw_cases import chain_cases
    from ciri_long_tpu_torch.tools.sw_cases import wave_cases as make

    rng = np.random.default_rng(20261017)
    cases = []
    for params in (SWParams(*p) for p in TILE_PARAMS):
        for B, Lq, Lr in CHAIN_SHAPES:
            q, r = chain_cases(rng, B, Lq, Lr)
            cases.append((('chain jobs', q, r, params), chain_kernels))
        for Lr in ROWSCAN_LRS:
            q, r = make(rng, Lr, (1, 31, 33, 65, 129, 300))
            cases.append((('row scan runs Lr {}'.format(Lr), q, r, params),
                          rowscan_kernels))
    return cases


def chain_kernels(Lq, Lr, params):
    """(name, kernel) of the harness's chain at C = 2, 4, 1 and B."""
    from ciri_long_tpu_torch.misc.kexp import sw_chain_cuda

    kernels = [('sw_chain C={}'.format(C),
                lambda q, r, p, C=C: sw_chain_cuda(q, r, p, C))
               for C in (2, 4, 1)]
    return kernels + [('sw_chain C=B', lambda q, r, p: sw_chain_cuda(
        q, r, p, q.shape[0]))]


def rowscan_kernels(Lq, Lr, params):
    """(name, kernel) of the harness's row scan by its rule and at every
    width."""
    from ciri_long_tpu_torch.misc.kexp import (ROWSCAN_WIDTHS, rowscan_plan,
                                               sw_rowscan_cuda)

    return [('sw_rowscan', sw_rowscan_cuda)] + [
        ('sw_rowscan W={}'.format(W),
         lambda q, r, p, W=W: sw_rowscan_cuda(
             q, r, p, rowscan_plan(q.shape[0], r.shape[1], W)))
        for W in ROWSCAN_WIDTHS]


def phase_kernel(torch, dev):
    """Every SW kernel against one plain output per case, then
    sw_score_ends's routes on the tile and wavefront cases, then the
    harness's chain and row scan on their cases; {name: max err}."""
    errs = {}
    runs = [(case, sw_kernels) for case in kernel_cases()]
    runs += [(case, sw_routes) for case in tile_cases() + wave_cases()]
    runs += probe_cases()
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
    sw_routes_ = {k: routes[k] for k in ('tiled', 'wave')}
    if (len(seen) != launches['sw_score_ends'] or planned == 0
            or sw_routes_ != {'tiled': planned, 'wave': len(seen) - planned}):
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
    launches = launch_counts(PROBE_KERNELS)
    emit('probe_path', launches=launches,
         kexp=[dict(l['variant'], gcups=l['gcups'], ms=l['ms'],
                    bound_ms=l['bound_ms']) for l in lines])
    if min(launches.values()) <= 0:
        raise AssertionError('the probe path missed a kernel: {}'.format(
            launches))
    return launches


def phase_probe_exact(torch, dev):
    """Every int16 probe against its plain version on each of its
    ``probe_cases`` (the TPU probe's input, negative lanes, wrapping lanes),
    launched alone and all six in one launch.  Exact, or it raises; returns
    the max abs difference of each entry point."""
    from ciri_long_tpu_torch.misc.int16_probe import (PROBES,
                                                      int16_probe_all_cuda,
                                                      int16_probe_cuda,
                                                      probe_cases)

    worst = {'int16_probe': 0, 'int16_probe_all': 0}
    cases = [probe_cases(probe, dev) for probe in PROBES]
    for probe, mine in zip(PROBES, cases):
        for label, x in mine:
            err = _max_err([int16_probe_cuda(probe, x)], [probe.plain(x)])
            emit('probe_exact', probe=probe.name, case=label,
                 shape=list(probe.shape), max_abs_err=err)
            worst['int16_probe'] = max(worst['int16_probe'], err)
    for k in range(len(cases[0])):
        xs = [mine[k][1] for mine in cases]
        errs = [_max_err([got], [probe.plain(x)]) for probe, x, got in
                zip(PROBES, xs, int16_probe_all_cuda(xs))]
        emit('probe_exact', probe='all six in one launch',
             case=cases[0][k][0], max_abs_err=errs)
        worst['int16_probe_all'] = max([worst['int16_probe_all']] + errs)
    if any(worst.values()):
        raise AssertionError('an int16 probe disagrees with its plain version')
    return worst


def wave_rows(torch, dev, smi, label, q, r, params, bound_ms, timer):
    """The wavefront at each R of WAVE_R_TIMED (ops/sw.py::_wave_plan with
    that many query rows a lane, K and the handoff row as the rule gives
    them), timed by ``timer`` (ms of one step); one JSON line, and {R: ms}.
    The rule's R (WAVE_ROWS) is the one these lines show fastest."""
    from ciri_long_tpu_torch.ops.sw import (WAVE_ROWS, _wave_plan,
                                            sw_score_ends_wave_cuda)

    B, Lq = q.shape
    Lr = r.shape[1]
    times, plans = {}, {}
    for R in WAVE_R_TIMED:
        plan = _wave_plan(B, Lq, Lr, rows=R)
        plans[R] = list(plan)
        times[R] = timer(lambda: sw_score_ends_wave_cuda(q, r, params, plan))
    emit('wave_rows', shape=label, B=B, Lq=Lq, Lr=Lr, plans=plans, ms=times,
         rule_rows=WAVE_ROWS, bound_ms=bound_ms, card=smi)
    return times


def probe_plans(smi, label, q, r, bound_ms, timer):
    """The harness's chain at each C of CHAIN_C_TIMED and R of
    CHAIN_R_TIMED (misc/kexp.py::chain_plan with that many query rows a
    lane) and its row scan at each width W (rowscan_plan with that W), timed
    by ``timer`` (ms of one step); two JSON lines, and {'chain_rows': {C:
    {R: ms}}, 'rowscan_widths': {W: ms}}.  The rules' R (CHAIN_ROWS) and W
    (ROWSCAN_WIDTH) are the ones these lines show fastest."""
    from ciri_long_tpu_torch.misc.kexp import (CHAIN_MIN_LR, CHAIN_ROWS,
                                               ROWSCAN_WIDTH,
                                               ROWSCAN_WIDTHS, chain_plan,
                                               rowscan_plan,
                                               sw_chain_cuda,
                                               sw_rowscan_cuda)
    from ciri_long_tpu_torch.misc.kexp import PARAMS as params

    B, Lq = q.shape
    Lr = r.shape[1]
    chain, chain_plans = {}, {}
    for C in CHAIN_C_TIMED:
        T = C * (max(Lr, CHAIN_MIN_LR) + 1) + 1   # the stream's slots
        chain[C], chain_plans[C] = {}, {}
        for R in CHAIN_R_TIMED:
            plan = chain_plan(B // C, Lq, T, C, rows=R)
            chain_plans[C][R] = list(plan)
            chain[C][R] = timer(lambda: sw_chain_cuda(q, r, params, C, plan))
    emit('chain_rows', shape=label, B=B, Lq=Lq, Lr=Lr, plans=chain_plans,
         ms=chain, rule_rows=CHAIN_ROWS, bound_ms=bound_ms, card=smi)
    widths, width_plans = {}, {}
    for W in ROWSCAN_WIDTHS:
        plan = rowscan_plan(B, Lr, W)
        width_plans[W] = list(plan)
        widths[W] = timer(lambda: sw_rowscan_cuda(q, r, params, plan))
    emit('rowscan_widths', shape=label, B=B, Lq=Lq, Lr=Lr, plans=width_plans,
         ms=widths, rule_width=ROWSCAN_WIDTH, bound_ms=bound_ms, card=smi)
    return {'chain_rows': chain, 'rowscan_widths': widths}


def phase_probe_time(torch, dev, smi):
    """The card's peak cell rate in both forms (the SW bound), the SW
    families and the plain version at each TIMED shape with the harness's
    dependent launches, and the int16 probes with independent launches,
    each beside its bound.  Kernel and library times are a CUDA graph's
    replay (``kexp.time_launches``: the card's time without the host's
    cost per launch), plain times the wall of the calls."""
    import numpy as np
    from ciri_long_tpu_torch.misc.int16_probe import (PROBES,
                                                      int16_probe_all_cuda,
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
        if _tile_plan(Lq, Lr, PARAMS) is None:
            sw[shape]['wave_rows'] = wave_rows(
                torch, dev, smi, shape, q, r, PARAMS, bound_ms,
                lambda step: time_launches(step, 10, dev, graph=True))
        sw[shape].update(probe_plans(smi, shape, q, r, bound_ms,
                                     lambda step: time_launches(
                                         step, 10, dev, graph=True)))
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
    # the six in one launch beside the six launches (both a graph's replay)
    # and the six PyTorch calls
    xs = [probe_input(probe, dev) for probe in PROBES]

    def six():
        for probe, x in zip(PROBES, xs):
            int16_probe_cuda(probe, x)

    def six_plain():
        for probe, x in zip(PROBES, xs):
            probe.plain(x)

    probes['all_ms'] = time_launches(lambda: int16_probe_all_cuda(xs), 200,
                                     dev, graph=True)
    probes['six_launches_ms'] = time_launches(six, 200, dev, graph=True)
    probes['six_plain_graph_ms'] = time_launches(six_plain, 200, dev,
                                                 graph=True)
    emit('probe_time', probe='all six in one launch', ms=probes['all_ms'],
         six_launches_ms=probes['six_launches_ms'],
         library_ms=probes['six_plain_graph_ms'],
         bound_ms=probes['bound_ms'], bound_by='bytes',
         bound_share=probes['bound_ms'] / probes['all_ms'], card=smi)
    return sw, probes


def compare_edit(torch, dev, label, a, b, alen, blen):
    """csrc/edit_distance.cu against the plain version on one batch, on the
    card, exact; returns the max abs difference or raises."""
    from ciri_long_tpu_torch.ops.edit import (edit_distance_batch_plain,
                                              edit_distance_cuda)
    args = [torch.as_tensor(x).to(dev).contiguous() for x in (a, b, alen,
                                                            blen)]
    got = edit_distance_cuda(*args)
    want = edit_distance_batch_plain(*args)
    torch.cuda.synchronize(dev)
    err = _max_err([got], [want])
    emit('kernel_vs_plain', kernel='edit_distance', case=label,
         B=int(args[0].shape[0]), La=int(args[0].shape[1]),
         Lb=int(args[1].shape[1]), max_abs_err=err)
    if err:
        raise AssertionError('edit_distance disagrees with plain on ' + label)
    return err


def compare_tb(torch, dev, label, q, r, n, m, scores):
    """csrc/sw_traceback.cu against the plain version on one batch of jobs,
    on the card, exact: every (score, begins, ends, run count) and every
    path's runs, element for element.  Returns the max abs difference or
    raises."""
    from ciri_long_tpu_torch.ops.sw_tb_batch import (sw_traceback_batch_plain,
                                                     sw_traceback_cuda,
                                                     tb_results)
    args = [torch.as_tensor(x).to(dev).contiguous() for x in (q, r, n, m)]
    got = sw_traceback_cuda(*args, *scores)
    want = sw_traceback_batch_plain(*args, *scores)
    torch.cuda.synchronize(dev)
    err = _max_err(list(got), list(want))     # out, and the runs
    if tb_results(*got) != tb_results(*want):
        err = max(err, 1)
    emit('kernel_vs_plain', kernel='sw_traceback', case=label,
         B=int(args[0].shape[0]), W=int(args[0].shape[1]),
         M=int(args[1].shape[1]), scores=list(scores), max_abs_err=err,
         hits=int((want[0][:, 0] > 0).sum().item()))
    if err:
        raise AssertionError('sw_traceback disagrees with plain on ' + label)
    return err


def compare_poa(torch, dev, label, arrays):
    """csrc/poa_align.cu against the plain version on one batch (numpy
    batch_arrays), on the card, exact: scores, pair counts and every pair.
    Returns the max abs difference or raises."""
    import numpy as np
    from ciri_long_tpu_torch.ops.poa_batch import (poa_align_batch_cuda,
                                                   poa_align_batch_plain)
    args = [torch.as_tensor(x).to(dev).contiguous() for x in arrays]
    got = poa_align_batch_cuda(*args)
    want = poa_align_batch_plain(*args)
    torch.cuda.synchronize(dev)
    err = _max_err(list(got), list(want))
    bases, offs = arrays[0], arrays[1]
    emit('kernel_vs_plain', kernel='poa_align', case=label,
         B=int(bases.shape[0]), Vmax=int(bases.shape[1]),
         nmax=int(arrays[3].shape[1]),
         max_indegree=int(np.diff(offs, axis=1).max(initial=0)),
         max_abs_err=err, pairs=int(want[2].sum().item()))
    if err:
        raise AssertionError('poa_align disagrees with plain on ' + label)
    return err


def phase_collapse_kernels(torch, dev):
    """Phase 6: collapse's kernels on tools/collapse_cases.py's and
    tools/poa_cases.py's cases; {name: max err}."""
    import numpy as np
    from ciri_long_tpu_torch.ops.sw_tb_batch import pack_jobs
    from ciri_long_tpu_torch.tools.collapse_cases import edit_cases, tb_cases
    from ciri_long_tpu_torch.tools.poa_cases import poa_cases

    from ciri_long_tpu_torch.utils.dispatch import ROUTES

    rng = np.random.default_rng(20261017)
    errs = {'edit_distance': 0, 'sw_traceback': 0, 'poa_align': 0}
    before = dict(ROUTES)
    for label, a, b, alen, blen in edit_cases(rng):
        errs['edit_distance'] = max(errs['edit_distance'], compare_edit(
            torch, dev, label, a, b, alen, blen))
    for label, qs, rs, scores in tb_cases(rng):
        errs['sw_traceback'] = max(errs['sw_traceback'], compare_tb(
            torch, dev, label, *pack_jobs(qs, rs), scores))
    for label, arrays in poa_cases(np.random.default_rng(20261019),
                                   wide=True):
        errs['poa_align'] = max(errs['poa_align'], compare_poa(
            torch, dev, label, arrays))
    routes = {k: ROUTES[k] - before[k] for k in COLLAPSE_ROUTES}
    emit('collapse_routes', routes=routes)
    if min(routes.values()) <= 0:
        raise AssertionError('phase 6 missed a route: {}'.format(routes))
    return errs


def _recording(torch, seen):
    """Wrap the three kernels' wrappers so that each call first copies its
    arguments into ``seen`` (lists by kernel name); returns the undo.  The
    launch counts stay the wrappers' own."""
    from ciri_long_tpu_torch.ops import edit, sw, sw_tb_batch

    patched = [(sw, 'sw_score_ends_cuda', 'sw_score_ends'),
               (edit, 'edit_distance_cuda', 'edit_distance'),
               (sw_tb_batch, 'sw_traceback_cuda', 'sw_traceback')]
    originals = []
    for module, attr, name in patched:
        kernel = getattr(module, attr)
        originals.append((module, attr, kernel))

        def recorder(*args, _kernel=kernel, _name=name, **kw):
            seen[_name].append(tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
            return _kernel(*args, **kw)

        setattr(module, attr, recorder)

    def undo():
        for module, attr, kernel in originals:
            setattr(module, attr, kernel)
    return undo


# collapse's calls whose wall the run sums over its threads: the SW (fused
# rounds and direct calls), the edit distances, the rotation's traceback,
# the junction consensus (a host ``poa`` on both routes) and the sub-cluster
# consensus (``poa_consensus_many``: csrc/poa_align.cu's rounds on cuda,
# host ``poa`` calls on cpu)
TIMED_CALLS = {'sw': ('_fused_sw', '_sw_many_vs_many_direct'),
               'edit': ('_edit_many_direct',),
               'traceback': ('sw_traceback_batch',),
               'poa_junction': ('poa',),
               'poa_subcluster': ('poa_consensus_many',)}
# the stages of ops/sw_tb_batch.py::sw_traceback_batch on the card: packing
# the jobs, the host-to-device copy, the route plan (its job lists copied
# too), the launches (the host's side; on a recorded run also the
# recorder's copies of the inputs), the device-to-host copy that waits for
# the kernels, and the Python that turns the runs into tuples
TB_STAGES = {'pack': ('pack_jobs',), 'upload': ('upload',),
             'plan': ('tb_plan',), 'launch': ('sw_traceback_cuda',),
             'download_and_wait': ('download',),
             'tb_results': ('tb_results',)}


def _timing(module, calls, seconds, cpu=None):
    """Wrap ``calls`` ({kind: attribute names}) of ``module`` so that each
    call adds its wall to ``seconds[kind]`` and, with ``cpu``, the thread's
    CPU time to ``cpu[kind]`` (both summed over threads; a thread waiting
    for the interpreter lock or the card spends wall without CPU, unless
    CUDA spins while it waits); returns the undo."""
    import threading

    lock = threading.Lock()
    originals = []
    for kind, names in calls.items():
        for attr in names:
            fn = getattr(module, attr)
            originals.append((attr, fn))

            def timed(*args, _fn=fn, _kind=kind, **kw):
                t0, c0 = time.perf_counter(), time.thread_time()
                try:
                    return _fn(*args, **kw)
                finally:
                    wall = time.perf_counter() - t0
                    used = time.thread_time() - c0
                    with lock:
                        seconds[_kind] = seconds.get(_kind, 0.0) + wall
                        if cpu is not None:
                            cpu[_kind] = cpu.get(_kind, 0.0) + used

            setattr(module, attr, timed)

    def undo():
        for attr, fn in originals:
            setattr(module, attr, fn)
    return undo


def _recording_poa(calls):
    """Wrap collapse's ``poa_consensus_many`` so that each call on the card
    appends (jobs, consensus list, the round loop's stats of the call) to
    ``calls``; returns the undo."""
    from ciri_long_tpu_torch.pipeline import collapse

    real = collapse.poa_consensus_many

    def recorder(jobs, *args, **kw):
        stats = {}
        out = real(jobs, *args, stats=stats, **kw)
        calls.append((jobs, out, stats))
        return out

    collapse.poa_consensus_many = recorder

    def undo():
        collapse.poa_consensus_many = real
    return undo


def run_collapse(torch, label, ref, cand_circ, root):
    """``collapse`` through the CLI on one sample, --device cuda (its kernel
    inputs and its sub-cluster POA calls recorded) then --device cpu, with
    the launch counts set to 0 before and read after each run.  Raises
    unless the four files are byte-identical, the corrected clusters and
    counters equal, every kernel launched on cuda and none on cpu.  Returns
    the recorded inputs, the phase's fields and the recorded POA calls."""
    import pickle
    from ciri_long_tpu_torch.cli.main import main
    from ciri_long_tpu_torch.ops import sw_tb_batch
    from ciri_long_tpu_torch.pipeline import collapse
    from ciri_long_tpu_torch.tools.world import sample_list
    from ciri_long_tpu_torch.utils.dispatch import (COLLAPSE_KERNELS,
                                                    DEVICE_MS, ROUTES,
                                                    launch_counts,
                                                    reset_launches)

    lst = sample_list(os.path.join(root, 'samples.lst'), [('s1', cand_circ)])
    seen = {name: [] for name in COLLAPSE_KERNELS if name != 'poa_align'}
    poa_calls = []
    runs = {}
    for device in ('cuda', 'cpu'):
        out = os.path.join(root, 'collapse_' + device)
        shutil.rmtree(out, ignore_errors=True)
        undo = _recording(torch, seen) if device == 'cuda' else (lambda: 0)
        undo_poa = _recording_poa(poa_calls) if device == 'cuda' else \
            (lambda: 0)
        host_s, tb_wall, tb_cpu = {}, {}, {}
        untime = _timing(collapse, TIMED_CALLS, host_s)
        untime_tb = _timing(sw_tb_batch, TB_STAGES, tb_wall, tb_cpu)
        try:
            reset_launches()
            t0 = time.perf_counter()
            main(['collapse', '-i', lst, '-o', out, '-r', ref, '-p', 'smoke',
                  '-t', '1', '--device', device])
            wall = time.perf_counter() - t0
            launches = launch_counts(COLLAPSE_KERNELS)
            routes = dict(ROUTES)
            device_ms = dict(DEVICE_MS)
        finally:
            untime_tb()
            untime()
            undo_poa()
            undo()
        with open(os.path.join(out, 'tmp', 'smoke.corrected.pkl'), 'rb') as f:
            circ_num, corrected = pickle.load(f)
        runs[device] = dict(
            wall_s=wall, launches=launches, routes=routes, host_s=host_s,
            device_ms=device_ms, tb_split=dict(wall_s=tb_wall, cpu_s=tb_cpu),
            files={ext: Path(out, 'smoke.' + ext).read_bytes()
                   for ext in COLLAPSE_FILES},
            counters=dict(circ_num), corrected=corrected)
    gpu, cpu = runs['cuda'], runs['cpu']
    identical = {ext: gpu['files'][ext] == cpu['files'][ext]
                 for ext in COLLAPSE_FILES}
    n_circ = gpu['files']['info'].count(b'\n')
    fields = dict(
        world=label, cand_reads=sum(1 for ln in open(cand_circ)
                                    if ln.startswith('>')),
        circrnas=n_circ, clusters=len(gpu['corrected']),
        counters=gpu['counters'], counters_equal=(
            gpu['counters'] == cpu['counters']),
        corrected_equal=gpu['corrected'] == cpu['corrected'],
        files_identical=identical, launches=gpu['launches'],
        routes=gpu['routes'], cpu_launches=cpu['launches'],
        cuda_wall_s=gpu['wall_s'], cpu_wall_s=cpu['wall_s'],
        cuda_calls_s=gpu['host_s'], cpu_calls_s=cpu['host_s'],
        cuda_traceback_split=gpu['tb_split'],
        poa_device_ms=gpu['device_ms']['poa_align'],
        poa_calls=len(poa_calls),
        poa_jobs=sum(len(c[0]) for c in poa_calls),
        recorded={k: len(v) for k, v in seen.items()})
    emit('collapse', **fields)
    if not all(identical.values()) or not fields['counters_equal'] \
            or not fields['corrected_equal']:
        raise AssertionError('collapse differs between --device cuda and '
                             'cpu on the {} world'.format(label))
    if min(gpu['launches'].values()) <= 0:
        raise AssertionError('collapse --device cuda missed a kernel: '
                             '{}'.format(gpu['launches']))
    if min(gpu['routes'][k] for k in ('wave', 'tb_smem', 'edit_thread')) <= 0:
        raise AssertionError('collapse --device cuda missed the routes its '
                             'jobs take: {}'.format(gpu['routes']))
    if any(cpu['launches'].values()):
        raise AssertionError('collapse --device cpu launched a kernel: '
                             '{}'.format(cpu['launches']))
    if n_circ <= 0:
        raise AssertionError('collapse found no circRNA on the {} '
                             'world'.format(label))
    return seen, fields, poa_calls


def poa_checks(torch, dev, smi, label, calls, rate):
    """A collapse run's sub-cluster POA on the card (``calls``, recorded by
    _recording_poa): every job replayed through the native ``poa``,
    byte-identical; then the call that held the largest launch (by cells)
    replayed to keep that launch's inputs (ops/poa.py::poa_launch_inputs),
    checked against the plain version, timed (a CUDA graph's replay of 10
    launches) beside the plain version and the bound: its cell updates,
    V x (n + 1) a job, at ``rate``, the card's rate for this update, or
    the bytes it must move at the HBM rate, whichever is larger (the
    inputs read once, the pairs, scores and counts written once, and the
    16-bit direction word of each of the (V + 1) x (n + 1) cells, which
    the walk reads; H, F1 and F2 need not leave the chip).  One JSON line;
    returns its fields."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from ciri_long_tpu_torch.misc.kexp import HBM_BYTES_PER_S, time_launches
    from ciri_long_tpu_torch.ops import poa as poa_mod
    from ciri_long_tpu_torch.ops.poa_batch import (DIR_BYTES,
                                                   poa_align_batch_cuda,
                                                   poa_align_batch_plain)

    def native(job):
        return poa_mod.poa(job, 2, False, 10, -4, -8, -2, -24, -1)[0]

    jobs = [job for c in calls for job in c[0]]
    got = [ccs for c in calls for ccs in c[1]]
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        want = list(pool.map(native, jobs))
    differ = sum(not _same(a, b) for a, b in zip(got, want))
    if differ or not calls:
        raise AssertionError('{}: {} of {} sub-cluster consensus differ from '
                             'the native poa ({} calls)'.format(
                                 label, differ, len(jobs), len(calls)))

    big_call = max(calls, key=lambda c: c[2]['largest_cells'])
    again, arrays = poa_mod.poa_launch_inputs(big_call[0], big_call[2],
                                              device=dev)
    if not all(_same(a, b) for a, b in zip(again, big_call[1])):
        raise AssertionError('{}: a replayed POA call differs'.format(label))
    err = compare_poa(torch, dev, label + ' largest poa_align launch',
                      arrays)
    bases, offs, preds, seqs, nv, ns = arrays
    args = [torch.as_tensor(x).to(dev).contiguous() for x in arrays]
    pairs = int(poa_align_batch_cuda(*args)[2].sum().item())
    ms = time_launches(lambda: poa_align_batch_cuda(*args, checked=True),
                       10, dev, graph=True)
    plain_ms = time_launches(lambda: poa_align_batch_plain(*args), 1, dev)
    nv64, ns64 = nv.astype(np.int64), ns.astype(np.int64)
    updates = int((nv64 * (ns64 + 1)).sum())
    cells = int(((nv64 + 1) * (ns64 + 1)).sum())
    nbytes = DIR_BYTES * cells + int(nv64.sum() + ns64.sum()) + \
        4 * int((nv64 + 1).sum() + preds.size) + 8 * pairs + 8 * len(nv)
    ops_ms = updates / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, 'operations') if ops_ms >= bytes_ms else \
        (bytes_ms, 'bytes')
    fields = dict(
        world=label, calls=len(calls), jobs=len(jobs), identical_to_native=
        len(jobs) - differ, launches=sum(c[2]['launches'] for c in calls),
        run_device_ms=sum(c[2]['device_ms'] for c in calls),
        largest=dict(B=int(len(nv)), Vmax=int(bases.shape[1]),
                     nmax=int(seqs.shape[1]), cells=cells, updates=updates,
                     pairs=pairs, max_indegree=int(
                         np.diff(offs, axis=1).max(initial=0)),
                     run_ms=big_call[2]['largest_ms']),
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / ms, ops_bound_ms=ops_ms,
        bytes_bound_ms=bytes_ms, max_abs_err=err, card=smi)
    emit('collapse_poa', **fields)
    return fields


def _same(a, b):
    """Two consensus results equal in form and bytes."""
    import numpy as np
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return np.asarray(a).dtype == np.asarray(b).dtype and \
        np.array_equal(a, b)


def _real(x, torch):
    """Per-row real lengths of PAD-suffixed codes (the first PAD)."""
    pad = x >= 5
    first = torch.where(pad.any(1), pad.int().argmax(1),
                        torch.full_like(pad[:, 0], x.shape[1], dtype=torch.int64))
    return first


def launch_cells(name, args, torch):
    """The DP cells one recorded launch's data needs: real query x
    reference lengths summed over its rows."""
    if name == 'sw_score_ends':
        q, r = args[0], args[1]
        return int((_real(q, torch) * _real(r, torch)).sum().item())
    a, b, n, m = args[:4]
    n = n.long().clamp(0, a.shape[1])
    m = m.long().clamp(0, b.shape[1])
    return int((n * m).sum().item())


def launch_work(name, args, torch):
    """The updates one recorded launch's data needs at the least: DP cells
    for the SW kernels; for the bit-parallel edit distance, 32-row word
    updates, ceil(pattern / 32) * text a pair with the pattern the side
    that needs fewer."""
    if name != 'edit_distance':
        return launch_cells(name, args, torch)
    a, b, n, m = args[:4]
    n = n.long().clamp(0, a.shape[1])
    m = m.long().clamp(0, b.shape[1])
    words = torch.minimum((n + 31) // 32 * m, (m + 31) // 32 * n)
    return int(words.sum().item())


def check_recorded(torch, dev, seen, sw_count=SW_CHECKED, tb_all=True,
                   edit_all=True, label='collapse'):
    """The recorded inputs of a collapse run against the plain versions:
    every edit and traceback launch (or the largest one when ``*_all`` is
    False) and the ``sw_count`` largest SW launches.  {name: max err}."""
    from ciri_long_tpu_torch.ops.sw import sw_score_ends
    errs = {}
    for name, args_list in seen.items():
        order = sorted(range(len(args_list)), reverse=True,
                       key=lambda t: launch_work(name, args_list[t], torch))
        keep = {'sw_score_ends': order[:sw_count],
                'edit_distance': order if edit_all else order[:1],
                'sw_traceback': order if tb_all else order[:1]}[name]
        err = 0
        for t in keep:
            args = args_list[t]
            case = '{} {} launch {}'.format(label, name, t)
            if name == 'sw_score_ends':
                err = max(err, compare(torch, dev, args[0].cpu().numpy(),
                                       args[1].cpu().numpy(), args[2], case,
                                       sw_routes(args[0].shape[1],
                                                 args[1].shape[1],
                                                 args[2]))['sw_score_ends'])
            elif name == 'edit_distance':
                err = max(err, compare_edit(torch, dev, case, *args))
            else:
                err = max(err, compare_tb(torch, dev, case, *args[:4],
                                          args[4:8]))
        errs[name] = err
    return errs


def sw_route_split(torch, dev, smi, label, args_list, times, rate,
                   rows_timed=False):
    """A collapse run's SW launches by route (tiled where ops/sw.py::
    _tile_plan gives a plan, wave elsewhere): per route the launches, their
    summed device time (``times``: each recorded launch's graph replay) and,
    at the route's largest launch (by cells), its shapes, ms, plain ms and
    bound at ``rate`` cells/s, and with ``rows_timed`` the wavefront's
    largest launch at each R (wave_rows).  One JSON line a route; returns
    {route: fields}."""
    from ciri_long_tpu_torch.misc.kexp import time_launches
    from ciri_long_tpu_torch.ops.sw import _tile_plan

    split = {}
    for route in ('wave', 'tiled'):
        mine = [t for t, a in enumerate(args_list)
                if (_tile_plan(a[0].shape[1], a[1].shape[1], a[2]) is None)
                == (route == 'wave')]
        fields = dict(launches=len(mine),
                      device_ms=sum(times[t] for t in mine))
        if mine:
            big = args_list[max(mine, key=lambda t: launch_cells(
                'sw_score_ends', args_list[t], torch))]
            bound_ms, bound_by = launch_bound(
                'sw_score_ends', big, {'sw_score_ends': rate}, torch)
            ms = _time_recorded(torch, dev, 'sw_score_ends', big, 10)
            fields.update(
                shape=[list(big[0].shape), list(big[1].shape)],
                params=list(big[2]),
                cells=launch_cells('sw_score_ends', big, torch), ms=ms,
                plain_ms=_plain_ms(torch, dev, 'sw_score_ends', big),
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms)
        split[route] = fields
        emit('collapse_sw_route', world=label, route=route, card=smi,
             **fields)
        if route == 'wave' and mine and rows_timed:
            fields['wave_rows'] = wave_rows(
                torch, dev, smi, label + ' largest wave launch', big[0],
                big[1], big[2], fields['bound_ms'],
                lambda step: time_launches(step, 10, dev, graph=True))
    return split


def phase_collapse(torch, dev, smi, world_ref):
    """Phase 7: collapse on phase 4's cand_circ.fa, then its sub-cluster POA
    and its SW launches by route; ({name: max err}, the POA's fields)."""
    from ciri_long_tpu_torch.misc.kexp import peak_cell_rate, recurrence_rate

    root = os.path.join(WORK, 'collapse_call_world')
    os.makedirs(root, exist_ok=True)
    seen, fields, poa_calls = run_collapse(
        torch, 'call', world_ref,
        os.path.join(WORK, 'out_cuda', 'smoke.cand_circ.fa'), root)
    errs = check_recorded(torch, dev, seen, label='call world collapse')
    poa = poa_checks(torch, dev, smi, 'call', poa_calls,
                     recurrence_rate(dev, 'poa_align'))
    errs['poa_align'] = poa['max_abs_err']
    sw_args = seen['sw_score_ends']
    sw_route_split(torch, dev, smi, 'call', sw_args,
                   [_time_recorded(torch, dev, 'sw_score_ends', a, 3)
                    for a in sw_args], peak_cell_rate(dev))
    return errs, dict(poa, launches=fields['launches']['poa_align'],
                      device_ms=fields['poa_device_ms'])


def _time_recorded(torch, dev, name, args, n_iter):
    """ms of one recorded launch, a CUDA graph's replay of n_iter (the
    route plans made beforehand, as the main path makes them)."""
    from ciri_long_tpu_torch.misc.kexp import time_launches
    from ciri_long_tpu_torch.ops import edit, sw, sw_tb_batch

    if name == 'sw_score_ends':
        def step():
            sw.sw_score_ends_cuda(*args)
    elif name == 'edit_distance':
        plan = edit.edit_plan(*(t.cpu().numpy() for t in args), dev)

        def step():
            edit.edit_distance_cuda(*args, plan=plan)
    else:
        q, r, n, m = args[:4]
        plan = sw_tb_batch.tb_plan(n.cpu().numpy(), m.cpu().numpy(),
                                   q.shape[1], r.shape[1], dev)

        def step():
            sw_tb_batch.sw_traceback_cuda(*args, plan=plan)
    return time_launches(step, n_iter, dev, graph=True)


def _plain_ms(torch, dev, name, args):
    from ciri_long_tpu_torch.misc.kexp import time_launches
    from ciri_long_tpu_torch.ops.edit import edit_distance_batch_plain
    from ciri_long_tpu_torch.ops.sw import sw_score_ends
    from ciri_long_tpu_torch.ops.sw_tb_batch import sw_traceback_batch_plain

    fn = {'sw_score_ends': sw_score_ends,
          'edit_distance': edit_distance_batch_plain,
          'sw_traceback': sw_traceback_batch_plain}[name]
    return time_launches(lambda: fn(*args), 1, dev)


def launch_bound(name, args, rates, torch):
    """(least ms, 'operations' or 'bytes') of one recorded launch: its
    updates (launch_work) at the card's rate for that kernel's update, or
    its bytes at the HBM rate (codes and lengths read once, outputs written
    once; for the traceback also the direction bytes of its jobs on the
    global route, one a cell, written once)."""
    from ciri_long_tpu_torch.misc.kexp import HBM_BYTES_PER_S
    from ciri_long_tpu_torch.ops.sw_tb_batch import global_bytes

    if name == 'sw_score_ends':
        q, r = args[0], args[1]
        nbytes = int(_real(q, torch).sum() + _real(r, torch).sum()) \
            + 12 * q.shape[0]
    else:
        a, b, n, m = args[:4]
        n = n.long().clamp(0, a.shape[1])
        m = m.long().clamp(0, b.shape[1])
        nbytes = int(n.sum() + m.sum()) + 8 * a.shape[0]
        nbytes += 4 * a.shape[0] if name == 'edit_distance' else \
            24 * a.shape[0] + int(global_bytes(n.cpu().numpy(),
                                               m.cpu().numpy()).sum())
    ops_ms = launch_work(name, args, torch) / rates[name] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else \
        (bytes_ms, 'bytes')


def save_wave_inputs(torch, args_list):
    """The cohort's wavefront launches (query, ref, params), on the host, to
    WAVE_INPUTS: the inputs ciri_long_tpu_torch/tools/wave_ab.py times in
    two checkouts."""
    from ciri_long_tpu_torch.ops.sw import _tile_plan

    torch.save([(a[0].cpu(), a[1].cpu(), tuple(a[2])) for a in args_list
                if _tile_plan(a[0].shape[1], a[1].shape[1], a[2]) is None],
               WAVE_INPUTS)


def phase_collapse_full(torch, dev, smi):
    """Phase 8: collapse at full size on the cohort of
    benchmarks/collapse_bench.py's defaults.  Returns ({name: max err},
    {name: the largest launch's numbers}, the phase's fields)."""
    from ciri_long_tpu_torch.cli.main import main
    from ciri_long_tpu_torch.misc.kexp import peak_cell_rate, recurrence_rate
    from ciri_long_tpu_torch.tools.world import cohort_world

    root = os.path.join(WORK, 'cohort')
    ref, reads, n_reads = cohort_world(os.path.join(root, 'world'), **COHORT)
    t0 = time.perf_counter()
    main(['call', '-i', reads, '-o', os.path.join(root, 'call'), '-r', ref,
          '-p', 'cohort', '-t', '1', '--device', 'cuda'])
    call_s = time.perf_counter() - t0
    emit('cohort_call', n_reads=n_reads, wall_s=call_s, cohort=COHORT)
    seen, fields, poa_calls = run_collapse(
        torch, 'cohort', ref, os.path.join(root, 'call',
                                           'cohort.cand_circ.fa'), root)
    errs = check_recorded(torch, dev, seen, sw_count=2, tb_all=False,
                          edit_all=False, label='cohort collapse')
    rates = {'sw_score_ends': peak_cell_rate(dev),
             'edit_distance': recurrence_rate(dev, 'edit_distance'),
             'sw_traceback': recurrence_rate(dev, 'sw_traceback'),
             'edit_cell': recurrence_rate(dev, 'edit_cell'),
             'poa_align': recurrence_rate(dev, 'poa_align')}
    emit('cell_rate', collapse_updates_per_s=rates, card=smi)
    poa = poa_checks(torch, dev, smi, 'cohort', poa_calls,
                     rates['poa_align'])
    errs['poa_align'] = poa['max_abs_err']
    largest = {}
    for name, args_list in seen.items():
        work = [launch_work(name, a, torch) for a in args_list]
        times = [_time_recorded(torch, dev, name, a, 3) for a in args_list]
        total = sum(times)
        if name == 'sw_score_ends':
            routes = sw_route_split(torch, dev, smi, 'cohort', args_list,
                                    times, rates[name], rows_timed=True)
            save_wave_inputs(torch, args_list)
        big = args_list[max(range(len(work)), key=work.__getitem__)]
        bound_ms, bound_by = launch_bound(name, big, rates, torch)
        largest[name] = dict(
            launches=len(args_list), device_ms=total,
            cells=sum(launch_cells(name, a, torch) for a in args_list),
            updates=sum(work), ms=_time_recorded(torch, dev, name, big, 10),
            plain_ms=_plain_ms(torch, dev, name, big), bound_ms=bound_ms,
            bound_by=bound_by, shape=[list(a.shape) for a in big
                                      if torch.is_tensor(a)],
            largest_cells=launch_cells(name, big, torch),
            largest_updates=max(work))
        if name == 'edit_distance':   # the bound of a DP cell an update
            largest[name]['cell_bound_ms'] = (
                largest[name]['largest_cells'] / rates['edit_cell'] * 1e3)
        emit('collapse_kernel_time', kernel=name, card=smi, **largest[name])
    largest['poa_align'] = dict(
        poa, launches=fields['launches']['poa_align'],
        device_ms=fields['poa_device_ms'],
        shape=[poa['largest'][k] for k in ('B', 'Vmax', 'nmax')])
    emit('collapse_full', reads=n_reads, cuda_wall_s=fields['cuda_wall_s'],
         cpu_wall_s=fields['cpu_wall_s'],
         cuda_reads_per_s=n_reads / fields['cuda_wall_s'],
         cpu_reads_per_s=n_reads / fields['cpu_wall_s'],
         device_ms={k: v['device_ms'] for k, v in largest.items()},
         cuda_calls_s=fields['cuda_calls_s'],
         cpu_calls_s=fields['cpu_calls_s'], card=smi)
    largest['sw_score_ends']['routes'] = routes
    return errs, largest, fields


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
    collapse_errs = phase_collapse_kernels(torch, dev)
    call_errs, call_poa = phase_collapse(
        torch, dev, smi, os.path.join(WORK, 'world', 'genome.fa'))
    for name, err in call_errs.items():
        collapse_errs[name] = max(collapse_errs.get(name, 0), err)
    full_errs, full, full_fields = phase_collapse_full(torch, dev, smi)
    for name, err in full_errs.items():
        collapse_errs[name] = max(collapse_errs.get(name, 0), err)

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
    # collapse's kernels at their largest launch of the full-size collapse
    # (phase 8), launched by it; sw_score_ends's collapse launches and
    # device time beside its call numbers
    def collapse_entry(name):
        big = full[name]
        prefix = 'edit_' if name == 'edit_distance' else 'tb_'
        extra = {k: big[k] for k in ('cell_bound_ms',) if k in big}
        return dict(entry(name, full_fields['launches'][name],
                          collapse_errs[name], big['ms'], big['plain_ms'],
                          big['bound_ms'], big['bound_by']),
                    shape=big['shape'], collapse_device_ms=big['device_ms'],
                    collapse_routes={k: v for k, v in
                                     full_fields['routes'].items()
                                     if k.startswith(prefix)}, **extra)

    def wave_fields(wave):
        """The cohort's wavefront launches: the largest one's time, bound
        and plan, and the summed device time of all of them; the plan and
        R times at the bench shape."""
        from ciri_long_tpu_torch.ops.sw import _wave_plan
        big = wave.get('shape')
        return dict(wave_launches=wave['launches'],
                    wave_device_ms=wave['device_ms'], wave_shape=big,
                    wave_ms=wave.get('ms'),
                    wave_plain_ms=wave.get('plain_ms'),
                    wave_bound_ms=wave.get('bound_ms'),
                    wave_plan=big and list(_wave_plan(big[0][0], big[0][1],
                                                      big[1][1])),
                    wave_rows_ms=wave.get('wave_rows'),
                    bench_plan=list(_wave_plan(*BENCH)),
                    bench_rows_ms=bench['wave_rows'])

    def family_err(prefix):
        return max(err for name, err in errs.items()
                   if name.startswith(prefix))

    def shapes_ms(name):
        return {shape: sw[shape][name] for shape in sw}

    kernels = [
        dict(entry('sw_score_ends', launches,
                   max([call_err, collapse_errs['sw_score_ends']]
                       + [err for name, err in errs.items()
                          if name.startswith('sw_score_ends')]),
                   bench['sw_score_ends']),
             main_ms=main['sw_score_ends'], main_bound_ms=main['bound_ms'],
             collapse_launches=full_fields['launches']['sw_score_ends'],
             collapse_routes={k: full_fields['routes'][k]
                              for k in ('wave', 'tiled')},
             collapse_device_ms=full['sw_score_ends']['device_ms'],
             **wave_fields(full['sw_score_ends']['routes']['wave'])),
        dict(entry('sw_rowscan', probe_launches['sw_rowscan'],
                   family_err('sw_rowscan'), bench['sw_rowscan']),
             shapes_ms=shapes_ms('sw_rowscan'),
             plans_ms={shape: sw[shape]['rowscan_widths'] for shape in sw}),
        dict(entry('sw_chain', probe_launches['sw_chain'],
                   family_err('sw_chain'), bench['sw_chain C=4']),
             c2_ms=bench['sw_chain C=2'],
             shapes_ms={C: shapes_ms('sw_chain C={}'.format(C))
                        for C in CHAIN_C_TIMED},
             plans_ms={shape: sw[shape]['chain_rows'] for shape in sw}),
        # the six probes summed; the library time is the card's own time of
        # the plain versions, each one PyTorch call
        entry('int16_probe', probe_launches['int16_probe'],
              probe_err['int16_probe'], probes['ms'], probes['plain_ms'],
              probes['bound_ms'], 'bytes', probes['library_ms']),
        # the six in one launch, beside the six launches' graph
        dict(entry('int16_probe_all', probe_launches['int16_probe_all'],
                   probe_err['int16_probe_all'], probes['all_ms'],
                   probes['plain_ms'], probes['bound_ms'], 'bytes',
                   probes['six_plain_graph_ms']),
             source=CSRC + 'int16_probe.cu',
             six_launches_ms=probes['six_launches_ms']),
        collapse_entry('edit_distance'),
        collapse_entry('sw_traceback'),
        # the largest launch of the cohort's sub-cluster POA, its launches
        # and their summed device time (CUDA events in the run); phase 7's
        # numbers beside them
        dict(entry('poa_align', full_fields['launches']['poa_align'],
                   collapse_errs['poa_align'], full['poa_align']['ms'],
                   full['poa_align']['plain_ms'],
                   full['poa_align']['bound_ms'],
                   full['poa_align']['bound_by']),
             shape=full['poa_align']['shape'],
             collapse_device_ms=full['poa_align']['device_ms'],
             largest=full['poa_align']['largest'],
             call_world={k: call_poa[k] for k in (
                 'launches', 'device_ms', 'ms', 'plain_ms', 'bound_ms',
                 'bound_by', 'largest')}),
    ]
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
