"""SW kernels of two checkouts timed in turns on one card: the wavefront
route of csrc/sw_score_ends.cu, with ``--tiled`` its tiled route, and with
``--probes`` the SW variant harness's chain and row scan
(csrc/sw_chain.cu, csrc/sw_rowscan.cu).

    python3 -m ciri_long_tpu_torch.tools.wave_ab --other DIR [--inputs FILE]
        [--tiled [FILE ...]] [--probes]

DIR is another checkout of this repository (the parent commit, say,
unpacked with ``git archive``).  Four runs, each in a process of its own on
the same card, in turns: DIR, this checkout, this checkout, DIR.  Each run
builds its own kernels and times its forced wavefront
(``ops/sw.py::sw_score_ends_wave_cuda``, which every checkout since the
first has) as a CUDA graph's replay: at SHAPES, the bench shape
512x1024x4096, the square 512x1024x1024 and chip_smoke.py's K2, K4 and K3
case shapes (random codes 0-3, SWParams(10, 4, 8, 2), 10 launches, 3 at
K3) and, with FILE,
on each input FILE holds (chip_smoke.py writes the cohort collapse's
wavefront launches to build/chip_smoke/cohort_wave_inputs.pt; 3 launches
each), summed.  With ``--probes`` each run also times misc/kexp.py's
``sw_chain_cuda`` at C = 2 and 4 and ``sw_rowscan_cuda`` (both wrappers
have kept their signatures since the first checkout that had them) by
their default plans at PROBE_SHAPES, chip_smoke.py's phase-5 shapes
(random codes 0-3, SWParams(10, 4, 8, 2), 10 launches).  With ``--tiled``
each run times the forced tiled route (``sw_score_ends_tiled_cuda``, whose
signature every checkout since the route's first has kept) at TILE_SHAPES,
the main path's 64x28x16384 and 128x54x16384 (random codes 0-3,
SWParams(10, 4, 8, 2), 10 launches), and on each launch of each FILE given
(chip_smoke.py writes call's tiled launches to
build/chip_smoke/call_tiled_inputs.pt and the cohort collapse's to
cohort_tiled_inputs.pt; 3 launches each): their sum and the largest
launch's time (10 launches) by file.  Prints one JSON
line a run, then the means of the two checkouts and their ratio, with the
card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = {'bench': (512, 1024, 4096), 'square': (512, 1024, 1024),
          'K2': (8, 256, 512), 'K4': (64, 2048, 512), 'K3': (4, 8192, 16384)}
PROBE_SHAPES = {'bench': (512, 1024, 4096), 'square': (512, 1024, 1024),
                'main64': (64, 28, 16384), 'main128': (128, 54, 16384),
                'short': (4096, 32, 128)}
TILE_SHAPES = {'main64': (64, 28, 16384), 'main128': (128, 54, 16384)}
PROBES = {'chain2': lambda kexp, q, r, p: kexp.sw_chain_cuda(q, r, p, 2),
          'chain4': lambda kexp, q, r, p: kexp.sw_chain_cuda(q, r, p, 4),
          'rowscan': lambda kexp, q, r, p: kexp.sw_rowscan_cuda(q, r, p)}


def _cells(q, r):
    """Real query x reference lengths summed over a launch's rows."""
    import torch
    lens = [torch.where((x >= 5).any(1), (x >= 5).int().argmax(1),
                        x.shape[1]) for x in (q, r)]
    return int((lens[0] * lens[1]).sum())


def time_tiled(sw, dev, rng, params, files):
    """The forced tiled route at TILE_SHAPES and on each recorded file."""
    import numpy as np
    import torch
    from ciri_long_tpu_torch.misc.kexp import time_launches

    out = {}
    for name, (B, Lq, Lr) in TILE_SHAPES.items():
        q, r = (torch.from_numpy(rng.integers(0, 4, shape).astype(
            np.int8)).to(dev) for shape in ((B, Lq), (B, Lr)))
        out['tiled_{}_ms'.format(name)] = time_launches(
            lambda: sw.sw_score_ends_tiled_cuda(q, r, params), 10, dev,
            graph=True)
    for path in files:
        stem = os.path.basename(path).replace('_inputs.pt', '')
        launches = [(qh.to(dev), rh.to(dev), sw.SWParams(*p))
                    for qh, rh, p in torch.load(path)]
        total = sum(time_launches(
            lambda: sw.sw_score_ends_tiled_cuda(q, r, p), 3, dev,
            graph=True) for q, r, p in launches)
        q, r, p = max(launches, key=lambda a: _cells(a[0], a[1]))
        out.update({stem + '_launches': len(launches),
                    stem + '_device_ms': total,
                    stem + '_largest_ms': time_launches(
                        lambda: sw.sw_score_ends_tiled_cuda(q, r, p), 10,
                        dev, graph=True)})
    return out


def time_tree(tree, inputs, probes=False, tiled=None):
    """One run: this process imports the port from ``tree``; returns the
    run's numbers."""
    script_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [x for x in sys.path
                            if os.path.abspath(x or '.') != script_dir]
    import numpy as np
    import torch

    from ciri_long_tpu_torch.misc import kexp
    from ciri_long_tpu_torch.misc.kexp import nvidia_smi, time_launches
    from ciri_long_tpu_torch.ops import sw

    if not os.path.abspath(sw.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError('imported {} instead of {}'.format(sw.__file__,
                                                              tree))
    dev = torch.device('cuda')
    params = sw.SWParams(10, 4, 8, 2)
    rng = np.random.default_rng(0)
    out = dict(tree=tree, card=nvidia_smi())
    for name, (B, Lq, Lr) in SHAPES.items():
        q, r = (torch.from_numpy(rng.integers(0, 4, shape).astype(
            np.int8)).to(dev) for shape in ((B, Lq), (B, Lr)))
        out[name + '_ms'] = time_launches(
            lambda: sw.sw_score_ends_wave_cuda(q, r, params),
            3 if name == 'K3' else 10, dev, graph=True)
    if inputs:
        total = 0.0
        launches = torch.load(inputs)
        for qh, rh, p in launches:
            qd, rd = qh.to(dev), rh.to(dev)
            p = sw.SWParams(*p)
            total += time_launches(
                lambda: sw.sw_score_ends_wave_cuda(qd, rd, p), 3, dev,
                graph=True)
        out.update(inputs_launches=len(launches), inputs_device_ms=total)
    if tiled is not None:
        out.update(time_tiled(sw, dev, rng, params, tiled))
    for shape, (B, Lq, Lr) in PROBE_SHAPES.items() if probes else ():
        q, r = (torch.from_numpy(rng.integers(0, 4, size).astype(
            np.int8)).to(dev) for size in ((B, Lq), (B, Lr)))
        for name, fn in PROBES.items():
            out['{}_{}_ms'.format(name, shape)] = time_launches(
                lambda: fn(kexp, q, r, params), 10, dev, graph=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python3 -m '
                                 'ciri_long_tpu_torch.tools.wave_ab')
    ap.add_argument('--other', required=True,
                    help='another checkout of this repository')
    ap.add_argument('--inputs', default=None,
                    help='recorded wavefront inputs (torch.save of '
                         '(query, ref, params) tuples)')
    ap.add_argument('--tiled', nargs='*', default=None, metavar='FILE',
                    help='also time the tiled route at its main-path shapes '
                         'and on these recorded tiled launches')
    ap.add_argument('--probes', action='store_true',
                    help="also time the harness's chain and row scan")
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tree:                          # one run, in its own process
        print(json.dumps(time_tree(args.tree, args.inputs, args.probes,
                                   args.tiled)), flush=True)
        return None
    other = os.path.abspath(args.other)
    inputs = args.inputs and os.path.abspath(args.inputs)
    tiled = ([] if args.tiled is None else
             ['--tiled'] + [os.path.abspath(x) for x in args.tiled])
    runs = []
    for tree in (other, HERE, HERE, other):
        cmd = [sys.executable, os.path.abspath(__file__), '--other', other,
               '--tree', tree] + (['--inputs', inputs] if inputs else []) + (
                   ['--probes'] if args.probes else []) + tiled
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError('run in {} failed:\n{}'.format(
                tree, proc.stderr[-4000:]))
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for key in runs[0]:
        if not key.endswith('_ms'):
            continue
        mine = (runs[1][key] + runs[2][key]) / 2
        theirs = (runs[0][key] + runs[3][key]) / 2
        summary[key] = dict(this=mine, other=theirs, ratio=mine / theirs)
    line = dict(summary=summary, other=other, card=runs[0]['card'])
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
