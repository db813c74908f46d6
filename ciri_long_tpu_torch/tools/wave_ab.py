"""The wavefront route of csrc/sw_score_ends.cu in two checkouts, on one card.

    python3 -m ciri_long_tpu_torch.tools.wave_ab --other DIR [--inputs FILE]

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
each), summed.  Prints one JSON line a run, then the means of the two
checkouts and their ratio, with the card's name and power limit.
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


def time_tree(tree, inputs):
    """One run: this process imports the port from ``tree``; returns the
    run's numbers."""
    script_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [x for x in sys.path
                            if os.path.abspath(x or '.') != script_dir]
    import numpy as np
    import torch

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
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python3 -m '
                                 'ciri_long_tpu_torch.tools.wave_ab')
    ap.add_argument('--other', required=True,
                    help='another checkout of this repository')
    ap.add_argument('--inputs', default=None,
                    help='recorded wavefront inputs (torch.save of '
                         '(query, ref, params) tuples)')
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.tree:                          # one run, in its own process
        print(json.dumps(time_tree(args.tree, args.inputs)), flush=True)
        return None
    other = os.path.abspath(args.other)
    inputs = args.inputs and os.path.abspath(args.inputs)
    runs = []
    for tree in (other, HERE, HERE, other):
        cmd = [sys.executable, os.path.abspath(__file__), '--other', other,
               '--tree', tree] + (['--inputs', inputs] if inputs else [])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError('run in {} failed:\n{}'.format(
                tree, proc.stderr[-4000:]))
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for key in [name + '_ms' for name in SHAPES] + ['inputs_device_ms']:
        if key not in runs[0]:
            continue
        mine = (runs[1][key] + runs[2][key]) / 2
        theirs = (runs[0][key] + runs[3][key]) / 2
        summary[key] = dict(this=mine, other=theirs, ratio=mine / theirs)
    line = dict(summary=summary, other=other, card=runs[0]['card'])
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
