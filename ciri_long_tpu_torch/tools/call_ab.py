"""``call`` of two checkouts, in turns on one card: the wall.

    python3 -m ciri_long_tpu_torch.tools.call_ab --other DIR
        [--reads FILE --ref FILE] [--runs N] [--devices cuda,cpu]
        [--threads T]

DIR is another checkout of this repository (the parent commit, say,
unpacked with ``git archive``); both must have their native host cores
built (``python3 setup.py build_ext --inplace``).  FILE defaults are the
world of chip_smoke.py's phase 4 (build/chip_smoke/world: 1 200 Nanopore
reads of 16 loci on a 2 Mb genome).  Four runs, each a process of its own
on the same card, in turns: DIR, this checkout, this checkout, DIR.  Each
builds its kernels, runs ``call`` N times (default 2) through its CLI with
``-t T`` (default 1; above 1 a spawn pool of T host workers beside the
card, which both checkouts must support) on each device of --devices
(default cuda) and reports the last of each: its wall, reads/s and its kernels' launch counts (the first
device's as ``wall_s``, ``reads_per_s``, the others' with the device's
name before them, ``cpu_wall_s``).  The runs' cand_circ.fa must be
byte-identical.  Prints one JSON line a run, then the means of the two
checkouts and their ratio, with the card's name and power limit.
"""

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORLD = os.path.join(HERE, 'build', 'chip_smoke', 'world')


def run_tree(tree, reads, ref, out, runs, devices=('cuda',), threads=1):
    """One run: this process imports the port from ``tree``; returns the
    run's numbers."""
    script_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [x for x in sys.path
                            if os.path.abspath(x or '.') != script_dir]
    import torch

    from ciri_long_tpu_torch.cli import main as cli
    from ciri_long_tpu_torch.misc.kexp import nvidia_smi
    from ciri_long_tpu_torch.ops import _build

    if not os.path.abspath(cli.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError('imported {} instead of {}'.format(cli.__file__,
                                                              tree))
    _build.build_all(sorted(p.name for p in _build.CSRC.glob('*.cu'))
                     + sorted(p.name for p in _build.CSRC.glob('*.cpp')))
    torch.cuda.init()
    with open(reads) as f:
        n_reads = sum(1 for ln in f if ln.startswith('>'))
    res = dict(tree=tree, threads=threads, card=nvidia_smi())
    for k, device in enumerate(devices):
        for _ in range(runs):
            dst = os.path.join(out, 'call_' + device)
            shutil.rmtree(dst, ignore_errors=True)
            t0 = time.perf_counter()
            cli.main(['call', '-i', reads, '-o', dst, '-r', ref, '-p', 'ab',
                      '-t', str(threads), '--device', device])
            wall = time.perf_counter() - t0
        with open(os.path.join(dst, 'ab.json')) as f:
            kernels = json.load(f)['kernels']
        with open(os.path.join(dst, 'ab.cand_circ.fa'), 'rb') as f:
            digest = hashlib.sha1(f.read()).hexdigest()
        pre = '' if k == 0 else device + '_'
        res.update({pre + 'wall_s': wall, pre + 'reads_per_s': n_reads / wall,
                    pre + 'kernels': kernels, pre + 'cand_circ': digest})
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python3 -m '
                                 'ciri_long_tpu_torch.tools.call_ab')
    ap.add_argument('--other', required=True,
                    help='another checkout of this repository')
    ap.add_argument('--reads', default=os.path.join(WORLD, 'reads.fa'))
    ap.add_argument('--ref', default=os.path.join(WORLD, 'genome.fa'))
    ap.add_argument('--runs', type=int, default=2,
                    help='call runs a process; the last is reported')
    ap.add_argument('--devices', default='cuda',
                    help='comma-separated devices of call, each timed in '
                         'every run')
    ap.add_argument('--threads', type=int, default=1,
                    help='call -t of every run')
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--out', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    reads, ref = os.path.abspath(args.reads), os.path.abspath(args.ref)
    devices = tuple(args.devices.split(','))
    if args.tree:                          # one run, in its own process
        print(json.dumps(run_tree(args.tree, reads, ref, args.out,
                                  args.runs, devices, args.threads)),
              flush=True)
        return None
    other = os.path.abspath(args.other)
    runs = []
    for k, tree in enumerate((other, HERE, HERE, other)):
        out = os.path.join(HERE, 'build', 'call_ab', str(k))
        cmd = [sys.executable, os.path.abspath(__file__), '--other', other,
               '--tree', tree, '--out', out, '--reads', reads, '--ref', ref,
               '--runs', str(args.runs), '--devices', args.devices,
               '--threads', str(args.threads)]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError('run in {} failed:\n{}'.format(
                tree, proc.stderr[-4000:]))
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    digests = {v for r in runs for k, v in r.items()
               if k.endswith('cand_circ')}
    if len(digests) != 1:
        raise AssertionError('the runs wrote different cand_circ.fa')
    summary = {}
    for key in [k for k in runs[0] if k.endswith(('wall_s', 'reads_per_s'))]:
        mine = (runs[1][key] + runs[2][key]) / 2
        theirs = (runs[0][key] + runs[3][key]) / 2
        summary[key] = dict(this=mine, other=theirs, ratio=mine / theirs)
    line = dict(summary=summary, other=other, cand_identical=True,
                card=runs[0]['card'])
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
