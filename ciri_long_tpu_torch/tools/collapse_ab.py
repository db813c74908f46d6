"""``collapse --device cuda`` of two checkouts, in turns on one card: the
wall and its POA seconds.

    python3 -m ciri_long_tpu_torch.tools.collapse_ab --other DIR
        [--cand FILE --ref FILE] [--runs N]

DIR is another checkout of this repository (the parent commit, say,
unpacked with ``git archive``); both must have their native host cores
built (``python3 setup.py build_ext --inplace``).  FILE defaults are the
cohort of chip_smoke.py's phase 8 (build/chip_smoke/cohort: its ``call``
output and genome), the 4 000-read cohort of benchmarks/collapse_bench.py.
Four runs, each a process of its own on the same card, in turns: DIR, this
checkout, this checkout, DIR.  Each builds its kernels, runs ``collapse`` N
times (default 2) through its CLI on one sample and reports the last: its
wall, and the seconds its threads spent in the junction consensus
(``pipeline/collapse.py``'s ``poa``) and in the sub-cluster consensus
(``poa_consensus_many``), summed over the threads, and its kernels' launch
counts.  The four runs' .info, .reads, .expression and .isoforms must be
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
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COHORT = os.path.join(HERE, 'build', 'chip_smoke', 'cohort')
FILES = ('info', 'reads', 'expression', 'isoforms')
POA_CALLS = {'poa_junction_s': 'poa', 'poa_subcluster_s': 'poa_consensus_many'}


def run_tree(tree, cand, ref, out, runs):
    """One run: this process imports the port from ``tree``; returns the
    run's numbers."""
    script_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [x for x in sys.path
                            if os.path.abspath(x or '.') != script_dir]
    import torch

    from ciri_long_tpu_torch.cli.main import main
    from ciri_long_tpu_torch.misc.kexp import nvidia_smi
    from ciri_long_tpu_torch.ops import _build
    from ciri_long_tpu_torch.pipeline import collapse
    from ciri_long_tpu_torch.tools.world import sample_list
    from ciri_long_tpu_torch.utils.dispatch import (COLLAPSE_KERNELS,
                                                    launch_counts,
                                                    reset_launches)

    if not os.path.abspath(collapse.__file__).startswith(
            os.path.abspath(tree)):
        raise RuntimeError('imported {} instead of {}'.format(
            collapse.__file__, tree))
    _build.build_all(sorted(p.name for p in _build.CSRC.glob('*.cu')))
    torch.cuda.init()
    lock = threading.Lock()
    seconds = {}
    for key, attr in POA_CALLS.items():
        fn = getattr(collapse, attr)

        def timed(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                with lock:
                    seconds[_key] = seconds.get(_key, 0.0) + \
                        time.perf_counter() - t0
        setattr(collapse, attr, timed)
    os.makedirs(out, exist_ok=True)
    lst = sample_list(os.path.join(out, 'samples.lst'), [('s1', cand)])
    for _ in range(runs):
        for key in POA_CALLS:
            seconds[key] = 0.0
        dst = os.path.join(out, 'collapse')
        shutil.rmtree(dst, ignore_errors=True)
        reset_launches()
        t0 = time.perf_counter()
        main(['collapse', '-i', lst, '-o', dst, '-r', ref, '-p', 'ab',
              '-t', '1', '--device', 'cuda'])
        wall = time.perf_counter() - t0
    digest = {ext: hashlib.sha1(open(os.path.join(
        dst, 'ab.' + ext), 'rb').read()).hexdigest() for ext in FILES}
    return dict(tree=tree, wall_s=wall, **seconds,
                launches=launch_counts(COLLAPSE_KERNELS), files=digest,
                card=nvidia_smi())


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python3 -m '
                                 'ciri_long_tpu_torch.tools.collapse_ab')
    ap.add_argument('--other', required=True,
                    help='another checkout of this repository')
    ap.add_argument('--cand', default=os.path.join(COHORT, 'call',
                                                   'cohort.cand_circ.fa'))
    ap.add_argument('--ref', default=os.path.join(COHORT, 'world',
                                                  'genome.fa'))
    ap.add_argument('--runs', type=int, default=2,
                    help='collapse runs a process; the last is reported')
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--out', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cand, ref = os.path.abspath(args.cand), os.path.abspath(args.ref)
    if args.tree:                          # one run, in its own process
        print(json.dumps(run_tree(args.tree, cand, ref, args.out,
                                  args.runs)), flush=True)
        return None
    other = os.path.abspath(args.other)
    runs = []
    for k, tree in enumerate((other, HERE, HERE, other)):
        out = os.path.join(HERE, 'build', 'collapse_ab', str(k))
        cmd = [sys.executable, os.path.abspath(__file__), '--other', other,
               '--tree', tree, '--out', out, '--cand', cand, '--ref', ref,
               '--runs', str(args.runs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError('run in {} failed:\n{}'.format(
                tree, proc.stderr[-4000:]))
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if any(r['files'] != runs[0]['files'] for r in runs):
        raise AssertionError('the checkouts wrote different collapse files')
    summary = {}
    for key in ('wall_s',) + tuple(POA_CALLS):
        mine = (runs[1][key] + runs[2][key]) / 2
        theirs = (runs[0][key] + runs[3][key]) / 2
        summary[key] = dict(this=mine, other=theirs, ratio=mine / theirs)
    line = dict(summary=summary, other=other, files_identical=True,
                card=runs[0]['card'])
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
