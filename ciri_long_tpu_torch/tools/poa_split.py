"""csrc/poa_align.cu's launch split into its row sweep and its walk, on one
card; with ``--other``, two checkouts in turns.

    python3 -m ciri_long_tpu_torch.tools.poa_split [--inputs FILE]
        [--other DIR] [--shapes]

The launch is FILE's (an .npz of ops/poa_batch.py::batch_arrays' six
arrays; chip_smoke.py writes the cohort collapse's largest launch to
build/chip_smoke/cohort_poa_largest.npz) or, without FILE, the largest
launch of ``poa_consensus_many`` on SYNTHETIC_READS reads mutated from one
template of SYNTHETIC_LENGTH bases (seed 0; the last round aligns 730 codes
to 1 542 nodes), kept by ops/poa.py::poa_launch_inputs.  Block 0's thread
0 stamps each launch with the card's %globaltimer at its start, when the
rows are done and when the walk is done (``poa_align_batch_cuda(...,
stamps=)``): ``rows_ms`` and ``walk_ms`` are the means over REPS launches,
``ms`` a CUDA graph's replay of 10 launches (kexp.time_launches), each
with the wrapper's plan made beforehand (``poa_plan``; ``checked=True``
in a checkout from before it, which planned nothing).  With
DIR (another checkout whose wrapper takes ``stamps=``), four runs in
processes of their own on the same card: DIR, this, this, DIR.  One JSON
line a run, then the means of the two checkouts with the card's name and
power limit.  ``--shapes`` also times this checkout's kernel under each
block of SHAPES (``poa_plan(shape=)``).
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SYNTHETIC_LENGTH = 740
SYNTHETIC_READS = 20
REPS = 20
# the blocks ``--shapes`` times in this checkout: (C columns a lane,
# threads)
SHAPES = ((1, 512), (1, 256), (2, 384), (2, 256), (2, 128), (4, 192),
          (4, 96))


def synthetic_reads():
    """The reads of the synthetic job (seeded)."""
    import numpy as np

    from ciri_long_tpu_torch.tools.simulate import mutate

    rng = np.random.default_rng(0)
    template = ''.join(rng.choice(list('ACGT'), size=SYNTHETIC_LENGTH))
    return [mutate(rng, template, 0.05, 0.04, 0.04)
            for _ in range(SYNTHETIC_READS)]


def split_tree(tree, inputs, shapes=False):
    """One run: this process imports the port from ``tree``; returns the
    run's numbers (with ``shapes``, also those of each block of SHAPES)."""
    script_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [x for x in sys.path
                            if os.path.abspath(x or '.') != script_dir]
    import numpy as np
    import torch

    from ciri_long_tpu_torch.misc.kexp import nvidia_smi, time_launches
    from ciri_long_tpu_torch.ops import poa as poa_mod
    from ciri_long_tpu_torch.ops import poa_batch

    if not os.path.abspath(poa_batch.__file__).startswith(
            os.path.abspath(tree)):
        raise RuntimeError('imported {} instead of {}'.format(
            poa_batch.__file__, tree))
    dev = torch.device('cuda')
    if inputs:
        with np.load(inputs) as f:
            arrays = [f[k] for k in ('bases', 'offs', 'preds', 'seqs', 'nv',
                                     'ns')]
    else:
        jobs = [synthetic_reads()]
        stats = {}
        poa_mod.poa_consensus_many(jobs, device='cuda', stats=stats)
        arrays = poa_mod.poa_launch_inputs(jobs, stats, device='cuda')[1]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]
    bases, offs, preds, seqs, nv, ns = arrays
    B = int(args[0].shape[0])
    out = dict(tree=tree, card=nvidia_smi(), B=B, Vmax=int(bases.shape[1]),
               nmax=int(seqs.shape[1]))
    if hasattr(poa_batch, 'poa_plan'):      # the plan made beforehand
        kw = dict(plan=poa_batch.poa_plan(offs, preds, nv, ns,
                                          bases.shape[1], seqs.shape[1],
                                          dev))
        out.update(depth=kw['plan'].depth, spill_rows=kw['plan'].spill_rows)
    else:                                   # a checkout from before it
        kw = dict(checked=True)
    out.update(time_split(torch, poa_batch, time_launches, args, kw, dev))
    if shapes:
        out['shapes'] = {}
        for C, threads in SHAPES:
            kw = dict(plan=poa_batch.poa_plan(
                offs, preds, nv, ns, bases.shape[1], seqs.shape[1], dev,
                shape=(C, threads)))
            out['shapes']['C{}T{}'.format(C, threads)] = time_split(
                torch, poa_batch, time_launches, args, kw, dev)
    return out


def time_split(torch, poa_batch, time_launches, args, kw, dev):
    """ms (a graph's replay of 10 launches), rows_ms and walk_ms (block 0's
    stamps, the mean of REPS launches) of one launch."""
    B = int(args[0].shape[0])
    stamps = torch.zeros((B, 3), dtype=torch.int64, device=dev)
    poa_batch.poa_align_batch_cuda(*args, **kw)
    rows, walk = [], []
    for _ in range(REPS):
        poa_batch.poa_align_batch_cuda(*args, stamps=stamps, **kw)
        t = stamps[0].tolist()
        rows.append((t[1] - t[0]) * 1e-6)
        walk.append((t[2] - t[1]) * 1e-6)
    ms = time_launches(lambda: poa_batch.poa_align_batch_cuda(*args, **kw),
                       10, dev, graph=True)
    return dict(ms=ms, rows_ms=sum(rows) / REPS, walk_ms=sum(walk) / REPS,
                rows_ms_min=min(rows), walk_ms_min=min(walk))


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python3 -m '
                                 'ciri_long_tpu_torch.tools.poa_split')
    ap.add_argument('--inputs', default=None,
                    help='a launch (.npz of batch_arrays\' six arrays)')
    ap.add_argument('--other', default=None,
                    help='another checkout of this repository')
    ap.add_argument('--shapes', action='store_true',
                    help='also time this checkout at each block of SHAPES')
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    inputs = args.inputs and os.path.abspath(args.inputs)
    if args.tree:                          # one run, in its own process
        print(json.dumps(split_tree(args.tree, inputs, args.shapes and
                                    args.tree == HERE)), flush=True)
        return None
    trees = [HERE]
    if args.other:
        other = os.path.abspath(args.other)
        trees = [other, HERE, HERE, other]
    runs = []
    for tree in trees:
        cmd = [sys.executable, os.path.abspath(__file__), '--tree', tree] + (
            ['--inputs', inputs] if inputs else []) + (
                ['--shapes'] if args.shapes else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError('run in {} failed:\n{}'.format(
                tree, proc.stderr[-4000:]))
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if len(runs) == 1:
        return runs[0]
    summary = {}
    for key in ('ms', 'rows_ms', 'walk_ms'):
        mine = (runs[1][key] + runs[2][key]) / 2
        theirs = (runs[0][key] + runs[3][key]) / 2
        summary[key] = dict(this=mine, other=theirs, ratio=mine / theirs)
    line = dict(summary=summary, other=trees[0], card=runs[0]['card'])
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
