"""call's chaining and screen kernels of two checkouts timed in turns on one
card: csrc/chain_dp.cu's DP and extraction (X2) and csrc/screen_keep.cu
(X3).

    python3 -m ciri_long_tpu_torch.tools.call_x_ab --other DIR
        [--inputs FILE]

DIR is another checkout of this repository (the parent commit, say,
unpacked with ``git archive``).  FILE holds call's largest launch of each
kernel (chip_smoke.py writes build/chip_smoke/call_x_inputs.pt, the
default).  Four runs, each in a process of its own on the same card, in
turns: DIR, this checkout, this checkout, DIR.  Each run builds its own
kernels and times, as a CUDA graph's replay of 10 launches
(kexp.time_launches; every wrapper has kept its signature since the first
checkout that had it), ``chain_dp_cuda``, ``chain_extract_cuda`` and
``screen_keep_cuda`` on FILE's launches, ``chain_extract_cuda`` on every
extraction launch of call's run summed (FILE's ``chain_extract_all``, 3
launches each), then ``screen_keep_cuda`` on each
launch of SCREEN_CASES: SCREEN_READS reads of SCREEN_WIDTH codes each, a
poly-A, a dinucleotide and a trinucleotide repeat, a perfect tandem repeat
of period 50, random codes and all N (seed 0, made here with numpy, the
same in both runs).  Prints one JSON line a run, then the means of the two
checkouts and their ratio, with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
INPUTS = os.path.join(HERE, 'build', 'chip_smoke', 'call_x_inputs.pt')
SCREEN_READS = 1104            # call's screen launch on chip_smoke's world
SCREEN_WIDTH = 4096
SCREEN_CASES = ('poly_a', 'dinucleotide', 'trinucleotide', 'period_50',
                'random', 'all_n')


def screen_case(name, B=SCREEN_READS, W=SCREEN_WIDTH, seed=0):
    """(reads int8 [B, W], lengths int32 [B], max_lag int32 [B]) of one
    SCREEN_CASES launch: every read W codes long at the widest bucket's lag
    range."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if name == 'poly_a':
        reads = np.zeros((B, W), np.int8)
    elif name in ('dinucleotide', 'trinucleotide', 'period_50'):
        p = {'dinucleotide': 2, 'trinucleotide': 3, 'period_50': 50}[name]
        units = rng.integers(0, 4, (B, p)).astype(np.int8)
        reads = np.tile(units, (1, W // p + 1))[:, :W]
    elif name == 'random':
        reads = rng.integers(0, 4, (B, W)).astype(np.int8)
    elif name == 'all_n':
        reads = np.full((B, W), 4, np.int8)
    else:
        raise ValueError('no screen case {!r}'.format(name))
    return (np.ascontiguousarray(reads), np.full(B, W, np.int32),
            np.full(B, W // 2, np.int32))


def time_tree(tree, inputs):
    """One run: this process imports the port from ``tree``; returns the
    run's numbers."""
    script_dir = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [x for x in sys.path
                            if os.path.abspath(x or '.') != script_dir]
    import torch

    from ciri_long_tpu_torch.misc.kexp import nvidia_smi, time_launches
    from ciri_long_tpu_torch.ops import chain, period

    if not os.path.abspath(chain.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError('imported {} instead of {}'.format(chain.__file__,
                                                              tree))
    dev = torch.device('cuda')
    out = dict(tree=tree, card=nvidia_smi())
    saved = torch.load(inputs)

    def on_card(args):
        return [a.to(dev) if torch.is_tensor(a) else a for a in args]

    dp = on_card(saved['chain_dp'])
    out['chain_dp_ms'] = time_launches(lambda: chain.chain_dp_cuda(*dp), 10,
                                       dev, graph=True)
    ext = on_card(saved['chain_extract'])
    plan = chain.extract_plan(
        (saved['chain_extract'][0][1:] - saved['chain_extract'][0][:-1])
        .numpy(), dev)
    out['chain_extract_ms'] = time_launches(
        lambda: chain.chain_extract_cuda(*ext, plan), 10, dev, graph=True)
    total = 0.0
    for args in saved.get('chain_extract_all', ()):
        a = on_card(args)
        p = chain.extract_plan((args[0][1:] - args[0][:-1]).numpy(), dev)
        total += time_launches(lambda: chain.chain_extract_cuda(*a, p), 3,
                               dev, graph=True)
    out['chain_extract_call_ms'] = total
    scr = on_card(saved['screen_keep'])
    out['screen_keep_ms'] = time_launches(
        lambda: period.screen_keep_cuda(*scr), 10, dev, graph=True)
    for name in SCREEN_CASES:
        reads, lens, lags = (torch.from_numpy(a).to(dev)
                             for a in screen_case(name))
        out['screen_{}_ms'.format(name)] = time_launches(
            lambda: period.screen_keep_cuda(reads, lens, lags), 10, dev,
            graph=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog='python3 -m '
                                 'ciri_long_tpu_torch.tools.call_x_ab')
    ap.add_argument('--other', required=True,
                    help='another checkout of this repository')
    ap.add_argument('--inputs', default=INPUTS,
                    help="call's largest X2/X3 launches (torch.save of a "
                         'dict of argument tuples)')
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    inputs = os.path.abspath(args.inputs)
    if args.tree:                          # one run, in its own process
        print(json.dumps(time_tree(args.tree, inputs)), flush=True)
        return None
    other = os.path.abspath(args.other)
    runs = []
    for tree in (other, HERE, HERE, other):
        cmd = [sys.executable, os.path.abspath(__file__), '--other', other,
               '--tree', tree, '--inputs', inputs]
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
