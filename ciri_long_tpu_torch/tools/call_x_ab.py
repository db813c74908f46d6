"""call's chaining, screen and polish kernels of two checkouts timed in turns
on one card: csrc/chain_dp.cu's DP and extraction (X2), csrc/screen_keep.cu
(X3), its lag-range counts csrc/tandem_counts.cu and
the lag profile csrc/lag_profile.cu, and csrc/nw_traceback.cu (X4).

    python3 -m ciri_long_tpu_torch.tools.call_x_ab --other DIR
        [--inputs FILE] [--nw-inputs FILE]

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
same in both runs); then ``tandem_counts_cuda`` (csrc/tandem_counts.cu,
the mesh's lag shard, where the checkout has it) on the recorded screen
launch's reads at MAX_LAG lags in 1, 2 and 4 ranges, and on each
SCREEN_CASES launch's reads at SCREEN_WIDTH // 2 lags, and the dry run's
2 x 192 x 32; then, where the checkout
has them, ``lag_profile_cuda`` (csrc/lag_profile.cu) on the recorded
screen launch's reads at MAX_LAG lags (``lag_profile_call_ms``) and both
it and ``tandem_counts_cuda`` on each LAG_SHAPES batch
at MAX_LAG lags (``lag_profile_{shape}_ms``, ``tandem_wide_{shape}_ms``:
6 reads of 4 097 and of 16 384 codes and 256 of 8 192, every other read a
rolling-circle read, seed 0, made here).  First X4
(build/chip_smoke/call_nw_inputs.pt, the
default of --nw-inputs, written by chip_smoke.py: codes, lengths, bands
and offsets, no plan): the pairs of call's largest nw_traceback launch
(``nw_largest_ms``) and all the pairs of call's first-band launches as one
batch (``nw_all_ms``, the parent's megabatch before megabatches of 500
reads), each planned by the checkout's own ``nw_plan`` and launched by its
own ``nw_traceback_cuda``, each launch of the plan timed as a CUDA graph's
replay of 10 and summed, with the plan's shape, the resident warps an SM
it allows and, where the checkout's wrapper takes stamps, its first
launch split into passes and walk (``nw_split``).  Either input file may be
absent; its part is then left out (the SCREEN_CASES timings need
neither).  Prints one JSON line a run, then the means of the two checkouts
and their ratio, with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
INPUTS = os.path.join(HERE, 'build', 'chip_smoke', 'call_x_inputs.pt')
NW_INPUTS = os.path.join(HERE, 'build', 'chip_smoke', 'call_nw_inputs.pt')
SMEM_SM = 233472               # an H100 SM's shared memory (bytes)
SCREEN_READS = 1104            # call's screen launch on chip_smoke's world
SCREEN_WIDTH = 4096
SCREEN_CASES = ('poly_a', 'dinucleotide', 'trinucleotide', 'period_50',
                'random', 'all_n')
# the lag-range kernels' wide shapes (reads, codes)
LAG_SHAPES = {'6x4097': (6, 4097), '6x16384': (6, 16384),
              '256x8192': (256, 8192)}


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


def lag_case(name, seed=0):
    """int8 reads [B, W] of LAG_SHAPES[name], no PAD: every other read a
    random unit of 200-1 500 codes repeated, the rest random codes."""
    import numpy as np

    B, W = LAG_SHAPES[name]
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, (B, W)).astype(np.int8)
    for b in range(0, B, 2):
        reads[b] = np.resize(rng.integers(0, 4, int(rng.integers(200, 1501))),
                             W)
    return reads


def nw_plan_shape(ntb, launch):
    """A launch's plan and its resident warps an SM: the checkout's width
    classes with the occupancy calculator's answer, or, for a plan of one
    row width (a checkout before the classes), its warps and widest band
    with the warps its blocks' shared memory lets an SM hold."""
    if hasattr(launch, 'classes'):
        return dict(classes=[[c.route, c.C, c.count, c.warps]
                             for c in launch.classes],
                    resident_warps=ntb.nw_occupancy(launch))
    smem = launch.warps * ntb.ROW_INTS * 4 * launch.wcap
    blocks = (min(32, 64 // launch.warps, SMEM_SM // (smem + 1024))
              if not launch.rows_global else 64 // launch.warps)
    return dict(warps=launch.warps, wcap=launch.wcap,
                rows_global=launch.rows_global, block_smem=smem,
                resident_warps=blocks * launch.warps)


def nw_split(torch, dev, q, r, launch, *scores):
    """One launch of csrc/nw_traceback.cu with %globaltimer stamps (a
    checkout whose wrapper takes ``stamps=``): the launch's span, its
    traceback passes' rows and walk and its check passes' rows (ms, the
    longest and the mean), each class's span and tasks, and the resident
    warps an SM of each class (ops/nw_tb_batch.py::nw_occupancy)."""
    import numpy as np
    from ciri_long_tpu_torch.ops import nw_tb_batch as ntb

    stamps = torch.zeros((2 * len(launch.pairs), 3), dtype=torch.int64,
                         device=dev)
    ntb.nw_traceback_cuda(q, r, launch, *scores, stamps=stamps)
    torch.cuda.synchronize(dev)
    st = stamps.cpu().numpy().astype(np.float64) * 1e-6
    t0 = st[:, 0].min()
    rows, walk = st[:, 1] - st[:, 0], st[:, 2] - st[:, 1]
    tasks = launch.tasks.cpu().numpy()

    def stat(x):
        return {'max_ms': float(x.max()), 'mean_ms': float(x.mean())} \
            if len(x) else None

    classes = []
    for c in launch.classes:
        t = tasks[c.start:c.start + c.count]
        classes.append(dict(route=c.route, C=c.C, tasks=c.count,
                            warps=c.warps,
                            span_ms=float(st[t, 2].max() - st[t, 0].min()),
                            rows=stat(rows[t]),
                            walk=stat(walk[t[t % 2 == 0]])))
    return dict(span_ms=float(st[:, 2].max() - t0),
                traceback_rows=stat(rows[0::2]), walk=stat(walk[0::2]),
                check_rows=stat(rows[1::2]),
                rows_end_ms=float(st[:, 1].max() - t0),
                classes=classes, resident_warps=ntb.nw_occupancy(launch))


def time_nw(torch, dev, pairs, time_launches):
    """X4 in this checkout: recorded pairs planned and launched by its own
    nw_plan and nw_traceback_cuda; (summed ms, plan shapes, the first
    launch's split where the checkout has stamps)."""
    from ciri_long_tpu_torch.ops import nw_tb_batch as ntb

    q, r = pairs['q'].to(dev), pairs['r'].to(dev)
    launches = ntb.nw_plan(pairs['n'], pairs['m'], pairs['band'],
                           pairs['q_off'], pairs['r_off'], dev)
    total = 0.0
    for launch in launches:
        total += time_launches(lambda: ntb.nw_traceback_cuda(
            q, r, launch, *pairs['scores']), 10, dev, graph=True)
    split = (nw_split(torch, dev, q, r, launches[0], *pairs['scores'])
             if hasattr(launches[0], 'classes') else None)
    return total, [nw_plan_shape(ntb, x) for x in launches], split


def time_tree(tree, inputs, nw_inputs=None):
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
    if nw_inputs and os.path.exists(nw_inputs):
        saved = torch.load(nw_inputs, weights_only=False)
        for key in ('largest', 'all'):
            (out['nw_{}_ms'.format(key)], out['nw_{}_plan'.format(key)],
             out['nw_{}_split'.format(key)]) = time_nw(
                 torch, dev, saved[key], time_launches)
    screened = None
    if os.path.exists(inputs):
        recorded, screened = time_recorded(torch, dev, torch.load(inputs),
                                           time_launches)
        out.update(recorded)
    for name in SCREEN_CASES:
        reads, lens, lags = (torch.from_numpy(a).to(dev)
                             for a in screen_case(name))
        out['screen_{}_ms'.format(name)] = time_launches(
            lambda: period.screen_keep_cuda(reads, lens, lags), 10, dev,
            graph=True)
    if hasattr(period, 'tandem_counts_cuda'):
        out.update(time_tandem(dev, screened, period, time_launches))
    if hasattr(period, 'lag_profile_cuda'):
        out.update(time_lag(dev, screened, period, time_launches))
    return out


def time_recorded(torch, dev, saved, time_launches):
    """X2 and X3 in this checkout on call's recorded launches (``saved``,
    chip_smoke.py's X_INPUTS); (their numbers, the screen launch's reads on
    the card)."""
    from ciri_long_tpu_torch.ops import chain, period

    def on_card(args):
        return [a.to(dev) if torch.is_tensor(a) else a for a in args]

    out = {}
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
    return out, scr[0]


def time_tandem(dev, screened, period, time_launches):
    """csrc/tandem_counts.cu in this checkout: call's screened reads (on the
    card, or None) at MAX_LAG lags cut into 1, 2 and 4 ranges (the ranges'
    launches summed, ``tandem_call_{n}_ms``), each SCREEN_CASES launch's
    reads at SCREEN_WIDTH // 2 lags (``tandem_{case}_ms``) and the dry
    run's 2 x 192 random codes at 32 lags (``tandem_dryrun_ms``), each
    launch a CUDA graph's replay of 10."""
    import numpy as np
    import torch

    launches = {}
    if screened is not None:
        for parts in (1, 2, 4):
            w = period.MAX_LAG // parts
            launches['call_{}'.format(parts)] = [(screened, w, t * w)
                                                 for t in range(parts)]
    for name in SCREEN_CASES:
        launches[name] = [(torch.from_numpy(screen_case(name)[0]).to(dev),
                           SCREEN_WIDTH // 2, 0)]
    launches['dryrun'] = [(torch.from_numpy(np.random.default_rng(0).integers(
        0, 4, (2, 192)).astype(np.int8)).to(dev), 32, 0)]

    def timed(runs):
        return sum(time_launches(lambda r=r: period.tandem_counts_cuda(
            r[0], r[1], 11, r[2]), 10, dev, graph=True) for r in runs)

    return {'tandem_{}_ms'.format(name): timed(runs)
            for name, runs in launches.items()}


def time_lag(dev, screened, period, time_launches):
    """csrc/lag_profile.cu and csrc/tandem_counts.cu in this checkout, each launch a CUDA graph's replay of 10: the profile on
    call's screened reads (on the card, or None) at MAX_LAG lags, both on
    each LAG_SHAPES batch at MAX_LAG lags."""
    import torch

    M = period.MAX_LAG
    out = {}
    if screened is not None:
        out['lag_profile_call_ms'] = time_launches(
            lambda: period.lag_profile_cuda(screened, M), 10, dev,
            graph=True)
    for name in LAG_SHAPES:
        reads = torch.from_numpy(lag_case(name)).to(dev)
        out['lag_profile_{}_ms'.format(name)] = time_launches(
            lambda: period.lag_profile_cuda(reads, M), 10, dev, graph=True)
        out['tandem_wide_{}_ms'.format(name)] = time_launches(
            lambda: period.tandem_counts_cuda(reads, M), 10, dev,
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
    ap.add_argument('--nw-inputs', default=NW_INPUTS,
                    help="the pairs of call's largest X4 launch (torch.save "
                         'of a dict: q, r, n, m, band, q_off, r_off, '
                         'scores)')
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    inputs = os.path.abspath(args.inputs)
    nw_inputs = os.path.abspath(args.nw_inputs)
    if args.tree:                          # one run, in its own process
        print(json.dumps(time_tree(args.tree, inputs, nw_inputs)),
              flush=True)
        return None
    other = os.path.abspath(args.other)
    runs = []
    for tree in (other, HERE, HERE, other):
        cmd = [sys.executable, os.path.abspath(__file__), '--other', other,
               '--tree', tree, '--inputs', inputs, '--nw-inputs', nw_inputs]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError('run in {} failed:\n{}'.format(
                tree, proc.stderr[-4000:]))
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for key in runs[0]:
        if not key.endswith('_ms') or key not in runs[3]:
            continue
        mine = (runs[1][key] + runs[2][key]) / 2
        theirs = (runs[0][key] + runs[3][key]) / 2
        summary[key] = dict(this=mine, other=theirs, ratio=mine / theirs)
    line = dict(summary=summary, other=other, card=runs[0]['card'])
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
