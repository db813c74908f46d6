"""Entry points of the port's dry run: the twin of ``__graft_entry__.py``.

entry(): the forward step of the flagship compute model -- the batched
affine-gap Smith-Waterman scorer (ops/sw.py; csrc/sw_score_ends.cu on the
card), the kernel that replaces the reference's hottest native path
(vendored SSW, ssw.c:123).

dryrun_multichip(n): builds a (reads, lag) mesh of n shards
(parallel/mesh.py), runs one pipeline step on tiny shapes (reads over
'reads', the tandem counts' lags over 'lag', the positive SW count summed
over the mesh), then the sharded call scan over a small synthetic world,
whose cand_circ.fa must be byte-identical to the one-shard run.

Both run on the card unless the caller asks for the CPU; on cuda n is at
most the visible cards.
"""

import os
import tempfile

import numpy as np


def entry(device='cuda'):
    """(forward, (query, ref)): forward(query, ref) scores the batch on
    ``device`` and returns the int32 (score, q_end, r_end) tensors."""
    import torch

    from ciri_long_tpu_torch.ops.sw import SWParams, sw_score_ends_auto
    from ciri_long_tpu_torch.utils.dispatch import resolve_device

    dev = resolve_device(device)
    params = SWParams(10, 4, 8, 2)

    def forward(query, ref):
        return sw_score_ends_auto(
            torch.from_numpy(np.ascontiguousarray(query, np.int8)).to(dev),
            torch.from_numpy(np.ascontiguousarray(ref, np.int8)).to(dev),
            params)

    rng = np.random.default_rng(0)
    query = rng.integers(0, 4, (8, 256)).astype(np.int8)
    ref = rng.integers(0, 4, (8, 512)).astype(np.int8)
    return forward, (query, ref)


def _check(ok, what):
    if not ok:
        raise AssertionError('dryrun_multichip: ' + what)


def dryrun_multichip(n_devices: int, device='cuda') -> None:
    from ciri_long_tpu_torch.ops.sw import SWParams
    from ciri_long_tpu_torch.parallel.mesh import (LAG_AXIS, READS_AXIS,
                                                   make_mesh,
                                                   make_pipeline_step)

    mesh = make_mesh(n_devices, device=device)
    _check(mesh.shape[READS_AXIS] * mesh.shape[LAG_AXIS] == n_devices,
           'the mesh does not cover {} shards'.format(n_devices))

    rng = np.random.default_rng(0)
    B = mesh.shape[READS_AXIS] * 2
    max_lag = mesh.shape[LAG_AXIS] * 32
    reads = rng.integers(0, 4, (B, 192)).astype(np.int8)
    query = rng.integers(0, 4, (B, 96)).astype(np.int8)
    ref = rng.integers(0, 4, (B, 160)).astype(np.int8)

    step = make_pipeline_step(mesh, SWParams(1, 1, 1, 1), max_lag)
    prof, score, n_pos = step(reads, query, ref)
    _check(prof.shape == (B, max_lag), 'tandem counts of shape {}'.format(
        prof.shape))
    _check(score.shape == (B,), 'scores of shape {}'.format(score.shape))
    _check(n_pos >= 0, 'a negative positive count')

    # --- the sharded call scan (parallel/cohort.py::scan_ccs_sharded) over
    # a small synthetic dataset: the full scan dataflow runs over the
    # mesh's reads axis and must write cand_circ.fa bytes identical to the
    # one-shard run.
    from ciri_long_tpu_torch.context import Context
    from ciri_long_tpu_torch.io.genome import Genome
    from ciri_long_tpu_torch.models.aligner import GenomeAligner
    from ciri_long_tpu_torch.ops.ccs import find_consensus
    from ciri_long_tpu_torch.parallel.cohort import scan_ccs_sharded

    chr1 = list(''.join(rng.choice(list('ACGT'), size=24_000)))
    loci = []
    for t in range(2):
        st = 5_000 + t * 9_000
        en = st + 260 + 40 * t
        chr1[st - 2:st] = list('AG')
        chr1[en:en + 2] = list('GT')
        loci.append((st, en))
    chr1 = ''.join(chr1)
    genome = Genome.from_dict({'chr1': chr1})
    ctx = Context(aligner=GenomeAligner(genome), genome=genome)

    bases = np.array(list('ACGT'))
    ccs_seq = {}
    n = 0
    for st, en in loci:
        unit = chr1[st:en]
        for d in range(3):
            rot = (d * 97) % len(unit)
            u = unit[rot:] + unit[:rot]
            read = (u * 4)[:int(len(u) * (3.0 + 0.3 * d))]
            # light substitution noise
            arr = np.array(list(read))
            flips = rng.random(len(arr)) < 0.02
            arr[flips] = bases[rng.integers(0, 4, int(flips.sum()))]
            segments, ccs = find_consensus(''.join(arr))
            if segments is None:
                continue
            ccs_seq['read_{:03d}'.format(n)] = [segments, ccs, ''.join(arr)]
            n += 1
    _check(n >= 4, 'the dataset produced too few CCS reads')

    with tempfile.TemporaryDirectory() as td:
        os.makedirs(td + '/one', exist_ok=True)
        os.makedirs(td + '/many', exist_ok=True)
        cnt_a, _ = scan_ccs_sharded(
            make_mesh(1, lag_parallel=1, device=device), ctx, ccs_seq, True,
            td + '/one', 'p')
        cnt_b, _ = scan_ccs_sharded(
            make_mesh(n_devices, lag_parallel=1, device=device), ctx,
            ccs_seq, True, td + '/many', 'p')
        _check(dict(cnt_a) == dict(cnt_b), 'counters diverged')
        a = open(td + '/one/p.cand_circ.fa', 'rb').read()
        b = open(td + '/many/p.cand_circ.fa', 'rb').read()
        _check(a == b and len(a) > 0,
               'sharded scan bytes diverged from the one-shard run')
