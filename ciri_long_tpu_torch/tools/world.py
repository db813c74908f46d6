"""Seeded synthetic worlds for driving ``call`` end to end.

``make_world``: a random single-contig genome with circRNA loci
(``random_loci``, canonical splice signals planted), rolling-circle reads
over each locus and linear background reads, all from
``ciri_long_tpu.tools.simulate`` and one numpy seed.  ``skill_world``: the
repo's small verification world (one circRNA at chr1:20001-20520 of a
50 kb genome, 10 circular + 4 linear reads).
``bsj_accuracy``: recall/precision of a ``cand_circ.fa`` against the
simulated truth (the scoring rule of benchmarks/validate.py: a call
matches a locus when both ends lie within ``tol`` bp).
"""

import os

import numpy as np

from ciri_long_tpu.io.genome import Genome
from ciri_long_tpu.tools.simulate import (mutate, plant_splice_signals,
                                          random_loci, simulate_linear,
                                          simulate_reads)


def _write_fasta(path, name, seq):
    with open(path, 'w') as f:
        f.write('>{}\n'.format(name))
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + '\n')


def rolling_read(rng, unit, copies=3.5, rot=0, noise=0.02):
    """A rolling-circle read: ``copies`` mutated copies of the rotated
    unit (the recipe of tests/test_pipeline_call.py::make_rolling_read)."""
    unit_rot = unit[rot:] + unit[:rot]
    n_full = int(copies)
    frac = copies - n_full
    parts = [mutate(rng, unit_rot, sub=noise, ins=noise / 2, dele=noise / 2)
             for _ in range(n_full)]
    if frac > 0:
        parts.append(mutate(rng, unit_rot[:int(len(unit) * frac)], sub=noise,
                            ins=noise / 2, dele=noise / 2))
    return ''.join(parts)


def skill_world(root):
    """Write the small verification world (seed 1234) to
    ``root/genome.fa`` and ``root/reads.fa``; returns their paths.  The
    expected call is BSJ 10 at chr1:20001-20520."""
    rng = np.random.default_rng(1234)
    start, end = 20_000, 20_520
    chr1 = list(''.join(rng.choice(list('ACGT'), size=50_000)))
    chr1[start - 2:start] = list('AG')
    chr1[end:end + 2] = list('GT')
    chr1 = ''.join(chr1)
    unit = chr1[start:end]
    os.makedirs(root, exist_ok=True)
    ref = os.path.join(root, 'genome.fa')
    _write_fasta(ref, 'chr1', chr1)
    reads = os.path.join(root, 'reads.fa')
    with open(reads, 'w') as f:
        for i in range(10):
            f.write('>circ_read_{}\n{}\n'.format(i, rolling_read(
                rng, unit, copies=3.2 + 0.3 * i, rot=(i * 53) % len(unit),
                noise=0.02)))
        for i in range(4):
            st = 30_000 + i * 1500
            f.write('>lin_read_{}\n{}\n'.format(
                i, mutate(rng, chr1[st:st + 1200], sub=0.02)))
    return ref, reads


def make_world(root, genome_kb=2000, loci=16, depth=60, linear=240,
               seed=0):
    """Write ``root/genome.fa`` and ``root/reads.fa``.  Returns (genome
    path, reads path, truth loci as [(contig, start1, end)]).

    Reads carry the empirical ONT error model with adapter debris and rare
    chimeras (tools/simulate.py::NANOPORE_PROFILE, benchmarks/validate.py
    --profile nanopore): the tool's real input, and the one that leaves
    clipped bases for the +-200 kb window SW.  Under a uniform 2 % error
    profile no read of such a world leaves 20 clipped bases, so ``call``
    never reaches the SW."""
    rng = np.random.default_rng(seed)
    chars = list(''.join(rng.choice(list('ACGT'), size=genome_kb * 1000)))
    truth_loci = random_loci(Genome.from_dict({'chr1': ''.join(chars)}), rng,
                             loci)
    chr1 = ''.join(plant_splice_signals(chars, truth_loci))
    genome = Genome.from_dict({'chr1': chr1})
    os.makedirs(root, exist_ok=True)
    ref = os.path.join(root, 'genome.fa')
    _write_fasta(ref, 'chr1', chr1)
    reads = os.path.join(root, 'reads.fa')
    with open(reads, 'w') as f:
        for rid, seq, _cid in simulate_reads(genome, truth_loci, rng,
                                             depth=depth, profile='nanopore',
                                             artifacts=True):
            f.write('>{}\n{}\n'.format(rid, seq))
        for rid, seq in simulate_linear(genome, rng, n=linear,
                                        profile='nanopore'):
            f.write('>{}\n{}\n'.format(rid, seq))
    truth = [(ctg, exons[0][0] + 1, exons[-1][1])
             for ctg, exons, _strand in truth_loci]
    return ref, reads, truth


def bsj_accuracy(cand_circ_fa, truth, tol=5):
    """(recall, precision, n_called) of the distinct BSJs in a
    cand_circ.fa: recall over the true loci, precision over the called
    loci."""
    called = set()
    with open(cand_circ_fa) as f:
        for line in f:
            if line.startswith('>'):
                ctg, span = line.split('\t')[1].rsplit(':', 1)
                st, en = span.split('-')
                called.add((ctg, int(st), int(en)))

    def match(a, b):
        return (a[0] == b[0] and abs(a[1] - b[1]) <= tol
                and abs(a[2] - b[2]) <= tol)

    recall = sum(any(match(c, t) for c in called) for t in truth)
    precision = sum(any(match(c, t) for t in truth) for c in called)
    return (recall / max(1, len(truth)), precision / max(1, len(called)),
            len(called))
