"""Seeded synthetic worlds: the benchmark's inputs, made from ``--seed``.

NumPy only: nothing of the program is imported, so a change to the program
cannot move the yardstick.  ``build_world`` is the one general generator:
a configuration's genome, its circRNA loci and their annotation (a GTF),
and a traffic mix's read files, every read mutated at once by
``mutate_batch`` under one ONT error profile (``NANOPORE_PROFILE``).

The amount of work is the same for every seed: the loci, each sample's
reads a locus, the copies, debris and chimeras, and where errors fall come
from ``LAYOUT_SEED``; the genome's bases, the rotations, the bases that
errors put in and the order of the reads come from the seed.  Each read's
name says its sample and its true locus (``sample1_circ7_read3``,
``sample2_lin_read0``), which the checks read back.
"""

import json
import os

import numpy as np

ALPHABET = np.frombuffer(b'ACGT', np.uint8)
_COMP = bytes.maketrans(b'ATCG', b'TAGC')
LAYOUT_SEED = 0

# The ONT R9.4-style error profile of the port's tools/simulate.py: ~5-6 %
# errors, deletion-biased, growing in homopolymers, doubled near the ends.
NANOPORE_PROFILE = dict(sub=0.025, ins=0.015, dele=0.025,
                        hp_k=0.10, hp_cap=0.45, geo_p=0.55, end_ramp=30,
                        end_mult=2.0)

ADAPTER = "AATGTACTTCGTTCAGTTACGTATTGCT"


def revcomp(seq):
    return seq.translate(_COMP)[::-1]


def circ_sequence(chrom, exons, strand):
    seq = "".join(chrom[st:en] for st, en in exons)
    return revcomp(seq) if strand == '-' else seq


def random_loci(clen, rng, n, n_exons, exon_len, intron_len):
    """``n`` loci ``('chr1', [(start, end), ...], strand)`` (0-based,
    half-open exons), one in each of ``n`` equal slots of the contig."""
    slot = (clen - 2000) // max(1, n)
    loci = []
    for t in range(n):
        k = int(rng.integers(n_exons[0], n_exons[1] + 1))
        span_max = k * exon_len[1] + (k - 1) * intron_len[1]
        lo = 1000 + t * slot
        hi = max(lo + 1, lo + slot - span_max - 100)
        pos = int(rng.integers(lo, hi))
        exons = []
        for _ in range(k):
            el = int(rng.integers(exon_len[0], exon_len[1]))
            exons.append((pos, pos + el))
            pos += el + int(rng.integers(intron_len[0], intron_len[1]))
        strand = '+' if rng.random() < 0.5 else '-'
        loci.append(('chr1', exons, strand))
    return loci


def _write_fasta(path, name, seq):
    with open(path, 'w') as f:
        f.write('>{}\n'.format(name))
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + '\n')


def write_gtf(path, loci, clen):
    """A GTF of one host gene a locus: the circRNA's exons and an exon of
    100 bp 500 bp outside each end, as an annotation gives a circRNA's
    host gene."""
    with open(path, 'w') as f:
        for li, (ctg, exons, strand) in enumerate(loci):
            flank = [(max(0, exons[0][0] - 600), max(1, exons[0][0] - 500)),
                     *exons,
                     (min(clen - 1, exons[-1][1] + 500),
                      min(clen, exons[-1][1] + 600))]
            attrs = 'gene_id "G{0}"; gene_name "Gene{0}"; ' \
                    'gene_type "protein_coding";'.format(li)
            rows = [('gene', flank[0][0], flank[-1][1], attrs),
                    ('transcript', flank[0][0], flank[-1][1],
                     attrs + ' transcript_id "T{}";'.format(li))]
            rows += [('exon', st, en, attrs + ' transcript_id "T{}";'.format(
                li)) for st, en in flank]
            for kind, st, en, attr in rows:
                f.write('\t'.join([ctg, 'portbench', kind, str(st + 1),
                                   str(en), '.', strand, '.', attr]) + '\n')


def sample_list(path, samples):
    """The list file of ``collapse -i``: ``sample<TAB>cand_circ.fa`` a
    line."""
    with open(path, 'w') as f:
        for sample, cand_circ in samples:
            f.write('{}\t{}\n'.format(sample, cand_circ))
    return path


def mutate_batch(rng, seqs, layout, profile=None):
    """The ONT profile's errors over many reads at once (uint8 ASCII arrays
    in, out): homopolymer-growing deletions, substitutions, geometric
    insertions of up to 8 bases after a kept base, the rates doubled within
    ``end_ramp`` bases of each read's ends.  Where errors fall comes from
    ``layout`` (a fixed number of draws for a fixed total length), the
    bases they put in from ``rng``."""
    p = dict(NANOPORE_PROFILE)
    if profile:
        p.update(profile)
    lens = np.array([len(s) for s in seqs], np.int64)
    cat = np.concatenate(seqs)
    N = len(cat)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    idx = np.arange(N, dtype=np.int64)
    pos = idx - np.repeat(starts, lens)
    rl = np.repeat(lens, lens)
    near = (pos < p['end_ramp']) | (rl - pos <= p['end_ramp'])
    mult = np.where(near, p['end_mult'], 1.0)
    brk = np.ones(N, bool)
    brk[1:] = cat[1:] != cat[:-1]
    brk[starts] = True
    run = idx - np.maximum.accumulate(np.where(brk, idx, 0)) + 1
    dele = np.minimum(p['dele'] * mult + p['hp_k'] * np.maximum(0, run - 2),
                      p['hp_cap'])
    r = layout.random(N)
    ins_draw = layout.random(N)
    ins_len = np.minimum(layout.geometric(p['geo_p'], N), 8)
    keep = r >= dele
    sub = keep & (r < dele + p['sub'] * mult)
    base = cat.copy()
    base[sub] = ALPHABET[rng.integers(0, 4, int(sub.sum()))]
    ins = keep & (ins_draw < p['ins'] * mult)
    nins = np.where(ins, ins_len, 0)
    width = keep.astype(np.int64) + nins
    end = np.cumsum(width)
    out = np.empty(int(end[-1]) if N else 0, np.uint8)
    out[(end - width)[keep]] = base[keep]
    slots = np.repeat(end - nins, nins) + (
        np.arange(int(nins.sum())) - np.repeat(np.cumsum(nins) - nins, nins))
    out[slots] = ALPHABET[rng.integers(0, 4, len(slots))]
    new_lens = np.add.reduceat(width, starts) if N else lens
    return np.split(out, np.cumsum(new_lens)[:-1])


def _genome_and_loci(cfg, rng, layout):
    """The configuration's one contig (random bases from ``rng``) and its
    loci (from ``layout``), with the canonical splice signals planted."""
    size = int(cfg['genome_kb']) * 1000
    chars = ALPHABET[rng.integers(0, 4, size)]
    loci = random_loci(size, layout, int(cfg['loci']), tuple(cfg['exons']),
                       tuple(cfg['exon_len']), tuple(cfg['intron_len']))
    for _ctg, exons, strand in loci:
        before, after = (b'AG', b'GT') if strand == '+' else (b'AC', b'CT')
        for st, en in exons:
            chars[st - 2:st] = np.frombuffer(before, np.uint8)
            chars[en:en + 2] = np.frombuffer(after, np.uint8)
    return chars.tobytes().decode('ascii'), loci


def abundances(layout, n_loci, mix):
    """Each locus's share of a sample's circular reads: the mix's
    ``abundances`` (one weight a locus) where it lists them, else weights
    drawn log-normally with the mix's ``lognormal_sigma``."""
    if 'abundances' in mix:
        w = np.asarray(mix['abundances'], np.float64)
        if len(w) != n_loci:
            raise ValueError('abundances: {} weights for {} loci'.format(
                len(w), n_loci))
    else:
        w = layout.lognormal(0.0, float(mix['lognormal_sigma']), n_loci)
    return w / w.sum()


def _reads(rng, layout, chrom, loci, n, mix, sample, share):
    """``n`` reads of one file of ``sample``: a ``circular`` share of
    rolling circles (``copies`` of a rotated locus, each locus's number of
    reads a multinomial draw over ``share``), the rest linear
    ``linear_len`` bp spans, each read given adapter debris and chimeras at
    ``mix``'s rates.  The sizes come from ``layout``; rotations, positions,
    the bases errors put in and the order from ``rng``."""
    n_circ = int(round(n * float(mix['circular'])))
    per_locus = layout.multinomial(n_circ, share)
    units = [circ_sequence(chrom, ex, st).encode('ascii')
             for _ctg, ex, st in loci]
    names, clean = [], []
    lo, hi = mix['copies']
    for li, count in enumerate(per_locus.tolist()):
        unit = units[li]
        for k in range(count):
            copies = float(layout.uniform(lo, hi))
            rot = int(rng.integers(0, len(unit)))
            full = (unit[rot:] + unit[:rot]) * (int(copies) + 1)
            clean.append(full[:int(len(unit) * copies)])
            names.append('{}_circ{}_read{}'.format(sample, li, k))
    span = int(mix['linear_len'])
    for i in range(n - n_circ):
        st = int(rng.integers(0, len(chrom) - span))
        clean.append(chrom[st:st + span].encode('ascii'))
        names.append('{}_lin_read{}'.format(sample, i))
    adapter = ADAPTER.encode('ascii')
    pool = chrom[:2000].encode('ascii')
    out = []
    for seq in clean:
        if layout.random() < mix['adapter_rate']:
            seq = adapter + seq
        if layout.random() < mix['adapter_rate']:
            seq = seq + revcomp(ADAPTER).encode('ascii')
        if layout.random() < mix['chimera_rate']:
            cut = int(rng.integers(0, len(pool) - 400))
            frag = pool[cut:cut + int(layout.integers(100, 400))]
            seq = frag + seq if layout.random() < 0.5 else seq + frag
        out.append(np.frombuffer(seq, np.uint8))
    seqs = mutate_batch(rng, out, layout)
    order = rng.permutation(n)
    return [(names[i], seqs[i]) for i in order], per_locus


def _write_reads(path, reads):
    with open(path, 'wb') as f:
        for name, seq in reads:
            f.write(b'>' + name.encode('ascii') + b'\n' + seq.tobytes()
                    + b'\n')


def build_world(root, cfg, mix, seed):
    """The world of one run of a cell under ``root``: ``genome.fa`` (one
    contig of the configuration's size), ``genome.gtf`` (a host gene a
    locus), and for each of the traffic mix's ``samples`` one read file of
    ``reads`` reads, ``<sample>/0.fa``.  Returns a dict with the genome's
    and the annotation's paths, each sample's file and its circular reads a
    locus (``drawn``), the truth loci (1-based, inclusive:
    ``(contig, start, end, [(exon start, exon end), ...])``) and the reads
    a sample."""
    rng = np.random.default_rng(int(seed))
    layout = np.random.default_rng(LAYOUT_SEED)
    chrom, loci = _genome_and_loci(cfg, rng, layout)
    share = abundances(layout, len(loci), mix)
    os.makedirs(root, exist_ok=True)
    ref = os.path.join(root, 'genome.fa')
    _write_fasta(ref, 'chr1', chrom)
    gtf = os.path.join(root, 'genome.gtf')
    write_gtf(gtf, loci, len(chrom))
    samples = {}
    for s in range(int(mix['samples'])):
        name = 'sample{}'.format(s + 1)
        sdir = os.path.join(root, name)
        os.makedirs(sdir, exist_ok=True)
        path = os.path.join(sdir, '0.fa')
        reads, drawn = _reads(rng, layout, chrom, loci, int(mix['reads']),
                              mix, name, share)
        _write_reads(path, reads)
        samples[name] = {'file': path, 'drawn': drawn.tolist()}
    truth = [(ctg, exons[0][0] + 1, exons[-1][1],
              [(st + 1, en) for st, en in exons])
             for ctg, exons, _strand in loci]
    return {'ref': ref, 'gtf': gtf, 'samples': samples, 'truth': truth,
            'reads': int(mix['reads'])}


def load_json(path):
    with open(path) as f:
        return json.load(f)
