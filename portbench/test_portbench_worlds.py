"""The cells' generator: a function of the seed, the same amount of work for
every seed, and read names and counts that say the truth.

    python -m pytest portbench/ -q
"""

import filecmp
import os

import numpy as np

import worlds

CFG = dict(genome_kb=40, loci=6, exons=[1, 3], exon_len=[120, 400],
           intron_len=[200, 2000])
MIX = dict(samples=2, reads=60, circular=0.8, lognormal_sigma=1.0,
           copies=[2.2, 8.0], linear_len=1200, adapter_rate=0.15,
           chimera_rate=0.02)


def _names(path):
    with open(path) as f:
        return [line[1:].strip() for line in f if line.startswith('>')]


def test_build_world_is_a_function_of_the_seed(tmp_path):
    a = worlds.build_world(str(tmp_path / 'a'), CFG, MIX, 2 ** 31 + 5)
    b = worlds.build_world(str(tmp_path / 'b'), CFG, MIX, 2 ** 31 + 5)
    c = worlds.build_world(str(tmp_path / 'c'), CFG, MIX, 2 ** 31 + 6)
    files = ['genome.fa', 'genome.gtf', 'sample1/0.fa', 'sample2/0.fa']
    assert all(filecmp.cmp(tmp_path / 'a' / f, tmp_path / 'b' / f,
                           shallow=False) for f in files)
    assert not filecmp.cmp(tmp_path / 'a' / 'sample1/0.fa',
                           tmp_path / 'c' / 'sample1/0.fa', shallow=False)
    assert not filecmp.cmp(tmp_path / 'a' / 'genome.fa',
                           tmp_path / 'c' / 'genome.fa', shallow=False)
    # the seed changes the content, not the amount of work
    assert a['truth'] == c['truth']
    assert filecmp.cmp(tmp_path / 'a' / 'genome.gtf',
                       tmp_path / 'c' / 'genome.gtf', shallow=False)
    for s in ('sample1', 'sample2'):
        assert a['samples'][s]['drawn'] == c['samples'][s]['drawn']
        assert sorted(_names(a['samples'][s]['file'])) == sorted(
            _names(c['samples'][s]['file']))
    sizes = [os.path.getsize(r / 'sample1/0.fa')
             for r in (tmp_path / 'a', tmp_path / 'c')]
    assert abs(sizes[0] - sizes[1]) < 0.01 * sizes[0]


def test_read_names_and_counts_say_the_truth(tmp_path):
    w = worlds.build_world(str(tmp_path / 'w'), CFG, MIX, 7)
    assert len(w['truth']) == CFG['loci']
    drawn = {s: v['drawn'] for s, v in w['samples'].items()}
    assert drawn['sample1'] != drawn['sample2']      # samples differ
    for s, v in w['samples'].items():
        names = _names(v['file'])
        assert len(names) == MIX['reads'] == len(set(names))
        assert all(n.startswith(s + '_') for n in names)
        circ = [int(n.split('_')[1][4:]) for n in names if '_circ' in n]
        assert len(circ) == 48
        assert np.bincount(circ, minlength=CFG['loci']).tolist() == \
            v['drawn']
    # reads of two samples never share a name (collapse keys reads by it)
    assert not set(_names(w['samples']['sample1']['file'])) & set(
        _names(w['samples']['sample2']['file']))


def test_abundances_from_a_list_or_drawn_log_normally():
    layout = np.random.default_rng(0)
    share = worlds.abundances(layout, 4, {'abundances': [1, 1, 2, 4]})
    assert share.tolist() == [0.125, 0.125, 0.25, 0.5]
    share = worlds.abundances(layout, 200, {'lognormal_sigma': 1.0})
    assert abs(share.sum() - 1) < 1e-12 and share.max() > 5 * share.min()


def test_the_gtf_gives_each_locus_a_host_gene(tmp_path):
    w = worlds.build_world(str(tmp_path / 'w'), CFG, MIX, 3)
    rows = [line.split('\t') for line in open(w['gtf'])]
    genes = [r for r in rows if r[2] == 'gene']
    assert len(genes) == CFG['loci']
    for li, ((ctg, st, en, exons), gene) in enumerate(zip(w['truth'],
                                                          genes)):
        assert int(gene[3]) < st and en < int(gene[4])
        got = [(int(r[3]), int(r[4])) for r in rows if r[2] == 'exon'
               and 'transcript_id "T{}";'.format(li) in r[8]]
        assert got[1:-1] == [tuple(e) for e in exons]


def test_mutate_batch_keeps_the_profiles_rates():
    rng = np.random.default_rng(1)
    seqs = [worlds.ALPHABET[rng.integers(0, 4, 2000)] for _ in range(200)]
    out = worlds.mutate_batch(rng, seqs, np.random.default_rng(2))
    assert len(out) == len(seqs)
    ratio = sum(map(len, out)) / sum(map(len, seqs))
    # ~2.5 % deleted (more in homopolymers), ~1.5 % x ~1.8 bases inserted
    assert 0.9 < ratio < 1.0
    assert all(set(np.unique(o)) <= set(worlds.ALPHABET) for o in out)
