"""The port's copies of the JAX package's leaf modules against their twins.

``ciri_long_tpu_torch`` carries its own ``version``, ``utils.{seq,misc,
logger,diskcache}``, ``config``, ``context``, ``io``, ``annot`` and
``tools.simulate``; each must behave exactly as the JAX package's on the
same numpy-seeded inputs, since the output formats and the on-disk caches
rest on them.  The tmp/ files cross both ways: a genome cache written by
either package loads in the other, and a tmp/ss.idx pickled by the JAX
package loads in the port without importing ``ciri_long_tpu``.
"""

import dataclasses
import gzip
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ciri_long_tpu import config as jconfig
from ciri_long_tpu import context as jcontext
from ciri_long_tpu import version as jversion
from ciri_long_tpu.annot import gtf as jgtf
from ciri_long_tpu.annot import signal as jsignal
from ciri_long_tpu.io import fastx as jfastx
from ciri_long_tpu.io import genome as jgenome
from ciri_long_tpu.tools import simulate as jsim
from ciri_long_tpu.utils import diskcache as jdisk
from ciri_long_tpu.utils import misc as jmisc
from ciri_long_tpu.utils import seq as jseq
from ciri_long_tpu_torch import config as tconfig
from ciri_long_tpu_torch import context as tcontext
from ciri_long_tpu_torch import version as tversion
from ciri_long_tpu_torch.annot import gtf as tgtf
from ciri_long_tpu_torch.annot import signal as tsignal
from ciri_long_tpu_torch.io import fastx as tfastx
from ciri_long_tpu_torch.io import genome as tgenome
from ciri_long_tpu_torch.tools import simulate as tsim
from ciri_long_tpu_torch.utils import diskcache as tdisk
from ciri_long_tpu_torch.utils import misc as tmisc
from ciri_long_tpu_torch.utils import seq as tseq

REPO = Path(__file__).resolve().parent.parent


def _chars(seed, n):
    rng = np.random.default_rng(seed)
    return list(''.join(rng.choice(list('ACGT'), size=n)))


def _world(sim, genome_mod, seed, profile):
    rng = np.random.default_rng(seed)
    chars = _chars(seed + 1, 60_000)
    loci = sim.random_loci(genome_mod.Genome.from_dict(
        {'chr1': ''.join(chars)}), rng, 4)
    chr1 = ''.join(sim.plant_splice_signals(chars, loci))
    genome = genome_mod.Genome.from_dict({'chr1': chr1, 'chrM': chr1[:3000]})
    reads = list(sim.simulate_reads(genome, loci, rng, depth=3,
                                    profile=profile,
                                    artifacts=profile == 'nanopore'))
    reads += list(sim.simulate_linear(genome, rng, n=5, profile=profile))
    reads.append(sim.mutate(rng, chr1[100:900]))
    return chr1, loci, reads


@pytest.mark.parametrize('profile', ['uniform', 'nanopore'])
def test_simulate_worlds_are_identical(profile):
    assert _world(tsim, tgenome, 7, profile) == \
        _world(jsim, jgenome, 7, profile)


def test_version_config_context():
    assert tversion.__version__ == jversion.__version__
    assert dataclasses.asdict(tconfig.DEFAULT) == \
        dataclasses.asdict(jconfig.DEFAULT)
    assert dataclasses.asdict(tconfig.CLIP_SCORE) == \
        dataclasses.asdict(jconfig.CLIP_SCORE)
    g = tgenome.Genome.from_dict({'c': 'ACGT' * 10})
    ctx = tcontext.Context(genome=g)
    assert ctx.contig_len == {'c': 40}
    assert tcontext.Context().contig_len == jcontext.Context().contig_len


def test_seq_helpers(rng):
    alphabet = list('ACGTNacgtnRY')
    seqs = [''.join(rng.choice(alphabet, size=int(n)))
            for n in rng.integers(0, 300, 20)] + ['']
    for s in seqs:
        np.testing.assert_array_equal(tseq.encode_seq(s), jseq.encode_seq(s))
        assert tseq.revcomp(s) == jseq.revcomp(s)
        assert tseq.compress_seq(s) == jseq.compress_seq(s)
        codes = jseq.encode_seq(s)
        assert tseq.decode_seq(codes) == jseq.decode_seq(codes)
        np.testing.assert_array_equal(tseq.revcomp_encoded(codes),
                                      jseq.revcomp_encoded(codes))
        if len(s) > 30:
            assert tseq.transform_seq(s, 17) == jseq.transform_seq(s, 17)
            assert tseq.get_junc_seq(s, 20) == jseq.get_junc_seq(s, 20)
    for a, b in zip(tseq.pack_codes(jseq.encode_seq(''.join(seqs))),
                    jseq.pack_codes(jseq.encode_seq(''.join(seqs)))):
        np.testing.assert_array_equal(a, b)
    coded = [jseq.encode_seq(s) for s in seqs[:5]]
    for a, b in zip(tseq.pad_encoded(coded), jseq.pad_encoded(coded)):
        np.testing.assert_array_equal(a, b)
    assert tseq.bucket_lengths([3, 300, 5000]) == \
        jseq.bucket_lengths([3, 300, 5000])


def test_misc_helpers(tmp_path):
    items = [{'k': i % 3, 'v': i} for i in range(10)]
    for fn, args in (('grouper', (range(7), 3)), ('pairwise', (range(5),)),
                     ('flatten', ([[1, 2], [3]],)),
                     ('min_sorted_items', (items, 'k')),
                     ('to_str', (b'ab',)), ('to_bytes', ('ab',))):
        assert list(getattr(tmisc, fn)(*args)) == \
            list(getattr(jmisc, fn)(*args)), fn
    d = tmp_path / 'made'
    assert tmisc.check_dir(str(d)) == jmisc.check_dir(str(d))
    f = tmp_path / 'f.txt'
    f.write_text('x')
    assert tmisc.check_file(str(f)) == jmisc.check_file(str(f))


@pytest.mark.parametrize('packed', ['0', '1'])
def test_genome_codes_and_caches(tmp_path, monkeypatch, packed):
    """Same codes and contig tables from one FASTA; byte-identical cache
    files; each package loads the other's cache."""
    monkeypatch.setenv('CIRI_PACK_GENOME', packed)
    chars = _chars(3, 9000)
    chars[4000:4100] = ['N'] * 100
    fa = tmp_path / 'g.fa'
    seqs = {'chr1': ''.join(chars), 'chr2': ''.join(chars[:777]).lower()}
    fa.write_text(''.join('>{} desc\n{}\n'.format(
        n, '\n'.join(s[i:i + 60] for i in range(0, len(s), 60)))
        for n, s in seqs.items()))
    tg = tgenome.Genome(str(fa))
    jg = jgenome.Genome(str(fa))
    assert tg.names == jg.names and tg.contig_len == jg.contig_len
    assert tg.offsets == jg.offsets and tg.is_packed == jg.is_packed
    np.testing.assert_array_equal(tg.dense_codes(), jg.dense_codes())
    for ctg, st, en in (('chr1', 3990, 4120), ('chr2', 0, 777),
                        ('chr1', 8000, 9000)):
        assert tg.seq(ctg, st, en) == jg.seq(ctg, st, en)
        np.testing.assert_array_equal(tg.codes_of(ctg, st, en),
                                      jg.codes_of(ctg, st, en))
    assert tg.locate(tg.global_pos('chr2', 5)) == \
        jg.locate(jg.global_pos('chr2', 5))

    tg.save_cache(str(tmp_path / 't_cache'))
    jg.save_cache(str(tmp_path / 'j_cache'))
    for name in sorted(os.listdir(tmp_path / 'j_cache')):
        assert (tmp_path / 't_cache' / name).read_bytes() == \
            (tmp_path / 'j_cache' / name).read_bytes(), name
    assert sorted(os.listdir(tmp_path / 't_cache')) == \
        sorted(os.listdir(tmp_path / 'j_cache'))
    from_j = tgenome.Genome.from_cache(str(tmp_path / 'j_cache'), str(fa))
    from_t = jgenome.Genome.from_cache(str(tmp_path / 't_cache'), str(fa))
    assert isinstance(from_j, tgenome.Genome)
    assert from_j.seq('chr1', 3990, 4120) == from_t.seq('chr1', 3990, 4120)
    np.testing.assert_array_equal(from_j.dense_codes(), jg.dense_codes())


def test_diskcache_round_trip(tmp_path):
    arrays = {'a': np.arange(10, dtype=np.int32),
              'b': np.ones((3, 2), np.int8)}
    tdisk.save_array_dir(str(tmp_path / 'c'), arrays, {'v': 1})
    meta, got = jdisk.load_array_dir(str(tmp_path / 'c'), ['a', 'b'])
    assert meta == {'v': 1}
    for g, name in zip(got, ['a', 'b']):
        np.testing.assert_array_equal(g, arrays[name])
    assert tdisk.load_array_dir(str(tmp_path / 'missing'), ['a']) is None


def test_read_fastx_records(tmp_path, rng):
    recs = [('r{}'.format(i), ''.join(rng.choice(list('ACGTN'),
                                                 size=int(n))))
            for i, n in enumerate(rng.integers(1, 200, 12))]
    fa = tmp_path / 'r.fa'
    fa.write_text(''.join('>{} extra words\n{}\n{}\n'.format(
        n, s[:50], s[50:]) for n, s in recs))
    fq = tmp_path / 'r.fq.gz'
    with gzip.open(fq, 'wt') as f:
        f.write(''.join('@{} x\n{}\n+\n{}\n'.format(n, s, 'I' * len(s))
                        for n, s in recs))
    for path in (fa, fq):
        got = list(tfastx.read_fastx(str(path)))
        assert got == list(jfastx.read_fastx(str(path)))
        assert got == [(n, s) for n, s in recs]


GTF_ROWS = [
    ['chr1', 't', 'gene', '1001', '5200', '.', '+', '.',
     'gene_id "G1"; gene_name "A"; gene_type "protein_coding";'],
    ['chr1', 't', 'exon', '1001', '1200', '.', '+', '.',
     'gene_id "G1"; transcript_id "T1"; exon_number "1";'],
    ['chr1', 't', 'exon', '3001', '3150', '.', '+', '.',
     'gene_id "G1"; transcript_id "T1"; exon_number "2";'],
    ['chr1', 't', 'exon', '5001', '5200', '.', '+', '.',
     'gene_id "G1"; transcript_id "T1"; exon_number "3";'],
    ['chr1', 't', 'gene', '7001', '9000', '.', '-', '.',
     'gene_id "G2"; gene_name "B";'],
    ['chr1', 't', 'exon', '8501', '9000', '.', '-', '.',
     'gene_id "G2"; transcript_id "T2";'],
    ['chr1', 't', 'exon', '7001', '7300', '.', '-', '.',
     'gene_id "G2"; transcript_id "T2";'],
    ['chr1', 't', 'CDS', '7001', '7300', '.', '-', '0', 'gene_id "G2";'],
]


def _plain(obj):
    """Indices as plain dicts and tuples (Features by their fields)."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, '__slots__') and hasattr(obj, 'attr_string'):
        return ('Feature',) + tuple(getattr(obj, f) for f in obj.__slots__) \
            + (sorted(obj.attr.items()),)
    return obj


@pytest.fixture
def annotation(tmp_path):
    gtf = tmp_path / 'a.gtf'
    gtf.write_text('#comment\n' + ''.join('\t'.join(r) + '\n'
                                          for r in GTF_ROWS))
    bed = tmp_path / 'c.bed'
    bed.write_text('chr1\t2000\t2500\t+\nchr1\tx\ty\t-\nchr1\t4000\t4400\t-\n')
    circ_gtf = tmp_path / 'c.gtf'
    circ_gtf.write_text('\t'.join(['chr1', 'c', 'exon', '6001', '6300', '.',
                                   '+', '.', 'gene_id "C1";']) + '\n')
    return gtf, bed, circ_gtf


def test_index_annotation_and_circ(annotation):
    gtf, bed, circ_gtf = annotation
    got = tgtf.index_annotation(str(gtf))
    want = jgtf.index_annotation(str(gtf))
    assert _plain(got) == _plain(want)
    for circ in (bed, circ_gtf):
        assert _plain(tgtf.index_circ(str(circ), got[2])) == \
            _plain(jgtf.index_circ(str(circ), want[2]))
        assert _plain(tgtf.index_circ(str(circ), None)) == \
            _plain(jgtf.index_circ(str(circ), None))


def _signal_world(genome_mod, context_mod, gtf_mod, gtf_path):
    chars = _chars(11, 12_000)
    for st, en in ((1000, 1200), (3000, 3150), (5000, 5200), (7000, 7300),
                   (8500, 9000)):
        chars[st - 2:st] = list('AG')
        chars[en:en + 2] = list('GT')
    chr1 = ''.join(chars)
    genome = genome_mod.Genome.from_dict({'chr1': chr1})
    gtf_idx, intron_idx, ss_idx = gtf_mod.index_annotation(str(gtf_path))
    return context_mod.Context(genome=genome, gtf_index=gtf_idx,
                               intron_index=intron_idx, ss_index=ss_idx)


def test_signal_search(annotation, rng):
    """The annotated and de novo splice-signal searches, the host-gene,
    retained-intron and overlap lookups on the same candidate BSJs."""
    gtf, _bed, _circ = annotation
    tctx = _signal_world(tgenome, tcontext, tgtf, gtf)
    jctx = _signal_world(jgenome, jcontext, jgtf, gtf)
    cands = [(1000, 5200), (1003, 3148), (3000, 5200), (7000, 9000),
             (8502, 8998)]
    cands += [(int(a), int(a) + int(b)) for a, b in
              zip(rng.integers(100, 6000, 6), rng.integers(150, 4000, 6))]
    for st, en in cands:
        for clip in (0, 3):
            t = tsignal.find_annotated_signal(tctx, 'chr1', st, en, clip)
            j = jsignal.find_annotated_signal(jctx, 'chr1', st, en, clip)
            assert t == j
            assert tsignal.find_denovo_signal(
                tctx, 'chr1', st, en, ['+'], t[3], t[1], t[2], clip) == \
                jsignal.find_denovo_signal(
                    jctx, 'chr1', st, en, ['+'], j[3], j[1], j[2], clip)
            assert tsignal.search_splice_signal(tctx, 'chr1', st, en, clip) \
                == jsignal.search_splice_signal(jctx, 'chr1', st, en, clip)
        for fn in ('find_host_gene', 'find_retained_introns',
                   'find_overlap_exons'):
            assert _plain(getattr(tsignal, fn)(tctx, 'chr1', st, en)) == \
                _plain(getattr(jsignal, fn)(jctx, 'chr1', st, en)), fn


def test_jax_ss_index_loads_in_the_port_alone(annotation, tmp_path):
    """A tmp/ss.idx pickled by the JAX package (its Feature class and the
    utils.misc.tree factory of its defaultdicts) loads in the port in a
    process where ``import ciri_long_tpu`` fails, as port objects."""
    gtf, bed, _circ = annotation
    gtf_idx, intron_idx, ss_idx = jgtf.index_annotation(str(gtf))
    ss_idx = jgtf.index_circ(str(bed), ss_idx)
    idx = tmp_path / 'ss.idx'
    with open(idx, 'wb') as f:
        pickle.dump([gtf_idx, intron_idx, ss_idx], f, -1)
    assert b'ciri_long_tpu.annot.gtf' in idx.read_bytes()
    want = _plain([gtf_idx, intron_idx, ss_idx])
    out = tmp_path / 'loaded.pkl'
    code = '\n'.join([
        'import pickle, sys',
        "sys.modules['ciri_long_tpu'] = None",
        "sys.modules['jax'] = None",
        'from ciri_long_tpu_torch.annot.gtf import Feature, load_index',
        'gtf_idx, intron_idx, ss_idx = load_index({!r})'.format(str(idx)),
        "feat = gtf_idx['chr1'][2][0]",
        'assert type(feat) is Feature, type(feat)',
        "ss_idx['chr1'][1]['+']['start'] = 1   # the defaultdicts still grow",
        "del ss_idx['chr1'][1]",
        'plain = lambda o: ({k: plain(v) for k, v in o.items()} if '
        'isinstance(o, dict) else [plain(v) for v in o] if isinstance('
        'o, (list, tuple)) else (("Feature",) + tuple(getattr(o, f) for f in '
        'o.__slots__) + (sorted(o.attr.items()),) if isinstance(o, Feature) '
        'else o))',
        'with open({!r}, "wb") as f:'.format(str(out)),
        '    pickle.dump(plain([gtf_idx, intron_idx, ss_idx]), f)',
    ])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, 'rb') as f:
        assert pickle.load(f) == want
