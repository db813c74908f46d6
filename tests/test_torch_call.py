"""The port's ``call`` slice against the JAX package on the CPU.

- the whole CLI on the small verification world (50 kb genome, one
  circRNA, 10 circular + 4 linear reads): JAX ``call --backend cpu`` and port ``call --device cpu`` give a
  byte-identical cand_circ.fa and equal counters (``timing`` and the port's
  ``kernels``, spans and counters aside), and each package resumes from
  the other's tmp/; the
  port's CCS scan on a -t 2 spawn pool equals its serial run;
- ``scan_ccs_chunk`` on the tests/test_pipeline_call.py world, with reads
  whose clipped bases take the +-200 kb window SW;
- the short-read recovery stage (``recover_ccs_chunk`` and the chunked
  ``recover_ccs_reads``, serial and on a -t 2 spawn pool) on the
  tests/test_recover.py world;
- the entry points' default device, 'cuda', which raises without a GPU
  (``call``'s, the chaining's and the tandem screen's, and ``collapse``'s);
- the aligner state carried across: the port's GenomeAligner built from the
  JAX index (``from_arrays``) and from the JAX package's on-disk
  tmp/minidx + tmp/gcodes caches maps exactly as the JAX aligner does.
"""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ciri_long_tpu.context import Context as JaxContext
from ciri_long_tpu.io.genome import Genome as JaxGenome
from ciri_long_tpu.models.aligner import GenomeAligner as JaxAligner
from ciri_long_tpu.pipeline import find_bsj as jfb
from ciri_long_tpu_torch.context import Context
from ciri_long_tpu_torch.io.genome import Genome
from ciri_long_tpu_torch.models.aligner import GenomeAligner
from ciri_long_tpu_torch.ops import sw as tsw
from ciri_long_tpu_torch.ops.ccs import find_consensus
from ciri_long_tpu_torch.pipeline import find_bsj as tfb
from ciri_long_tpu_torch.tools.world import _write_fasta
from ciri_long_tpu_torch.tools.world import skill_world as skill_world_files
from ciri_long_tpu_torch.cli.main import main as cli_main
from ciri_long_tpu_torch.ops.chain import chain_extract_batch
from ciri_long_tpu_torch.ops.edit import edit_distance_batch
from ciri_long_tpu_torch.ops.period import screen_keep, tandem_counts
from ciri_long_tpu_torch.pipeline.find_ccs import find_ccs_reads
from ciri_long_tpu_torch.ops.sw_tb_batch import sw_traceback_batch
from ciri_long_tpu_torch.pipeline.collapse import correct_reads
from ciri_long_tpu_torch.parallel.dryrun import dryrun_multichip
from ciri_long_tpu_torch.parallel.mesh import make_mesh
from ciri_long_tpu_torch.tools import ssw_cli
from ciri_long_tpu_torch.utils.dispatch import LAUNCHES
from tests.test_pipeline_call import make_rolling_read, rand_seq
from tests.test_poa import mutate

torch.set_num_threads(1)

S, E = 20_000, 20_520
# call's summary on --device cpu: every kernel of its path, none launched
CPU_KERNELS = {'sw_score_ends': 0, 'chain_dp': 0, 'chain_extract': 0,
               'screen_keep': 0, 'nw_traceback': 0}


@pytest.fixture(scope='module')
def skill_world(tmp_path_factory):
    """The small verification world (tools/world.py::skill_world)."""
    root = tmp_path_factory.mktemp('skill')
    skill_world_files(str(root))
    return root


def _jax_call(root, out):
    from ciri_long_tpu.cli.main import call
    call(SimpleNamespace(input=str(root / 'reads.fa'), output=str(out),
                         reference=str(root / 'genome.fa'), prefix='vtest',
                         gtf=None, circ=None, threads=1, debug=False,
                         backend='cpu'))


def _port_call(root, out):
    from ciri_long_tpu_torch.cli.main import main
    main(['call', '-i', str(root / 'reads.fa'), '-o', str(out), '-r',
          str(root / 'genome.fa'), '-p', 'vtest', '-t', '1', '--device',
          'cpu'])


def _outputs(out):
    with open(out / 'vtest.json') as f:
        summary = json.load(f)
    counters = {k: v for k, v in summary.items()
                if k not in ('timing', 'kernels', 'spans', 'counters',
                             'threads')}
    files = {name: (out / name).read_bytes()
             for name in ('vtest.cand_circ.fa', 'vtest.low_confidence.fa')}
    return counters, files, summary


@pytest.fixture(scope='module')
def skill_runs(skill_world):
    _jax_call(skill_world, skill_world / 'out_jax')
    _port_call(skill_world, skill_world / 'out_port')
    return skill_world


def test_call_matches_jax_on_skill_world(skill_runs):
    jc, jf, _ = _outputs(skill_runs / 'out_jax')
    tc, tf, summary = _outputs(skill_runs / 'out_port')
    assert tf == jf
    assert tc == jc
    assert tc['bsj'] == 10 and tc['signal'] == 10
    heads = [ln.split('\t')[1] for ln in
             tf['vtest.cand_circ.fa'].decode().splitlines()
             if ln.startswith('>')]
    assert heads == ['chr1:20001-20520'] * 10
    assert summary['kernels'] == CPU_KERNELS   # cpu: no launches
    assert set(summary['timing']) == {'ccs', 'scan_ccs', 'recover_ccs',
                                      'scan_raw'}


@pytest.mark.parametrize('first,second', [('jax', 'port'), ('port', 'jax')])
def test_each_package_resumes_from_the_others_tmp(skill_runs, first, second):
    """tmp/ (ccs/raw fasta, scan manifest, gcodes and minidx caches)
    written by one package is reused unchanged by the other."""
    src = skill_runs / 'out_{}'.format(first)
    out = skill_runs / 'resume_{}_to_{}'.format(first, second)
    shutil.copytree(src, out)
    meta = out / 'tmp' / 'minidx' / 'meta.json'
    assert meta.exists()
    stamp = meta.stat().st_mtime_ns
    (out / 'vtest.cand_circ.fa').unlink()
    # launches of an earlier run in this process stay out of the summary
    LAUNCHES['sw_score_ends'] = 7
    (_port_call if second == 'port' else _jax_call)(skill_runs, out)
    assert meta.stat().st_mtime_ns == stamp       # index cache not rebuilt
    assert (out / 'vtest.cand_circ.fa').read_bytes() == \
        (src / 'vtest.cand_circ.fa').read_bytes()
    if second == 'port':
        assert _outputs(out)[2]['kernels'] == CPU_KERNELS
    LAUNCHES['sw_score_ends'] = 0


def test_scan_ccs_reads_pool_matches_serial(skill_runs):
    """-t 2 on the CPU over the port's CCS reads of the skill world, four a
    chunk: the spawn-pool workers run scan_ccs_chunk on the host (they pass
    'cpu', not the 'cuda' default) and the output equals the serial run's
    and ``call``'s."""
    from dataclasses import replace

    from ciri_long_tpu_torch.config import DEFAULT
    from ciri_long_tpu_torch.pipeline.find_ccs import load_ccs_reads
    ref = str(skill_runs / 'genome.fa')
    ccs_seq = load_ccs_reads(str(skill_runs / 'out_port'), 'vtest')
    genome = Genome(ref)
    ctx = Context(aligner=GenomeAligner(genome), genome=genome)
    cfg = replace(DEFAULT.call, ccs_chunk_size=4)
    outs = []
    for name, threads in (('serial', 1), ('pool', 2)):
        out = skill_runs / 'scan_{}'.format(name)
        out.mkdir()
        cnt, short = tfb.scan_ccs_reads(ctx, ccs_seq, True, str(out), 'p',
                                        cfg, threads=threads, ref_fasta=ref,
                                        device='cpu')
        outs.append((dict(cnt), short, (out / 'p.cand_circ.fa').read_bytes()))
    assert outs[0] == outs[1]
    assert outs[0][0]['bsj'] == 10
    assert outs[0][2] == (skill_runs / 'out_port' /
                          'vtest.cand_circ.fa').read_bytes()


@pytest.fixture(scope='module')
def pipeline_world(module_rng):
    """tests/test_pipeline_call.py's world, with one aligner per package."""
    rng = module_rng
    chr1 = list(rand_seq(rng, 50_000))
    chr1[S - 2:S] = list('AG')
    chr1[E:E + 2] = list('GT')
    chr1 = ''.join(chr1)
    jgenome = JaxGenome.from_dict({'chr1': chr1})
    genome = Genome.from_dict({'chr1': chr1})
    jctx = JaxContext(aligner=JaxAligner(jgenome), genome=jgenome)
    tctx = Context(aligner=GenomeAligner(genome), genome=genome)
    return jctx, tctx, chr1


def test_scan_ccs_chunk_matches_jax(pipeline_world, rng, monkeypatch):
    jctx, tctx, chr1 = pipeline_world
    unit = chr1[S:E]
    units = [unit, unit,
             rand_seq(rng, 30) + unit,                  # foreign insert
             chr1[S - 3000:S - 2970] + unit]            # short far exon
    chunk = []
    for i, (u, rot) in enumerate(zip(units, [0, 202, 101, 77])):
        read = make_rolling_read(rng, u, copies=3.2 + 0.3 * i, rot=rot,
                                 noise=0.02)
        segments, ccs = find_consensus(read)
        assert ccs is not None
        chunk.append(('read_{}'.format(i), segments, ccs, read))
    chunk.append(('lin', '0-10;10-20', chr1[30_000:30_600],
                  chr1[30_000:31_200]))

    calls = []
    real = tfb.sw_window_align_many

    def spy(*a, **kw):
        calls.append(len(a[0]))
        return real(*a, **kw)

    monkeypatch.setattr(tfb, 'sw_window_align_many', spy)
    got = tfb.scan_ccs_chunk(tctx, chunk, True, device='cpu')
    want = jfb.scan_ccs_chunk(jctx, chunk, True)
    assert dict(got[0]) == dict(want[0])
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert calls                  # a clipped read took the window SW
    assert sum(rec[1] == 'chr1:20001-20520' for rec in got[2]) >= 2


@pytest.fixture(scope='module')
def recover_world(module_rng, tmp_path_factory):
    """tests/test_recover.py's world: twelve 90-110 bp circRNAs on a 30 kb
    contig, one short consensus read each (some rotated, some with
    substitutions), plus one read that maps nowhere; one short-mode aligner
    per package."""
    rng = module_rng
    chr1 = list(rand_seq(rng, 30_000))
    spans = [(2_000 + t * 2_000, 2_000 + t * 2_000 + 90 + (t % 3) * 10)
             for t in range(12)]
    for st, en in spans:
        chr1[st - 2:st] = list('AG')
        chr1[en:en + 2] = list('GT')
    chr1 = ''.join(chr1)
    reads = []
    for t, (st, en) in enumerate(spans):
        unit = chr1[st:en]
        rot = (17 * t) % len(unit) if t % 2 else 0
        unit = unit[rot:] + unit[:rot]
        if t % 4 == 3:
            unit = mutate(rng, unit, sub=0.02)
        segments = ';'.join('{}-{}'.format(i * len(unit), (i + 1) * len(unit))
                            for i in range(6))
        reads.append(('sr_{}'.format(t), segments, unit, unit * 6))
    unit = rand_seq(rng, 100)
    reads.append(('sr_nowhere', '0-100;100-200;200-300', unit, unit * 3))
    jgenome = JaxGenome.from_dict({'chr1': chr1})
    genome = Genome.from_dict({'chr1': chr1})
    jctx = JaxContext(aligner=JaxAligner(jgenome, short_mode=True),
                      genome=jgenome)
    tctx = Context(aligner=GenomeAligner(genome, short_mode=True),
                   genome=genome)
    root = tmp_path_factory.mktemp('recover')
    _write_fasta(root / 'genome.fa', 'chr1', chr1)   # for the spawn pool
    return jctx, tctx, reads, root


def test_recover_ccs_chunk_matches_jax(recover_world):
    jctx, tctx, reads, _ = recover_world
    got_cnt, got = tfb.recover_ccs_chunk(tctx, reads, True, device='cpu')
    want_cnt, want = jfb.recover_ccs_chunk(jctx, reads, True)
    assert dict(got_cnt) == dict(want_cnt)
    assert got == want
    assert got_cnt['ccs_mapped'] >= 10 and got_cnt['bsj'] >= 8
    assert len(got) == got_cnt['bsj']


def test_recover_ccs_reads_matches_jax(recover_world):
    """The stage driver, chunked (4 reads a chunk): same counters and
    byte-identical cand_circ.fa appended after existing records."""
    from dataclasses import replace

    from ciri_long_tpu.config import DEFAULT as JAX_DEFAULT
    from ciri_long_tpu_torch.config import DEFAULT
    jctx, tctx, reads, root = recover_world
    jcfg = replace(JAX_DEFAULT.call, ccs_chunk_size=4)
    cfg = replace(DEFAULT.call, ccs_chunk_size=4)
    cnts, cands = [], []
    for name, run in (
            ('jax', lambda d: jfb.recover_ccs_reads(jctx, reads, True, d,
                                                    'p', jcfg)),
            ('port', lambda d: tfb.recover_ccs_reads(tctx, reads, True, d,
                                                     'p', cfg,
                                                     device='cpu'))):
        out = root / name
        out.mkdir()
        (out / 'p.cand_circ.fa').write_text('>earlier\tchr1:1-2\n')
        cnts.append(dict(run(str(out))))
        cands.append((out / 'p.cand_circ.fa').read_bytes())
    assert cnts[0] == cnts[1]
    assert cands[0] == cands[1]
    assert cands[1].startswith(b'>earlier\tchr1:1-2\n')
    assert cands[1].count(b'>') == 1 + cnts[1]['bsj']


def test_recover_ccs_reads_pool_matches_serial(recover_world):
    """-t 2 on the CPU: the spawn-pool workers run recover_ccs_chunk on the
    host (they pass 'cpu', not the 'cuda' default) and the appended bytes
    equal the serial run's."""
    from dataclasses import replace

    from ciri_long_tpu_torch.config import DEFAULT
    _, tctx, reads, root = recover_world
    cfg = replace(DEFAULT.call, ccs_chunk_size=4)
    outs = []
    for name, threads in (('serial', 1), ('pool', 2)):
        out = root / name
        out.mkdir()
        (out / 'p.cand_circ.fa').write_text('')
        cnt = tfb.recover_ccs_reads(tctx, reads, True, str(out), 'p', cfg,
                                    threads=threads,
                                    ref_fasta=str(root / 'genome.fa'),
                                    device='cpu')
        outs.append((dict(cnt), (out / 'p.cand_circ.fa').read_bytes()))
    assert outs[0] == outs[1]
    assert outs[0][0]['bsj'] >= 8


@pytest.mark.parametrize('entry', [
    lambda: tsw.sw_align_batch(np.zeros((1, 4), np.int8),
                               np.zeros((1, 4), np.int8), tsw.SWParams()),
    lambda: tsw.sw_align_batch_submit(np.zeros((1, 4), np.int8),
                                      np.zeros((1, 4), np.int8),
                                      tsw.SWParams()),
    lambda: tsw.sw_window_align(np.zeros(4, np.int8), np.zeros(9, np.int8),
                                tsw.SWParams()),
    lambda: tsw.sw_window_align_many([], tsw.SWParams()),
    lambda: tfb.align_clip_segments_batch(None, []),
    lambda: tfb.scan_ccs_chunk(None, [], True),
    lambda: tfb.scan_ccs_reads(None, {}, True, 'unused', 'p'),
    lambda: tfb.recover_ccs_chunk(None, [], True),
    lambda: tfb.recover_ccs_reads(None, [], True, 'unused', 'p'),
    lambda: tfb.scan_raw_reads(None, 'unused.fa', True, 'unused', 'p'),
    lambda: edit_distance_batch(np.zeros((1, 4), np.int8),
                                np.zeros((1, 4), np.int8)),
    lambda: sw_traceback_batch([np.zeros(4, np.int8)], [np.zeros(4, np.int8)]),
    lambda: correct_reads(None, []),
    lambda: cli_main(['collapse', '-i', 'unused.lst', '-o', 'unused']),
    lambda: tfb.scan_raw_chunk(None, [], True, {}),
    lambda: GenomeAligner.map_batch(None, []),
    lambda: chain_extract_batch(np.zeros(1, np.int64), [], [], [], 30.0, 15),
    lambda: find_ccs_reads('unused.fa', 'unused', 'p'),
    lambda: screen_keep(np.full((1, 512), 5, np.int8), [0], 256),
    lambda: make_mesh(),
    lambda: tandem_counts(np.full((1, 64), 5, np.int8), 8),
    lambda: ssw_cli.main(['unused_t.fa', 'unused_q.fa']),
    lambda: dryrun_multichip(1),
], ids=['sw_align_batch', 'sw_align_batch_submit', 'sw_window_align',
        'sw_window_align_many', 'align_clip_segments_batch',
        'scan_ccs_chunk', 'scan_ccs_reads', 'recover_ccs_chunk',
        'recover_ccs_reads', 'scan_raw_reads', 'edit_distance_batch',
        'sw_traceback_batch', 'correct_reads', 'collapse', 'scan_raw_chunk',
        'map_batch', 'chain_extract_batch', 'find_ccs_reads', 'screen_keep',
        'make_mesh', 'tandem_counts', 'ssw_cli', 'dryrun_multichip'])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """With no ``device`` the port's entry points ask for 'cuda', which
    raises where no GPU is visible instead of running on the host."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        entry()


def _hit_key(h):
    return (h.ctg, h.strand, h.q_st, h.q_en, h.r_st, h.r_en, h.mlen, h.blen,
            list(h.cigar), h.is_primary, h.mapq, float(h.score))


def test_aligner_state_carried_across(tmp_path, rng):
    chr1 = rand_seq(rng, 30_000)
    _write_fasta(tmp_path / 'g.fa', 'chr1', chr1)
    cache = str(tmp_path / 'tmp' / 'minidx')
    os.makedirs(os.path.dirname(cache))
    jgenome = JaxGenome(str(tmp_path / 'g.fa'))
    jgenome.save_cache(str(tmp_path / 'tmp' / 'gcodes'))
    jal = JaxAligner(jgenome, index_cache=cache)

    seqs = [mutate(rng, chr1[st:st + 700], sub=0.03)
            for st in (100, 5000, 12_345, 29_000)]
    seqs.append(chr1[8000:8400] + chr1[20_000:20_500])     # two hits
    seqs.append(rand_seq(rng, 300))                         # no hit
    want = [[_hit_key(h) for h in hits] for hits in jal.map_batch(seqs)]
    assert sum(len(w) for w in want) >= 5

    arrays = {f: getattr(jal.index, f) for f in jal.index._fields}
    genome = Genome.from_cache(str(tmp_path / 'tmp' / 'gcodes'),
                               str(tmp_path / 'g.fa'))
    assert genome is not None
    from_arrays = GenomeAligner.from_arrays(genome, arrays)
    from_cache = GenomeAligner(genome, index_cache=cache)
    for al in (from_arrays, from_cache):
        for f in ('codes', 'pos', 'strand', 'buckets'):
            np.testing.assert_array_equal(getattr(al.index, f),
                                          getattr(jal.index, f))
        got = [[_hit_key(h) for h in hits]
               for hits in al.map_batch(seqs, device='cpu')]
        assert got == want
        assert [[_hit_key(h) for h in al.map(s)] for s in seqs] == \
            [[_hit_key(h) for h in jal.map(s)] for s in seqs]
