"""The port's short-consensus recovery and the JAX package's last public
device ops, against the JAX package on the CPU.

- ``call`` on a small tools/world.py::short_world (a 100 kb genome, one
  regular locus and three one-exon loci of 30-59 bp, depth 8): the port's
  ``call --device cpu`` and the JAX package's ``call --backend cpu`` write
  the same cand_circ.fa, tmp/*.ccs.fa and tmp/*.raw.fa and counters, and
  the recovery stage ([3/4]) gets reads; ``make_world`` without short loci
  writes the bytes it wrote before they existed;
- ``lag_profile`` (plain) bit-equal to JAX's; ``screen_periodic``;
  ``chain_scores_batch`` on rows with holes in their valid masks (f to
  1e-3 absolute: JAX's DP is float32 with float32 log2, the port's float64
  rounded once; pre exact wherever JAX's best candidate beats the next by
  more than that); ``edit_distance_batch_padded``; ``ssw_align`` under and
  over 32 768 reference codes, ``find_bsj`` and ``align_clip_segments`` on
  the world's consensus reads;
- the four namespaces' ``__all__``, each name resolving, and importing
  ``ciri_long_tpu_torch.ops`` loading neither torch nor a kernel.
"""

import hashlib
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ciri_long_tpu.context import Context as JaxContext
from ciri_long_tpu.io.genome import Genome as JaxGenome
from ciri_long_tpu.models.aligner import GenomeAligner as JaxAligner
from ciri_long_tpu.ops import chain as jchain
from ciri_long_tpu.ops import edit as jedit
from ciri_long_tpu.ops import period as jperiod
from ciri_long_tpu.pipeline import find_bsj as jfb
from ciri_long_tpu_torch.context import Context
from ciri_long_tpu_torch.io.genome import Genome
from ciri_long_tpu_torch.models.aligner import GenomeAligner
from ciri_long_tpu_torch.models.hits import get_primary_alignment
from ciri_long_tpu_torch.ops import chain as tchain
from ciri_long_tpu_torch.ops import edit as tedit
from ciri_long_tpu_torch.ops import period as tperiod
from ciri_long_tpu_torch.pipeline import find_bsj as tfb
from ciri_long_tpu_torch.tools.world import make_world, short_world
from ciri_long_tpu_torch.utils.seq import encode_seq

torch.set_num_threads(1)

PREFIX = 'short'


def _fasta(path):
    seqs, name = {}, None
    for ln in open(path):
        ln = ln.rstrip('\n')
        if ln.startswith('>'):
            name = ln[1:].split()[0]
            seqs[name] = ''
        elif name is not None:
            seqs[name] += ln
    return seqs


def _outputs(out):
    summary = json.loads((out / (PREFIX + '.json')).read_text())
    counters = {k: v for k, v in summary.items()
                if k not in ('timing', 'kernels', 'spans', 'counters',
                             'threads')}
    files = {name: (out / name).read_bytes() for name in (
        PREFIX + '.cand_circ.fa', 'tmp/{}.ccs.fa'.format(PREFIX),
        'tmp/{}.raw.fa'.format(PREFIX))}
    return counters, files, summary['timing']


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The small short world, run through both packages' ``call``."""
    from ciri_long_tpu.cli.main import call
    from ciri_long_tpu_torch.cli.main import main
    root = tmp_path_factory.mktemp('short')
    ref, reads, truth = short_world(str(root / 'world'), genome_kb=100,
                                    loci=1, depth=8, linear=4, short_loci=3)
    main(['call', '-i', reads, '-o', str(root / 'port'), '-r', ref, '-p',
          PREFIX, '-t', '1', '--device', 'cpu'])
    call(SimpleNamespace(input=reads, output=str(root / 'jax'),
                         reference=ref, prefix=PREFIX, gtf=None, circ=None,
                         threads=1, debug=False, backend='cpu'))
    return root, ref, truth


@pytest.fixture(scope='module')
def contexts(world):
    """Both packages' Contexts (the scan's aligner) on the world's genome,
    and its consensus reads."""
    root, ref, _ = world
    chr1 = _fasta(ref)['chr1']
    jg = JaxGenome.from_dict({'chr1': chr1})
    tg = Genome.from_dict({'chr1': chr1})
    ccs = list(_fasta(str(root / 'port' / 'tmp' /
                          '{}.ccs.fa'.format(PREFIX))).values())
    return (JaxContext(aligner=JaxAligner(jg), genome=jg),
            Context(aligner=GenomeAligner(tg), genome=tg), ccs)


def test_call_matches_jax_on_short_world(world):
    root, _, truth = world
    jc, jf, _ = _outputs(root / 'jax')
    tc, tf, timing = _outputs(root / 'port')
    assert tf == jf
    assert tc == jc
    assert timing['recover_ccs']['items'] > 0
    assert tc['bsj'] > 0 and len(truth) == 4


def test_make_world_without_short_loci_is_unchanged(tmp_path):
    """short_loci=0 draws the numbers and writes the bytes make_world
    wrote before short loci existed (md5 of genome.fa + reads.fa)."""
    ref, reads, truth = make_world(str(tmp_path), genome_kb=60, loci=2,
                                   depth=3, linear=3, seed=7, short_loci=0)
    digest = hashlib.md5(open(ref, 'rb').read()
                         + open(reads, 'rb').read()).hexdigest()
    assert digest == '9e5c7a4c138510baa7fa34d3f58976dd'
    assert truth == [('chr1', 22551, 24955), ('chr1', 41163, 41305)]


def _profile_reads(rng, W):
    x = rng.integers(0, 4, (4, W)).astype(np.int8)
    x[0] = np.resize(rng.integers(0, 4, 37), W)
    x[1, 3::17] = 4
    x[2, W // 2:] = 5
    x[3, 9:] = 5                                  # a read under the lags
    return x


@pytest.mark.parametrize('W,max_lag,offset', [
    (150, 64, 0), (150, 64, 120), (4_200, 96, 4_150)])
def test_lag_profile_matches_jax(rng, W, max_lag, offset):
    """Bit-equal float32 fractions: widths under and over 4 096, lag
    ranges inside, across and past the reads, PAD and N codes."""
    reads = _profile_reads(rng, W)
    want = np.asarray(jperiod.lag_profile(reads, max_lag, lag_offset=offset,
                                          pad_lags=offset + max_lag))
    got = tperiod.lag_profile(reads, max_lag, offset, device='cpu')
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert want[0].max() > 0.9
    with pytest.raises(ValueError, match='pad_lags'):
        tperiod.lag_profile(reads, max_lag, offset + 1,
                            pad_lags=offset + max_lag, device='cpu')


def test_screen_periodic_matches_jax(rng):
    reads = _profile_reads(rng, 600)
    lengths = np.array([600, 300, 50, 590])
    counts = tperiod.tandem_counts(reads, 256, device='cpu')
    want = jperiod.screen_periodic(counts, lengths)
    assert np.array_equal(tperiod.screen_periodic(counts, lengths), want)
    assert want[0] and not want[2]
    short = counts[:, :100]                   # L / 2 > max_lag: kept
    assert np.array_equal(tperiod.screen_periodic(short, lengths),
                          jperiod.screen_periodic(short, lengths))


def _best_gaps(r, q, ctg, valid, k, window=64, gap_r=200_000, gap_q=5_000):
    """For each anchor, JAX's float32 DP redone in float64 from its f: the
    best candidate's lead over the next one (inf with fewer than two)."""
    f, _ = (np.asarray(t, np.float64) for t in jchain.chain_scores_batch(
        r, q, ctg, valid, k))
    lead = np.full(f.shape, np.inf)
    for b in range(f.shape[0]):
        for i in range(f.shape[1]):
            j = np.arange(max(0, i - window), i)
            dr = r[b, i] - r[b, j]
            dq = q[b, i] - q[b, j]
            ok = (valid[b, j] & (dr > 0) & (dq > 0) & (dq <= gap_q)
                  & (dr <= gap_r) & (ctg[b, j] == ctg[b, i]))
            g = np.abs(dr - dq)
            pen = np.where(dr >= dq, np.log2(g + 1.0),
                           0.5 * g + 0.5 * np.log2(g + 1.0))
            pen = pen + 0.1 * np.maximum(0, dq - 2 * k)
            cand = np.sort((f[b, j] + np.minimum(np.minimum(dq, dr), k)
                            - pen)[ok])[::-1]
            if len(cand) > 1:
                lead[b, i] = cand[0] - cand[1]
    return lead


def test_chain_scores_batch_matches_jax(rng):
    """JAX's padded contract with holes in the valid masks: invalid
    anchors at f = k, pre = -1; the window counts padded slots; f to 1e-3;
    pre exact where the best candidate leads the next by more than 1e-3."""
    B, A, k = 5, 160, 15
    q = np.cumsum(rng.integers(1, 12, (B, A)), axis=1)
    r = q + 500 + rng.integers(0, 3, (B, A)) * (rng.random((B, A)) < 0.3)
    r[:, A // 2:] += 700                           # an intron
    ctg = np.zeros((B, A), np.int32)
    ctg[2, 100:] = 1
    valid = rng.random((B, A)) < 0.8
    valid[0] = True
    valid[1, :40] = False                          # not a prefix
    valid[4] = False
    want_f, want_pre = (np.asarray(t) for t in jchain.chain_scores_batch(
        r, q, ctg, valid, k))
    f, pre = tchain.chain_scores_batch(r, q, ctg, valid, k, device='cpu')
    assert f.dtype == np.float32 and pre.dtype == np.int32
    assert np.allclose(f, want_f, rtol=0, atol=1e-3)
    clear = _best_gaps(r, q, ctg, valid, k) > 1e-3
    assert np.array_equal(pre[clear], want_pre[clear])
    assert (pre[~valid] == -1).all() and (f[~valid] == k).all()
    assert (pre[valid] >= 0).sum() > B * A // 2
    with pytest.raises(ValueError, match='window'):
        tchain.chain_scores_batch(r, q, ctg, valid, k, window=32,
                                  device='cpu')


def test_edit_distance_batch_padded_matches_jax(rng):
    a = rng.integers(0, 5, (24, 40)).astype(np.int8)
    b = rng.integers(0, 5, (24, 52)).astype(np.int8)
    b[:12, :30] = a[:12, :30]
    alen = rng.integers(0, 41, 24).astype(np.int32)
    blen = rng.integers(0, 53, 24).astype(np.int32)
    want = np.asarray(jedit.edit_distance_batch_padded(a, b, alen, blen))
    got = tedit.edit_distance_batch_padded(a, b, alen, blen, device='cpu')
    assert np.array_equal(got, want)


@pytest.mark.parametrize('ref_len', [900, 40_000])
def test_ssw_align_matches_jax(rng, ref_len):
    """One pair through the batch (a reference under 32 768 codes) and
    through the exact window chunks (over it)."""
    ref = rng.integers(0, 4, ref_len).astype(np.int8)
    query = ref[ref_len - 400:ref_len - 340].copy()
    query[::9] = (query[::9] + 1) % 4
    want = jfb.ssw_align(query, ref)
    got = tfb.ssw_align(query, ref, device='cpu')
    fields = ('score', 'query_begin', 'query_end', 'ref_begin', 'ref_end')
    assert ([getattr(got, x) for x in fields]
            == [getattr(want, x) for x in fields])
    assert got.score > 0


def test_find_bsj_and_clip_segments_match_jax(contexts, rng):
    """find_bsj on the world's consensus reads, then align_clip_segments on
    each found circle with 30 random bases added (clips that take the SW
    over the +-200 kb window, the whole 100 kb contig here)."""
    jctx, tctx, ccs = contexts
    clipped = 0
    for seq in ccs[:6]:
        want = jfb.find_bsj(jctx, seq)
        got = tfb.find_bsj(tctx, seq, device='cpu')
        assert got == want
        circ = want[0]
        if circ is None:
            continue
        circ = circ + ''.join(rng.choice(list('ACGT'), 30))
        jhit = get_primary_alignment(jctx.aligner.map(circ))
        thit = get_primary_alignment(tctx.aligner.map(circ))
        if jhit is None:
            assert thit is None
            continue
        want = jfb.align_clip_segments(jctx, circ, jhit)
        got = tfb.align_clip_segments(tctx, circ, thit, device='cpu')
        assert got == want
        clipped += thit.q_st + len(circ) - thit.q_en >= 20
    assert clipped >= 1


def test_namespaces_match_jax():
    """The four packages export the JAX package's names, each one reading
    as an object of the port; ops.poa is callable as JAX's poa."""
    import importlib
    for name in ('ops', 'models', 'utils', 'parallel'):
        jax_pkg = importlib.import_module('ciri_long_tpu.' + name)
        pkg = importlib.import_module('ciri_long_tpu_torch.' + name)
        assert pkg.__all__ == jax_pkg.__all__
        for attr in pkg.__all__:
            value = getattr(pkg, attr)
            assert getattr(value, '__module__', pkg.__name__).startswith(
                'ciri_long_tpu_torch') or isinstance(value, str), attr
    from ciri_long_tpu_torch import ops
    assert ops.poa(['ACGTTGCA', 'ACGTTGCA', 'ACCTTGCA'])[0] == 'ACGTTGCA'
    with pytest.raises(AttributeError):
        ops.not_a_name


def test_importing_ops_loads_no_kernel():
    code = ('import sys; import ciri_long_tpu_torch.ops, '
            'ciri_long_tpu_torch.models, ciri_long_tpu_torch.utils, '
            'ciri_long_tpu_torch.parallel; '
            'bad = [m for m in sys.modules if m in ("torch", "numpy", '
            '"ciri_long_tpu_torch.ops._build") or m.startswith('
            '"ciri_long_tpu_torch.ops.")]; print(bad); sys.exit(bool(bad))')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stdout + proc.stderr
