"""The port's ``collapse`` slice against the JAX package on the CPU.

- the fuser copy (parallel/fuser.py): fused SW and edit-distance jobs equal
  direct calls, and jobs submitted from worker threads come back exact;
- the stage's functions (``cluster_reads``, ``curate_junction``,
  ``cluster_sequence``, ``correct_cluster``) against the JAX functions on
  the same inputs, a small simulated cohort (4 loci, Nanopore profile);
- the cuda route's structure on the CPU (DEVICE_THREADS worker threads, the
  fuser, the kernels' plain versions in place of the launches) against the
  host route, and a failed kernel build raising through it;
- the CLI: JAX ``collapse --backend cpu`` and port ``collapse --device cpu``
  write byte-identical .info, .reads, .expression and .isoforms on the
  verification world (one circRNA at chr1:20001-20520) and on the cohort
  split into two samples; each package resumes from the other's
  tmp/{prefix}.corrected.pkl; the port's -t 2 spawn pool equals its serial
  run; -t 2 with --device cuda raises.
"""

import json
import os
import pickle
import shutil
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ciri_long_tpu.context import Context as JaxContext
from ciri_long_tpu.io.genome import Genome as JaxGenome
from ciri_long_tpu.pipeline import collapse as jcl
from ciri_long_tpu_torch.context import Context
from ciri_long_tpu_torch.io.genome import Genome
from ciri_long_tpu_torch.ops import edit, sw
from ciri_long_tpu_torch.ops import sw_tb_batch as tb
from ciri_long_tpu_torch.ops.poa import poa_consensus_many_plain
from ciri_long_tpu_torch.parallel.fuser import DeviceFuser, current_fuser
from ciri_long_tpu_torch.pipeline import collapse as tcl
from ciri_long_tpu_torch.tools.world import (make_world, sample_list,
                                             skill_world)
from ciri_long_tpu_torch.utils import dispatch

torch.set_num_threads(1)

FILES = ('info', 'reads', 'expression', 'isoforms')


def _jax_call(reads, ref, out, prefix):
    from ciri_long_tpu.cli.main import call
    call(SimpleNamespace(input=reads, output=str(out), reference=ref,
                         prefix=prefix, gtf=None, circ=None, threads=1,
                         debug=False, backend='cpu'))


def _jax_collapse(lst, ref, out, prefix):
    from ciri_long_tpu.cli.main import collapse
    collapse(SimpleNamespace(input=str(lst), output=str(out), reference=ref,
                             prefix=prefix, gtf=None, circ=None, threads=1,
                             debug=False, backend='cpu'))


def _port_collapse(lst, ref, out, prefix, *extra):
    from ciri_long_tpu_torch.cli.main import main
    main(['collapse', '-i', str(lst), '-o', str(out), '-r', ref, '-p', prefix,
          '--device', 'cpu', *extra])


def _files(out, prefix):
    return {ext: (out / '{}.{}'.format(prefix, ext)).read_bytes()
            for ext in FILES}


def _split(src, dst1, dst2, alone):
    """Two samples from one cand_circ.fa: records alternate between them,
    and the reads of circ ``alone`` all go to the first, so its column of
    the second sample is missing."""
    lines = open(src).read().splitlines()
    recs = [lines[i:i + 2] for i in range(0, len(lines), 2)]
    with open(dst1, 'w') as f1, open(dst2, 'w') as f2:
        for k, (head, seq) in enumerate(recs):
            to_first = k % 2 == 0 or head.split('\t')[1] == alone
            (f1 if to_first else f2).write(head + '\n' + seq + '\n')


@pytest.fixture(scope='module')
def skill(tmp_path_factory):
    root = tmp_path_factory.mktemp('skill_collapse')
    ref, reads = skill_world(str(root / 'w'))
    _jax_call(reads, ref, root / 'call', 'vtest')
    lst = sample_list(str(root / 'samples.lst'),
                      [('vtest', str(root / 'call' / 'vtest.cand_circ.fa'))])
    _jax_collapse(lst, ref, root / 'out_jax', 'vtest')
    _port_collapse(lst, ref, root / 'out_port', 'vtest')
    return SimpleNamespace(root=root, ref=ref, lst=lst)


@pytest.fixture(scope='module')
def cohort(tmp_path_factory):
    """4 circRNA loci on a 300 kb genome, Nanopore reads at depth 12 and 20
    linear reads (seed 3); the JAX package's ``call`` gives the candidates,
    split into two samples."""
    root = tmp_path_factory.mktemp('cohort_collapse')
    ref, reads, truth = make_world(str(root / 'w'), genome_kb=300, loci=4,
                                   depth=12, linear=20, seed=3)
    _jax_call(reads, ref, root / 'call', 'co')
    cand = str(root / 'call' / 'co.cand_circ.fa')
    first = open(cand).readline().split('\t')[1]
    os.makedirs(root / 's1')
    os.makedirs(root / 's2')
    _split(cand, root / 's1' / 's1.cand_circ.fa',
           root / 's2' / 's2.cand_circ.fa', first)
    lst = sample_list(str(root / 'samples.lst'),
                      [('s1', str(root / 's1' / 's1.cand_circ.fa')),
                       ('s2', str(root / 's2' / 's2.cand_circ.fa'))])
    _jax_collapse(lst, ref, root / 'out_jax', 'co')
    _port_collapse(lst, ref, root / 'out_port', 'co')

    jgenome = JaxGenome(ref)
    genome = Genome(ref)
    jcand = jcl.load_cand_circ(lst)
    tcand = tcl.load_cand_circ(lst)
    return SimpleNamespace(
        root=root, ref=ref, lst=lst, truth=truth,
        jctx=JaxContext(genome=jgenome), tctx=Context(genome=genome),
        jcand=jcand, tcand=tcand, jclusters=jcl.cluster_reads(jcand),
        tclusters=tcl.cluster_reads(tcand))


# -- the fuser copy ------------------------------------------------------

def _rand_codes(rng, lo, hi):
    return rng.integers(0, 5, size=int(rng.integers(lo, hi))).astype(np.int8)


def _sw_job(rng):
    n = int(rng.integers(1, 9))
    qs = [_rand_codes(rng, 5, 300) for _ in range(n)]
    rs = [_rand_codes(rng, 5, 500) for _ in range(n)]
    p = sw.SWParams(10, 4, 8, 2) if rng.integers(2) else sw.SWParams(2, 4, 4,
                                                                      2)
    return qs, rs, p


def _same_sw(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_fused_sw_matches_direct_and_jax(rng):
    jobs = [_sw_job(rng) for _ in range(13)]
    fused = tcl._fused_sw(jobs, 'cpu')
    for (qs, rs, p), got in zip(jobs, fused):
        _same_sw(got, tcl._sw_many_vs_many_direct(qs, rs, p, 'cpu'))
        _same_sw(got, jcl._sw_many_vs_many_direct(qs, rs, jcl.SWParams(*p)))


def test_fused_edit_matches_direct_and_jax(rng):
    jobs = []
    for _ in range(9):
        n = int(rng.integers(1, 7))
        jobs.append(([_rand_codes(rng, 0, 200) for _ in range(n)],
                     [_rand_codes(rng, 0, 150) for _ in range(n)]))
    fused = tcl._fused_edit(jobs, 'cpu')
    for (a, b), got in zip(jobs, fused):
        assert np.array_equal(got, tcl._edit_many_direct(a, b, 'cpu'))
        assert np.array_equal(got, jcl._edit_many_direct(a, b))


def test_fuser_threads_roundtrip(rng):
    """Worker threads submitting through DeviceFuser get per-job results
    identical to direct calls; jobs actually fuse (rounds < jobs)."""
    jobs = [_sw_job(rng) for _ in range(24)]
    fuser = DeviceFuser({'sw': lambda js: tcl._fused_sw(js, 'cpu'),
                         'edit': lambda js: tcl._fused_edit(js, 'cpu')})
    results = [None] * len(jobs)

    def worker(lo, hi):
        fuser.register()
        try:
            assert current_fuser() is fuser
            for t in range(lo, hi):
                results[t] = fuser.call('sw', jobs[t])
        finally:
            fuser.unregister()

    threads = [threading.Thread(target=worker, args=(k * 6, (k + 1) * 6))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    fuser.close()
    assert current_fuser() is None
    for job, got in zip(jobs, results):
        _same_sw(got, tcl._sw_many_vs_many_direct(*job, 'cpu'))
    assert fuser.jobs == len(jobs)
    assert 0 < fuser.rounds < len(jobs)


def test_fuser_propagates_executor_error():
    def boom(jobs):
        raise ValueError('fused boom')

    fuser = DeviceFuser({'sw': boom})
    fuser.register()
    try:
        with pytest.raises(ValueError, match='fused boom'):
            fuser.call('sw', ([], [], None))
    finally:
        fuser.unregister()
        fuser.close()


def test_launch_counts_survive_threads(monkeypatch):
    """collapse's worker threads launch the traceback kernel side by side:
    count_launch loses no update under frequent thread switches."""
    import sys

    from ciri_long_tpu_torch.utils import dispatch

    monkeypatch.setitem(dispatch.LAUNCHES, 'sw_traceback', 0)
    monkeypatch.setitem(dispatch.ROUTES, 'wave', 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                dispatch.count_launch('sw_traceback', 'wave')

        threads = [threading.Thread(target=work)
                   for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert dispatch.LAUNCHES['sw_traceback'] == 2000 * len(threads)
    assert dispatch.ROUTES['wave'] == 2000 * len(threads)


# -- the stage's functions against the JAX package -------------------------

def _norm(cs):
    return [(list(r[0]), r[1], [tuple(x) for x in r[2]], *r[3:]) for r in cs]


def test_cluster_reads_matches_jax(cohort):
    assert [[tuple(r) for r in c] for c in cohort.tclusters] == \
        [[tuple(r) for r in c] for c in cohort.jclusters]
    assert sum(len(c) >= 2 for c in cohort.tclusters) >= 3


def test_curate_junction_matches_jax(cohort):
    for jc, tc in zip(cohort.jclusters, cohort.tclusters):
        if len(tc) < 2:
            continue
        ctg = tc[0].circ_id.split(':')[0]
        st = [int(r.circ_id.split(':')[1].split('-')[0]) for r in tc]
        en = [int(r.circ_id.split(':')[1].split('-')[1]) for r in tc]
        junc = tc[0].seq[:40]
        want = jcl.curate_junction(cohort.jctx, ctg, st, en, junc)
        got = tcl.curate_junction(cohort.tctx, ctg, st, en, junc,
                                  device='cpu')
        assert got == want and len(got) > 100


def test_cluster_sequence_matches_jax(cohort):
    from ciri_long_tpu_torch.utils.seq import compress_seq
    for tc in cohort.tclusters:
        if len(tc) < 3:
            continue
        sequence = {r.read_id: r.seq for r in tc}
        hpc = [(compress_seq(r.seq), [r.read_id]) for r in tc]
        want = jcl.cluster_sequence(hpc, sequence)
        assert tcl.cluster_sequence(hpc, sequence, device='cpu') == want
        assert tcl.batch_cluster_sequence('c', list(sequence.items()),
                                          'cpu') == \
            jcl.batch_cluster_sequence('c', list(sequence.items()))


def test_correct_cluster_matches_jax(cohort):
    done = 0
    for jc, tc in zip(cohort.jclusters, cohort.tclusters):
        want = jcl.correct_cluster(cohort.jctx, jc)
        got = tcl.correct_cluster(cohort.tctx, tc, device='cpu')
        assert (got is None) == (want is None)
        if want is not None:
            assert got[0] == want[0]
            assert _norm([got[1]]) == _norm([want[1]])
            done += 1
    assert done >= 3


# -- the cuda route's structure on the CPU ---------------------------------

class _PlainKernels:
    """Stand-ins for the four kernels' entry points on the cuda route: the
    plain PyTorch versions on CPU tensors, counted per call."""

    def __init__(self):
        self.calls = {'sw': 0, 'edit': 0, 'tb': 0, 'poa': 0}
        self.devices = set()
        self.lock = threading.Lock()

    def _count(self, kind, device):
        with self.lock:
            self.calls[kind] += 1
            self.devices.add(getattr(device, 'type', device))

    def sw_align_batch(self, q, r, p, device):
        return sw.sw_align_batch_collect(self.sw_align_batch_submit(
            q, r, p, device))

    def sw_align_batch_submit(self, q, r, p, device):
        self._count('sw', device)
        return ('dev', sw._sw_align_fused(sw._to_device(q, 'cpu'),
                                          sw._to_device(r, 'cpu'), p))

    def edit_distance_batch(self, a, b, alen, blen, device):
        self._count('edit', device)
        return edit.edit_distance_batch_plain(
            *(torch.from_numpy(np.asarray(x)) for x in (a, b, alen,
                                                        blen))).numpy()

    def sw_traceback_batch(self, qs, rs, match, mismatch, gap_open,
                           gap_extend, device):
        self._count('tb', device)
        args = (torch.from_numpy(x) for x in tb.pack_jobs(qs, rs))
        return tb.tb_results(*tb.sw_traceback_batch_plain(
            *args, match, mismatch, gap_open, gap_extend))

    def poa_consensus_many(self, jobs, device):
        self._count('poa', device)
        return poa_consensus_many_plain(jobs)


def _fake_cuda(monkeypatch, kernels):
    """Route collapse as on the card: its device resolves to one whose
    type is 'cuda', and its kernel entry points are ``kernels``'."""
    fake = SimpleNamespace(type='cuda')
    monkeypatch.setattr(tcl, 'resolve_device', lambda d: fake)
    for name in ('sw_align_batch', 'sw_align_batch_submit',
                 'edit_distance_batch', 'sw_traceback_batch',
                 'poa_consensus_many'):
        monkeypatch.setattr(tcl, name, getattr(kernels, name))
    return fake


def test_cuda_route_structure_matches_host_route(cohort, monkeypatch):
    clusters = cohort.tclusters
    want_cnt, want = tcl.correct_reads(cohort.tctx, clusters, device='cpu')

    kernels = _PlainKernels()
    _fake_cuda(monkeypatch, kernels)
    widths, rounds = [], []
    real_chunk = tcl.correct_chunk
    real_fuser = tcl.DeviceFuser

    def chunk_spy(ctx, chunk, max_cluster=200, exec_threads=1, device=None):
        widths.append(exec_threads)
        return real_chunk(ctx, chunk, max_cluster, exec_threads, device)

    class FuserSpy(real_fuser):
        def close(self):
            super().close()
            rounds.append((self.rounds, self.jobs))

    monkeypatch.setattr(tcl, 'correct_chunk', chunk_spy)
    monkeypatch.setattr(tcl, 'DeviceFuser', FuserSpy)
    dispatch.reset_launches()
    got_cnt, got = tcl.correct_reads(cohort.tctx, clusters)
    assert dict(got_cnt) == dict(want_cnt)
    assert _norm(got) == _norm(want)
    assert widths == [tcl.DEVICE_THREADS] == [16]
    # every SW and edit job went through the fuser's rounds; the
    # traceback ran once a cluster
    assert len(rounds) == 1 and 0 < rounds[0][0] < rounds[0][1]
    # the accounting: the fire counters sum to the rounds, the jobs by
    # kind to the jobs, each cluster thread's states to its clusters' span
    summary = dispatch.summary()
    counted = summary['counters']
    assert sum(v for k, v in counted.items()
               if k.startswith('fuser.fire.')) == rounds[0][0]
    assert counted['fuser.jobs.sw'] + counted['fuser.jobs.edit'] == \
        rounds[0][1]
    assert counted['pool.tail_thread_s'] >= 0
    threads = {k: v for k, v in summary['threads'].items()
               if k.startswith('collapse-cluster')}
    assert 1 < len(threads) <= tcl.DEVICE_THREADS
    for rows in threads.values():
        assert rows['fuser.wait']['calls'] > 0
        assert sum(rows[s]['seconds'] for s in (
            'collapse.cluster_host', 'fuser.wait', 'poa.rounds',
            'collapse.junction_poa', 'collapse.rotation_tb')
            if s in rows) == pytest.approx(rows['collapse.cluster']['seconds'],
                                           rel=1e-3)
    assert kernels.calls['sw'] > 0 and kernels.calls['edit'] > 0
    assert kernels.calls['tb'] >= sum(len(c) >= 2 for c in clusters)
    assert kernels.calls['poa'] > 0
    assert kernels.devices == {'cuda'}


def test_cuda_route_raises_when_a_kernel_fails(cohort, monkeypatch):
    """No host fallback: a kernel that cannot be built raises out of
    correct_reads on the cuda route, through the fuser."""
    kernels = _PlainKernels()
    _fake_cuda(monkeypatch, kernels)

    def unbuilt(*a, **kw):
        raise RuntimeError('nvcc failed (1) building edit_distance.cu')

    monkeypatch.setattr(tcl, 'edit_distance_batch', unbuilt)
    with pytest.raises(RuntimeError, match='nvcc failed'):
        tcl.correct_reads(cohort.tctx, cohort.tclusters)


# -- the CLI -------------------------------------------------------------

def test_collapse_cli_matches_jax_on_skill_world(skill):
    got = _files(skill.root / 'out_port', 'vtest')
    assert got == _files(skill.root / 'out_jax', 'vtest')
    rows = got['info'].decode().splitlines()
    assert len(rows) == 1
    assert rows[0].split('\t')[:7] == ['chr1', 'CIRI-long', 'circRNA',
                                       '20001', '20520', '10', '+']
    log = (skill.root / 'out_port' / 'vtest.log').read_text()
    assert 'circRNAs: 1  isoforms: 1' in log
    assert ('kernels: {"sw_score_ends": 0, "edit_distance": 0, '
            '"sw_traceback": 0, "poa_align": 0}') in log
    assert 'device ms: {"poa_align": 0.0}' in log


def test_collapse_cli_matches_jax_on_two_sample_cohort(cohort):
    got = _files(cohort.root / 'out_port', 'co')
    assert got == _files(cohort.root / 'out_jax', 'co')
    assert got['info'].count(b'\n') >= 3
    head = got['expression'].decode().splitlines()[0]
    assert head == 'circ_ID\ts1\ts2'
    assert b'.0' in got['expression']          # a circ missing from s2


def test_collapse_cli_writes_its_summary(cohort):
    """``collapse`` writes {out}/{prefix}.json beside its four files (which
    stay equal to the JAX package's): its stages' timing, the kernels'
    launches and device time, and the run's spans and counters; each
    thread's states sum to its clusters' span."""
    from ciri_long_tpu_torch.utils.dispatch import COLLAPSE_KERNELS

    out = cohort.root / 'out_port'
    assert _files(out, 'co') == _files(cohort.root / 'out_jax', 'co')
    summary = json.loads((out / 'co.json').read_text())
    assert set(summary['timing']) == {'cluster', 'exp_mtx'}
    assert summary['kernels'] == {k: 0 for k in COLLAPSE_KERNELS}
    assert summary['device_ms'] == {'poa_align': 0.0}
    spans = summary['spans']
    for name in ('collapse.correct_reads', 'collapse.cluster',
                 'collapse.cluster_host', 'poa.rounds',
                 'collapse.junction_poa', 'collapse.rotation_tb',
                 'stage.cluster', 'stage.exp_mtx'):
        assert spans[name]['calls'] > 0, name
    for stage in ('cluster', 'exp_mtx'):
        assert round(spans['stage.' + stage]['seconds'], 3) == \
            summary['timing'][stage]['seconds']
    assert spans['collapse.cluster']['calls'] >= 3
    states = ('collapse.cluster_host', 'fuser.wait', 'poa.rounds',
              'collapse.junction_poa', 'collapse.rotation_tb')
    for rows in summary['threads'].values():
        if 'collapse.cluster' in rows:
            assert sum(rows[s]['seconds'] for s in states if s in rows) == \
                pytest.approx(rows['collapse.cluster']['seconds'], rel=1e-3)


@pytest.mark.parametrize('first,second', [('jax', 'port'), ('port', 'jax')])
def test_each_package_resumes_from_the_others_pickle(skill, first, second):
    src = skill.root / 'out_{}'.format(first)
    out = skill.root / 'resume_{}_to_{}'.format(first, second)
    shutil.copytree(src, out)
    pkl = out / 'tmp' / 'vtest.corrected.pkl'
    data = pkl.read_bytes()
    assert b'ciri_long_tpu' not in data        # no class path of a package
    for ext in FILES:
        (out / 'vtest.{}'.format(ext)).unlink()
    (_port_collapse if second == 'port' else _jax_collapse)(
        skill.lst, skill.ref, out, 'vtest')
    assert pkl.read_bytes() == data            # resumed, not recomputed
    assert _files(out, 'vtest') == _files(src, 'vtest')


def test_correct_reads_pool_matches_serial(cohort):
    """-t 2 on the CPU: a spawn pool of host workers over one-cluster
    chunks gives the serial run's corrected clusters and counters."""
    ref = cohort.ref
    idx = None
    cnt1, cs1 = tcl.correct_reads(cohort.tctx, cohort.tclusters,
                                  device='cpu')
    cnt2, cs2 = tcl.correct_reads(cohort.tctx, cohort.tclusters, threads=2,
                                  ref_fasta=ref, idx_file=idx, device='cpu')
    assert dict(cnt2) == dict(cnt1)
    assert _norm(cs2) == _norm(cs1)
    assert len(cs1) >= 3


def test_corrected_pickle_loads_without_either_package(skill):
    """The resume file holds builtins only (counters, ids, sequences), so
    either package reads the other's."""
    with open(skill.root / 'out_port' / 'tmp' / 'vtest.corrected.pkl',
              'rb') as f:
        circ_num, corrected = pickle.load(f)
    assert dict(circ_num) == {'Annotated': 1}
    assert len(corrected) == 1 and corrected[0][3] == 'chr1:20001-20520'


def test_resumes_from_a_pickle_of_the_old_class_names(monkeypatch):
    """A corrected.pkl pickled under the class paths the JAX package used
    before the rename (ciri_long_tpu.pipeline.collapse.Circ and .Read),
    written here through a stand-in module, loads through the port's
    resume unpickler into its READ and CIRC with JAX's fields, as JAX's
    pickle.load loads it through its aliases."""
    import sys
    import types
    from collections import namedtuple
    from ciri_long_tpu_torch.annot.gtf import _PortUnpickler

    name = 'ciri_long_tpu.pipeline.collapse'
    old = types.ModuleType(name)
    old.Circ = namedtuple('Circ', jcl.CIRC._fields)
    old.Read = namedtuple('Read', jcl.READ._fields)
    for cls in (old.Circ, old.Read):
        cls.__module__ = name
    monkeypatch.setitem(sys.modules, name, old)
    circ = old.Circ('chr1', 1, 10, '+')
    read = old.Read('r1', 'chr1:1-10', '+', [(1, 10)], 'AG-GT', (0, 0), [],
                    'ACGT', 's1', 'Annotated')
    data = pickle.dumps([{'Annotated': 1}, [(circ, [read])]])
    assert b'Circ' in data and b'Read' in data
    monkeypatch.undo()
    import io
    circ_num, corrected = _PortUnpickler(io.BytesIO(data)).load()
    (got_circ, (got_read,)), = corrected
    assert circ_num == {'Annotated': 1}
    assert type(got_circ) is tcl.CIRC and type(got_read) is tcl.READ
    assert got_circ == tuple(circ) and got_read == tuple(read)
    assert got_circ._fields == jcl.CIRC._fields
    assert got_read._fields == jcl.READ._fields
    assert tcl.Circ is tcl.CIRC and tcl.Read is tcl.READ
    want = pickle.loads(data)[1][0]
    assert type(want[0]) is jcl.CIRC and tuple(want[0]) == tuple(got_circ)


def test_cohort_world_is_collapse_bench_world(tmp_path):
    """tools/world.py::cohort_world writes the files that
    benchmarks/collapse_bench.py:45-70 writes from the same seed, here at a
    small size, with the JAX package's simulator."""
    from ciri_long_tpu.io.genome import Genome as JGenome
    from ciri_long_tpu.tools.simulate import random_loci, simulate_reads
    from ciri_long_tpu_torch.tools.world import cohort_world

    ref, reads, n = cohort_world(str(tmp_path / 'port'), reads=80,
                                 genome_kb=200, loci=4, seed=5)
    rng = np.random.default_rng(5)
    chr1 = ''.join(rng.choice(list('ACGT'), size=200 * 1000))
    loci = random_loci(JGenome.from_dict({'chr1': chr1}), rng, 4)
    want = ''.join('>{}\n{}\n'.format(rid, seq) for rid, seq, _ in
                   simulate_reads(JGenome.from_dict({'chr1': chr1}), loci,
                                  rng, depth=20))
    assert open(ref).read() == '>chr1\n{}\n'.format(chr1)
    assert open(reads).read() == want
    assert n == want.count('>') == 80
