"""``-t > 1`` with ``--device cuda``: the port's host pool beside the card,
on the CPU, held to the port's -t 1 and to the JAX package.

On the CPU the card's route runs with its kernels' plain versions patched
in (``_card_call`` for ``call``: the SW uploads, the chain extraction, the
tandem screen and the center-star NW; test_torch_collapse.py's
``_PlainKernels`` for ``collapse``), as tests/test_torch_nw_tb.py,
test_torch_chain.py and test_torch_collapse.py do.  The patches stay in
this process: spawned workers run the host route ('cpu'), which needs none.

- (b) find_ccs_reads at threads=2 on the card's route: a detection pool of
  2 threads, no fork, the same tmp/ files as -t 1 and as JAX;
- (c) scan_ccs_reads and scan_raw_reads on one spawn pool of 2 workers
  (the CLI's pre-spawned pool), and recover_ccs_reads on its own: the same
  cand_circ.fa, scan manifest and low_confidence.fa as JAX at threads=1,
  the card stealing at least one chunk of each; a stolen chunk that raises
  fails the stage;
- (d) correct_reads at threads=2: the same corrected clusters and counters
  as the port's -t 1 cpu route and JAX, DEVICE_THREADS stealers sharing
  one fuser;
- (e) the CLI: ``call -t 2`` and ``collapse -t 2`` with ``--device cuda``
  give the -t 1 bytes;
- (f) a spawned scan worker cannot see the card.
"""

import functools
import os
import pickle
import threading
import time
from dataclasses import replace
from multiprocessing.pool import ThreadPool
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ciri_long_tpu.context import Context as JaxContext
from ciri_long_tpu.io.genome import Genome as JaxGenome
from ciri_long_tpu.models.aligner import GenomeAligner as JaxAligner
from ciri_long_tpu.pipeline import find_bsj as jfb
from ciri_long_tpu.pipeline.find_ccs import find_ccs_reads as jax_find_ccs
from ciri_long_tpu_torch.cli.main import main as cli_main
from ciri_long_tpu_torch.config import DEFAULT
from ciri_long_tpu_torch.context import Context
from ciri_long_tpu_torch.io.genome import Genome
from ciri_long_tpu_torch.models import aligner as taligner
from ciri_long_tpu_torch.models.aligner import GenomeAligner
from ciri_long_tpu_torch.ops import chain as tchain
from ciri_long_tpu_torch.ops import nw_tb_batch as ntb
from ciri_long_tpu_torch.ops import sw as tsw
from ciri_long_tpu_torch.parallel.hybrid import HybridDrain
from ciri_long_tpu_torch.pipeline import collapse as tcl
from ciri_long_tpu_torch.pipeline import find_bsj as tfb
from ciri_long_tpu_torch.pipeline import find_ccs as tfc
from ciri_long_tpu_torch.tools.world import sample_list, skill_world
from ciri_long_tpu_torch.utils import dispatch
from tests.test_torch_call import recover_world  # noqa: F401 -- fixture
from tests.test_torch_collapse import (_PlainKernels, _fake_cuda, _files,
                                       _norm, cohort)  # noqa: F401 -- fixture
from tests.test_torch_nw_tb import _ccs_reads

torch.set_num_threads(1)

CARD = torch.device('cuda', 0)
CALL_PATH = ('sw', 'chain', 'screen', 'nw')


def _resolve(d):
    """The card for any cuda name, the CPU for 'cpu'."""
    d = torch.device(d) if not isinstance(d, torch.device) else d
    return CARD if d.type == 'cuda' else d


def _card_call(monkeypatch):
    """``call``'s card route with every kernel replaced by its plain version
    on CPU tensors.  Returns the card-route calls of each kernel, and the
    names of the threads that made them."""
    calls = {k: 0 for k in CALL_PATH}
    threads = set()
    lock = threading.Lock()

    def count(kind):
        with lock:
            calls[kind] += 1
            threads.add(threading.current_thread().name)

    for mod in (dispatch, tfb, tfc, tsw, taligner, ntb):
        monkeypatch.setattr(mod, 'resolve_device', _resolve)
    real_to_device = tsw._to_device

    def to_device(arr, device):
        if _resolve(device).type == 'cuda':
            count('sw')
        return real_to_device(arr, 'cpu')

    real_extract = tchain.chain_extract_batch

    def extract(*args, device, **kw):
        if _resolve(device).type == 'cuda':
            count('chain')
        return real_extract(*args, device='cpu', **kw)

    real_screen = tfc.screen_keep

    def screen(*args):
        count('screen')
        return real_screen(*args[:-1], device='cpu')

    def nw(q, r, launch, *scores):
        count('nw')
        return ntb.nw_launch_plain(q, r, launch, *scores)

    monkeypatch.setattr(tsw, '_to_device', to_device)
    monkeypatch.setattr(tchain, 'chain_extract_batch', extract)
    monkeypatch.setattr(tfc, 'screen_keep', screen)
    monkeypatch.setattr(ntb, 'upload', lambda arrays, device: [
        torch.from_numpy(np.ascontiguousarray(x)) for x in arrays])
    monkeypatch.setattr(ntb, 'nw_traceback_cuda', nw)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a, **k: None)
    return SimpleNamespace(calls=calls, threads=threads)


def _no_fork(monkeypatch):
    import multiprocessing
    real = multiprocessing.get_context

    def get_context(method=None):
        assert method != 'fork', 'the card route forked'
        return real(method)

    monkeypatch.setattr(tfc.multiprocessing, 'get_context', get_context)


class _DrainSpy(HybridDrain):
    made = []

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.width = kw.get('device_width', 1)
        _DrainSpy.made.append(self)


@pytest.fixture
def drains(monkeypatch):
    _DrainSpy.made = []
    monkeypatch.setattr(tfb, 'HybridDrain', _DrainSpy)
    monkeypatch.setattr(tcl, 'HybridDrain', _DrainSpy)
    return _DrainSpy.made


# -- (b) the CCS stage ---------------------------------------------------

def test_find_ccs_reads_threads_on_the_card_route(rng, tmp_path,
                                                  monkeypatch):
    reads_fa = tmp_path / 'reads.fa'
    _ccs_reads(rng, reads_fa)
    monkeypatch.setenv('CIRI_CCS_DEVICE', '0')
    monkeypatch.delenv('CIRI_SELECT_THREADS', raising=False)
    jres = jax_find_ccs(str(reads_fa), str(tmp_path / 'jax'), 'p',
                        use_device_screen=False)
    card = _card_call(monkeypatch)
    _no_fork(monkeypatch)
    widths = []
    real_pool = tfc.ThreadPoolExecutor

    def pool_spy(n):
        widths.append(n)
        return real_pool(n)

    monkeypatch.setattr(tfc, 'ThreadPoolExecutor', pool_spy)
    one = tfc.find_ccs_reads(str(reads_fa), str(tmp_path / 't1'), 'p',
                             threads=1, device='cuda')
    assert widths == []                 # -t 1: CIRI_SELECT_THREADS unset
    two = tfc.find_ccs_reads(str(reads_fa), str(tmp_path / 't2'), 'p',
                             threads=2, device='cuda')
    assert widths == [2]
    assert one == two == jres and jres[1] >= 12
    for name in ('tmp/p.ccs.fa', 'tmp/p.raw.fa'):
        want = (tmp_path / 'jax' / name).read_bytes()
        assert (tmp_path / 't1' / name).read_bytes() == want
        assert (tmp_path / 't2' / name).read_bytes() == want
    assert card.calls['screen'] == 2 and card.calls['nw'] >= 2


# -- (c) the scan stages on a spawn pool -----------------------------------

@pytest.fixture(scope='module')
def scan_world(tmp_path_factory):
    """The verification world, its consensus reads, one Context per
    package, and a spawn pool of 2 scan workers (the CLI's pre-spawned
    pool), terminated at the end."""
    root = tmp_path_factory.mktemp('threads_scan')
    ref, reads = skill_world(str(root / 'w'))
    ccs_seq = tfc.find_ccs_reads(reads, str(root / 'ccs'), 'p',
                                 device='cpu')[2]
    jgenome = JaxGenome(ref)
    genome = Genome(ref)
    pool = tfb._spawn_pool(2, ref, None, False, None)
    try:
        yield SimpleNamespace(
            root=root, ref=ref, reads=reads, ccs_seq=ccs_seq, pool=pool,
            jctx=JaxContext(aligner=JaxAligner(jgenome), genome=jgenome),
            tctx=Context(aligner=GenomeAligner(genome), genome=genome),
            cfg=replace(DEFAULT.call, ccs_chunk_size=4, raw_chunk_size=4))
    finally:
        pool.terminate()
        pool.join()


def _scan_files(out):
    return {name: (out / name).read_bytes() for name in
            ('p.cand_circ.fa', 'tmp/p.scan.progress', 'p.low_confidence.fa')}


def test_scan_stages_drain_beside_the_pool(scan_world, tmp_path,
                                           monkeypatch, drains):
    w = scan_world
    jout = tmp_path / 'jax'
    (jout / 'tmp').mkdir(parents=True)
    jcnt, jshort = jfb.scan_ccs_reads(w.jctx, w.ccs_seq, True, str(jout),
                                      'p', w.cfg, threads=1)
    jraw = jfb.scan_raw_reads(w.jctx, w.reads, True, str(jout), 'p', w.cfg,
                              threads=1)
    card = _card_call(monkeypatch)
    out = tmp_path / 'card'
    (out / 'tmp').mkdir(parents=True)
    cnt, short = tfb.scan_ccs_reads(
        w.tctx, w.ccs_seq, True, str(out), 'p', w.cfg, threads=2,
        ref_fasta=w.ref, pool=w.pool, device='cuda')
    raw = tfb.scan_raw_reads(w.tctx, w.reads, True, str(out), 'p', w.cfg,
                             threads=2, ref_fasta=w.ref, pool=w.pool,
                             device='cuda')
    assert (dict(cnt), short) == (dict(jcnt), jshort)
    assert (dict(raw[0]), raw[1]) == (dict(jraw[0]), jraw[1])
    assert _scan_files(out) == _scan_files(jout)
    assert cnt['bsj'] == 10
    # 3 consensus chunks and 4 raw chunks, the card took some of each,
    # from its stealer thread; the pool's workers ran the rest
    assert [len(d._payloads) for d in drains] == [3, 4]
    assert all(d.stolen >= 1 for d in drains)
    assert card.calls['chain'] >= 2
    assert any(t.startswith('ciri-hybrid-device') for t in card.threads)


def test_stolen_scan_chunk_that_raises_fails_the_stage(scan_world, tmp_path,
                                                       monkeypatch):
    w = scan_world
    _card_call(monkeypatch)

    def broken(ctx, chunk, is_canonical, cfg, device):
        assert device.type == 'cuda'
        raise RuntimeError('nvcc failed (1) building chain_dp.cu')

    monkeypatch.setattr(tfb, 'scan_ccs_chunk', broken)
    out = tmp_path / 'card'
    (out / 'tmp').mkdir(parents=True)
    with pytest.raises(RuntimeError, match='hybrid drain failed'):
        tfb.scan_ccs_reads(w.tctx, w.ccs_seq, True, str(out), 'p', w.cfg,
                           threads=2, ref_fasta=w.ref, pool=w.pool,
                           device='cuda')


def test_recover_ccs_reads_drain_matches_jax(recover_world, tmp_path,
                                             monkeypatch, drains):
    jctx, tctx, reads, root = recover_world
    cfg = replace(DEFAULT.call, ccs_chunk_size=4)
    outs = {}
    for name in ('jax', 'card'):
        (tmp_path / name).mkdir()
        (tmp_path / name / 'p.cand_circ.fa').write_text('')
    want = jfb.recover_ccs_reads(jctx, reads, True, str(tmp_path / 'jax'),
                                 'p', cfg, threads=1)
    _card_call(monkeypatch)
    got = tfb.recover_ccs_reads(tctx, reads, True, str(tmp_path / 'card'),
                                'p', cfg, threads=2,
                                ref_fasta=str(root / 'genome.fa'),
                                device='cuda')
    for name in ('jax', 'card'):
        outs[name] = (tmp_path / name / 'p.cand_circ.fa').read_bytes()
    assert dict(got) == dict(want) and got['bsj'] >= 8
    assert outs['card'] == outs['jax']
    assert len(drains) == 1 and drains[0].stolen >= 1


# -- (f) the workers and the card --------------------------------------------

def test_spawned_scan_worker_cannot_see_the_card(scan_world):
    pool = scan_world.pool
    assert pool.apply(functools.partial(os.getenv, 'CUDA_VISIBLE_DEVICES'),
                      ()) == ''
    assert pool.apply(torch.cuda.device_count, ()) == 0
    with pytest.raises(RuntimeError, match='is_available'):
        pool.apply(dispatch.resolve_device, ('cuda',))


# -- (d) collapse's correction pass ----------------------------------------

def test_correct_reads_drain_shares_one_fuser(cohort, monkeypatch, drains):  # noqa: F811
    kernels = _PlainKernels()
    fake = _fake_cuda(monkeypatch, kernels)
    monkeypatch.setattr(tcl, 'resolve_device', lambda d: fake
                        if getattr(d, 'type', d) == 'cuda'
                        else torch.device('cpu'))
    # the pool's workers on threads of this process (the scheduler is the
    # same; a spawn pool is held to the host route by
    # test_correct_reads_pool_matches_serial)
    monkeypatch.setenv('CUDA_VISIBLE_DEVICES', '')
    monkeypatch.setattr(tcl, '_COLLAPSE_CTX', None)
    # a pool that starts late takes only its prefetch (a chunk a worker),
    # so the stealers claim every other chunk at once; they meet at a
    # barrier, registered, so that their first jobs share fused rounds
    n_chunks = len(cohort.tclusters)
    assert 4 <= n_chunks <= 8             # -t 2: chunks of one cluster

    def late_init(*args):
        time.sleep(1.0)
        tcl._collapse_worker_init(*args)

    monkeypatch.setattr(tcl, '_spawn_pool', lambda n, *args: ThreadPool(
        n, late_init, args))
    barrier = threading.Barrier(n_chunks - 2, timeout=60)
    real_cluster = tcl.correct_cluster

    def correct_cluster(ctx, cluster, *a, device, **kw):
        if device is fake:
            barrier.wait()
        return real_cluster(ctx, cluster, *a, device=device, **kw)

    monkeypatch.setattr(tcl, 'correct_cluster', correct_cluster)
    fusers = []

    class FuserSpy(tcl.DeviceFuser):
        def close(self):
            super().close()
            fusers.append((self.rounds, self.jobs))

    monkeypatch.setattr(tcl, 'DeviceFuser', FuserSpy)
    gcache = str(cohort.root / 'out_port' / 'tmp' / 'gcodes')
    got_cnt, got = tcl.correct_reads(cohort.tctx, cohort.tclusters,
                                     threads=2, ref_fasta=cohort.ref,
                                     gcache=gcache, device='cuda')
    with open(cohort.root / 'out_port' / 'tmp' / 'co.corrected.pkl',
              'rb') as f:
        cpu_cnt, cpu = pickle.load(f)
    with open(cohort.root / 'out_jax' / 'tmp' / 'co.corrected.pkl',
              'rb') as f:
        jax_cnt, jax = pickle.load(f)
    assert dict(got_cnt) == dict(cpu_cnt) == dict(jax_cnt)
    assert _norm(got) == _norm(cpu) == _norm(jax)
    assert len(drains) == 1 and drains[0].width == tcl.DEVICE_THREADS == 16
    assert drains[0].stolen == n_chunks - 2
    # one fuser, shared by the stealers, fusing several jobs a round
    assert len(fusers) == 1 and 0 < fusers[0][0] < fusers[0][1]
    assert kernels.calls['sw'] > 0 and kernels.calls['tb'] > 0
    assert kernels.devices == {'cuda', 'cpu'}


# -- (e) the CLI ---------------------------------------------------------------

def _cli_outputs(out, prefix):
    import json
    with open(out / '{}.json'.format(prefix)) as f:
        summary = json.load(f)
    counters = {k: v for k, v in summary.items()
                if k not in ('timing', 'kernels', 'spans', 'counters',
                             'threads')}
    return counters, {name: (out / name).read_bytes() for name in (
        '{}.cand_circ.fa'.format(prefix),
        '{}.low_confidence.fa'.format(prefix), 'tmp/{}.ccs.fa'.format(prefix),
        'tmp/{}.raw.fa'.format(prefix))}, summary['kernels']


def test_cli_threads_on_the_card_route_match_t1(tmp_path, monkeypatch):
    ref, reads = skill_world(str(tmp_path / 'w'))

    def call(out, *extra):
        cli_main(['call', '-i', reads, '-o', str(tmp_path / out), '-r', ref,
                  '-p', 'vtest', *extra])

    def collapse(out, cand, *extra):
        lst = sample_list(str(tmp_path / (out + '.lst')),
                          [('vtest', str(tmp_path / cand /
                                         'vtest.cand_circ.fa'))])
        cli_main(['collapse', '-i', lst, '-o', str(tmp_path / out), '-r',
                  ref, '-p', 'vtest', *extra])

    # each run as a fresh process starts: the CLI sets the select core's
    # thread budget from -t when the variable is unset
    monkeypatch.delenv('CIRI_SELECT_THREADS', raising=False)
    call('t1', '-t', '1', '--device', 'cpu')
    collapse('c1', 't1', '-t', '1', '--device', 'cpu')
    monkeypatch.delenv('CIRI_SELECT_THREADS')
    card = _card_call(monkeypatch)
    kernels = _PlainKernels()
    _fake_cuda(monkeypatch, kernels)
    call('t2', '-t', '2', '--device', 'cuda')
    collapse('c2', 't2', '-t', '2', '--device', 'cuda')

    want_cnt, want_files, cpu_kernels = _cli_outputs(tmp_path / 't1',
                                                     'vtest')
    got_cnt, got_files, _ = _cli_outputs(tmp_path / 't2', 'vtest')
    assert got_cnt == want_cnt and got_cnt['bsj'] == 10
    assert got_files == want_files
    assert set(cpu_kernels.values()) == {0}
    assert card.calls['chain'] > 0 and card.calls['screen'] == 1
    assert card.calls['nw'] > 0
    assert _files(tmp_path / 'c2', 'vtest') == _files(tmp_path / 'c1',
                                                      'vtest')
    assert (tmp_path / 'c2' / 'tmp' / 'vtest.corrected.pkl').read_bytes() \
        == (tmp_path / 'c1' / 'tmp' / 'vtest.corrected.pkl').read_bytes()
    assert kernels.devices == {'cuda'} and kernels.calls['tb'] > 0
