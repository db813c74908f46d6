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
from ciri_long_tpu_torch.ops import rows as rows_mod
from ciri_long_tpu_torch.ops.rows import (RUNGS, Rows, concat_rows,
                                          encoded_rows, padded, row_groups,
                                          rows_of)
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


# -- the fuser copy and the native rounds' twins ---------------------------

def _rand_codes(rng, lo, hi):
    return rng.integers(0, 5, size=int(rng.integers(lo, hi))).astype(np.int8)


def _lists(rows):
    """The rows of a ops/rows.py::Rows as a list of code arrays."""
    return [rows.codes[o:o + n] for o, n in zip(rows.off.tolist(),
                                                rows.lens.tolist())]


def _ragged(rng, seqs, n, case):
    """Rows of n row views over ``seqs`` held once: random picks, with
    empty slices (case 'empty') or the whole sequences in order."""
    base = rows_of(seqs)
    pick = rng.integers(0, len(seqs), n)
    off, lens = base.off[pick].copy(), base.lens[pick].copy()
    if case == 'empty':
        lens[rng.random(n) < 0.3] = 0
    elif case == 'slices':
        cut = rng.integers(0, lens + 1)
        off, lens = off + cut // 2, (lens - cut).astype(np.int32)
    return Rows(base.codes, off.astype(np.int32), lens)


# row lengths at each rung's edge (RUNGS up to 512) and past the last
# rung a fused round of collapse meets
EDGES = [0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 511, 512, 513]
ROW_CASES = ('random', 'empty', 'slices', 'rung_edges')


def _sw_job(rng, case='random'):
    n = int(rng.integers(1, 9))
    if case == 'rung_edges':
        qs = [_rand_codes(rng, k, k + 1) for k in EDGES]
        rs = [_rand_codes(rng, k, k + 1) for k in EDGES[::-1]]
        q, r = rows_of(qs), rows_of(rs)
    else:
        q = _ragged(rng, [_rand_codes(rng, 5, 300) for _ in range(3)], n,
                    case)
        r = _ragged(rng, [_rand_codes(rng, 5, 500) for _ in range(4)], n,
                    case)
    p = sw.SWParams(10, 4, 8, 2) if rng.integers(2) else sw.SWParams(2, 4, 4,
                                                                      2)
    return q, r, p


def _edit_job(rng, case='random'):
    if case == 'rung_edges':
        return (rows_of([_rand_codes(rng, k, k + 1) for k in EDGES]),
                rows_of([_rand_codes(rng, k, k + 1) for k in EDGES[1:]]
                        + [_rand_codes(rng, 40, 41)]))
    n = int(rng.integers(1, 7))
    return (_ragged(rng, [_rand_codes(rng, 0, 200) for _ in range(3)], n,
                    case),
            _ragged(rng, [_rand_codes(rng, 0, 150) for _ in range(2)], n,
                    case))


def _same_sw(got, want):
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _jax_sw(q, r, p):
    return jcl._sw_many_vs_many_direct(_lists(q), _lists(r),
                                       jcl.SWParams(*p))


@pytest.mark.parametrize('case', ROW_CASES)
def test_fused_sw_matches_direct_and_jax(rng, case):
    jobs = [_sw_job(rng, case) for _ in range(4 if case == 'rung_edges'
                                              else 13)]
    fused = tcl._fused_sw(jobs, 'cpu')
    want = jcl._fused_sw([(_lists(q), _lists(r), jcl.SWParams(*p))
                          for q, r, p in jobs])
    for (q, r, p), got, w in zip(jobs, fused, want):
        _same_sw(got, tcl._fused_sw([(q, r, p)], 'cpu')[0])
        _same_sw(got, _jax_sw(q, r, p))
        _same_sw(got, w)


@pytest.mark.parametrize('case', ROW_CASES)
def test_fused_edit_matches_direct_and_jax(rng, case):
    jobs = [_edit_job(rng, case) for _ in range(9)]
    fused = tcl._fused_edit(jobs, 'cpu')
    want = jcl._fused_edit([(_lists(a), _lists(b)) for a, b in jobs])
    for (a, b), got, w in zip(jobs, fused, want):
        assert np.array_equal(got, tcl._fused_edit([(a, b)], 'cpu')[0])
        assert np.array_equal(got, jcl._edit_many_direct(_lists(a),
                                                         _lists(b)))
        assert np.array_equal(got, w)


@pytest.mark.parametrize('case', ROW_CASES)
def test_native_sw_round_twin_matches_fused_scorer(rng, case):
    """sw_align_rows_plain (the native round's expand, forward pass,
    reversed prefixes, reverse pass and [B, 5] answers, in numpy and the
    plain scorer) equals _sw_align_fused on each job padded, the host
    route and JAX, over a round of ragged jobs of two params."""
    jobs = [_sw_job(rng, case) for _ in range(3 if case == 'rung_edges'
                                              else 7)]
    params = list(dict.fromkeys(p for _, _, p in jobs))
    n = [len(q.lens) for q, _, _ in jobs]
    pid = np.repeat([params.index(p) for _, _, p in jobs], n)
    q = concat_rows([j[0] for j in jobs])
    r = concat_rows([j[1] for j in jobs])
    got = sw.sw_align_rows_plain(q, r, pid, params)
    assert np.array_equal(got, sw.sw_align_rows(q, r, pid, params, 'cpu'))
    at = 0
    for jq, jr, p in jobs:
        k = len(jq.lens)
        want = [t.numpy() for t in sw._sw_align_fused(
            torch.from_numpy(padded(jq)[0]), torch.from_numpy(padded(jr)[0]),
            p)]
        assert np.array_equal(got[:, at:at + k], np.stack(want))
        _same_sw(got[:, at:at + k], _jax_sw(jq, jr, p))
        at += k


@pytest.mark.parametrize('case', ROW_CASES + ('bad_code',))
def test_native_edit_round_twin_plans_the_routes_and_matches(rng, case):
    """edit_rows_plan lists the pairs whose shorter row fits one word,
    then the rest, each in pair order; edit_distance_rows_plain equals
    the padded batch on the host and JAX; a code outside 0..7 inside a
    row raises, one outside every row does not."""
    jobs = [_edit_job(rng, 'random' if case == 'bad_code' else case)
            for _ in range(5)]
    a = concat_rows([j[0] for j in jobs])
    b = concat_rows([j[1] for j in jobs])
    if case == 'bad_code':
        inside = int(np.flatnonzero(a.lens)[0])
        outside = Rows(np.append(a.codes, np.int8(9)), a.off, a.lens)
        assert edit.edit_rows_plan(outside, b)[1] >= 0
        codes = a.codes.copy()
        codes[a.off[inside]] = 8
        with pytest.raises(ValueError, match='codes must be 0..7'):
            edit.edit_rows_plan(Rows(codes, a.off, a.lens), b)
        with pytest.raises(ValueError, match='codes must be 0..7'):
            edit.edit_distance_rows_plain(Rows(codes, a.off, a.lens), b)
        return
    (apad, alen), (bpad, blen) = padded(a), padded(b)
    order, n_thread = edit.edit_rows_plan(a, b)
    short = [k for k in range(len(alen)) if min(alen[k], blen[k]) <= 32]
    assert order.tolist() == short + [k for k in range(len(alen))
                                      if k not in short]
    assert n_thread == len(short)
    got = edit.edit_distance_rows_plain(a, b)
    assert np.array_equal(got, edit.edit_distance_batch(apad, bpad, alen,
                                                        blen, 'cpu'))
    assert np.array_equal(got, edit.edit_distance_rows(a, b, 'cpu'))
    assert np.array_equal(got, jcl._edit_many_direct(_lists(a), _lists(b)))


class _EmulatedRowsLib:
    """csrc/sw_score_ends.cu's and csrc/edit_distance.cu's row-round entry
    points emulated through their C interface (the pointers and ints
    ctypes passes): the views, plan rows and route order read from memory,
    the rounds computed with the plain scorer and edit distance."""

    def __init__(self):
        self.stages = []

    @staticmethod
    def _array(ptr, ctype, n):
        if not n:
            return np.zeros(0, np.ctypeslib.as_ctypes_type(ctype))
        return np.ctypeslib.as_array((np.ctypeslib.as_ctypes_type(ctype) * n)
                                     .from_address(ptr))

    def _stage(self, device):
        self.stages.append(device)
        return 1000 + len(self.stages)

    sw_rows_stage_new = edit_rows_stage_new = _stage

    def sw_rows_run(self, h, qp, nq, rp, nr, vp, B, pp, G, outp, nsp):
        qc, rc = self._array(qp, np.int8, nq), self._array(rp, np.int8, nr)
        views = self._array(vp, np.int32, 4 * B).reshape(4, B)
        plan = self._array(pp, np.int32, 13 * G).reshape(G, 13)
        out = self._array(outp, np.int32, 5 * B).reshape(B, 5)
        assert plan[:, 0].tolist() == np.r_[0, np.cumsum(plan[:, 1])[:-1]]\
            .tolist() and plan[:, 1].sum() == B
        for start, n, Lq, Lr, *p in plan[:, :8].tolist():
            rows = slice(start, start + n)
            q = Rows(qc, views[0, rows], views[1, rows])
            r = Rows(rc, views[2, rows], views[3, rows])
            assert Lq == max(1, q.lens.max()) and Lr == max(1, r.lens.max())
            out[rows] = sw.sw_align_rows_plain(
                q, r, np.zeros(n, np.int64), [sw.SWParams(*p)]).T
        self._array(nsp, np.float64, 3)[:] += 1.0
        return 0

    def edit_rows_run(self, h, ap, na, bp, nb, vp, B, outp, infop, nsp):
        ac, bc = self._array(ap, np.int8, na), self._array(bp, np.int8, nb)
        views = self._array(vp, np.int32, 4 * B).reshape(4, B)
        a = Rows(ac, views[0], views[1])
        b = Rows(bc, views[2], views[3])
        try:
            order, n_thread = edit.edit_rows_plan(a, b)
        except ValueError:
            return -2
        self._array(outp, np.int32, B)[:] = edit.edit_distance_rows_plain(
            a, b)
        self._array(infop, np.int32, 2)[:] = (n_thread, B - n_thread)
        self._array(nsp, np.float64, 3)[:] += 1.0
        return 0


def test_native_round_wrappers_on_an_emulated_library(rng, monkeypatch):
    """sw_align_rows and edit_distance_rows on the card's route with the
    kernels' libraries emulated through their C interface: the views,
    plan rows and answers round-trip to the twins' answers, the launches
    and phases are counted, the device's one stage serves both kinds and
    every round (each library's staging made once), a code outside 0..7
    raises."""
    from ciri_long_tpu_torch.ops import _build
    lib = _EmulatedRowsLib()
    monkeypatch.setattr(_build, 'load', lambda source, symbols: lib)
    dev = torch.device('cuda', 0)
    monkeypatch.setattr(sw, 'resolve_device', lambda d: dev)
    monkeypatch.setattr(edit, 'resolve_device', lambda d: dev)
    monkeypatch.setitem(dispatch.LAUNCHES, 'sw_score_ends', 0)
    monkeypatch.setitem(dispatch.LAUNCHES, 'edit_distance', 0)
    monkeypatch.setitem(dispatch.LAUNCHES, 'fused_rows', 0)
    monkeypatch.setattr(rows_mod, '_STAGES', {})
    jobs = [_sw_job(rng, 'slices') for _ in range(5)]
    params = list(dict.fromkeys(p for _, _, p in jobs))
    pid = np.repeat([params.index(p) for _, _, p in jobs],
                    [len(q.lens) for q, _, _ in jobs])
    q = concat_rows([j[0] for j in jobs])
    r = concat_rows([j[1] for j in jobs])
    phases = {}
    got = sw.sw_align_rows(q, r, pid, params, 'cuda', phases)
    assert np.array_equal(got, sw.sw_align_rows_plain(q, r, pid, params))
    groups = row_groups(q.lens, r.lens, pid)[1]
    assert dispatch.LAUNCHES['sw_score_ends'] == 2 * len(groups)
    assert dispatch.LAUNCHES['fused_rows'] == 3
    assert set(phases) == set(sw.ROW_PHASES)
    assert phases['upload'] == phases['device_wait'] == 1.0
    a, b = _edit_job(rng, 'empty')
    d = edit.edit_distance_rows(a, b, 'cuda', phases)
    assert np.array_equal(d, edit.edit_distance_rows_plain(a, b))
    assert dispatch.LAUNCHES['edit_distance'] == 1
    assert dispatch.LAUNCHES['fused_rows'] == 4
    assert phases['download'] == 2.0
    bad = Rows(np.full(4, 9, np.int8), np.zeros(1, np.int32),
               np.full(1, 4, np.int32))
    with pytest.raises(ValueError, match='codes must be 0..7'):
        edit.edit_distance_rows(bad, bad, 'cuda')
    sw.sw_align_rows(q, r, pid, params, 'cuda')
    assert lib.stages == [0, 0]
    assert list(rows_mod._STAGES) == [('cuda', 0)]
    assert sorted(rows_mod.row_stage(dev)._handles.values()) == [1001, 1002]


@pytest.mark.parametrize('seqs', [[], ['ACGTN'], ['AC', '', 'GGTTA', 'N']])
def test_encoded_rows_hold_each_string_once(seqs):
    """encoded_rows (one encode of the joined strings) gives rows_of's
    Rows of the strings encoded one by one."""
    from ciri_long_tpu_torch.utils.seq import encode_seq
    got, want = encoded_rows(seqs), rows_of([encode_seq(x) for x in seqs])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_row_groups_follow_the_rungs(rng):
    """row_groups: rows of one params index and one rung a side share a
    group, in a stable order; widths are the group's longest rows."""
    ql = np.array(EDGES + [40_000], np.int32)
    rl = np.array(EDGES[::-1] + [3], np.int32)
    pid = rng.integers(0, 2, len(ql))
    order, groups = row_groups(ql, rl, pid)
    assert sorted(order.tolist()) == list(range(len(ql)))
    for start, n, lq, lr, k in groups.tolist():
        rows = order[start:start + n]
        assert list(rows) == sorted(rows)
        assert set(pid[rows]) == {k}
        assert len({int(np.searchsorted(RUNGS, x)) for x in ql[rows]}) == 1
        assert len({int(np.searchsorted(RUNGS, x)) for x in rl[rows]}) == 1
        assert lq == max(1, ql[rows].max()) and lr == max(1, rl[rows].max())


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
        _same_sw(got, tcl._fused_sw([job], 'cpu')[0])
        _same_sw(got, _jax_sw(*job))
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


BUILDERS = ('curate_junction', 'head_anchor_and_template',
            'junc_scores_sorted', 'cluster_sequence')


def _record_rows(monkeypatch):
    """(port, jax): the rows of every SW and edit job each package's
    collapse builds from here on, as ('sw' | 'edit', rows, rows) with the
    rows as lists of code arrays (the port's Rows expanded)."""
    got, want = [], []
    t_sw, t_edit = tcl._sw_rows, tcl._edit_rows
    j_sw, j_edit = jcl._sw_many_vs_many, jcl._edit_many

    def port_sw(q, r, params=tcl.JUNC_SW, device='cuda'):
        got.append(('sw', _lists(q), _lists(r)))
        return t_sw(q, r, params, device)

    def port_edit(a, b, device='cuda'):
        got.append(('edit', _lists(a), _lists(b)))
        return t_edit(a, b, device)

    def jax_sw(q, r, params=jcl.JUNC_SW):
        want.append(('sw', list(q), list(r)))
        return j_sw(q, r, params)

    def jax_edit(a, b):
        want.append(('edit', list(a), list(b)))
        return j_edit(a, b)

    monkeypatch.setattr(tcl, '_sw_rows', port_sw)
    monkeypatch.setattr(tcl, '_edit_rows', port_edit)
    monkeypatch.setattr(jcl, '_sw_many_vs_many', jax_sw)
    monkeypatch.setattr(jcl, '_edit_many', jax_edit)
    return got, want


def _same_jobs(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        for side in (1, 2):
            assert len(g[side]) == len(w[side])
            for x, y in zip(g[side], w[side]):
                assert x.dtype == np.int8 and np.array_equal(x, y)


@pytest.mark.parametrize('builder', BUILDERS)
def test_row_view_builders_give_the_list_rows(cohort, monkeypatch, rng,
                                              builder):
    """Each ragged-view job builder of the port's collapse gives exactly
    the rows the JAX package's list-building code gives, on random
    clusters and windows of the cohort's genome (head-anchor and template:
    every job of correct_cluster, whose first two are those)."""
    from ciri_long_tpu_torch.utils.seq import compress_seq
    got, want = _record_rows(monkeypatch)
    clusters = [c for c in cohort.tclusters if len(c) >= 3]
    assert clusters
    for tc in clusters:
        jc = [c for c in cohort.jclusters if c[0].read_id == tc[0].read_id][0]
        ctg = tc[0].circ_id.split(':')[0]
        st = [int(r.circ_id.split(':')[1].split('-')[0]) for r in tc]
        en = [int(r.circ_id.split(':')[1].split('-')[1]) for r in tc]
        if builder == 'curate_junction':
            k = int(rng.integers(0, len(tc[0].seq) - 60))
            junc = tc[int(rng.integers(len(tc)))].seq[k:k + int(
                rng.integers(30, 60))]
            pick = rng.permutation(len(tc))[:int(rng.integers(1, len(tc)))]
            args = ([st[i] for i in pick], [en[i] for i in pick], junc)
            tcl.curate_junction(cohort.tctx, ctg, *args, device='cpu')
            jcl.curate_junction(cohort.jctx, ctg, *args)
        elif builder == 'head_anchor_and_template':
            tcl.correct_cluster(cohort.tctx, tc, device='cpu')
            jcl.correct_cluster(cohort.jctx, jc)
            assert got[0][0] == got[1][0] == 'sw'
        elif builder == 'junc_scores_sorted':
            juncs = [(min(st) + int(d), max(en) - int(e), 0.1)
                     for d, e in rng.integers(-8, 8, (int(
                         rng.integers(1, 4)), 2))]
            seqs = [r.seq[:int(rng.integers(20, 50))] for r in tc]
            tcl.junc_scores_sorted(cohort.tctx, ctg, juncs, seqs,
                                   device='cpu')
            jcl.junc_scores_sorted(cohort.jctx, ctg, juncs, seqs)
        else:
            pick = rng.permutation(len(tc))[:int(rng.integers(2, len(tc)
                                                              + 1))]
            hpc = [(compress_seq(tc[i].seq), [tc[i].read_id]) for i in pick]
            sequence = {r.read_id: r.seq for r in tc}
            assert tcl.cluster_sequence(hpc, sequence, device='cpu') == \
                jcl.cluster_sequence(hpc, sequence)
    assert got
    _same_jobs(got, want)


@pytest.mark.parametrize('P', [2, 3, 37, 200])
def test_distance_matrix_equals_the_pair_loop(rng, P):
    """cluster_sequence's vectorised distance matrix, d / max(len_i,
    len_j) in one assignment, equals the loop over the pairs it replaced
    bit for bit."""
    lens = rng.integers(1, 3000, P).astype(np.int32)
    i, j = np.triu_indices(P, 1)
    d = rng.integers(0, 3000, len(i)).astype(np.int32)
    loop = np.zeros((P, P))
    for t, (a, b) in enumerate(zip(i.tolist(), j.tolist())):
        loop[a][b] = d[t] / max(int(lens[a]), int(lens[b]))
    vec = np.zeros((P, P))
    vec[i, j] = d / np.maximum(lens[i], lens[j])
    assert np.array_equal((loop + loop.T).view(np.uint64),
                          (vec + vec.T).view(np.uint64))


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
    native rounds' twins and the plain PyTorch versions on CPU tensors,
    counted per call (and the rounds' rows)."""

    def __init__(self):
        self.calls = {'sw': 0, 'edit': 0, 'tb': 0, 'poa': 0}
        self.rows = {'sw': 0, 'edit': 0}
        self.devices = set()
        self.lock = threading.Lock()

    def _count(self, kind, device):
        with self.lock:
            self.calls[kind] += 1
            self.devices.add(getattr(device, 'type', device))

    def sw_align_rows(self, q, r, pid, params, device, phases=None):
        self._count('sw', device)
        self.rows['sw'] += len(q.lens)
        return sw.sw_align_rows_plain(q, r, pid, params)

    def edit_distance_rows(self, a, b, device, phases=None):
        self._count('edit', device)
        self.rows['edit'] += len(a.lens)
        return edit.edit_distance_rows_plain(a, b)

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
    for name in ('sw_align_rows', 'edit_distance_rows', 'sw_traceback_batch',
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
    # every round took the native call, with every row submitted; its
    # phases lie inside the rounds' spans
    assert counted['fuser.native.sw'] + counted['fuser.native.edit'] == \
        rounds[0][0]
    assert counted['fuser.native.sw'] == kernels.calls['sw']
    assert counted['fuser.rows.sw'] == kernels.rows['sw'] > 0
    assert counted['fuser.rows.edit'] == kernels.rows['edit'] > 0
    run_ns = 1e9 * sum(summary['spans']['fuser.run.' + k]['thread_seconds']
                       for k in ('sw', 'edit'))
    phases = [counted['fuser.ns.' + p] for p in sw.ROW_PHASES]
    assert min(phases) >= 0 and 0 < sum(phases) <= run_ns
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

    monkeypatch.setattr(tcl, 'edit_distance_rows', unbuilt)
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
            '"sw_traceback": 0, "poa_align": 0, "fused_rows": 0}') in log
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
