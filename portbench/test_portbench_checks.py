"""The checks that decide ``correct``: their references against the port's
own plain versions and the world's truth, their controls, and whole runs
with the timed path broken underneath, on the CPU at a small size.

The runs drive ``run.run_cell`` past its look for a card (``device='cpu'``).
Run on the card too: ``python -m pytest portbench/ -m cuda`` runs the
cell's controls at its own size.

    python -m pytest portbench/ -q
"""

import numpy as np
import pytest
import torch

import run
from checks import outputs, poa
from ciri_long_tpu_torch.ops import poa as port_poa
from ciri_long_tpu_torch.pipeline import collapse as port_collapse

CELL = 'collapse.cohort'
SMALL = ({'genome_kb': 200, 'loci': 6}, {'reads': 150})


def _job(rng, n, length):
    base = ''.join(rng.choice(list('ACGT'), length))
    job = []
    for _ in range(n):
        s = list(base)
        for _ in range(length // 10):
            s[int(rng.integers(0, len(s)))] = 'ACGT'[int(rng.integers(0, 4))]
        for _ in range(length // 30):
            del s[int(rng.integers(0, len(s)))]
            s.insert(int(rng.integers(0, len(s))),
                     'ACGT'[int(rng.integers(0, 4))])
        job.append(''.join(s))
    return job


def test_poa_reference_is_the_ports_poa():
    job = _job(np.random.default_rng(4), 16, 120)
    assert poa.reference(job) == port_poa.poa(job)[0]
    assert poa.reference(job[:3]) == port_poa.poa(job[:3])[0]
    assert poa.reference(job, poa.CONTROL_READS) != poa.reference(job)


def test_the_poa_sample_takes_each_column_class_and_its_largest_job():
    rng = np.random.default_rng(5)
    jobs = [['A' * n] * k for n, k in [(100, 3), (300, 9), (700, 2),
                                       (600, 5), (1500, 2), (3000, 1),
                                       (200, 4)]]
    assert [poa.column_class(j) for j in jobs] == [0, 0, 1, 1, 2, 3, 0]
    picked = poa.pick(jobs, rng)
    assert 1 in picked and 3 in picked and 4 in picked and 5 in picked
    assert len(picked) == 6       # a largest and one drawn in classes 0, 1
    assert sorted(picked) == picked


TRUTH = [('chr1', 1001, 1500, [(1001, 1200), (1301, 1500)]),
         ('chr1', 5001, 5300, [(5001, 5300)])]


def _write(tmp_path, expr, iso):
    (tmp_path / 'p.expression').write_text(expr)
    (tmp_path / 'p.isoforms').write_text(iso)
    return str(tmp_path)


def test_output_gaps_against_the_truth(tmp_path):
    drawn = {'s1': [10, 4], 's2': [6, 0]}
    exact = _write(tmp_path, 'circ_ID\ts1\ts2\n'
                   'chr1:1002-1500\t10.0\t6.0\nchr1:5001-5303\t4.0\t0.0\n',
                   'isoform_ID\ts1\ts2\n'
                   'chr1:1002-1500|1002-1200,1300-1500\t1.0\t1.0\n'
                   'chr1:5001-5303|5001-5303\t1.0\t0\n')
    assert outputs.gaps(exact, 'p', TRUTH, drawn) == {
        'expression_gap': 0.0, 'isoform_gap': 0.0}
    # s2 left out, a junction 9 bp off, half an isoform's usage wrong
    bad = _write(tmp_path, 'circ_ID\ts1\n'
                 'chr1:1002-1500\t10.0\nchr1:5010-5300\t4.0\n',
                 'isoform_ID\ts1\n'
                 'chr1:1002-1500|1002-1200,1300-1500\t0.5\n'
                 'chr1:1002-1500|1002-1500\t0.5\n')
    g = outputs.gaps(bad, 'p', TRUTH, drawn)
    assert g['expression_gap'] == 1.0              # s2: 6 of 6 missing
    assert g['isoform_gap'] == 1.0
    g = outputs.gaps(bad, 'p', TRUTH, {'s1': [10, 4]})
    assert g['expression_gap'] == pytest.approx((4 + 4) / 14)
    assert g['isoform_gap'] == pytest.approx(1 - 5 / 14)


def _run(work, seed=2 ** 31 + 99, controls=False):
    cfg, mix = SMALL
    return run.run_cell(CELL, seed, 0.1, False, device='cpu', cfg_over=cfg,
                        mix_over=mix, controls=controls, work=work)


def test_a_sound_run_is_correct_and_each_control_is_not(tmp_path):
    out = _run(tmp_path, controls=True)
    assert out['correct'], out['checks']
    assert all(v['value'] <= v['limit'] for v in out['checks'].values())
    ctl = out['control_checks']
    assert ctl['poa_jobs_differ']['value'] > 0
    assert ctl['expression_gap']['value'] > ctl['expression_gap']['limit']
    assert ctl['isoform_gap']['value'] > ctl['isoform_gap']['limit']


def _broken_poa(fault):
    orig = port_poa.poa_consensus_many

    def broken(jobs, *args, **kwargs):
        out = list(orig(jobs, *args, **kwargs))
        if fault == 'altered':
            out = [('T' if c[:1] != 'T' else 'A') + c[1:] for c in out]
        elif fault == 'half':
            out[len(out) // 2:] = [job[0] for job in jobs[len(out) // 2:]]
        else:
            out = [job[0] for job in jobs]
        return out
    return broken


def _sample_left_out():
    """Half of the batch left out: collapse loads the first sample only."""
    orig = port_collapse.load_cand_circ

    def broken(in_file):
        reads = orig(in_file)
        first = min(r.sample for r in reads.values())
        return {k: r for k, r in reads.items() if r.sample == first}
    return broken


def _junction_moved():
    """An answer altered where produced: every circRNA's start 20 bp off
    when the matrices are written."""
    orig = port_collapse.cal_exp_mtx

    def broken(ctx, cand_reads, corrected, *args, **kwargs):
        moved = []
        for row in corrected:
            ctg, st, en = port_collapse.circ_pos(row[3])
            moved.append(row[:3] + ('{}:{}-{}'.format(ctg, st + 20, en),)
                         + row[4:])
        return orig(ctx, cand_reads, moved, *args, **kwargs)
    return broken


@pytest.mark.parametrize('fault, fails', [
    ('poa_altered', ['poa_jobs_differ']),
    ('poa_half', ['poa_jobs_differ']),
    ('poa_unchanged', ['poa_jobs_differ']),
    ('sample_left_out', ['expression_gap', 'isoform_gap']),
    ('junction_moved', ['expression_gap', 'isoform_gap']),
])
def test_a_broken_timed_path_is_not_correct(fault, fails, monkeypatch,
                                            tmp_path):
    if fault.startswith('poa_'):
        broken = _broken_poa(fault[4:])
        monkeypatch.setattr(port_poa, 'poa_consensus_many', broken)
        monkeypatch.setattr(port_collapse, 'poa_consensus_many', broken)
    elif fault == 'sample_left_out':
        monkeypatch.setattr(port_collapse, 'load_cand_circ',
                            _sample_left_out())
    else:
        monkeypatch.setattr(port_collapse, 'cal_exp_mtx', _junction_moved())
    out = _run(tmp_path)
    assert not out['correct']
    assert all(out['checks'][k]['value'] > out['checks'][k]['limit']
               for k in fails), out['checks']


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.cuda
def test_the_controls_fail_at_the_cells_own_size(card):
    out = run.run_cell(CELL, 2 ** 31 + 77, 10, False, controls=True)
    assert out['correct'], out['checks']
    ctl = out['control_checks']
    assert ctl['poa_jobs_differ']['value'] > 0
    assert ctl['expression_gap']['value'] > ctl['expression_gap']['limit']
