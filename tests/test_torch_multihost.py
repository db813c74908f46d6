"""Two ranks of the port's multi-process worker
(parallel/multihost_worker.py) over torch.distributed (gloo) on the CPU:
the psum of the sharded SW's positive count and the records' gather hold
on both, both ranks write the same cand_circ.fa, and its bytes are the
JAX package's serial ``scan_ccs_reads`` on its own ``build_demo_world``
(same seed), run in this process; the two demo worlds' reads are equal.
"""

import hashlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from ciri_long_tpu.parallel.multihost_worker import \
    build_demo_world as jax_demo_world
from ciri_long_tpu.pipeline.find_bsj import scan_ccs_reads as jax_scan
from ciri_long_tpu_torch.parallel.multihost_worker import build_demo_world

REPO = Path(__file__).resolve().parent.parent


def free_port():
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def fields(out, marker):
    line = [ln for ln in out.splitlines() if ln.startswith(marker)][0]
    return dict(kv.split('=', 1) for kv in line.split()[1:])


def test_demo_worlds_equal():
    _, ccs_seq = build_demo_world()
    _, jccs_seq = jax_demo_world()
    assert ccs_seq == jccs_seq and len(ccs_seq) >= 8


def run_ranks(tmp_path, extra):
    """Rank i of the worker with ``--device cpu`` and ``extra[i]``, each as
    a subprocess with its own timeout; [(returncode, output)]."""
    coord = '127.0.0.1:{}'.format(free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'ciri_long_tpu_torch.parallel.multihost_worker',
         '--coordinator', coord, '--num-processes', str(len(extra)),
         '--process-id', str(pid), '--device', 'cpu'] + args,
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid, args in enumerate(extra)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            pytest.fail('multihost worker timed out:\n' + out[-2000:])
        outs.append((p.returncode, out))
    return outs


def test_two_ranks_over_gloo(tmp_path):
    outs = run_ranks(tmp_path, [
        ['--scan-out', str(tmp_path / 'cohort_{}.fa'.format(pid))]
        for pid in range(2)])
    md5s = []
    for rc, out in outs:
        assert rc == 0, out[-2000:]
        res = fields(out, 'MULTIHOST_RESULT')
        assert res['got'] == res['expected'] and int(res['got']) > 0
        gat = fields(out, 'MULTIHOST_GATHER')
        assert gat['ids_ok'] == 'True' and gat['n'] == '10'
        scan = fields(out, 'MULTIHOST_SCAN')
        assert int(scan['n_rec']) >= 8
        md5s.append(scan['md5'])
        launches = fields(out, 'MULTIHOST_LAUNCHES')
        assert launches.pop('pid') == res['pid']
        assert set(launches.values()) == {'0'}     # the plain versions
    assert md5s[0] == md5s[1]
    assert (tmp_path / 'cohort_0.fa').read_bytes() == \
        (tmp_path / 'cohort_1.fa').read_bytes()

    ctx, ccs_seq = jax_demo_world()
    (tmp_path / 'serial').mkdir()
    jax_scan(ctx, ccs_seq, True, str(tmp_path / 'serial'), 'p')
    ref = (tmp_path / 'serial' / 'p.cand_circ.fa').read_bytes()
    assert hashlib.md5(ref).hexdigest() == md5s[0]


def test_rank_left_alone_fails(tmp_path):
    """A rank whose peer is gone fails its collective and exits non-zero
    instead of waiting: rank 0 runs no scan and leaves the group, rank 1
    waits for it in the scan's gather."""
    (rc0, out0), (rc1, out1) = run_ranks(
        tmp_path, [[], ['--scan-out', str(tmp_path / 'alone.fa')]])
    assert rc0 == 0, out0[-2000:]
    assert rc1 != 0 and 'MULTIHOST_SCAN' not in out1
    assert not (tmp_path / 'alone.fa').exists()
