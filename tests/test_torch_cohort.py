"""The port's sharded call scan (parallel/cohort.py), ``call --dist mesh``
and the dry run (parallel/dryrun.py) on the CPU, exact:

- ``scan_ccs_sharded`` at 1, 3 and 8 shards writes the bytes of the port's
  serial ``scan_ccs_reads`` and of JAX ``scan_ccs_sharded`` (its 8 virtual
  CPU devices), with the same counters and short reads, on
  tests/test_cohort.py's world built in both packages from one seed; on a
  mesh of (faked) cards shard s scans on cuda:s;
- ``call --dist mesh --device cpu`` on tools/world.py's verification world
  writes the plain ``call``'s cand_circ.fa and counters;
- ``dryrun_multichip(8, device='cpu')`` passes, and ``entry``'s forward
  scores what the JAX package's ``__graft_entry__.entry`` does.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from ciri_long_tpu.parallel.cohort import scan_ccs_sharded as jax_sharded
from ciri_long_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ciri_long_tpu_torch.cli.main import main as cli_main
from ciri_long_tpu_torch.parallel.cohort import (_shard_bounds,
                                                 scan_ccs_sharded)
from ciri_long_tpu_torch.parallel.dryrun import dryrun_multichip, entry
from ciri_long_tpu_torch.parallel.mesh import make_mesh
from ciri_long_tpu_torch.pipeline.find_bsj import scan_ccs_reads
from ciri_long_tpu_torch.tools.world import skill_world
from tests.test_torch_records import cohort_worlds

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope='module')
def worlds(module_rng):
    return cohort_worlds(module_rng)


@pytest.fixture(scope='module')
def serial(worlds, tmp_path_factory):
    """The port's serial scan of the world: (counters, short ids, bytes)."""
    ctx, ccs_seq = worlds[0]
    out = tmp_path_factory.mktemp('serial')
    (out / 'tmp').mkdir()
    cnt, short = scan_ccs_reads(ctx, ccs_seq, True, str(out), 'p',
                                device='cpu')
    return dict(cnt), [s[0] for s in short], (out / 'p.cand_circ.fa'
                                              ).read_bytes()


@pytest.mark.parametrize('n', [1, 3, 8])
def test_sharded_scan_byte_identical(worlds, serial, tmp_path, n):
    (ctx, ccs_seq), (jctx, jccs_seq) = worlds
    for name in ('port', 'jax'):
        (tmp_path / name).mkdir()
    cnt, short = scan_ccs_sharded(make_mesh(n, lag_parallel=1, device='cpu'),
                                  ctx, ccs_seq, True, str(tmp_path / 'port'),
                                  'p')
    jcnt, jshort = jax_sharded(jax_make_mesh(n, lag_parallel=1), jctx,
                               jccs_seq, True, str(tmp_path / 'jax'), 'p')
    got = (tmp_path / 'port' / 'p.cand_circ.fa').read_bytes()
    assert got == serial[2] and len(got) > 0
    assert got == (tmp_path / 'jax' / 'p.cand_circ.fa').read_bytes()
    assert dict(cnt) == serial[0] == dict(jcnt)
    assert [s[0] for s in short] == serial[1] == [s[0] for s in jshort]


def test_shards_run_on_their_cards(worlds, serial, tmp_path, monkeypatch):
    """On cuda a shard a card: shard s's chunks go to cuda:s (the scan run
    by the plain route here, its device recorded), and the merge writes
    the serial bytes."""
    import torch

    from ciri_long_tpu_torch.parallel import cohort

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    seen = []
    real = cohort.scan_ccs_chunk

    def on_card(ctx, chunk, is_canonical, cfg, device):
        seen.append((device, chunk[0][0]))
        return real(ctx, chunk, is_canonical, cfg, 'cpu')

    monkeypatch.setattr(cohort, 'scan_ccs_chunk', on_card)
    ctx, ccs_seq = worlds[0]
    mesh = make_mesh(lag_parallel=1)
    scan_ccs_sharded(mesh, ctx, ccs_seq, True, str(tmp_path), 'p')
    firsts = [lo for lo, _ in _shard_bounds(len(ccs_seq), 4)]
    assert seen == [(torch.device('cuda', s), 'read_{:03d}'.format(lo))
                    for s, lo in enumerate(firsts)]
    assert (tmp_path / 'p.cand_circ.fa').read_bytes() == serial[2]


def test_shard_bounds():
    assert _shard_bounds(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert _shard_bounds(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]


def _call_outputs(out):
    counters = {k: v for k, v in json.loads(
        (out / 'vtest.json').read_text()).items()
        if k not in ('timing', 'kernels', 'spans', 'counters', 'threads')}
    return counters, (out / 'vtest.cand_circ.fa').read_bytes()


def test_call_dist_mesh(tmp_path):
    ref, reads = skill_world(str(tmp_path / 'w'))
    runs = {}
    for name, extra in (('plain', []), ('mesh', ['--dist', 'mesh'])):
        cli_main(['call', '-i', reads, '-o', str(tmp_path / name), '-r', ref,
                  '-p', 'vtest', '-t', '1', '--device', 'cpu'] + extra)
        runs[name] = _call_outputs(tmp_path / name)
    assert runs['mesh'] == runs['plain']
    assert runs['mesh'][0]['bsj'] == 10


def test_mesh_prespawns_no_scan_pool(tmp_path):
    """With --dist mesh the scan stage is the mesh's: call spawns no scan
    pool before the CCS stage, whatever -t says (JAX main.py:204-205)."""
    from types import SimpleNamespace

    from ciri_long_tpu_torch.cli.main import _prespawn_scan_pool

    args = SimpleNamespace(threads=4, debug=False, dist='mesh')
    assert _prespawn_scan_pool(args, str(tmp_path), 'p', 'unused.fa', None,
                               None) is None


def test_dryrun_multichip():
    dryrun_multichip(8, device='cpu')


def test_entry_matches_graft_entry():
    spec = importlib.util.spec_from_file_location(
        '__graft_entry__', str(REPO / '__graft_entry__.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jfn, jargs = mod.entry()
    fn, args = entry(device='cpu')
    for a, b in zip(args, jargs):
        assert np.array_equal(a, b)
    for a, b in zip(fn(*args), jfn(*jargs)):
        assert np.array_equal(a.numpy(), np.asarray(b))
