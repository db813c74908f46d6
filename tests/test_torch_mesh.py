"""The port's mesh layer (parallel/mesh.py) and the lag-range tandem counts
(ops/period.py::tandem_counts, csrc/tandem_counts.cu) against the JAX
package on the CPU, exact.  The JAX side runs on its 8 virtual CPU devices
(tests/conftest.py), the port's shards all sit on the CPU with the plain
versions:

- ``tandem_counts`` / ``tandem_counts_plain`` with a lag offset equal JAX
  ``tandem_counts`` at offsets 0, 32 and 96, on tandem, random and
  N-poisoned reads, a read under k, an all-PAD row and lags past the width;
  csrc/tandem_counts.cu's schedule (blocks of LAG_BLOCK lags, warps of
  GROUP lags, lanes striding the windows, the -1 ids past W) emulated in
  numpy gives the same counts, chunk and group edges included;
- ``make_mesh``'s shapes equal JAX's at 1, 2, 6 and 8 devices; cuda asks
  for no more shards than cards;
- ``sharded_sw`` at 1, 2 and 8 shards equals JAX ``sharded_sw`` on 8
  devices: score, q_end, r_end and the positive count, on a batch that
  does not divide the reads axis;
- ``make_pipeline_step`` at (reads, lag) = (4, 2) and (8, 1) equals JAX's
  step: the counts, the scores and the positive count;
- ``gather_candidates`` equals JAX's on padded and unpadded batches.
"""

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import period as jperiod
from ciri_long_tpu.ops.sw import SWParams as JaxSWParams
from ciri_long_tpu.parallel import mesh as jmesh
from ciri_long_tpu_torch.ops import period as tperiod
from ciri_long_tpu_torch.ops.sw import SWParams
from ciri_long_tpu_torch.parallel import mesh as tmesh
from ciri_long_tpu_torch.tools import chain_cases as cases
from tests.test_torch_period import emulate_pairs

torch.set_num_threads(1)



def tandem_reads(rng, W=120):
    """A tandem read, a random read, an N-poisoned tandem read, a read
    under k and an all-PAD row, PAD = 5 past each read, width W."""
    unit = rng.integers(0, 4, 23)
    rows = [np.tile(unit, 6)[:W - 7],
            rng.integers(0, 4, W),
            np.tile(unit, 6)[:W - 30].copy(),
            rng.integers(0, 4, 9),
            np.zeros(0, np.int64)]
    rows[2][[5, 40, 41]] = 4
    mat = np.full((len(rows), W), 5, np.int8)
    for b, r in enumerate(rows):
        mat[b, :len(r)] = r
    return mat


def emulate_tandem(reads, max_lag, k, lag_offset):
    """csrc/kmer_pairs.h's count over a lag range in numpy (the sorted keys
    of tandem_counts.cu's earlier design; the screen's count from lag 1):
    a block a read, lags lo = lag_offset + 1 .. lag_offset + max_lag
    (``emulate_pairs``: the sorted keys, the route by WALK_CAP, the pair
    walk from the searched start, the lag route up to nwin), the row zero
    past the read's last valid window.  Returns (out int64 [B, max_lag],
    routes bool [B], True for the lag route)."""
    out = np.zeros((len(reads), max_lag), np.int64)
    routes = np.zeros(len(reads), bool)
    for b, row in enumerate(reads):
        out[b], routes[b] = emulate_pairs(row, lag_offset + 1,
                                          lag_offset + max_lag, k)
    return out, routes


def _held_to_jax(mat, max_lag, offset):
    """The emulated count, tandem_counts and tandem_counts_plain equal to
    JAX's tandem_counts, the routes to ``_lag_route``'s; returns (JAX's
    counts, the routes)."""
    want = np.asarray(jperiod.tandem_counts(mat, max_lag, 11,
                                            lag_offset=offset,
                                            pad_lags=offset + max_lag))
    got, routes = emulate_tandem(mat, max_lag, 11, offset)
    assert np.array_equal(got, want)
    assert np.array_equal(tperiod.tandem_counts(mat, max_lag, 11, offset,
                                                device='cpu'), want)
    assert np.array_equal(routes, [tperiod._lag_route(row, offset + 1,
                                                      offset + max_lag, 11)
                                   for row in mat])
    return want, routes


@pytest.mark.parametrize('offset', [0, 32, 96])
def test_tandem_counts_at_lag_offsets(rng, offset):
    mat = tandem_reads(rng)
    for max_lag in (32, 40):
        pad = offset + max_lag
        want = np.asarray(jperiod.tandem_counts(mat, max_lag, 11,
                                                lag_offset=offset,
                                                pad_lags=pad))
        got = tperiod.tandem_counts(mat, max_lag, 11, offset, pad,
                                    device='cpu')
        assert got.dtype == np.int32 and np.array_equal(got, want)
        plain = tperiod.tandem_counts_plain(torch.from_numpy(mat), max_lag,
                                            11, offset).numpy()
        assert np.array_equal(plain, want)
        emulated, routes = emulate_tandem(mat, max_lag, 11, offset)
        assert np.array_equal(emulated, want)
        assert not routes.any()
    assert want[0].any() or offset == 96      # the period shows below L
    assert not want[3:].any()                 # under k; all PAD


@pytest.mark.parametrize('shape', [(3, 300, 0), (2, 600, 257), (2, 90, 5)])
def test_tandem_kernel_schedule_edges(rng, shape):
    """Ranges of 300, 600 and 90 lags (no multiple of LAGS), an offset
    past THREADS, and lags past the width, against JAX."""
    B, max_lag, offset = shape
    W = 700
    unit = rng.integers(0, 4, 37)
    mat = np.full((B, W), 5, np.int8)
    mat[0, :W - 5] = np.tile(unit, 20)[:W - 5]
    mat[1:, :W // 2] = rng.integers(0, 5, (B - 1, W // 2))
    _held_to_jax(mat, max_lag, offset)


@pytest.mark.parametrize('offset', [0, 1024])
@pytest.mark.parametrize('case', ['poly_a', 'dinucleotide', 'trinucleotide',
                                  'period_50'])
def test_tandem_low_complexity_takes_the_lag_route(case, offset):
    """tools/chain_cases.py's low-complexity reads (beside a random and a
    noisy tandem read, width 4 096) at 1 024 lags from offset 0 and from
    mid-range: the low-complexity read takes the lag route (but for the
    period of 50 from mid-range, whose ~20 keys a window in the range keep
    every thread under WALK_CAP), the other two the pair route, all exact
    to JAX."""
    mat, _lens, _lags = cases.screen_launches(np.random.default_rng(13))[case]
    want, routes = _held_to_jax(mat, 1024, offset)
    lag = case != 'period_50' or offset == 0
    assert routes.tolist() == [lag, False, False]
    assert want[0].any() and want[2].any()


@pytest.mark.parametrize('case', ['poly_a', 'period_50'])
def test_tandem_lag_route_in_two_passes(case):
    """3 000 lags from offset 100: the lag route's threads take a second
    pass of THREADS * LAGS lags, exact to JAX up to the read's last
    window."""
    mat, _lens, _lags = cases.screen_launches(np.random.default_rng(13))[case]
    want, routes = _held_to_jax(mat, 3000, 100)
    assert routes.tolist() == [True, False, False]
    assert want[0, 2048:].any()


def _colliding_kmers(k=11):
    """Two distinct k-mer ids with one Fibonacci hash (the kernels'
    hash(kid) << POS_BITS | i keys), found by a seeded search."""
    rng = np.random.default_rng(5)
    seen = {}
    while True:
        kid = int(rng.integers(0, 4 ** k))
        h = ((kid * 2654435761) & 0xffffffff) >> tperiod.POS_BITS
        if h in seen and seen[h] != kid:
            return seen[h], kid
        seen[h] = kid


def test_tandem_hash_collision_counts_nothing(rng):
    """Two distinct k-mers with equal hashes, d = 40 apart in a random read:
    their keys are walked together (the hashes alone would count one pair
    at d), and the code check counts none, as JAX."""
    k, d = 11, 40
    a, b = (np.array([(x >> (2 * (k - 1 - j))) & 3 for j in range(k)],
                     np.int8) for x in _colliding_kmers(k))
    mat = np.full((2, 200), 5, np.int8)
    mat[:, :190] = rng.integers(0, 4, (2, 190))
    mat[0, 60:60 + k], mat[0, 60 + d:60 + d + k] = a, b
    keys = tperiod.screen_keys(mat[0], k)
    hashes, pos = keys >> np.uint64(tperiod.POS_BITS), keys & np.uint64(
        (1 << tperiod.POS_BITS) - 1)
    at = {int(p): int(h) for h, p in zip(hashes, pos)}
    assert at[60] == at[60 + d]
    for offset, max_lag in ((0, 64), (d - 1, 1), (20, 30)):
        want, routes = _held_to_jax(mat, max_lag, offset)
        assert want[0, d - offset - 1] == 0 and not routes.any()


@pytest.mark.parametrize('offset', [200, 260])
def test_tandem_range_past_the_last_window(rng, offset):
    """Reads of 300 and 200 bases in width 700, lags offset + 1 .. offset +
    64: the range starts past the 200-base read's last valid window (a row
    of zeros, no route) and straddles the 300-base reads' (counts up to
    it, zeros past)."""
    mat = np.full((3, 700), 5, np.int8)
    unit = rng.integers(0, 4, 23)
    mat[0, :300] = np.tile(unit, 14)[:300]
    mat[1, :200] = np.tile(unit, 9)[:200]
    mat[2, :300] = 0                           # a poly-A
    want, routes = _held_to_jax(mat, 64, offset)
    end = 300 - 11 - offset                    # lags past nwin - 1 = 289
    assert not want[1].any() and not routes[1]
    assert want[0, :end].any() and want[2, :end].all()
    assert not want[:, end:].any()


def test_tandem_counts_refuses():
    reads = torch.zeros((2, 30), dtype=torch.int8)
    with pytest.raises(ValueError, match='CUDA tensor'):
        tperiod.tandem_counts_cuda(reads, 8)
    with pytest.raises(ValueError, match='pad_lags'):
        tperiod.tandem_counts(reads.numpy(), 8, lag_offset=4, pad_lags=10,
                              device='cpu')


def test_tandem_counts_refuses_wider_than_the_kernel(rng):
    """Despite its name, no longer a refusal: csrc/tandem_counts.cu takes
    reads of any width on its bit planes (its route code 0 for reads of
    codes 0..5).  The port's tandem_counts (plain on the CPU) equals JAX's
    at 4 097 and 6 000 codes, tandem reads and random ones, PAD tails and
    N."""
    for W in (4_097, 6_000):
        mat = np.full((3, W), 5, np.int8)
        mat[0, :W - 5] = np.resize(rng.integers(0, 4, 41), W - 5)
        mat[1] = rng.integers(0, 4, W)
        mat[1, 7::53] = 4
        mat[2, :300] = 0
        want = np.asarray(jperiod.tandem_counts(mat, 64, 11, lag_offset=3,
                                                pad_lags=67))
        assert want[0].any() and want[2].any()
        assert np.array_equal(tperiod.tandem_counts(mat, 64, 11, 3,
                                                    device='cpu'), want)
        assert not tperiod.odd_reads(torch.from_numpy(mat)).any()
    with pytest.raises(ValueError, match='CUDA tensor'):
        tperiod.tandem_counts_cuda(torch.from_numpy(mat), 8)


def test_smoke_tandem_work_counts(rng):
    """chip_smoke.py's operations bound for tandem_counts counts the equal
    k-mer pairs in the lag range: tandem_counts_plain summed, at offsets
    inside, across and past the reads."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke_', path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    reads = cases.bucket_reads(rng, 1024)
    mat, _lens = cases.pad(reads, 1024)
    for offset, max_lag in ((0, 512), (100, 300), (700, 400), (1100, 8)):
        want = int(tperiod.tandem_counts_plain(
            torch.from_numpy(mat), max_lag, 11, offset).sum())
        assert smoke._tandem_equal_pairs(mat, offset, max_lag) == want
        assert want > 0 or offset >= 1024
        assert smoke._tandem_pairs(mat, offset, max_lag) >= want


@pytest.mark.parametrize('n', [1, 2, 6, 8])
def test_make_mesh_shapes(n):
    mesh = tmesh.make_mesh(n, device='cpu')
    assert mesh.shape == dict(jmesh.make_mesh(n).shape)
    assert mesh.devices == [torch.device('cpu')] * n and mesh.group is None
    flat = tmesh.make_mesh(n, lag_parallel=1, device='cpu')
    assert flat.shape == {'reads': n, 'lag': 1}


def test_make_mesh_on_cards(monkeypatch):
    """One shard a visible card, cuda:0 .. n-1; more shards than cards
    raise, nothing wraps around."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    mesh = tmesh.make_mesh()
    assert mesh.shape == {'reads': 2, 'lag': 2}
    assert mesh.devices == [torch.device('cuda', i) for i in range(4)]
    assert tmesh.make_mesh(lag_parallel=1).shape == {'reads': 4, 'lag': 1}
    with pytest.raises(ValueError, match='5 shards'):
        tmesh.make_mesh(5)


@pytest.mark.parametrize('n', [1, 2, 8])
def test_sharded_sw(rng, n):
    q = rng.integers(0, 5, (13, 64)).astype(np.int8)   # not divisible
    r = rng.integers(0, 5, (13, 96)).astype(np.int8)
    q[3, 40:] = 5
    r[7, :] = 5
    want = jmesh.sharded_sw(jmesh.make_mesh(), q, r, JaxSWParams(1, 1, 1, 1))
    got = tmesh.sharded_sw(tmesh.make_mesh(n, device='cpu'), q, r,
                           SWParams(1, 1, 1, 1))
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    assert got[3] == want[3] > 0


@pytest.mark.parametrize('lag_parallel', [2, 1])
def test_pipeline_step(rng, lag_parallel):
    jm = jmesh.make_mesh(8, lag_parallel=lag_parallel)
    tm = tmesh.make_mesh(8, lag_parallel=lag_parallel, device='cpu')
    assert tm.shape == dict(jm.shape) == {'reads': 8 // lag_parallel,
                                          'lag': lag_parallel}
    B = 24
    reads = np.concatenate([tandem_reads(rng), rng.integers(
        0, 4, (B - 5, 120)).astype(np.int8)])
    q = rng.integers(0, 4, (B, 48)).astype(np.int8)
    r = rng.integers(0, 4, (B, 64)).astype(np.int8)
    max_lag = lag_parallel * 32
    want = jmesh.sharded_pipeline_step(jm, reads, q, r, max_lag=max_lag)
    got = tmesh.sharded_pipeline_step(tm, reads, q, r, max_lag=max_lag)
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[1], np.asarray(want[1]))
    assert got[2] == int(np.asarray(want[2]).reshape(-1)[0]) > 0
    assert got[0][0].any()


@pytest.mark.parametrize('B', [32, 13])
def test_gather_candidates(rng, B):
    rec = rng.integers(0, 1000, (B, tmesh.CAND_FIELDS)).astype(np.int32)
    rec[:, 0] = rng.permutation(B) // 2        # ties on the read id
    valid = rng.random(B) < 0.6
    want = jmesh.gather_candidates(jmesh.make_mesh(), rec, valid)
    got = tmesh.gather_candidates(tmesh.make_mesh(8, device='cpu'), rec,
                                  valid)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert got[1] == int(valid.sum())
