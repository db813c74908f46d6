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

torch.set_num_threads(1)

# csrc/tandem_counts.cu's schedule constants
THREADS, GROUP, LAG_BLOCK = 256, 4, 256


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


def emulate_kernel(reads, max_lag, k, lag_offset):
    """csrc/tandem_counts.cu in numpy: a block a (read, LAG_BLOCK lags),
    kid with PAD_KID = GROUP ids of -1 past W, each warp's groups of GROUP
    lags from j0 = chunk * LAG_BLOCK + warp * GROUP in steps of WARPS *
    GROUP, the lanes' windows i < W - d0 summed (the warp reduction), a
    lag written only below the block's end.  Every output written once."""
    B, W = reads.shape
    out = np.full((B, max_lag), -1, np.int64)
    chunks = -(-max_lag // LAG_BLOCK)
    for b in range(B):
        kid = np.full(W + GROUP, -1, np.int64)
        for i in range(W - k + 1):
            win = reads[b, i:i + k].astype(np.int64)
            if (win <= 3).all() and (win >= 0).all():
                kid[i] = int(''.join(map(str, win)), 4)
        for chunk in range(chunks):
            j_end = min(max_lag, (chunk + 1) * LAG_BLOCK)
            for warp in range(THREADS // 32):
                for j0 in range(chunk * LAG_BLOCK + warp * GROUP, j_end,
                                THREADS // 32 * GROUP):
                    d0 = lag_offset + j0 + 1
                    i = np.arange(max(0, W - d0))
                    a = kid[i]
                    for g in range(GROUP):
                        if j0 + g < j_end:
                            assert out[b, j0 + g] == -1
                            out[b, j0 + g] = int(
                                ((kid[i + d0 + g] == a) & (a >= 0)).sum())
    assert (out >= 0).all()
    return out


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
        assert np.array_equal(emulate_kernel(mat, max_lag, 11, offset), want)
    assert want[0].any() or offset == 96      # the period shows below L
    assert not want[3:].any()                 # under k; all PAD


@pytest.mark.parametrize('shape', [(3, 300, 0), (2, 600, 257), (2, 90, 5)])
def test_tandem_kernel_schedule_edges(rng, shape):
    """Lag ranges across a block's LAG_BLOCK and no multiple of GROUP, an
    offset past one block, and lags past the width, against JAX."""
    B, max_lag, offset = shape
    W = 700
    unit = rng.integers(0, 4, 37)
    mat = np.full((B, W), 5, np.int8)
    mat[0, :W - 5] = np.tile(unit, 20)[:W - 5]
    mat[1:, :W // 2] = rng.integers(0, 5, (B - 1, W // 2))
    want = np.asarray(jperiod.tandem_counts(mat, max_lag, 11,
                                            lag_offset=offset,
                                            pad_lags=offset + max_lag))
    assert np.array_equal(emulate_kernel(mat, max_lag, 11, offset), want)
    assert np.array_equal(tperiod.tandem_counts(mat, max_lag, 11, offset,
                                                device='cpu'), want)


def test_tandem_counts_refuses():
    reads = torch.zeros((2, 30), dtype=torch.int8)
    with pytest.raises(ValueError, match='CUDA tensor'):
        tperiod.tandem_counts_cuda(reads, 8)
    with pytest.raises(ValueError, match='pad_lags'):
        tperiod.tandem_counts(reads.numpy(), 8, lag_offset=4, pad_lags=10,
                              device='cpu')


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
