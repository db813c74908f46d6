"""The port's CCS tandem pre-screen (ops/period.py, X3) against the JAX
package on the CPU.

- ``tandem_counts_plain`` and ``screen_keep_plain`` exact to JAX's
  ``tandem_counts`` and ``screen_keep`` at every screen bucket, on tandem,
  random and N-poisoned reads, a read of 2 * MIN_PERIOD - 1 bases, and reads
  whose period lies between L / 2 and the bucket's b / 2 (where a lag range
  of L // 2 would give another answer);
- soundness on tests/test_ccs_screen.py's fuzz generator: a read the screen
  drops gets no consensus from find_consensus;
- ``find_ccs_reads`` on the card route (the CUDA call replaced by the plain
  version) screens every read the JAX package would (not those under
  2 * MIN_PERIOD or over SCREEN_MAX_LEN) and writes the same tmp/*.ccs.fa,
  tmp/*.raw.fa and counters as the CPU route and as the JAX package.
"""

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import period as jperiod
from ciri_long_tpu.pipeline.find_ccs import find_ccs_reads as jax_find_ccs
from ciri_long_tpu_torch.ops import period as tperiod
from ciri_long_tpu_torch.ops.ccs import MIN_PERIOD, find_consensus
from ciri_long_tpu_torch.pipeline import find_ccs as tfc
from ciri_long_tpu_torch.tools import chain_cases as cases
from ciri_long_tpu_torch.utils.seq import encode_seq
from tests.test_pipeline_call import make_rolling_read, rand_seq

torch.set_num_threads(1)


@pytest.mark.parametrize('b', tperiod.SCREEN_BUCKETS)
def test_screen_keep_plain_exact_to_jax(rng, b):
    reads = cases.bucket_reads(rng, b)
    mat, lens = cases.pad(reads, b)
    M = b // 2
    want_counts = np.asarray(jperiod.tandem_counts(mat, M, 11))
    got_counts = tperiod.tandem_counts_plain(torch.from_numpy(mat), M, 11)
    assert np.array_equal(got_counts.numpy(), want_counts)
    want = np.asarray(jperiod.screen_keep(mat, lens, M, 11, MIN_PERIOD, 2.0))
    got = tperiod.screen_keep(mat, lens, M, 11, MIN_PERIOD, 2.0,
                              device='cpu')
    assert np.array_equal(got, want)
    assert want.any() and not want.all()
    # the read whose period lies between L / 2 and b / 2: kept at the
    # bucket's lag range, dropped at L // 2
    t = 12
    assert want[t]
    assert not tperiod.screen_keep(mat[t:t + 1], lens[t:t + 1],
                                   int(lens[t]) // 2, device='cpu')[0]


def test_screen_keep_plain_mixed_buckets(rng):
    """One batch of reads from every bucket, each at its own lag range,
    padded to the widest (as find_ccs.device_screen sends them): equal to
    JAX's screen_keep bucket by bucket."""
    reads, want = [], []
    for b in tperiod.SCREEN_BUCKETS:
        part = cases.bucket_reads(rng, b)
        mat, lens = cases.pad(part, b)
        want.append(np.asarray(jperiod.screen_keep(mat, lens, b // 2)))
        reads += part
    mat, lens = cases.pad(reads, tperiod.SCREEN_MAX_LEN)
    lags = np.array([tperiod.screen_bucket(int(n)) // 2 for n in lens])
    got = tperiod.screen_keep(mat, lens, lags, device='cpu')
    assert np.array_equal(got, np.concatenate(want))


@pytest.mark.parametrize('noise', [0.02, 0.08])
def test_screen_soundness_fuzz(rng, noise):
    """A read that screen_keep drops gets no consensus (the generator of
    tests/test_ccs_screen.py); the screen drops most random reads."""
    reads = []
    for i in range(30):
        unit = rand_seq(rng, int(rng.integers(60, 450)))
        reads.append(make_rolling_read(rng, unit,
                                       copies=2.2 + 3 * rng.random(),
                                       noise=noise))
    for i in range(30):
        reads.append(rand_seq(rng, int(rng.integers(150, 2000))))
    items = [('r%d' % i, s) for i, s in enumerate(reads)
             if 2 * MIN_PERIOD <= len(s) <= tperiod.SCREEN_MAX_LEN]
    mat, lens = cases.pad([encode_seq(s) for _, s in items],
                     tperiod.SCREEN_MAX_LEN)
    lags = np.array([tperiod.screen_bucket(int(n)) // 2 for n in lens])
    keep = tperiod.screen_keep(mat, lens, lags, device='cpu')
    dropped = 0
    for (rid, seq), k in zip(items, keep):
        if not k:
            assert find_consensus(seq) == (None, None), rid
            dropped += 1
    assert dropped >= 20


def _reads_file(rng, path):
    with open(path, 'w') as f:
        for i in range(12):
            unit = rand_seq(rng, int(rng.integers(80, 400)))
            f.write('>c{}\n{}\n'.format(i, make_rolling_read(
                rng, unit, copies=2.5 + 0.3 * i, noise=0.03)))
        for i in range(8):
            f.write('>l{}\n{}\n'.format(i, rand_seq(rng, 900)))
        f.write('>short\n{}\n'.format(rand_seq(rng, 2 * MIN_PERIOD - 1)))
        unit = rand_seq(rng, 1000)
        f.write('>long\n{}\n'.format(make_rolling_read(
            rng, unit, copies=tperiod.SCREEN_MAX_LEN / 1000 + 0.001,
            noise=0.0)[:tperiod.SCREEN_MAX_LEN + 1]))


def test_find_ccs_reads_card_route_matches_cpu_and_jax(rng, tmp_path,
                                                      monkeypatch):
    reads_fa = tmp_path / 'reads.fa'
    _reads_file(rng, reads_fa)
    outs = {}
    jres = jax_find_ccs(str(reads_fa), str(tmp_path / 'jax'), 'p',
                        use_device_screen=False)
    outs['cpu'] = tfc.find_ccs_reads(str(reads_fa), str(tmp_path / 'cpu'),
                                     'p', device='cpu')

    screened = []
    real = tperiod.screen_keep

    def fake(mat, lens, lags, *args):
        device = args[-1]
        assert device.type == 'cuda'
        keep = real(mat, lens, lags, *args[:-1], device='cpu')
        screened.extend(zip((int(n) for n in lens), keep))
        return keep

    monkeypatch.setattr(tfc, 'resolve_device',
                        lambda d: torch.device('cuda', 0))
    monkeypatch.setattr(tfc, 'screen_keep', fake)
    outs['cuda'] = tfc.find_ccs_reads(str(reads_fa), str(tmp_path / 'cuda'),
                                      'p', device='cuda')
    assert outs['cuda'] == outs['cpu'] == jres
    for name in ('tmp/p.ccs.fa', 'tmp/p.raw.fa'):
        want = (tmp_path / 'jax' / name).read_bytes()
        assert (tmp_path / 'cpu' / name).read_bytes() == want
        assert (tmp_path / 'cuda' / name).read_bytes() == want
    # every read of the screen's range was screened, and only those
    assert sorted(n for n, _ in screened) == sorted(
        n for n in (len(s) for s in _seqs(reads_fa))
        if 2 * MIN_PERIOD <= n <= tperiod.SCREEN_MAX_LEN)
    assert len(screened) == 20
    assert sum(not k for _, k in screened) >= 6     # the linear reads
    assert jres[1] >= 10


def _seqs(path):
    with open(path) as f:
        return [ln.strip() for ln in f if not ln.startswith('>')]


def test_screen_keep_refuses_lags_out_of_range():
    mat = np.full((1, 512), 5, np.int8)
    with pytest.raises(ValueError, match='max_lag'):
        tperiod.screen_keep(mat, [100], tperiod.MAX_LAG + 1, device='cpu')
    with pytest.raises(ValueError, match='over the screen ladder'):
        tperiod.screen_bucket(tperiod.SCREEN_MAX_LEN + 1)


def test_smoke_screen_work_counts(rng):
    """chip_smoke.py's operations bound for the screen counts the equal
    k-mer pairs within each read's lag range: the tandem counts summed over
    lags 1..M, read by read; the kernel's (window, lag) pairs are at least
    as many."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke_', path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    reads = cases.bucket_reads(rng, 512)
    mat, lens = cases.pad(reads, 512)
    lags = rng.integers(1, 257, len(reads))
    want = sum(int(tperiod.tandem_counts_plain(
        torch.from_numpy(mat[b:b + 1]), int(m)).sum())
        for b, m in enumerate(lags))
    assert smoke._screen_equal_pairs(mat, lags) == want > 0
    assert smoke._screen_pairs(mat, lags) > want
