"""The port's CCS tandem pre-screen (ops/period.py, X3) against the JAX
package on the CPU.

- ``tandem_counts_plain`` and ``screen_keep_plain`` exact to JAX's
  ``tandem_counts`` and ``screen_keep`` at every screen bucket, on tandem,
  random and N-poisoned reads, a read of 2 * MIN_PERIOD - 1 bases, and reads
  whose period lies between L / 2 and the bucket's b / 2 (where a lag range
  of L // 2 would give another answer);
- soundness on tests/test_ccs_screen.py's fuzz generator: a read the screen
  drops gets no consensus from find_consensus;
- ``find_ccs_reads`` on the card route (the CUDA calls replaced by the
  plain versions) screens every read the JAX package would (not those under
  2 * MIN_PERIOD or over SCREEN_MAX_LEN) and writes the same tmp/*.ccs.fa,
  tmp/*.raw.fa and counters as the CPU route and as the JAX package;
- csrc/screen_keep.cu's sort-and-count emulated (``emulate_screen`` over
  ``emulate_pairs``, csrc/kmer_pairs.h's schedule, which
  tests/test_torch_mesh.py shares: the sorted hash keys, the route rule,
  the pair route's walk from its searched start with its k-mer check, the
  lag route's count up to nwin) equal to ``tandem_counts_plain`` and JAX's
  ``tandem_counts``, and its election to ``screen_keep_plain`` and JAX's
  ``screen_keep``, on tools/chain_cases.py's screen launches: random,
  tandem and N-poisoned reads, low-complexity reads (which take the lag
  route), reads under k, a width no multiple of 16, mixed lag ranges.
"""

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import period as jperiod
from ciri_long_tpu.pipeline.find_ccs import find_ccs_reads as jax_find_ccs
from ciri_long_tpu_torch.ops import nw_tb_batch as tnw
from ciri_long_tpu_torch.ops import period as tperiod
from ciri_long_tpu_torch.ops.ccs import MIN_PERIOD, find_consensus
from ciri_long_tpu_torch.pipeline import find_ccs as tfc
from ciri_long_tpu_torch.tools import chain_cases as cases
from ciri_long_tpu_torch.utils.seq import encode_seq
from tests.test_pipeline_call import make_rolling_read, rand_seq

torch.set_num_threads(1)

# csrc/kmer_pairs.h's schedule constants
THREADS, LAGS, PAD, WALK_CAP = 256, 8, 16, 256


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
    # the card's route also polishes on the card (ops/nw_tb_batch.py): its
    # uploads kept on the CPU, its kernel replaced by the plain version
    monkeypatch.setattr(tnw, 'resolve_device',
                        lambda d: torch.device('cuda', 0))
    monkeypatch.setattr(tnw, 'upload', lambda arrays, device: [
        torch.from_numpy(np.ascontiguousarray(x)) for x in arrays])
    monkeypatch.setattr(tnw, 'nw_traceback_cuda', tnw.nw_launch_plain)
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


def _kid(row, k, pad):
    """The k-mer id of each window of one read (codes [W]) by position, -1
    for an invalid window and for ``pad`` entries past W."""
    x = np.asarray(row).astype(np.int64)
    W = len(x)
    kid = np.full(W + pad, -1, np.int64)
    n = W - k + 1
    if n > 0:
        ok = x < 4
        ids = np.zeros(n, np.int64)
        valid = np.ones(n, bool)
        for j in range(k):
            ids = ids * 4 + np.where(ok[j:j + n], x[j:j + n], 0)
            valid &= ok[j:j + n]
        kid[:n] = np.where(valid, ids, -1)
    return kid


def _first_at_least(keys, start, target):
    """csrc/kmer_pairs.h's first_at_least: doubling steps from ``start``,
    then a binary search of the last step."""
    n = len(keys)
    lo = hi = start
    step = 1
    while hi < n and keys[hi] < target:
        lo, hi, step = hi + 1, hi + step, 2 * step
    hi = min(hi, n)
    while lo < hi:
        mid = (lo + hi) // 2
        if keys[mid] < target:
            lo = mid + 1
        else:
            hi = mid
    return lo


def emulate_pairs(row, lo, hi, k=11):
    """csrc/kmer_pairs.h's count of one read (codes [W]) over lags lo..hi:
    (cnt int64 [hi - lo + 1], lag route).  The sorted keys
    (``screen_keys``) and nwin; the range cut at nwin - 1, and a read with
    no valid window or nothing left in its range counts nothing on the pair
    route.  The route: thread t walks, for its sorted keys s = t, t +
    THREADS, ..., from the first key >= key + lo (the kernel's doubling
    search from s + 1) to key + hi, and stops past WALK_CAP keys; the pair
    route walks the same keys and counts the pairs whose k-mer ids (not
    only hashes) are equal; the lag route's thread t counts lags at .. at +
    LAGS - 1 (at = lo + LAGS t, then a pass of THREADS LAGS lags further)
    over the windows i0 + u, u < LAGS, while i0 + at < nwin, reading kid
    past W as the PAD entries of -1 (an index past them raises), each
    count written once."""
    W = len(row)
    kid = _kid(row, k, PAD)
    cnt = np.zeros(max(hi - lo + 1, 0), np.int64)
    keys = tperiod.screen_keys(row, k).tolist()
    n = len(keys)
    if n == 0:
        return cnt, False
    pos = [key & ((1 << tperiod.POS_BITS) - 1) for key in keys]
    nwin = max(pos) + 1
    assert nwin <= W - k + 1
    top = min(hi, nwin - 1)
    if lo > top:
        return cnt, False
    starts = [_first_at_least(keys, s + 1, keys[s] + lo) for s in range(n)]
    walked = np.zeros(THREADS, np.int64)
    for t in range(THREADS):
        for s in range(t, n, THREADS):
            s2 = starts[s]
            while (walked[t] <= WALK_CAP and s2 < n
                   and keys[s2] <= keys[s] + top):
                walked[t] += 1
                s2 += 1
    lag = bool((walked > WALK_CAP).any())
    if not lag:
        for s in range(n):
            s2 = starts[s]
            while s2 < n and keys[s2] <= keys[s] + top:
                if kid[pos[s2]] == kid[pos[s]]:
                    cnt[pos[s2] - pos[s] - lo] += 1
                s2 += 1
        return cnt, lag
    written = np.zeros(len(cnt), bool)
    for t in range(THREADS):
        for at in range(lo + LAGS * t, top + 1, THREADS * LAGS):
            i = np.arange(-(-(nwin - at) // LAGS) * LAGS)
            xi = kid[i]
            for s in range(LAGS):
                if at + s <= top:
                    assert not written[at + s - lo]
                    written[at + s - lo] = True
                    cnt[at + s - lo] = ((xi >= 0)
                                        & (kid[i + at + s] == xi)).sum()
    assert written[:top - lo + 1].all()
    return cnt, lag


def emulate_screen(row, M, k=11):
    """csrc/screen_keep.cu's counts for one read (codes [W], lag range M):
    (cnt int64 [M], lag route), csrc/kmer_pairs.h over lags 1..M."""
    return emulate_pairs(row, 1, M, k)


def _elect(cnt, L, M):
    """The kernel's election on counts cnt [M] (the contract at the head of
    csrc/screen_keep.cu)."""
    cs = np.concatenate([[0], np.cumsum(cnt)])
    lo_raw, hi_raw = tperiod.support_windows(M)
    lo = np.clip(lo_raw, 1, M + 1)
    hi = np.clip(hi_raw, 0, M)
    sup = cs[hi] - cs[lo - 1]
    lags = np.arange(1, M + 1)
    valid = (lags >= MIN_PERIOD) & (np.float32(lags) * np.float32(2.0)
                                    <= np.float32(L))
    return bool((valid & (sup >= 8) & (20 * sup >= L)).any())


LAG_ROUTE = ('poly_a', 'dinucleotide', 'trinucleotide', 'period_50')


@pytest.mark.parametrize('case', ['poly_a', 'dinucleotide', 'trinucleotide',
                                  'period_50', 'all_n', 'no_valid_window',
                                  'poly_a_tail', 'mixed_lags', 'short_width',
                                  'width_100', 'many_reads'])
def test_screen_kernel_schedule_exact(case):
    """The kernel's sort-and-count (emulate_screen) exact to the plain
    counts and JAX's tandem_counts, its election to screen_keep_plain and
    JAX's screen_keep; the low-complexity reads take the lag route, random
    and noisy tandem reads the pair route."""
    mat, lens, lags = cases.screen_launches(np.random.default_rng(13))[case]
    if case == 'many_reads':
        mat, lens, lags = mat[:200], lens[:200], lags[:200]
    M = int(lags.max())
    want = np.asarray(jperiod.tandem_counts(mat, M, 11))
    plain = tperiod.tandem_counts_plain(torch.from_numpy(mat), M, 11).numpy()
    keep = tperiod.screen_keep_plain(torch.from_numpy(mat),
                                     torch.from_numpy(lens),
                                     torch.from_numpy(lags)).numpy()
    routes = []
    for b in range(len(mat)):
        m = int(lags[b])
        cnt, lag = emulate_screen(mat[b], m)
        assert np.array_equal(cnt, want[b, :m]), b
        assert np.array_equal(cnt, plain[b, :m]), b
        assert _elect(cnt, int(lens[b]), m) == keep[b], b
        routes.append(lag)
    if len(mat) == 3:       # a low_complexity_reads read, random, tandem
        assert routes == [case in LAG_ROUTE, False, False]
    else:                   # perfect repeats of short periods may take it
        assert routes.count(False) > len(routes) // 2
    assert np.array_equal(routes, tperiod.screen_routes_plain(mat, lags))
    if len(set(lags.tolist())) == 1:
        jkeep = np.asarray(jperiod.screen_keep(mat, lens, M, 11, MIN_PERIOD,
                                               2.0))
        assert np.array_equal(keep, jkeep)


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
