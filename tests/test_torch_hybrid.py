"""The port's work-steal drain (ciri_long_tpu_torch/parallel/hybrid.py)
against the JAX package's (ciri_long_tpu/parallel/hybrid.py).

The pool is a ``multiprocessing.pool.ThreadPool``, as
tests/test_hybrid_scan.py's FakePool stands in for the spawn pool: the
scheduler is the same code whatever runs the pool's chunks.

- every chunk is delivered exactly once and in order, with the same results
  as the JAX drain on the same payloads;
- the card's side takes at least one chunk of every drain of 2 or more
  chunks (2, 4 and 16 chunks, 2 and 4 workers), where the JAX drain's
  prefetch and tail rule leave it none on a few chunks;
- a pool worker's error propagates;
- a card chunk's error propagates from ``result`` and ``join``, even when
  the pool's raced copy of that chunk was delivered first: the reverse of
  test_hybrid_drain_device_error_healed_by_pool_race
  (tests/test_collapse_hybrid.py), whose drain hands a failed device chunk
  back to the pool;
- a stress run with more threads than cores delivers every chunk once.
"""

import threading
import time
from multiprocessing.pool import ThreadPool

import pytest

from ciri_long_tpu.parallel.hybrid import HybridDrain as JaxDrain
from ciri_long_tpu_torch.parallel.hybrid import HybridDrain


@pytest.fixture
def pool():
    with ThreadPool(4) as p:
        yield p


def _drain(cls, pool, nworkers, n, work=0.0, local_work=0.0,
           device_width=1):
    seen = {'pool': [], 'local': []}
    lock = threading.Lock()

    def worker_fn(x):
        with lock:
            seen['pool'].append(x)
        time.sleep(work)
        return x * x + 1

    def run_local(x):
        with lock:
            seen['local'].append(x)
        time.sleep(local_work)
        return x * x + 1

    d = cls(pool, nworkers, worker_fn, run_local,
            [(ci, ci + 100) for ci in range(n)], device_width=device_width)
    return d, [d.result(ci) for ci in range(n)], seen


@pytest.mark.parametrize('n', [1, 3, 24])
def test_results_in_order_and_equal_to_jax(pool, n):
    got, res, seen = _drain(HybridDrain, pool, 2, n, work=0.01)
    got.join()
    want, jres, _ = _drain(JaxDrain, pool, 2, n, work=0.01)
    assert res == jres == [(ci + 100) ** 2 + 1 for ci in range(n)]
    # every chunk ran, each on one side unless the pool raced a steal
    assert set(seen['pool']) | set(seen['local']) == \
        {ci + 100 for ci in range(n)}
    assert len(set(seen['pool']) & set(seen['local'])) <= got.raced
    assert got.stolen == len(seen['local'])
    if n >= 2:
        assert got.stolen >= 1


@pytest.mark.parametrize('nworkers', [2, 4])
@pytest.mark.parametrize('n', [2, 4, 16])
def test_card_takes_a_chunk(pool, nworkers, n):
    """Even when the pool is far faster than the card, the card runs at
    least one chunk, from the back, and the pool runs the front ones."""
    d, res, seen = _drain(HybridDrain, pool, nworkers, n, work=0.0,
                          local_work=0.05)
    d.join()
    assert res == [(ci + 100) ** 2 + 1 for ci in range(n)]
    assert d.stolen >= 1
    assert n - 1 + 100 in seen['local']
    assert 100 in seen['pool']


def test_jax_prefetch_leaves_the_card_nothing_on_few_chunks(pool):
    """Why the prefetch and tail rule were re-derived: the JAX drain at
    2 workers over the call world's 4 scan chunks gives the card none."""
    d, _, seen = _drain(JaxDrain, pool, 2, 4)
    assert d.stolen == 0 and seen['local'] == []


def test_many_stealers_share_the_back(pool):
    d, res, seen = _drain(HybridDrain, pool, 2, 16, work=0.02,
                          local_work=0.005, device_width=4)
    d.join()
    assert res == [(ci + 100) ** 2 + 1 for ci in range(16)]
    assert d.stolen == len(seen['local']) >= 2
    assert len(set(seen['local'])) == len(seen['local'])


def test_stress_exactly_once():
    """More pool threads and stealers than cores, the interpreter switching
    threads every microsecond: every chunk is delivered once, in order, and
    ``stolen`` counts every chunk a stealer finished."""
    import os
    import sys

    n = 400
    local = []
    lock = threading.Lock()

    def run_local(x):
        with lock:
            local.append(x)
        return -x

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        width = 2 * (os.cpu_count() or 1) + 2
        with ThreadPool(width) as p:
            d = HybridDrain(p, width, lambda x: -x, run_local,
                            [(ci, ci) for ci in range(n)],
                            device_width=width)
            assert [d.result(ci) for ci in range(n)] == \
                [-ci for ci in range(n)]
            d.join()
            assert not any(t.is_alive() for t in d._threads)
    finally:
        sys.setswitchinterval(old)
    assert d.stolen == len(local) == len(set(local)) >= 1
    assert not d._done


def test_pool_error_propagates(pool):
    def worker_fn(x):
        raise ValueError('pool boom %d' % x)

    d = HybridDrain(pool, 1, worker_fn, lambda x: x,
                    [(ci, ci) for ci in range(4)])
    with pytest.raises(RuntimeError, match='hybrid drain failed') as exc:
        d.result(0)
    assert isinstance(exc.value.__cause__, ValueError)


def test_card_error_propagates_past_the_pool_race(pool):
    """The card's chunk (the last) fails only after the pool, out of fresh
    chunks, raced it and delivered its copy: the drain still fails, from
    result() and from join(); nothing gives the chunk back to the pool."""
    n = 3
    holder = {}
    started = threading.Event()

    def run_local(x):
        started.wait(30)
        d = holder['d']
        deadline = time.monotonic() + 30
        while n - 1 not in d._done:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        raise RuntimeError('nvcc failed (1) building sw_score_ends.cu')

    def worker_fn(x):
        started.wait(30)
        return x

    d = HybridDrain(pool, 2, worker_fn, run_local,
                    [(ci, ci) for ci in range(n)])
    holder['d'] = d
    started.set()
    for t in d._threads:
        t.join(30)
    assert d.raced == 1 and d.stolen == 0
    assert n - 1 in d._done          # the pool's copy arrived first
    with pytest.raises(RuntimeError, match='hybrid drain failed') as exc:
        d.result(n - 1)
    assert 'nvcc failed' in str(exc.value.__cause__)
    with pytest.raises(RuntimeError, match='nvcc failed'):
        d.join()


def test_card_error_fails_the_drain_without_a_race(pool):
    def run_local(x):
        raise RuntimeError('kernel launch failed')

    d = HybridDrain(pool, 2, lambda x: x, run_local,
                    [(ci, ci) for ci in range(6)])
    with pytest.raises(RuntimeError, match='hybrid drain failed'):
        for ci in range(6):
            d.result(ci)
        d.join()
