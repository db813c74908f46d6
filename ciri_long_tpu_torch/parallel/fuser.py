"""Cross-cluster dispatch fusion for the collapse stage.

A copy of ``ciri_long_tpu/parallel/fuser.py`` (it imports only threading,
time and concurrent.futures; the port keeps its own copy).

The collapse correction pass runs clusters on worker threads
(pipeline/collapse.py::correct_chunk); each cluster's control flow is a
CHAIN of small batched device ops (head-anchor SW, template SW, junction
curation SW+edit, junction scoring, HPC distance matrices, per-exon-pair
scoring).  Launched per cluster, each op is a few small kernels with a host
round trip between them.

The fuser turns that into a submit-all/collect-all shape: worker threads
submit jobs and block on futures; ONE dispatcher thread drains the queue,
concatenates every pending job of a kind into a single padded batch, runs
ONE device call, and distributes row slices back.  K concurrent clusters
with op-chain depth k collapse from K*k calls to ~k fused rounds, and the
device only ever sees one dispatcher.

Exactness: every fused op is row-independent (SW/edit batches pad rows
without cross-talk), so fused results are bit-identical to per-cluster
dispatches.

No reference analog: the reference's collapse loop is ~2500 serial SSW
calls per cluster (collapse.py:161-173).
"""

import threading
import time
from concurrent.futures import Future

_BY_THREAD = {}          # thread ident -> fuser (worker registration)


def current_fuser():
    """The fuser the CURRENT thread is registered with, or None (module
    helpers route their device calls through it when present)."""
    return _BY_THREAD.get(threading.get_ident())


class DeviceFuser:
    """Batch-fusing dispatcher.

    ``executors`` maps kind -> callable(list_of_payloads) ->
    list_of_results (same order).  Executors run on the dispatcher
    thread only, one at a time.

    Fire rule: dispatch as soon as every registered worker is blocked
    on a future (maximum fusion), or ``linger_s`` after the oldest
    pending job (so one worker stuck in long host work cannot stall
    the rest indefinitely).
    """

    def __init__(self, executors, linger_s=0.02):
        self._executors = executors
        self._linger = linger_s
        self._cv = threading.Condition()
        self._pending = []            # (kind, payload, Future)
        self._workers = set()         # registered thread idents
        self._blocked = 0
        self._stop = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True, name='ciri-fuser')
        self._thread.start()
        self.rounds = 0               # fused dispatch rounds (telemetry)
        self.jobs = 0                 # jobs fused into them

    # -- worker side ----------------------------------------------------
    def register(self):
        """Route the CURRENT thread's fusable ops through this fuser
        (module helpers find it via current_fuser())."""
        ident = threading.get_ident()
        _BY_THREAD[ident] = self
        with self._cv:
            self._workers.add(ident)

    def unregister(self):
        ident = threading.get_ident()
        _BY_THREAD.pop(ident, None)
        with self._cv:
            self._workers.discard(ident)
            self._cv.notify_all()

    def call(self, kind, payload):
        """Submit one job and block until its fused round completes."""
        fut = Future()
        with self._cv:
            if not self._pending:
                self._first_ts = time.monotonic()
            self._pending.append((kind, payload, fut))
            self._blocked += 1
            self._cv.notify_all()
        try:
            return fut.result()
        finally:
            with self._cv:
                self._blocked -= 1
                self._cv.notify_all()

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join()

    # -- dispatcher side ------------------------------------------------
    _first_ts = 0.0

    def _dispatch_loop(self):
        while True:
            with self._cv:
                while True:
                    if self._stop and not self._pending:
                        return
                    if self._pending:
                        all_blocked = (self._workers
                                       and self._blocked
                                       >= len(self._workers))
                        age = time.monotonic() - self._first_ts
                        if (self._stop or all_blocked
                                or age >= self._linger
                                or not self._workers):
                            break
                        self._cv.wait(max(5e-4, self._linger - age))
                    else:
                        self._cv.wait(0.25)
                batch = self._pending
                self._pending = []
            by_kind = {}
            for kind, payload, fut in batch:
                by_kind.setdefault(kind, []).append((payload, fut))
            for kind, jobs in by_kind.items():
                try:
                    results = self._executors[kind](
                        [p for p, _ in jobs])
                    if len(results) != len(jobs):
                        raise RuntimeError(
                            'fused executor %r returned %d results for '
                            '%d jobs' % (kind, len(results), len(jobs)))
                except BaseException as exc:  # propagate to every waiter
                    for _, fut in jobs:
                        fut.set_exception(exc)
                    continue
                for (_, fut), res in zip(jobs, results):
                    fut.set_result(res)
                self.rounds += 1
                self.jobs += len(jobs)
