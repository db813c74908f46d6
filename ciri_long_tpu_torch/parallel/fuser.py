"""Cross-cluster dispatch fusion for the collapse stage.

The port's own copy of ``ciri_long_tpu/parallel/fuser.py``, with the
accounting below added.

The collapse correction pass runs clusters on worker threads
(pipeline/collapse.py::correct_chunk); each cluster's control flow is a
CHAIN of small batched device ops (head-anchor SW, template SW, junction
curation SW+edit, junction scoring, HPC distance matrices, per-exon-pair
scoring).  Launched per cluster, each op is a few small kernels with a host
round trip between them.

The fuser turns that into a submit-all/collect-all shape: worker threads
submit jobs and block on futures; ONE dispatcher thread drains the queue,
hands every pending job of a kind to that kind's executor as one batch
(collapse's: one native call over the jobs' row views), and distributes
row slices back.  K concurrent clusters
with op-chain depth k collapse from K*k calls to ~k fused rounds, and the
device only ever sees one dispatcher.

Exactness: every fused op is row-independent (SW/edit batches pad rows
without cross-talk), so fused results are bit-identical to per-cluster
dispatches.

No reference analog: the reference's collapse loop is ~2500 serial SSW
calls per cluster (collapse.py:161-173).

Accounting (utils/dispatch.py): a worker's wait is its state ``fuser.wait``;
the dispatcher's spans are ``fuser.linger`` (jobs pending while it is free
and its fire rule is not yet met) and ``fuser.run.<kind>``; each round adds
one to ``fuser.fire.<reason>`` (``all_blocked``, ``linger`` or ``stop``,
so they sum to ``rounds``) and its jobs to ``fuser.jobs.<kind>``.
"""

import threading
import time
from concurrent.futures import Future

from ciri_long_tpu_torch.utils.dispatch import count, span, state

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
        self._linger_ns = int(linger_s * 1e9)
        self._cv = threading.Condition()
        self._pending = []            # (kind, payload, Future)
        self._first_ns = 0            # perf_counter_ns of the oldest job
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
        with state('fuser.wait'):
            with self._cv:
                if not self._pending:
                    self._first_ns = time.perf_counter_ns()
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
    def _fire_reason(self):
        """Why the pending jobs go now, or None (called under the lock)."""
        if self._stop:
            return 'stop'
        if self._blocked >= len(self._workers):
            return 'all_blocked'
        if time.perf_counter_ns() - self._first_ns >= self._linger_ns:
            return 'linger'
        return None

    def _next_batch(self):
        """(pending jobs, fire reason) once the fire rule is met; (None,
        None) once closed with nothing pending."""
        free = time.perf_counter_ns()
        with self._cv:
            while not self._pending:
                if self._stop:
                    return None, None
                self._cv.wait(0.25)
            reason = self._fire_reason()
            if reason is None:
                with span('fuser.linger',
                          start_ns=max(free, self._first_ns)):
                    while reason is None:
                        left = self._linger_ns - (time.perf_counter_ns()
                                                  - self._first_ns)
                        self._cv.wait(max(5e-4, left / 1e9))
                        reason = self._fire_reason()
            batch, self._pending = self._pending, []
        return batch, reason

    def _dispatch_loop(self):
        while True:
            batch, reason = self._next_batch()
            if batch is None:
                return
            by_kind = {}
            for kind, payload, fut in batch:
                by_kind.setdefault(kind, []).append((payload, fut))
            for kind, jobs in by_kind.items():
                try:
                    with span('fuser.run.' + kind):
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
                count('fuser.fire.' + reason)
                count('fuser.jobs.' + kind, len(jobs))
