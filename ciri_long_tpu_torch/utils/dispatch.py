"""Device resolution, kernel launch counters, and the spans and counters of
the host's work.

``resolve_device`` turns the CLI's ``--device`` into a ``torch.device`` and
raises when CUDA is asked for and absent: the port never carries on on the
CPU behind the user's back.

``LAUNCHES`` counts, per hand-written kernel, the launches its wrapper made
(``count_launch``) since the last ``reset_launches`` (plain integers, read with
``launch_counts``; ``call`` and ``collapse`` reset them when they start and
report those of ``CALL_KERNELS`` and ``COLLAPSE_KERNELS``), so a run can
show that its path went through the kernel; ``ROUTES`` counts the
launches of each kernel's routes beside it, and ``DEVICE_MS`` the device
time of the launches that a host loop times itself (csrc/poa_align.cu's
round loop, CUDA events around each launch).

``span(name)`` (a context manager or a decorator) adds a call and its
nanoseconds (``time.perf_counter_ns``, CLOCK_MONOTONIC) to a table of the
calling thread; ``state(name)`` does the same, but a state entered inside
another takes its time from it, so the states a thread passes through sum
to the span that holds them.  ``count(name, n)`` adds to a counter in the
same table.  Each thread keeps its own table, so the hot path takes no
lock; ``summary()`` merges them.  While a ``torch.profiler`` records, a span
or state also opens a ``record_function`` of its name on the calling
thread, which puts it on the device trace's clock; otherwise it costs two
clock reads and a dict update.  ``SPAN_NAMES`` names every span, state and
counter the program opens.  ``reset_launches`` clears the tables with the
launch counts.
"""

import array
import functools
import threading
import time

import numpy as np
import torch
import torch.autograd.profiler as _profiler

# kernel name -> launches since the last reset_launches()
LAUNCHES = {'sw_score_ends': 0, 'sw_rowscan': 0, 'sw_chain': 0,
            'int16_probe': 0, 'int16_probe_all': 0, 'edit_distance': 0,
            'sw_traceback': 0, 'poa_align': 0, 'chain_dp': 0,
            'chain_extract': 0, 'screen_keep': 0, 'nw_traceback': 0,
            'tandem_counts': 0, 'lag_profile': 0, 'fused_rows': 0}
# the kernels ``call`` and ``collapse`` can launch (sw_rowscan, sw_chain and
# the int16 probes serve misc/kexp and misc/int16_probe; tandem_counts the
# mesh's pipeline step, parallel/mesh.py; lag_profile ops/period.py's public
# op; fused_rows the helper kernels of collapse's native SW and edit rounds,
# csrc/row_views.h's expand and csrc/sw_score_ends.cu's reverse prefixes and
# answers)
CALL_KERNELS = ('sw_score_ends', 'chain_dp', 'chain_extract', 'screen_keep',
                'nw_traceback')
COLLAPSE_KERNELS = ('sw_score_ends', 'edit_distance', 'sw_traceback',
                    'poa_align', 'fused_rows')
# kernel name -> ms of device time since the last reset_launches()
DEVICE_MS = {'poa_align': 0.0}
# route -> launches that ran it since the last reset_launches (``call``'s
# summary leaves this out): csrc/sw_score_ends.cu's wave and tiled
# (ops/sw.py::_tile_plan), csrc/edit_distance.cu's thread and warp routes
# (one launch may run both; csrc/edit_distance.cu::edit_rows_run plans
# them), csrc/sw_traceback.cu's shared-memory and global routes
# (ops/sw_tb_batch.py::tb_plan),
# csrc/nw_traceback.cu's width classes, a kernel launch each: C = 1, 2, 4, 8
# columns a lane with the rows in registers, a block of warps a pass
# (nw_block), or the rows in global scratch (nw_global;
# ops/nw_tb_batch.py::nw_plan); and, counted in
# pairs, not launches, the
# center-star pairs that needed a wider band than their first
# (``nw_escalate``) and those that CCS's polish aligned on the host
# (``nw_host``: the native center star of the cpu route; 0 on the card);
# and the value routes of csrc/tandem_counts.cu and csrc/lag_profile.cu
# (``tandem_value``, ``lag_value``: counted in reads with a code outside
# 0..5, not in launches), also picked on the card, where each such read
# counts itself in a device tally (``route_tally``) that ``settle_routes``
# folds in here
ROUTES = {'wave': 0, 'tiled': 0, 'edit_thread': 0, 'edit_warp': 0,
          'tb_smem': 0, 'tb_global': 0, 'nw_c1': 0, 'nw_c2': 0, 'nw_c4': 0,
          'nw_c8': 0, 'nw_block': 0, 'nw_global': 0,
          'nw_escalate': 0, 'nw_host': 0, 'tandem_value': 0,
          'lag_value': 0}
# (route, device) -> [int32 [1] tally on the device, its count already
# folded]
_TALLIES = {}


_LAUNCH_LOCK = threading.Lock()


def count_launch(name, *routes, times=1, device_ms=None):
    """``times`` launches of kernel ``name`` (one by default), and as many
    for each route of it that the launches ran; ``device_ms`` adds their
    device time to DEVICE_MS.  Locked: collapse's worker threads launch
    kernels side by side, and ``+=`` on a dict entry is not atomic."""
    with _LAUNCH_LOCK:
        LAUNCHES[name] += times
        for route in routes:
            ROUTES[route] += times
        if device_ms is not None:
            DEVICE_MS[name] += device_ms


def count_route(route, times=1):
    """``times`` more in ROUTES[route] (locked, as count_launch)."""
    with _LAUNCH_LOCK:
        ROUTES[route] += times


def route_tally(route, device):
    """The int32 [1] tally on ``device`` to which a kernel adds one for each
    read that takes ``route`` on the card (made, zero, at its first
    use)."""
    with _LAUNCH_LOCK:
        key = (route, str(device))
        if key not in _TALLIES:
            _TALLIES[key] = [torch.zeros(1, dtype=torch.int32,
                                         device=device), 0]
        return _TALLIES[key][0]


def settle_routes():
    """Add to ROUTES the reads the card's tallies counted since the last
    call (waits for the launches queued before it on each tally's
    device)."""
    with _LAUNCH_LOCK:
        for (route, _), entry in _TALLIES.items():
            n = int(entry[0][0])
            ROUTES[route] += n - entry[1]
            entry[1] = n


def reset_launches():
    """Zero the launch counts, the device times, and every thread's spans
    and counters."""
    settle_routes()
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0
    for name in DEVICE_MS:
        DEVICE_MS[name] = 0.0
    with _LAUNCH_LOCK:
        _TABLES.clear()
        _GENERATION[0] += 1


def launch_counts(names=None):
    return {name: LAUNCHES[name] for name in (names or LAUNCHES)}


def resolve_device(name) -> torch.device:
    """``torch.device`` for ``name`` ('cuda', 'cuda:N' or 'cpu').  Raises
    RuntimeError for a CUDA device when no GPU is visible."""
    dev = torch.device(name)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device '{}' requested but torch.cuda.is_available() is "
                "False (torch {}, CUDA build {})".format(
                    name, torch.__version__, torch.version.cuda))
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError("unsupported device '{}' (cuda or cpu)".format(name))
    return dev


# every span, state and counter the program opens or adds to, with what it
# times or counts (spans and states in seconds of a thread, counters in
# their own unit)
SPAN_NAMES = {
    # batched entry points (a span each call)
    'aligner.map_batch': 'models/aligner.py: one batch of reads mapped',
    'sw_align_batch': 'ops/sw.py: one batch of SW alignments',
    'edit_distance_batch': 'ops/edit.py: one batch of edit distances',
    'sw_traceback_batch': 'ops/sw_tb_batch.py: one batch of SW tracebacks',
    'chain_scores_batch': 'ops/chain.py: one batch of chaining DPs',
    'chain_extract_batch': 'ops/chain.py: chains extracted from a batch',
    'chain.backtrack': 'ops/chain.py: host backtrack of chains',
    'tandem_counts': 'ops/period.py: lag-range tandem counts',
    'lag_profile': 'ops/period.py: lag profile',
    'screen_keep': 'ops/period.py: the tandem screen',
    'nw_tb_submit': 'ops/nw_tb_batch.py: NW traceback jobs submitted',
    'nw_tb_collect': 'ops/nw_tb_batch.py: NW traceback results collected',
    'nw_tb_batch': 'ops/nw_tb_batch.py: one batch of NW tracebacks',
    'clip_sw_batch': 'pipeline/find_bsj.py: clip SW of a batch of reads',
    # the stages of call and collapse (utils/logger.py::StageTimer)
    'stage.ccs': 'call [1/4]: cyclic consensus',
    'stage.scan_ccs': 'call [2/4]: consensus reads scanned',
    'stage.recover_ccs': 'call [3/4]: short consensus reads recovered',
    'stage.scan_raw': 'call [4/4]: raw reads scanned',
    'stage.cluster': 'collapse [1/2]: clustering and correction',
    'stage.exp_mtx': 'collapse [2/2]: expression and isoform matrices',
    # collapse's correction pass (pipeline/collapse.py)
    'collapse.correct_reads': 'the correction pass of collapse',
    'collapse.cluster': 'one cluster corrected, on its thread; the sum of '
                        'the five states below',
    'collapse.cluster_host': 'state: host work of a cluster outside the '
                             'four below',
    'fuser.wait': 'state: a cluster thread waits on a fused SW or edit '
                  'round (parallel/fuser.py)',
    'poa.rounds': 'state: sub-cluster POA consensus (ops/poa.py::'
                  'poa_consensus_many)',
    'collapse.junction_poa': "state: the host POA of a cluster's junction "
                             'windows',
    'collapse.rotation_tb': 'state: the rotation SW tracebacks of a '
                            'cluster (sw_traceback_batch)',
    'pool.tail_thread_s': 'counter: s a chunk left its cluster threads '
                          'idle (its wall x pool width - cluster seconds)',
    # the fuser's dispatcher thread (parallel/fuser.py)
    'fuser.linger': 'jobs pending, the dispatcher free, its fire rule not '
                    'yet met',
    'fuser.run.sw': 'a fused SW round run',
    'fuser.run.edit': 'a fused edit-distance round run',
    'fuser.fire.all_blocked': 'counter: rounds fired as every registered '
                              'thread waited',
    'fuser.fire.linger': 'counter: rounds fired as the oldest job reached '
                         'the linger',
    'fuser.fire.stop': 'counter: rounds fired as the fuser closed',
    'fuser.jobs.sw': 'counter: SW jobs fused',
    'fuser.jobs.edit': 'counter: edit-distance jobs fused',
    # collapse's native SW and edit rounds (pipeline/collapse.py::_fused_sw,
    # _fused_edit on the card: the fuser's rounds, and a chunk of one
    # cluster's direct calls), summed over rounds
    'fuser.native.sw': 'counter: SW rounds that took the native call',
    'fuser.native.edit': 'counter: edit rounds that took the native call',
    'fuser.rows.sw': "counter: SW rows of the native rounds",
    'fuser.rows.edit': "counter: edit-distance rows of the native rounds",
    'fuser.ns.pack': "counter: ns joining a round's jobs and planning it "
                     '(Python)',
    'fuser.ns.upload': "counter: ns staging a round's rows and enqueueing "
                       'their upload (native)',
    'fuser.ns.device_wait': 'counter: ns from the upload enqueued to the '
                            "round's sync (native)",
    'fuser.ns.download': "counter: ns copying a round's answers out of "
                         'pinned memory (native)',
    'fuser.ns.unpack': "counter: ns slicing a round's answers per job "
                       '(Python)',
    # csrc/poa_align.cu's round loop, ns of steady clock a phase (thread-
    # summed)
    'poa.ns.pack': "counter: ns packing a round's jobs",
    'poa.ns.plan': "counter: ns planning a round's launch",
    'poa.ns.upload': "counter: ns copying a round's inputs to the card",
    'poa.ns.device_wait': 'counter: ns from the launch to the sync',
    'poa.ns.download': "counter: ns copying a round's alignments back",
    'poa.ns.fuse': "counter: ns fusing a round's alignments into graphs",
}

# threads' tables since the last reset_launches, and its count
_TABLES = []
_GENERATION = [0]
_LOCAL = threading.local()


class _Table:
    """One thread's spans (name -> [calls, ns, array of start, end ns]),
    counters (name -> value) and stack of open states ([name, since ns,
    calls])."""

    __slots__ = ('thread', 'generation', 'spans', 'counts', 'states')

    def __init__(self, thread, generation):
        self.thread = thread
        self.generation = generation
        self.spans = {}
        self.counts = {}
        self.states = []

    def add(self, name, t0, t1, calls=1):
        entry = self.spans.get(name)
        if entry is None:
            entry = self.spans[name] = [0, 0, array.array('q')]
        entry[0] += calls
        entry[1] += t1 - t0
        entry[2].append(t0)
        entry[2].append(t1)

    def enter_state(self, name, now, calls=1):
        if self.states:
            top = self.states[-1]
            self.add(top[0], top[1], now, 0)
        self.states.append([name, now, calls])

    def exit_state(self, now):
        name, since, calls = self.states.pop()
        self.add(name, since, now, calls)
        if self.states:
            self.states[-1][1] = now


def _table():
    table = getattr(_LOCAL, 'table', None)
    if table is None or table.generation != _GENERATION[0]:
        with _LAUNCH_LOCK:
            table = _LOCAL.table = _Table(threading.current_thread().name,
                                          _GENERATION[0])
            _TABLES.append(table)
    return table


def _record(name):
    """An open ``record_function(name)`` while a profiler records, else
    None."""
    if not _profiler._is_profiler_enabled:
        return None
    rf = _profiler.record_function(name)
    rf.__enter__()
    return rf


class span:
    """Time a block (``with span(name):``) or every call of a function
    (``@span(name)``) on the calling thread; after the block, ``ns`` is
    its nanoseconds.  ``start_ns``: the span began earlier, at that
    ``time.perf_counter_ns()`` (on another thread, say)."""

    __slots__ = ('name', 'start_ns', 'ns', '_t0', '_rf', '_table')

    def __init__(self, name, start_ns=None):
        self.name = name
        self.start_ns = start_ns
        self.ns = None

    def __enter__(self):
        self._rf = _record(self.name)
        self._table = _table()
        self._t0 = time.perf_counter_ns()
        if self.start_ns is not None:
            self._t0 = min(self._t0, self.start_ns)
        return self

    def __exit__(self, *exc):
        now = time.perf_counter_ns()
        self.ns = now - self._t0
        self._table.add(self.name, self._t0, now)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class state:
    """``with state(name):`` the calling thread is in state ``name``: its
    time goes to ``name`` and not to the state it interrupts (a span
    of its own on a thread in no state)."""

    __slots__ = ('name', '_rf', '_table')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._rf = _record(self.name)
        self._table = _table()
        self._table.enter_state(self.name, time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        self._table.exit_state(time.perf_counter_ns())
        if self._rf is not None:
            self._rf.__exit__(None, None, None)


def count(name, n=1):
    """Add ``n`` to the calling thread's counter ``name``."""
    counts = _table().counts
    counts[name] = counts.get(name, 0) + n


def counters():
    """{name: value} of every counter, summed over threads."""
    out = {}
    for table in list(_TABLES):
        for name, value in list(table.counts.items()):
            out[name] = out.get(name, 0) + value
    return out


def summary():
    """The spans and counters since the last reset_launches: ``spans``
    {name: {calls, seconds (wall time in which any thread was inside),
    thread_seconds (summed over threads)}}, ``counters`` {name: value},
    and ``threads`` {thread name: {span: {calls, seconds}}} (threads of one
    name summed)."""
    spans, threads, intervals = {}, {}, {}
    for table in list(_TABLES):
        mine = threads.setdefault(table.thread, {})
        for name, (calls, ns, iv) in list(table.spans.items()):
            tot = spans.setdefault(name, [0, 0])
            tot[0] += calls
            tot[1] += ns
            # a copy of the whole (start, end) pairs: a buffer exported
            # from the live array would stop its thread from growing it
            intervals.setdefault(name, []).append(
                np.frombuffer(iv[:len(iv) & ~1], np.int64).reshape(-1, 2))
            row = mine.setdefault(name, {'calls': 0, 'seconds': 0.0})
            row['calls'] += calls
            row['seconds'] += ns / 1e9
    return {'spans': {name: {'calls': calls, 'thread_seconds': ns / 1e9,
                             'seconds': _union_s(intervals[name])}
                      for name, (calls, ns) in sorted(spans.items())},
            'counters': dict(sorted(counters().items())),
            'threads': {t: dict(sorted(rows.items()))
                        for t, rows in sorted(threads.items()) if rows}}


def _union_s(parts):
    """Seconds covered by the union of [start, end] ns intervals."""
    iv = np.concatenate(parts)
    if not len(iv):
        return 0.0
    iv = iv[np.argsort(iv[:, 0], kind='stable')]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)
    return float((ends[last] - starts).sum()) / 1e9
