"""Spans around the program's layers and the reduction of a device trace.

``Spans`` wraps functions of the program (by module and name, from
outside it) with a host clock and a ``torch.profiler.record_function`` of
the span's name; it is installed in traced runs only.  ``reduce`` takes a
``torch.profiler`` trace of the window apart: the seconds in which any
operation of the process ran on the card (kernels, copies, sets; the union
of their intervals), the device operations that took most time, and the
idle gaps between them, each put to the innermost span that was open on
the host at its middle.
"""

import threading
import time
from collections import defaultdict

import numpy as np

from checks._patch import Patches

TOP = 10
WINDOW = 'portbench.window'


class Spans:
    def __init__(self, table):
        self.table = dict(table)       # span name -> (module, attr)
        self.seconds = defaultdict(float)
        self.lock = threading.Lock()
        self.patches = Patches()

    def install(self):
        import torch

        for name, (module, attr) in self.table.items():
            def timed(orig, *args, _name=name, **kwargs):
                t0 = time.perf_counter()
                try:
                    with torch.profiler.record_function(_name):
                        return orig(*args, **kwargs)
                finally:
                    dt = time.perf_counter() - t0
                    with self.lock:
                        self.seconds[_name] += dt
            self.patches.wrap(module, attr, timed)

    def uninstall(self):
        self.patches.undo()


def _union(intervals):
    """Merged [start, end) intervals (sorted), as two arrays."""
    if not len(intervals):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    iv = np.asarray(sorted(intervals), np.int64)
    starts, ends = iv[:, 0], np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = starts[1:] > ends[:-1]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return starts[idx], ends[last]


def reduce(events, span_names, t0_ns, t1_ns):
    """(busy_s, breakdown) of the window [t0_ns, t1_ns] from kineto events
    (``prof.profiler.kineto_results.events()``)."""
    from torch.autograd import DeviceType

    dev, spans = [], defaultdict(list)
    by_op = defaultdict(int)
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            # a span's (or the window's) image on the device's timeline
            # is no work of the device
            if (e.is_user_annotation() or e.name() in span_names
                    or e.name() == WINDOW):
                continue
            s, t = max(e.start_ns(), t0_ns), min(e.end_ns(), t1_ns)
            if t > s:
                dev.append((s, t))
                by_op[e.name()] += t - s
        elif e.name() in span_names:
            spans[e.name()].append((e.start_ns(), e.end_ns()))
    bs, be = _union(dev)
    busy_s = float((be - bs).sum()) / 1e9
    gap_s = np.append(bs, t1_ns) - np.insert(be, 0, t0_ns)
    gap_mid = (np.append(bs, t1_ns) + np.insert(be, 0, t0_ns)) // 2
    keep = gap_s > 0
    gap_s, gap_mid = gap_s[keep], gap_mid[keep]
    # innermost first: the span whose calls are the shortest
    order = sorted(spans, key=lambda n: np.mean([t - s for s, t in
                                                 spans[n]]))
    owner = np.full(len(gap_s), -1)
    for k, name in enumerate(order):
        s, t = _union(spans[name])
        at = np.searchsorted(s, gap_mid, side='right') - 1
        inside = (at >= 0) & (gap_mid < t[np.maximum(at, 0)])
        owner[(owner < 0) & inside] = k
    idle = defaultdict(float)
    for k, secs in zip(owner.tolist(), (gap_s / 1e9).tolist()):
        idle[order[k] if k >= 0 else 'outside every span'] += secs
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return busy_s, {
        'device_ops': [[n, ns / 1e9] for n, ns in top],
        'idle_gaps': sorted(([n, s] for n, s in idle.items()),
                            key=lambda kv: -kv[1])[:TOP]}
