"""Device resolution, kernel launch counters and dispatch accounting.

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

``count_dispatch`` is the JAX package's env-gated accounting decorator
(``ciri_long_tpu/utils/dispatch.py:24``): set CIRI_DISPATCH_STATS=1 and every
wrapped entry point accumulates (calls, wall seconds), printed to stderr at
exit.  Zero overhead when the variable is unset.
"""

import atexit
import functools
import os
import sys
import threading
import time
from collections import defaultdict

import torch

_ENABLED = os.environ.get('CIRI_DISPATCH_STATS') not in (None, '', '0')
_STATS = defaultdict(lambda: [0, 0.0])

# kernel name -> launches since the last reset_launches()
LAUNCHES = {'sw_score_ends': 0, 'sw_rowscan': 0, 'sw_chain': 0,
            'int16_probe': 0, 'int16_probe_all': 0, 'edit_distance': 0,
            'sw_traceback': 0, 'poa_align': 0}
# the kernels ``call`` and ``collapse`` can launch (sw_rowscan, sw_chain and
# the int16 probes serve misc/kexp and misc/int16_probe)
CALL_KERNELS = ('sw_score_ends',)
COLLAPSE_KERNELS = ('sw_score_ends', 'edit_distance', 'sw_traceback',
                    'poa_align')
# kernel name -> ms of device time since the last reset_launches()
DEVICE_MS = {'poa_align': 0.0}
# route -> launches that ran it since the last reset_launches (``call``'s
# summary leaves this out): csrc/sw_score_ends.cu's wave and tiled
# (ops/sw.py::_tile_plan), csrc/edit_distance.cu's thread and warp routes
# (one launch may run both; ops/edit.py::edit_plan), csrc/sw_traceback.cu's
# shared-memory and global routes (ops/sw_tb_batch.py::tb_plan)
ROUTES = {'wave': 0, 'tiled': 0, 'edit_thread': 0, 'edit_warp': 0,
          'tb_smem': 0, 'tb_global': 0}


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


def reset_launches():
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0
    for name in DEVICE_MS:
        DEVICE_MS[name] = 0.0


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


def count_dispatch(name):
    def deco(fn):
        if not _ENABLED:
            return fn

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                st = _STATS[name]
                st[0] += 1
                st[1] += time.monotonic() - t0
        return wrapped
    return deco


def report(out=None):
    out = out or sys.stderr
    if not _STATS:
        return
    total = sum(w for _, w in _STATS.values())
    print('--- dispatch stats (CIRI_DISPATCH_STATS) ---', file=out)
    for name, (calls, wall) in sorted(_STATS.items(),
                                      key=lambda kv: -kv[1][1]):
        print('{:28s} {:6d} calls {:9.2f} s  ({:.0f} ms/call)'.format(
            name, calls, wall, 1000.0 * wall / max(calls, 1)), file=out)
    print('{:28s} {:>6s}       {:9.2f} s'.format('TOTAL', '', total),
          file=out)


if _ENABLED:
    atexit.register(report)
