"""Device resolution, kernel launch counters and dispatch accounting.

``resolve_device`` turns the CLI's ``--device`` into a ``torch.device`` and
raises when CUDA is asked for and absent: the port never carries on on the
CPU behind the user's back.

``LAUNCHES`` counts, per hand-written kernel, the launches its wrapper made
since the last ``reset_launches`` (plain integers, read with
``launch_counts``; ``call`` resets them when it starts), so a run can show
that its main path went through the kernel.

``count_dispatch`` is the JAX package's env-gated accounting decorator
(``ciri_long_tpu/utils/dispatch.py:24``): set CIRI_DISPATCH_STATS=1 and every
wrapped entry point accumulates (calls, wall seconds), printed to stderr at
exit.  Zero overhead when the variable is unset.
"""

import atexit
import functools
import os
import sys
import time
from collections import defaultdict

import torch

_ENABLED = os.environ.get('CIRI_DISPATCH_STATS') not in (None, '', '0')
_STATS = defaultdict(lambda: [0, 0.0])

# kernel name -> launches since the last reset_launches()
LAUNCHES = {'sw_score_ends': 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts():
    return dict(LAUNCHES)


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
