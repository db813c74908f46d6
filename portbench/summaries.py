"""The summary JSON that each ``collapse`` run of the window writes,
``{out}/{prefix}.json`` (``spans``, ``counters``: utils/dispatch.py's
tables of the run), read by the per-layer metrics of the program's own
spans and counters."""

import json
import os


def per_kread(rec, value):
    """``value(summary)`` summed over the window's units, over its
    thousands of input reads; None outside ``collapse``, or when a unit
    wrote no summary (a program without one)."""
    if rec['entry'] != 'collapse' or not rec['units'] or not rec['reads']:
        return None
    total = 0.0
    for u in rec['units']:
        path = os.path.join(u['out'], u['prefix'] + '.json')
        try:
            with open(path) as f:
                summary = json.load(f)
        except (OSError, ValueError):
            return None
        if 'spans' not in summary or 'counters' not in summary:
            return None
        total += value(summary)
    return total / (rec['reads'] / 1000)


def thread_seconds(summary, name):
    return summary['spans'].get(name, {}).get('thread_seconds', 0.0)
