"""Shared on-disk array-cache helpers for the mmap-shared genome and
minimizer-index caches (io/genome.py, models/minimizer.py).

Layout: a directory of .npy files plus meta.json.  Writes build a
sibling temp dir and swap it in; the previous cache is renamed aside
before the new one lands, so a reader never sees a half-written dir and
a failed swap cannot destroy an existing cache.  Concurrent savers can
race on the final rename -- the loser's tree is discarded -- but some
complete cache always survives.
"""

import json
import os
import shutil
import tempfile

import numpy as np


def save_array_dir(cache_dir: str, arrays: dict, meta: dict) -> None:
    """Atomically persist ``arrays`` (name -> ndarray) + ``meta``."""
    parent = os.path.dirname(os.path.abspath(cache_dir)) or '.'
    tmp = tempfile.mkdtemp(prefix='.cache.', dir=parent)
    old = None
    try:
        for name, arr in arrays.items():
            np.save(os.path.join(tmp, name + '.npy'), arr)
        with open(os.path.join(tmp, 'meta.json'), 'w') as f:
            json.dump(meta, f)
        if os.path.isdir(cache_dir):
            old = tempfile.mkdtemp(prefix='.cache.old.', dir=parent)
            os.rmdir(old)
            os.rename(cache_dir, old)
        os.rename(tmp, cache_dir)
        tmp = None
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)


def load_array_dir(cache_dir: str, names):
    """Memory-mapped load of ``names``; returns (meta, [arrays]) or None
    when absent/unreadable.  Callers validate the meta fingerprint."""
    try:
        with open(os.path.join(cache_dir, 'meta.json')) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    try:
        return meta, [np.load(os.path.join(cache_dir, n + '.npy'),
                              mmap_mode='r') for n in names]
    except (OSError, ValueError):
        return None
