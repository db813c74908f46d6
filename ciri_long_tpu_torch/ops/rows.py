"""Ragged row views: the rows of a batched SW or edit-distance job as views
into one flat int8 code buffer.

A job of collapse's correction pass holds many short rows that repeat: one
junction against thousands of genome pieces, every pair of a cluster's
sequences.  ``Rows`` keeps each distinct sequence once and names a row by
its (offset, length) in the buffer, so a job is built with a few numpy
calls and never copies a sequence once per row.  ``concat_rows`` joins the
jobs of a fused round (a few numpy calls a job, none a row) and
``row_groups`` groups a round's SW rows by the length rungs ``RUNGS``, so
each group is padded to its own longest row; the native rounds of
``ops/sw.py::sw_align_rows`` and ``ops/edit.py::edit_distance_rows`` take
that form.  ``padded`` lays rows out as the PAD-suffixed ``[B, L]`` arrays
the host cores and the plain versions read.

``RowStage`` holds what the native rounds on one device reuse: each kernel
library's staging (pinned host memory, device buffers, a stream and an
event, made in ``csrc/row_views.h``), made at its first round.
``row_stage`` keeps one a device for the process, which every round on
that device takes, fused or not; the process's end releases it.
"""

import threading
from typing import NamedTuple

import numpy as np

from ciri_long_tpu_torch.utils.seq import encode_seq

PAD = 5

# the length ladder that groups a fused round's SW rows: rows of one rung
# (by query and by reference length) share a launch, padded to the
# group's own longest row
RUNGS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


class Rows(NamedTuple):
    """Row k is ``codes[off[k]:off[k] + lens[k]]``: int8 codes, int32
    offsets and lengths."""
    codes: np.ndarray
    off: np.ndarray
    lens: np.ndarray


def _views(seqs):
    """int32 offsets and lengths of ``seqs`` laid end to end."""
    lens = np.fromiter(map(len, seqs), np.int32, len(seqs))
    off = np.zeros(len(seqs), np.int32)
    np.cumsum(lens[:-1], out=off[1:])
    return off, lens


def rows_of(seqs):
    """Rows holding each code array of ``seqs`` once, in order."""
    codes = (np.concatenate(seqs).astype(np.int8, copy=False) if len(seqs)
             else np.zeros(0, np.int8))
    return Rows(codes, *_views(seqs))


def encoded_rows(seqs):
    """Rows of the strings ``seqs``, each once, in order, encoded in one
    call."""
    return Rows(encode_seq(''.join(seqs)), *_views(seqs))


def repeat_row(codes, n):
    """Rows of ``codes`` ``n`` times over: one copy, n views."""
    codes = np.asarray(codes, np.int8)
    return Rows(codes, np.zeros(n, np.int32),
                np.full(n, len(codes), np.int32))


def concat_rows(parts):
    """The rows of every Rows of ``parts``, in order, over one buffer
    (each part's offsets shifted by the codes before it)."""
    if len(parts) == 1:
        return parts[0]
    sizes = np.fromiter((len(p.codes) for p in parts), np.int64, len(parts))
    base = np.zeros(len(parts), np.int64)
    np.cumsum(sizes[:-1], out=base[1:])
    if base[-1] + sizes[-1] >= 2 ** 31:
        raise ValueError('concat_rows: {} codes exceed int32 offsets'.format(
            int(base[-1] + sizes[-1])))
    return Rows(np.concatenate([p.codes for p in parts]),
                np.concatenate([p.off + np.int32(b)
                                for p, b in zip(parts, base.tolist())]),
                np.concatenate([p.lens for p in parts]))


def check_rows(rows, name='rows'):
    """Raise unless ``rows`` is int8 codes with int32 views of one length
    that lie inside the buffer."""
    codes, off, lens = rows
    if codes.dtype != np.int8 or codes.ndim != 1:
        raise TypeError('{}: codes must be a flat int8 array'.format(name))
    if off.dtype != np.int32 or lens.dtype != np.int32 or \
            off.shape != lens.shape or off.ndim != 1:
        raise TypeError('{}: off and lens must be int32 [B]'.format(name))
    if len(off) and (off.min() < 0 or lens.min() < 0 or
                     int((off.astype(np.int64) + lens).max()) > len(codes)):
        raise ValueError('{}: a view lies outside its {} codes'.format(
            name, len(codes)))


def padded(rows, width=None):
    """(int8 [B, width] codes PAD-suffixed, int32 lengths) of ``rows``;
    ``width`` defaults to the longest row (at least 1)."""
    codes, off, lens = rows
    if width is None:
        width = max(1, int(lens.max()) if len(lens) else 1)
    col = np.arange(width, dtype=np.int64)
    inside = col[None, :] < lens[:, None]
    src = np.append(codes, np.int8(PAD))
    at = np.where(inside, off[:, None].astype(np.int64) + col[None, :],
                  len(codes))
    return src[at], lens


def row_groups(q_lens, r_lens, pid=None):
    """The launch groups of a fused round's SW rows: rows of one params
    index (``pid``, int [B], default all 0) whose query and reference
    lengths fall on the same rungs of RUNGS (every length past the last
    rung on one more).  Returns (order, groups): ``order`` int64 [B] lists
    the rows group by group (stable), ``groups`` int64 [G, 5] holds each
    group's first place in ``order``, its rows, its widths (the longest
    query and reference row, at least 1) and its params index."""
    B = len(q_lens)
    pid = np.zeros(B, np.int64) if pid is None else np.asarray(pid, np.int64)
    n = len(RUNGS) + 1
    key = (pid * n + np.searchsorted(RUNGS, q_lens)) * n + \
        np.searchsorted(RUNGS, r_lens)
    order = np.argsort(key, kind='stable')
    if not B:
        return order, np.zeros((0, 5), np.int64)
    skey = key[order]
    starts = np.flatnonzero(np.r_[True, skey[1:] != skey[:-1]])
    counts = np.diff(np.r_[starts, B])
    lq = np.maximum.reduceat(np.asarray(q_lens, np.int64)[order], starts)
    lr = np.maximum.reduceat(np.asarray(r_lens, np.int64)[order], starts)
    return order, np.stack([starts, counts, np.maximum(lq, 1),
                            np.maximum(lr, 1), pid[order][starts]], axis=1)


class RowStage:
    """The native staging the rounds on ``device`` reuse, one a kernel
    library (made by its ``<prefix>_stage_new`` at the first round that
    needs it), kept for the process.  One round at a time holds it
    (``lock``)."""

    def __init__(self, device):
        self.device = device
        self.lock = threading.Lock()
        self._handles = {}

    def handle(self, lib, prefix):
        """This stage's native staging of ``lib`` (made on first use)."""
        if prefix not in self._handles:
            h = getattr(lib, prefix + '_stage_new')(
                self.device.index or 0)
            if not h:
                raise RuntimeError('{}_stage_new failed on {}'.format(
                    prefix, self.device))
            self._handles[prefix] = h
        return self._handles[prefix]


_STAGES = {}
_STAGES_LOCK = threading.Lock()


def row_stage(device):
    """The RowStage of ``device`` (a torch.device), made at its first use
    and kept for the process."""
    key = (device.type, device.index or 0)
    with _STAGES_LOCK:
        if key not in _STAGES:
            _STAGES[key] = RowStage(device)
        return _STAGES[key]
