"""The center-star column vote of CCS's polish in host C++ (csrc/star_vote.cpp).

On the card's route of ``pipeline/find_ccs.py`` every unit of a read that
takes the center star is aligned to the read's representative by
csrc/nw_traceback.cu; ``star_vote`` then votes every such read of a
megabatch in one call of the host library, reading each alignment's run
entries where the kernel's walk wrote them (the downloaded run buffers of
``ops/nw_tb_batch.py::nw_traceback_collect_runs``).  The result is exactly
``ops/ccs.py::center_star_consensus(units, cigars=...)`` read by read;
``star_vote_plain`` is that loop, the plain version the tests hold the
library to.

The library is built by the host compiler at first use (ops/_build.py) and
called through ctypes, which drops the interpreter lock for the call; a
failed build raises.
"""

import ctypes
from typing import List, NamedTuple

import numpy as np

from ciri_long_tpu_torch.ops.ccs import center_star_consensus

_P = ctypes.c_void_p
_SYMBOLS = {'star_vote': ([ctypes.c_int64] + [_P] * 8 + [ctypes.c_int],
                          ctypes.c_int64)}


class StarBatch(NamedTuple):
    """The star reads of one vote: ``codes`` int8, every unit of every read
    concatenated; ``unit_off`` int64 [U + 1], unit u at codes[unit_off[u] :
    unit_off[u + 1]]; ``read_units`` int64 [R + 1], read r's units
    read_units[r] .. read_units[r + 1] - 1; ``rep`` int64 [R], each read's
    representative (an index within the read); ``run_addr`` uint64 [U] and
    ``run_cnt`` int64 [U], the address and count of each unit's uint32 run
    entries (its cigar to the representative; 0 at a representative); and
    ``keep``, the buffers those addresses point into."""
    codes: np.ndarray
    unit_off: np.ndarray
    read_units: np.ndarray
    rep: np.ndarray
    run_addr: np.ndarray
    run_cnt: np.ndarray
    keep: tuple

    def runs(self, u) -> np.ndarray:
        """Unit u's run entries (uint32, a copy)."""
        cnt = int(self.run_cnt[u])
        if cnt == 0:
            return np.zeros(0, np.uint32)
        buf = (ctypes.c_uint32 * cnt).from_address(int(self.run_addr[u]))
        return np.frombuffer(buf, np.uint32).copy()

    def copy(self) -> 'StarBatch':
        """The same batch with its run entries copied into one buffer of
        its own (so that it outlives the buffers it was read from)."""
        runs = [self.runs(u) for u in range(len(self.run_cnt))]
        flat = np.concatenate(runs + [np.zeros(1, np.uint32)])
        start = np.cumsum([0] + [len(x) for x in runs])[:-1]
        addr = np.where(self.run_cnt > 0,
                        flat.ctypes.data + 4 * start, 0).astype(np.uint64)
        return self._replace(codes=self.codes.copy(), run_addr=addr,
                             keep=(flat,))


def star_batch(reads, rep, runs) -> StarBatch:
    """A StarBatch from ``reads`` (a list of lists of int8 unit codes, each
    non-empty, two or more a read), ``rep`` (each read's representative
    index) and ``runs`` (per read, per unit, (address, count) of its run
    entries, None at the representative), plus the buffers to keep."""
    units = [u for read in reads for u in read]
    lens = np.array([len(u) for u in units], np.int64)
    unit_off = np.zeros(len(units) + 1, np.int64)
    unit_off[1:] = np.cumsum(lens)
    read_units = np.zeros(len(reads) + 1, np.int64)
    read_units[1:] = np.cumsum([len(read) for read in reads])
    flat = [x for read in runs for x in read]
    addr = np.array([0 if x is None else x[0] for x in flat], np.uint64)
    cnt = np.array([0 if x is None else x[1] for x in flat], np.int64)
    codes = (np.concatenate(units).astype(np.int8) if units
             else np.zeros(0, np.int8))
    return StarBatch(codes, unit_off, read_units,
                     np.asarray(rep, np.int64), addr, cnt, ())


def star_vote(batch: StarBatch, threads=1) -> List[np.ndarray]:
    """Every read's consensus (int8 codes) by csrc/star_vote.cpp, its reads
    split over ``threads`` threads.  Raises when the library cannot be built
    or a read's input is inconsistent."""
    from ciri_long_tpu_torch.ops import _build

    R = len(batch.rep)
    if R == 0:
        return []
    lib = _build.load('star_vote.cpp', _SYMBOLS)
    arrays = [np.ascontiguousarray(batch.codes, np.int8),
              np.ascontiguousarray(batch.unit_off, np.int64),
              np.ascontiguousarray(batch.read_units, np.int64),
              np.ascontiguousarray(batch.rep, np.int64),
              np.ascontiguousarray(batch.run_addr, np.uint64),
              np.ascontiguousarray(batch.run_cnt, np.int64)]
    out = np.empty(max(1, len(batch.codes)), np.int8)
    out_len = np.empty(R, np.int64)
    bad = lib.star_vote(R, *(a.ctypes.data for a in arrays), out.ctypes.data,
                        out_len.ctypes.data, int(threads))
    if bad >= 0:
        raise ValueError('star_vote: read {} has a representative outside it '
                         'or run entries that do not fit its units'
                         .format(bad))
    at = batch.unit_off[batch.read_units[:-1]]
    return [out[a:a + k].copy() for a, k in zip(at.tolist(),
                                                 out_len.tolist())]


def star_vote_plain(batch: StarBatch) -> List[np.ndarray]:
    """The plain version: ops/ccs.py::center_star_consensus(units,
    cigars=...) read by read, the cigars decoded from the same run
    entries."""
    out = []
    for r in range(len(batch.rep)):
        u0, u1 = (int(x) for x in batch.read_units[r:r + 2])
        units = [batch.codes[batch.unit_off[u]:batch.unit_off[u + 1]]
                 for u in range(u0, u1)]
        cigars = [None if u - u0 == batch.rep[r] else
                  [(int(e) >> 4, int(e) & 15) for e in batch.runs(u)]
                  for u in range(u0, u1)]
        out.append(np.asarray(center_star_consensus(units, cigars=cigars),
                              np.int8))
    return out
