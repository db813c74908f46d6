"""Cyclic consensus (CCS) detection: tandem-repeat finding + unit consensus.

Replaces the pyccs Rust wheel (reference find_ccs.py:8-17).  Contract
(SURVEY.md §3.5): ``find_consensus(seq) -> (segments, ccs)`` where
``segments`` is a ';'-joined list of 'start-end' spans of the repeat units
in read coordinates and ``ccs`` is the consensus of the units, or
``(None, None)`` when the read is not a tandem repeat.  The reference
parses the span string at find_bsj.py:254-255,381-382 and requires the
consensus to be length-consistent with a POA over the true units
(tests/test_poa.py:19-32).

Algorithm (alignment-free period estimation + POA polish):
  1. k-mer lag voting: every pair of consecutive occurrences of the same
     k-mer votes for its distance.  In a rolling-circle read the unit
     period dominates the vote; indel drift is absorbed by clustering the
     votes with a relative tolerance window.
  2. anchor skeleton: the k-mer whose occurrence list best fits an
     arithmetic progression with the elected period becomes the segment
     anchor; missing units are interpolated, partial head/tail units kept.
  3. consensus: POA (ops/poa.py, spoa 10/-4/-8/-2/-24/-1 scoring) over the
     full-length units.

Stage 1 is O(L log L) host numpy (sort + windowed counting) -- cheap next
to consensus.  The batched consensus POA and every downstream alignment
ride the TPU kernels.
"""

from collections import Counter
from typing import Optional, Tuple

import numpy as np

from ciri_long_tpu_torch.ops.poa import poa
from ciri_long_tpu_torch.ops.traceback import banded_global_cigar
from ciri_long_tpu.utils.seq import decode_seq, encode_seq

K = 11                 # k-mer size for lag voting
MIN_PERIOD = 30        # circRNAs shorter than ~30 bp are dropped anyway
MIN_UNITS = 2.0        # need at least ~2 copies to call a repeat
MAX_POA_UNITS = 12     # voting accuracy saturates ~8-10 units deep


def _kmer_codes(codes: np.ndarray, k: int = K) -> Tuple[np.ndarray, np.ndarray]:
    """Packed k-mer integer codes and their start positions; k-mers touching
    a non-ACGT base are dropped."""
    L = len(codes)
    if L < k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    valid = codes < 4
    ok = np.ones(L - k + 1, bool)
    # a k-mer is valid iff all k bases are valid
    bad = ~valid
    if bad.any():
        cs = np.concatenate([[0], np.cumsum(bad)])
        ok = (cs[k:] - cs[:-k]) == 0
    pw = (4 ** np.arange(k, dtype=np.int64))
    km = np.zeros(L - k + 1, np.int64)
    c64 = codes.astype(np.int64)
    for t in range(k):
        km += np.where(ok, c64[t:L - k + 1 + t], 0) * pw[t]
    pos = np.nonzero(ok)[0]
    return km[pos], pos


def _lag_votes(km: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Distances between consecutive occurrences of identical k-mers."""
    if len(km) < 2:
        return np.zeros(0, np.int64)
    order = np.lexsort((pos, km))
    km_s, pos_s = km[order], pos[order]
    same = km_s[1:] == km_s[:-1]
    lags = pos_s[1:] - pos_s[:-1]
    return lags[same & (lags >= MIN_PERIOD)]


def _elect_period(lags: np.ndarray, L: int) -> Optional[int]:
    """Cluster lag votes with a relative window; return the fundamental
    period, or None when support is too weak."""
    if len(lags) == 0:
        return None
    lags = np.sort(lags)
    # support(l) = #votes within [0.94*l - 4, 1.06*l + 4]
    lo = np.searchsorted(lags, 0.94 * lags - 4, side='left')
    hi = np.searchsorted(lags, 1.06 * lags + 4, side='right')
    support = hi - lo
    best = int(support.max())
    min_support = max(8, 0.05 * L)
    if best < min_support:
        return None
    # prefer the smallest lag cluster whose support is close to the best
    # (the fundamental period rather than its harmonics)
    good = support >= max(min_support, 0.55 * best)
    cand = lags[good]
    cand_sup = support[good]
    p = int(cand[0])
    # a harmonic check: if ~half of p also clears the bar, it IS the
    # fundamental and the loop above already picked it (cand is sorted)
    # refine: median of the elected cluster
    sel = lags[(lags >= 0.94 * p - 4) & (lags <= 1.06 * p + 4)]
    del cand_sup
    return int(np.median(sel))


def _anchor_boundaries(km, pos, period: int, L: int):
    """Pick the anchor k-mer and lay out unit boundaries across the read."""
    if len(km) == 0:
        return None
    order = np.lexsort((pos, km))
    km_s, pos_s = km[order], pos[order]
    # run-length encode k-mer groups
    starts = np.nonzero(np.concatenate([[True], km_s[1:] != km_s[:-1]]))[0]
    ends = np.concatenate([starts[1:], [len(km_s)]])
    tol = max(6, int(0.08 * period))

    # score every k-mer group in one pass: within-group position deltas
    # that land within tol of the period, segment-summed via cumsum
    same = km_s[1:] == km_s[:-1]
    d = pos_s[1:] - pos_s[:-1]
    good = same & (np.abs(d - period) <= tol)
    cs = np.concatenate([[0], np.cumsum(good)])
    scores = cs[ends - 1] - cs[starts]          # sum of good[s:e-1]
    scores[ends - starts < 2] = -1
    best_score = int(scores.max()) if len(scores) else -1
    if best_score < 1:
        return None
    # ties: smallest first occurrence, then first group in k-mer order
    tied = np.nonzero(scores == best_score)[0]
    gi = tied[np.argmin(pos_s[starts[tied]])]
    best_occ = pos_s[starts[gi]:ends[gi]]

    # keep the longest chain of period-spaced occurrences
    occ = [int(best_occ[0])]
    for x in best_occ[1:]:
        gap = int(x) - occ[-1]
        if gap < 0.5 * period:
            continue
        occ.append(int(x))

    # phase-align the skeleton to the read origin so the first unit starts
    # at 0 (pyccs convention: segments '0-145;145-289;...'); the relative
    # anchor spacing still carries the indel drift correction
    shift = occ[0] % period
    occ = [x - shift for x in occ]

    # interpolate missing boundaries in big gaps
    bs = [occ[0]]
    for x in occ[1:]:
        base = bs[-1]
        gap = x - base
        m = int(round(gap / period))
        if m >= 2 and abs(gap - m * period) <= m * tol:
            step = gap / m
            for t in range(1, m):
                bs.append(int(round(base + t * step)))
        bs.append(x)

    # extend left to the read start
    while bs[0] >= 0.75 * period:
        bs.insert(0, max(0, bs[0] - period))
    if 0 < bs[0] < 0.25 * period:
        bs[0] = 0
    elif bs[0] > 0:
        bs.insert(0, 0)
    # extend right to the read end
    while L - bs[-1] >= 1.25 * period:
        bs.append(bs[-1] + period)
    if L - bs[-1] >= 15:
        bs.append(L)
    else:
        bs[-1] = L
    return bs


def star_rep_index(units):
    """Median-length representative index for center_star_consensus; the
    batched pipeline path uses this to stage the unit-vs-rep alignment
    jobs for one device dispatch (ops/nw_tb_batch.py)."""
    order = sorted(range(len(units)), key=lambda i: len(units[i]))
    return order[len(order) // 2]


def center_star_consensus(units, cigars=None):
    """Consensus of near-identical unit sequences by center-star alignment
    + per-column majority vote.

    Each unit is globally aligned (vectorised banded NW) to a
    median-length representative; votes are tallied per representative
    column (base / deletion) and per inter-column insertion slot.  This is
    the O(U x L) fast path of the pyccs replacement -- the full POA is kept
    for the spoa-parity consensus calls in collapse, but at rolling-circle
    depth a column vote is equally accurate and ~50x cheaper.
    Ties break toward the representative's own call.

    ``cigars`` optionally supplies precomputed banded_global_cigar cigars
    per unit (None at the representative's slot), as produced by the
    batched device path; entries must correspond to ``units`` AFTER
    empty-sequence filtering.
    """
    units = [np.asarray(u, np.int8) for u in units if len(u)]
    U = len(units)
    if U == 0:
        return np.zeros(0, np.int8)
    if U == 1:
        return units[0]
    if cigars is None:
        # host fast path: the whole star (NW per unit + votes + insertion
        # slots) in one C++ call (nwcore.cpp::py_center_star; parity fuzz
        # in tests/test_ccs.py)
        try:
            from ciri_long_tpu import _nwcore
            native = getattr(_nwcore, 'center_star', None)
        except ImportError:
            native = None
        if native is not None:
            offs = np.zeros(U + 1, np.int64)
            offs[1:] = np.cumsum([len(u) for u in units])
            buf = native(
                np.ascontiguousarray(np.concatenate(units), np.int8), offs,
                2, 4, 4, 2)
            return np.frombuffer(buf, np.int8).copy()
    rep_i = star_rep_index(units)
    rep = units[rep_i]
    n = len(rep)

    DEL = -1
    base_mat = np.full((U, n), DEL, np.int8)
    inserts = [dict() for _ in range(U)]   # slot p -> inserted codes

    for ui, u in enumerate(units):
        if ui == rep_i:
            base_mat[ui] = rep
            continue
        if cigars is not None and cigars[ui] is not None:
            cigar = cigars[ui]
        else:
            _, cigar = banded_global_cigar(u, rep)
        qi = ri = 0
        for length, op in cigar:
            if op == 0:
                base_mat[ui, ri:ri + length] = u[qi:qi + length]
                qi += length
                ri += length
            elif op == 1:
                inserts[ui][ri] = u[qi:qi + length]
                qi += length
            elif op in (2, 3):
                ri += length

    # per-column vote over {A, C, G, T, N, deletion}
    counts = np.zeros((6, n), np.int32)
    for v in range(5):
        counts[v] = (base_mat == v).sum(axis=0)
    counts[5] = (base_mat == DEL).sum(axis=0)
    # representative tie-break: its own call gets +1 half-vote (doubled)
    counts2 = counts * 2
    counts2[rep, np.arange(n)] += 1
    winner = np.argmax(counts2, axis=0)

    # insertion slots: majority of units must insert at a slot
    ins_len = np.zeros((U, n + 1), np.int16)
    for ui in range(U):
        for p, seq_ins in inserts[ui].items():
            ins_len[ui, p] = len(seq_ins)
    ins_support = (ins_len > 0).sum(axis=0)

    keep = winner < 5
    qual = np.nonzero(ins_support * 2 > U)[0]
    base_cons = winner.astype(np.int8)
    if len(qual) == 0:
        # fast path (insertion consensus is rare at rolling-circle depth)
        if not keep.any():
            return rep
        return base_cons[keep]

    # slot-p insertions precede column p's base call
    pieces = []
    prev = 0
    for p in qual:
        seg = base_cons[prev:p][keep[prev:p]]
        if len(seg):
            pieces.append(seg)
        lens = [int(x) for x in ins_len[:, p] if x > 0]
        mode = Counter(lens).most_common(1)[0][0]
        for ui in range(U):
            if ins_len[ui, p] == mode:
                pieces.append(np.asarray(inserts[ui][p], np.int8))
                break
        prev = p
    seg = base_cons[prev:n][keep[prev:n]]
    if len(seg):
        pieces.append(seg)
    if not pieces:
        return rep
    return np.concatenate(pieces).astype(np.int8)


def detect_units(codes, k: int = K):
    """Tandem-repeat detection half of find_consensus: period election +
    anchor segmentation, no consensus yet.  Returns None when the read is
    not a rolling-circle candidate, else (period, segments, units) with
    segments/units as (start, end) pairs (units = the consensus-eligible
    subset).  Native C++ core when built (native/ccscore.cpp, parity fuzz
    in tests/test_ccs.py); numpy cascade fallback below."""
    L = len(codes)
    if L < 2 * MIN_PERIOD:
        return None

    try:
        from ciri_long_tpu import _ccscore
    except ImportError:
        _ccscore = None
    if _ccscore is not None:
        hit = _ccscore.detect(
            np.ascontiguousarray(codes, np.uint8).tobytes(), k,
            MIN_PERIOD, MIN_UNITS)
        if hit is None:
            return None
        period, bs_raw = hit
        bs = [int(x) for x in np.frombuffer(bs_raw, np.int64)]
        if len(bs) < 3:
            return None
        segments = list(zip(bs[:-1], bs[1:]))
        units = [(st, en) for st, en in segments
                 if 0.75 * period <= en - st <= 1.35 * period]
        if len(units) < 2:
            return None
        return period, segments, units

    km, pos = _kmer_codes(codes, k)
    lags = _lag_votes(km, pos)
    # only periods that fit at least MIN_UNITS copies matter
    lags = lags[lags <= L / MIN_UNITS]
    period = _elect_period(lags, L)
    if period is None or L < MIN_UNITS * period:
        return None

    bs = _anchor_boundaries(km, pos, period, L)
    if bs is None or len(bs) < 3:
        return None

    segments = list(zip(bs[:-1], bs[1:]))
    units = [(st, en) for st, en in segments
             if 0.75 * period <= en - st <= 1.35 * period]
    if len(units) < 2:
        return None
    return period, segments, units


def find_consensus(seq, k: int = K, star_cigars=None, det=None):
    """Tandem-repeat detection + cyclic consensus.

    Accepts an ASCII string (returns str results, pyccs-compatible) or an
    int8 code array (returns arrays).  ``star_cigars`` optionally injects
    precomputed center-star cigars and ``det`` a precomputed
    detect_units() result (the batched device path,
    pipeline/find_ccs.py); byte-identical either way.
    """
    as_str = isinstance(seq, str)
    codes = encode_seq(seq) if as_str else np.asarray(seq, np.int8)
    if det is None:
        det = detect_units(codes, k)
    if det is None:
        return None, None
    period, segments, units = det

    cons_units = [codes[st:en] for st, en in units[:MAX_POA_UNITS]]
    if len(cons_units) >= 3:
        cons = center_star_consensus(cons_units, cigars=star_cigars)
    else:
        # at 2-unit depth a column vote has no majority; the POA with the
        # partial head/tail fragments included breaks the ties (pyccs's
        # POA input includes the trailing fragment too, reference
        # tests/test_poa.py:15,27)
        partials = [(st, en) for st, en in segments
                    if (st, en) not in units and en - st >= 0.2 * period]
        poa_units = cons_units + [codes[st:en] for st, en in partials[:4]]
        cons, _ = poa(poa_units)
    if len(cons) < MIN_PERIOD:
        return None, None

    seg_str = ';'.join('{}-{}'.format(st, en) for st, en in segments)
    if as_str:
        return seg_str, decode_seq(cons)
    return seg_str, cons
