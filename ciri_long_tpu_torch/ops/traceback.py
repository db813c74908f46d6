"""Host-side traceback DP for cigar generation.

The device kernels (ops/sw.py) produce scores and coordinates for the bulk
filtering decisions; cigars are only materialised for the few survivors
(e.g. the ~100 bp junction-window alignment whose cigar feeds
find_alignment_pos, reference collapse.py:373-382, align.py:799-820).
These windows are tiny, and cigar strings are variable-length host objects,
so the traceback runs in numpy on host -- the analog of the reference's
``banded_sw`` (ssw.c:548-735) which likewise re-runs a small banded DP on
CPU after the SIMD score pass.

Cigar operations follow align.py:11-30: 0=M 1=I 2=D 3=N 4=S (I consumes
query, D/N consume reference).
"""

from typing import List, Tuple

import numpy as np

try:
    from ciri_long_tpu_torch import _alncore as _NATIVE
except ImportError:
    _NATIVE = None

NEG = -(1 << 28)


def _score_matrix(match, mismatch):
    m = np.full((6, 6), -mismatch, np.int32)
    np.fill_diagonal(m, match)
    m[4, :] = 0
    m[:, 4] = 0
    m[5, :] = NEG
    m[:, 5] = NEG
    return m


def sw_traceback(q: np.ndarray, r: np.ndarray, match=1, mismatch=1,
                 gap_open=1, gap_extend=1):
    """Full affine-gap local alignment with traceback.

    Args: encoded int arrays (codes 0..4).
    Returns (score, q_begin, q_end, r_begin, r_end, cigar) with inclusive
    ends and cigar a list of (length, op) covering q_begin..q_end (no
    soft-clips included).
    Returns None when no positive-scoring cell exists.
    """
    if _NATIVE is not None:
        ret = _NATIVE.sw_traceback(
            np.ascontiguousarray(np.asarray(q, np.int8)),
            np.ascontiguousarray(np.asarray(r, np.int8)),
            match, mismatch, gap_open, gap_extend)
        if ret is None:
            return None
        score, qb, qe, rb, re_, cig = ret
        packed = np.frombuffer(cig, np.uint32)
        cigar = [(int(x) >> 4, int(x) & 0xF) for x in packed]
        return score, qb, qe, rb, re_, cigar

    q = np.asarray(q, np.int32)
    r = np.asarray(r, np.int32)
    n, m = len(q), len(r)
    if n == 0 or m == 0:
        return None
    S = _score_matrix(match, mismatch)
    sub = S[q[:, None], r[None, :]]  # [n, m]

    H = np.zeros((n + 1, m + 1), np.int32)
    E = np.full((n + 1, m + 1), NEG, np.int32)   # gap in ref direction (consumes r)
    F = np.full((n + 1, m + 1), NEG, np.int32)   # gap consuming q
    for i in range(1, n + 1):
        E[i, 1:] = 0  # filled in loop
        e = NEG
        Hrow_m1 = H[i - 1]
        Frow = np.maximum(F[i - 1, 1:] - gap_extend, Hrow_m1[1:] - gap_open)
        F[i, 1:] = Frow
        diag = Hrow_m1[:-1] + sub[i - 1]
        h = np.maximum(np.maximum(diag, Frow), 0)
        # E within-row: sequential but vectorized via prefix-max identity
        jj = np.arange(m)
        p = np.maximum.accumulate(h + jj * gap_extend)
        Erow = np.empty(m, np.int32)
        Erow[0] = NEG
        Erow[1:] = p[:-1] - gap_open - (jj[1:] - 1) * gap_extend
        E[i, 1:] = Erow
        H[i, 1:] = np.maximum(h, Erow)

    score = int(H.max())
    if score <= 0:
        return None
    # earliest ref end, then earliest query end among max cells
    cells = np.argwhere(H == score)
    cells = cells[np.lexsort((cells[:, 0], cells[:, 1]))]
    i_end, j_end = int(cells[0][0]), int(cells[0][1])

    # Traceback by local recomputation of which move produced each cell.
    ops: List[Tuple[int, int]] = []
    i, j = i_end, j_end

    def push(op):
        if ops and ops[-1][1] == op:
            ops[-1] = (ops[-1][0] + 1, op)
        else:
            ops.append((1, op))

    state = 'H'
    while i > 0 and j > 0:
        if state == 'H':
            if H[i, j] == 0:
                break
            if H[i, j] == H[i - 1, j - 1] + sub[i - 1, j - 1]:
                push(0); i -= 1; j -= 1
            elif H[i, j] == E[i, j]:
                state = 'E'
            elif H[i, j] == F[i, j]:
                state = 'F'
            else:  # should not happen
                break
        elif state == 'E':
            push(2)
            stay = j > 1 and E[i, j] == E[i, j - 1] - gap_extend and \
                E[i, j] != H[i, j - 1] - gap_open
            j -= 1
            if not stay:
                state = 'H'
        else:
            push(1)
            stay = i > 1 and F[i, j] == F[i - 1, j] - gap_extend and \
                F[i, j] != H[i - 1, j] - gap_open
            i -= 1
            if not stay:
                state = 'H'
    ops.reverse()
    return score, i, i_end - 1, j, j_end - 1, ops


def cigar_to_string(cigar) -> str:
    table = 'MIDNSHP=X'
    return ''.join('{}{}'.format(l, table[op]) for l, op in cigar)


def banded_global_cigar(q: np.ndarray, r: np.ndarray, band=None,
                        match=2, mismatch=4, gap_open=4, gap_extend=2):
    """Banded global (Needleman-Wunsch) alignment with affine gaps.

    Used by the seed-chain aligner to stitch the inter-anchor gaps into a
    cigar (the role minimap2's ksw2 extension plays for the reference's
    mappy hits).  Band defaults to |len(q) - len(r)| + 16, doubled until the
    optimum is stable -- the reference's banded_sw uses the same
    band-doubling idea (ssw.c:571-633).

    Returns (score, cigar) aligning ALL of q to ALL of r.
    """
    q = np.asarray(q, np.int32)
    r = np.asarray(r, np.int32)
    n, m = len(q), len(r)
    if n == 0:
        return 0, ([(m, 2)] if m else [])
    if m == 0:
        return 0, [(n, 1)]
    if band is None:
        band = abs(n - m) + 16
    S = _score_matrix(match, mismatch)

    # native banded core with band doubling (the hot host path: CCS unit
    # consensus, inter-anchor stitches)
    native = _nw_native(q, r, band, match, mismatch, gap_open, gap_extend)
    if native is not None:
        return native

    # small problems: exact full-matrix DP with numpy-vectorised rows (the
    # common inter-anchor stitch is well under this bound)
    if n * m <= 4_000_000:
        return _nw_full_vec(q, r, S, gap_open, gap_extend)

    while True:
        res = _banded_nw(q, r, band, S, gap_open, gap_extend)
        if res is not None:
            score, cigar = res
            if band >= max(n, m):
                return score, cigar
            # verify stability by doubling once
            res2 = _banded_nw(q, r, min(2 * band, max(n, m)), S, gap_open, gap_extend)
            if res2 is not None and res2[0] == score:
                return score, cigar
            band = min(2 * band, max(n, m))
            if res2 is not None and band >= max(n, m):
                return res2
        else:
            band *= 2
            if band > max(n, m) + 1:
                band = max(n, m)


def extend_align(q: np.ndarray, r: np.ndarray, match=2, mismatch=4,
                 gap_open=4, gap_extend=2, zdrop=100):
    """Extension alignment: anchored at (0, 0), ends wherever the score is
    maximal (the role ksw2's extension mode plays for minimap2's soft-clip
    decisions).  Greedy z-drop: rows stop contributing once the running best
    falls more than ``zdrop`` behind.

    Most extensions either reach the sequence end quickly or z-drop within
    tens of rows, so the DP first runs in a small window and only widens if
    the best cell hits the window edge.

    Returns (score, q_len_used, r_len_used, cigar) -- the cigar covers
    q[0:q_len_used] vs r[0:r_len_used]; (0, 0, 0, []) if extension is
    immediately unprofitable.
    """
    q = np.asarray(q, np.int32)
    r = np.asarray(r, np.int32)
    n, m = len(q), len(r)
    if n == 0 or m == 0:
        return 0, 0, 0, []

    try:
        from ciri_long_tpu_torch import _nwcore
        score, qi, rj, cig = _nwcore.extend(
            np.ascontiguousarray(q, np.uint8).tobytes(),
            np.ascontiguousarray(r, np.uint8).tobytes(),
            match, mismatch, gap_open, gap_extend, zdrop)
        return int(score), int(qi), int(rj), _decode_cigar_u32(cig)
    except ImportError:
        pass

    n1 = min(n, 192)
    m1 = min(m, n1 + 64)
    res = _extend_core(q[:n1], r[:m1], match, mismatch, gap_open,
                       gap_extend, zdrop)
    if res is None:
        return 0, 0, 0, []
    best, bi, bj, H, E, F = res
    if (bi >= n1 - 4 or bj >= m1 - 4) and (n > n1 or m > m1):
        res = _extend_core(q, r, match, mismatch, gap_open, gap_extend, zdrop)
        if res is None:
            return 0, 0, 0, []
        best, bi, bj, H, E, F = res

    ops = []

    def push(op):
        if ops and ops[-1][1] == op:
            ops[-1] = (ops[-1][0] + 1, op)
        else:
            ops.append((1, op))

    i, j = bi, bj
    state = 'H'
    while i > 0 or j > 0:
        if state == 'H':
            if j > 0 and H[i, j] == E[i, j]:
                state = 'E'
            elif i > 0 and H[i, j] == F[i, j]:
                state = 'F'
            elif i > 0 and j > 0:
                push(0); i -= 1; j -= 1
            elif j > 0:
                push(2); j -= 1
            else:
                push(1); i -= 1
        elif state == 'E':
            push(2)
            stay = j > 1 and E[i, j] == E[i, j - 1] - gap_extend
            j -= 1
            if not stay:
                state = 'H'
        else:
            push(1)
            stay = i > 1 and F[i, j] == F[i - 1, j] - gap_extend
            i -= 1
            if not stay:
                state = 'H'
    ops.reverse()
    return int(best), bi, bj, ops


def _extend_core(q, r, match, mismatch, gap_open, gap_extend, zdrop):
    """Row DP for extend_align; returns (best, bi, bj, H, E, F) or None.
    Matrices are np.empty with only the touched region initialised (the
    traceback never leaves the computed rows)."""
    n, m = len(q), len(r)
    S = _score_matrix(match, mismatch)
    H = np.empty((n + 1, m + 1), np.int64)
    E = np.empty((n + 1, m + 1), np.int64)
    F = np.empty((n + 1, m + 1), np.int64)
    jj = np.arange(m + 1, dtype=np.int64)
    H[0, 0] = 0
    H[0, 1:] = -gap_open - (jj[1:] - 1) * gap_extend
    E[:, 0] = NEG
    E[0, 1:] = H[0, 1:]
    F[0, :] = NEG
    best, bi, bj = 0, 0, 0
    for i in range(1, n + 1):
        H[i, 0] = -gap_open - (i - 1) * gap_extend
        F[i, 0] = H[i, 0]
        Frow = np.maximum(F[i - 1, 1:] - gap_extend, H[i - 1, 1:] - gap_open)
        F[i, 1:] = Frow
        diag = H[i - 1, :-1] + S[q[i - 1]][r]
        hpre = np.concatenate([[H[i, 0]], np.maximum(diag, Frow)])
        p = np.maximum.accumulate(hpre + jj * gap_extend)
        Erow = E[i]
        Erow[1:] = p[:-1] - gap_open - (jj[1:] - 1) * gap_extend
        Hrow = np.maximum(hpre, Erow)
        Hrow[0] = H[i, 0]
        H[i] = Hrow
        rb = int(Hrow.max())
        if rb > best:
            best = rb
            bi = i
            bj = int(np.argmax(Hrow))
        elif best - rb > zdrop:
            break
    if best <= 0:
        return None
    return best, bi, bj, H, E, F


def _decode_cigar_u32(buf):
    arr = np.frombuffer(buf, np.uint32)
    return [(int(x >> 4), int(x & 0xf)) for x in arr]


def _nw_native(q, r, band, match, mismatch, gap_open, gap_extend):
    """C++ banded NW (native/nwcore.cpp) with band doubling until the score
    is stable; None when the extension is unavailable."""
    try:
        from ciri_long_tpu_torch import _nwcore
    except ImportError:
        return None
    n, m = len(q), len(r)
    qb = np.ascontiguousarray(q, np.uint8).tobytes()
    rb = np.ascontiguousarray(r, np.uint8).tobytes()
    big = max(n, m)

    def run(b):
        return _nwcore.nw_banded(qb, rb, int(b), match, mismatch,
                                 gap_open, gap_extend)

    res = run(band)
    while True:
        if band >= big:
            if res is None:
                res = run(big)
            return (None if res is None
                    else (int(res[0]), _decode_cigar_u32(res[1])))
        nxt_band = min(2 * band, big)
        nxt = run(nxt_band)
        if res is not None and nxt is not None and nxt[0] == res[0]:
            return int(res[0]), _decode_cigar_u32(res[1])
        band, res = nxt_band, nxt


def _nw_matrix(q, r, S, gap_open, gap_extend):
    """Global-alignment prefix-score matrix H[a, j] = best score aligning
    q[:a] to r[:j] (numpy-vectorised rows, same recurrences as
    _nw_full_vec)."""
    n, m = len(q), len(r)
    H = np.full((n + 1, m + 1), NEG, np.int64)
    F = np.full((n + 1, m + 1), NEG, np.int64)
    jj = np.arange(m + 1, dtype=np.int64)
    H[0, 0] = 0
    H[0, 1:] = -gap_open - (jj[1:] - 1) * gap_extend
    sub = S[q[:, None], r[None, :]] if n and m else np.zeros((n, m), np.int64)
    for i in range(1, n + 1):
        H[i, 0] = -gap_open - (i - 1) * gap_extend
        F[i, 0] = H[i, 0]
        Frow = np.maximum(F[i - 1, 1:] - gap_extend, H[i - 1, 1:] - gap_open)
        F[i, 1:] = Frow
        diag = H[i - 1, :-1] + sub[i - 1]
        hpre = np.concatenate([[H[i, 0]], np.maximum(diag, Frow)])
        p = np.maximum.accumulate(hpre + jj * gap_extend)
        Erow = np.empty(m + 1, np.int64)
        Erow[0] = NEG
        Erow[1:] = p[:-1] - gap_open - (jj[1:] - 1) * gap_extend
        H[i] = np.maximum(hpre, Erow)
    return H


def splice_junction_align(qg, ref_gap, intron_len, match=2, mismatch=4,
                          gap_open=4, gap_extend=2, bonus=6):
    """Place an intron of length ``intron_len`` inside ``ref_gap`` while
    aligning the query gap ``qg`` across it WITH gaps (the ungapped
    prefix/suffix vote misplaces junctions whenever the consensus carries
    an indel near the boundary).

    For every (query split a, ref split j): score = H_left[a, j] +
    H_right[L-a, L-j] where the H matrices are global prefix-score
    matrices of the donor/acceptor flanks; canonical splice motifs
    (GT..AG or its minus-strand image CT..AC) at (j, j+G) earn ``bonus``.

    Returns (cigar) covering qg against ref_gap including the N op.
    """
    qg = np.asarray(qg, np.int32)
    ref_gap = np.asarray(ref_gap, np.int32)
    L = len(qg)
    G = int(intron_len)
    if L == 0:
        return [(G, 3)] if G else []
    S = _score_matrix(match, mismatch)
    ref_left = ref_gap[:L]
    ref_right = ref_gap[G:]

    try:
        from ciri_long_tpu_torch import _nwcore

        def _pm(a, b):
            buf = _nwcore.prefix_matrix(
                np.ascontiguousarray(a, np.uint8).tobytes(),
                np.ascontiguousarray(b, np.uint8).tobytes(),
                match, mismatch, gap_open, gap_extend)
            return np.frombuffer(buf, np.int32).reshape(len(a) + 1,
                                                        len(b) + 1)
        Hl = _pm(qg, ref_left)
        Hr = _pm(qg[::-1], ref_right[::-1])
    except ImportError:
        Hl = _nw_matrix(qg, ref_left, S, gap_open, gap_extend)
        Hr = _nw_matrix(qg[::-1], ref_right[::-1], S, gap_open, gap_extend)
    M = Hl + Hr[::-1, ::-1]
    col_best = M.max(axis=0)

    if G >= 4:
        don1 = ref_gap[0:L + 1]
        don2 = ref_gap[1:L + 2]
        acc1 = ref_gap[G - 2:G - 2 + L + 1]
        acc2 = ref_gap[G - 1:G - 1 + L + 1]
        gt_ag = (don1 == 2) & (don2 == 3) & (acc1 == 0) & (acc2 == 2)
        ct_ac = (don1 == 1) & (don2 == 3) & (acc1 == 0) & (acc2 == 1)
        col_best = col_best + bonus * (gt_ag | ct_ac)

    j_star = int(np.argmax(col_best))
    a_star = int(np.argmax(M[:, j_star]))

    cigar = []

    def emit(op, length):
        if length <= 0:
            return
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + length, op)
        else:
            cigar.append((length, op))

    if a_star > 0 or j_star > 0:
        _, left_cig = banded_global_cigar(qg[:a_star], ref_left[:j_star],
                                          match=match, mismatch=mismatch,
                                          gap_open=gap_open,
                                          gap_extend=gap_extend)
        for l, op in left_cig:
            emit(op, l)
    emit(3, G)
    if a_star < L or j_star < L:
        _, right_cig = banded_global_cigar(qg[a_star:], ref_right[j_star:],
                                           match=match, mismatch=mismatch,
                                           gap_open=gap_open,
                                           gap_extend=gap_extend)
        for l, op in right_cig:
            emit(op, l)
    return cigar


def _nw_full_vec(q, r, S, gap_open, gap_extend):
    """Global affine NW with numpy-vectorised rows; within-row E via the
    prefix-max identity (exact for gap_open >= gap_extend, the only regime
    the pipeline uses -- see ops/sw.py)."""
    n, m = len(q), len(r)
    H = np.full((n + 1, m + 1), NEG, np.int32)
    E = np.full((n + 1, m + 1), NEG, np.int32)
    F = np.full((n + 1, m + 1), NEG, np.int32)
    jj = np.arange(m + 1, dtype=np.int32)
    H[0, 0] = 0
    H[0, 1:] = -gap_open - (jj[1:] - 1) * gap_extend
    E[0, 1:] = H[0, 1:]
    sub = S[q[:, None], r[None, :]].astype(np.int32)
    for i in range(1, n + 1):
        H[i, 0] = -gap_open - (i - 1) * gap_extend
        F[i, 0] = H[i, 0]
        Frow = np.maximum(F[i - 1, 1:] - gap_extend, H[i - 1, 1:] - gap_open)
        F[i, 1:] = Frow
        diag = H[i - 1, :-1] + sub[i - 1]
        hpre = np.concatenate([[H[i, 0]], np.maximum(diag, Frow)])
        p = np.maximum.accumulate(hpre + jj * gap_extend)
        Erow = np.empty(m + 1, np.int32)
        Erow[0] = NEG
        Erow[1:] = p[:-1] - gap_open - (jj[1:] - 1) * gap_extend
        E[i] = Erow
        H[i] = np.maximum(hpre, Erow)
    score = int(H[n, m])

    ops = []
    i, j = n, m

    def push(op):
        if ops and ops[-1][1] == op:
            ops[-1] = (ops[-1][0] + 1, op)
        else:
            ops.append((1, op))

    state = 'H'
    while i > 0 or j > 0:
        if state == 'H':
            if j > 0 and H[i, j] == E[i, j]:
                state = 'E'
            elif i > 0 and H[i, j] == F[i, j]:
                state = 'F'
            elif i > 0 and j > 0:
                push(0); i -= 1; j -= 1
            elif j > 0:
                push(2); j -= 1
            else:
                push(1); i -= 1
        elif state == 'E':
            push(2)
            stay = j > 1 and E[i, j] == E[i, j - 1] - gap_extend
            j -= 1
            if not stay:
                state = 'H'
        else:
            push(1)
            stay = i > 1 and F[i, j] == F[i - 1, j] - gap_extend
            i -= 1
            if not stay:
                state = 'H'
    ops.reverse()
    return score, ops


def _banded_nw(q, r, band, S, gap_open, gap_extend):
    n, m = len(q), len(r)
    H = np.full((n + 1, m + 1), NEG, np.int64)
    E = np.full((n + 1, m + 1), NEG, np.int64)
    F = np.full((n + 1, m + 1), NEG, np.int64)
    H[0, 0] = 0
    top = min(m, band)
    H[0, 1:top + 1] = -gap_open - (np.arange(top)) * gap_extend
    E[0, 1:top + 1] = H[0, 1:top + 1]
    for i in range(1, n + 1):
        lo = max(1, i - band)
        hi = min(m, i + band)
        if lo > hi:
            return None
        if i - band <= 0:
            H[i, 0] = -gap_open - (i - 1) * gap_extend
            F[i, 0] = H[i, 0]
        for j in range(lo, hi + 1):
            e = max(E[i, j - 1] - gap_extend, H[i, j - 1] - gap_open)
            f = max(F[i - 1, j] - gap_extend, H[i - 1, j] - gap_open)
            h = max(H[i - 1, j - 1] + S[q[i - 1], r[j - 1]], e, f)
            E[i, j] = e
            F[i, j] = f
            H[i, j] = h
    if H[n, m] <= NEG // 2:
        return None

    ops = []
    i, j = n, m

    def push(op):
        if ops and ops[-1][1] == op:
            ops[-1] = (ops[-1][0] + 1, op)
        else:
            ops.append((1, op))

    state = 'H'
    while i > 0 or j > 0:
        if state == 'H':
            if j > 0 and H[i, j] == E[i, j]:
                state = 'E'
            elif i > 0 and H[i, j] == F[i, j]:
                state = 'F'
            elif i > 0 and j > 0:
                push(0); i -= 1; j -= 1
            elif j > 0:
                push(2); j -= 1
            else:
                push(1); i -= 1
        elif state == 'E':
            push(2)
            stay = j > 1 and E[i, j] == E[i, j - 1] - gap_extend
            j -= 1
            if not stay:
                state = 'H'
        else:
            push(1)
            stay = i > 1 and F[i, j] == F[i - 1, j] - gap_extend
            i -= 1
            if not stay:
                state = 'H'
    ops.reverse()
    return int(H[n, m]), ops
