"""Seeded SW inputs that put the optimum where reference tiles can go wrong.

``tile_cases`` makes the rows that hold the tiled route of
csrc/sw_score_ends.cu (ops/sw.py::_tile_plan: tiles of T owned columns,
each swept from a halo before it) to the plain scorer: an exact query copy
across a tile edge, the widest gapped copy that still beats its pieces,
equal-score twins in two tiles (the smaller r_end must win), N and PAD
runs at tile edges, all-PAD references and queries, random codes with PAD
suffixes, and a copy across the last, partial tile's edge.

``tile_edge_cases`` makes the rows that hold the tiles' schedule (each
tile's warp over strips of 32*R query rows, cut to its window's real
width): one row for each real query length asked for, a copy of the query
planted at a tile edge, every other row cut by a PAD suffix; references
whose real length ends inside a tile's window, at a window's end, at its
start and before it (the later tiles do no sweep); all-PAD rows, N rows
and a mid-row PAD; equal-score twins in two tiles and, from a homopolymer
one code longer in the query than in the reference, in neighbouring query
rows (two lanes' rows, or one lane's R rows).

``wave_cases`` makes the rows that hold the wavefront route (a block of K
warps per row, each over strips of 32*R query rows, each row swept only to
its real lengths): one row for every real query length in ``WAVE_LQ`` (the
edges of a lane's R rows, of a strip and of a group of K strips, for R in
1, 2, 4 and K in 2, 4, 8), rows with N, a mid-row PAD, an all-PAD query or
reference, and equal-score twins in strips far apart (across warps and
groups), all under one padded shape.

``chain_cases`` makes the jobs that hold the chained wavefront
(csrc/sw_chain.cu: C jobs' references back to back behind boundary codes):
the best cell in a job's last column, just before the next boundary, and
in its first, just after one; all-PAD references and queries; equal-score
twins; N rows; random codes with PAD suffixes.  The CPU tests, the card's
tests and chip_smoke.py share them.
"""

import numpy as np

N = 4
PAD = 5
KINDS = ('edge', 'gapped', 'twins', 'n_pad', 'pad_ref', 'pad_query',
         'random', 'last_edge')
# real query lengths at every edge of the wavefront's schedule
WAVE_LQ = tuple(sorted(
    {1, 31, 32, 33}
    | {32 * R + d for R in (1, 2, 4) for d in (-1, 1)}
    | {32 * R * K + d for R in (1, 2, 4) for K in (2, 4, 8)
       for d in (-1, 1, 33)}))
# reference widths: one column, one chunk and one column either side of
# two, and a few chunks
WAVE_LR = (1, 63, 64, 65, 130)
WAVE_SPECIAL = ('mid_pad', 'pad_query', 'pad_ref', 'twins', 'n_rows')
TILE_SPECIAL = ('lr_inside', 'lr_at_end', 'lr_at_start', 'lr_before',
                'pad_ref', 'pad_query', 'n_rows', 'mid_pad', 'twins_tiles',
                'twins_rows')
CHAIN_KINDS = ('last_col', 'first_col', 'pad_ref', 'pad_query', 'twins',
               'n_rows', 'random')


def _gap(piece, params):
    """The widest gap, in reference columns, that a junction between two
    exact pieces of ``piece`` codes still pays for:
    gap_open + (g-1)*gap_extend < piece*match; 0 when none does."""
    room = piece * params.match - params.gap_open
    if room <= 0:
        return 0
    return (room - 1) // params.gap_extend + 1


def _place(r, start, codes):
    """Write ``codes`` into r from ``start``, clamped to lie inside r."""
    start = int(min(max(start, 0), len(r) - len(codes)))
    r[start:start + len(codes)] = codes
    return start


def _gapped(rng, q, params):
    """q in about five exact pieces with the widest paying gap of random
    codes between each two: a plant whose span nears Lq + Lq*match/gE."""
    Lq = len(q)
    piece = max(1, Lq // 5)
    g = _gap(piece, params)
    cuts = list(range(piece, Lq, piece))
    parts = np.split(q, cuts)
    out = []
    for t, part in enumerate(parts):
        if t:
            out.append(rng.integers(0, 4, g).astype(np.int8))
        out.append(part)
    return np.concatenate(out)


def tile_cases(rng, B, Lq, Lr, T, params):
    """[B, Lq] queries and [B, Lr] references, int8 codes; row b is of kind
    KINDS[b % len(KINDS)], planted around the tile edges k*T."""
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    r = rng.integers(0, 4, (B, Lr)).astype(np.int8)
    edges = list(range(T, Lr, T)) or [Lr // 2]
    for b in range(B):
        kind = KINDS[b % len(KINDS)]
        e = int(rng.choice(edges))
        if kind == 'edge' and Lq <= Lr:
            _place(r[b], e - int(rng.integers(0, Lq)), q[b])
        elif kind == 'gapped':
            plant = _gapped(rng, q[b], params)
            if len(plant) <= Lr:
                _place(r[b], e + int(rng.integers(0, 8)) - len(plant) + 1,
                       plant)
        elif kind == 'twins' and 2 * Lq <= Lr:
            first = _place(r[b], int(rng.integers(0, max(1, e - Lq))), q[b])
            later = [x for x in edges if x >= first + Lq] or [first + Lq]
            _place(r[b], max(int(rng.choice(later)) - Lq // 2, first + Lq),
                   q[b])
        elif kind == 'n_pad':
            if Lq <= Lr:
                _place(r[b], e - Lq // 2, q[b])
            q[b, Lq // 3:Lq // 3 + 2] = N
            r[b, max(0, e - 3):e + 3] = N
            e2 = int(rng.choice(edges))
            r[b, max(0, e2 - 2):e2 + 2] = PAD
        elif kind == 'pad_ref':
            r[b] = PAD
        elif kind == 'pad_query':
            q[b] = PAD
        elif kind == 'random':
            q[b] = rng.integers(0, 5, Lq)
            r[b] = rng.integers(0, 5, Lr)
            q[b, int(rng.integers(1, Lq + 1)):] = PAD
            r[b, int(rng.integers(Lr // 2, Lr + 1)):] = PAD
        elif kind == 'last_edge' and Lq <= Lr:
            _place(r[b], edges[-1] - Lq // 2, q[b])
    return q, r


def tile_edge_cases(rng, lqs, Lq, Lr, T, halo):
    """[B, Lq] queries and [B, Lr] references, int8 codes: one row for each
    real query length of ``lqs`` (random codes 0-4, PAD past it; the query
    copied across a tile edge k*T; every other row with a random reference
    PAD suffix), then one row of each TILE_SPECIAL kind at the full length.
    The window of tile k is [max(0, k*T - halo), min((k+1)*T, Lr))."""
    rows = len(lqs) + len(TILE_SPECIAL)
    q = np.full((rows, Lq), PAD, np.int8)
    r = rng.integers(0, 5, (rows, Lr)).astype(np.int8)
    tiles = -(-Lr // T)
    for b, lq in enumerate(lqs):
        q[b, :lq] = rng.integers(0, 5, lq)
        e = T * int(rng.integers(1, tiles))
        _place(r[b], e - int(rng.integers(0, lq)), q[b, :lq])
        if b % 2:
            r[b, int(rng.integers(1, Lr + 1)):] = PAD
    for t, kind in enumerate(TILE_SPECIAL):
        b = len(lqs) + t
        q[b] = rng.integers(0, 5, Lq)
        k = int(rng.integers(1, tiles - 1)) if tiles > 2 else 1
        start, end = max(0, k * T - halo), min((k + 1) * T, Lr)
        cut = {'lr_inside': (start + end) // 2, 'lr_at_end': end,
               'lr_at_start': start,
               'lr_before': max(1, start - int(rng.integers(1, T)))}.get(kind)
        if cut is not None:
            _place(r[b], cut - Lq, q[b])
            r[b, cut:] = PAD
        elif kind == 'pad_ref':
            r[b] = PAD
        elif kind == 'pad_query':
            q[b] = PAD
        elif kind == 'n_rows':
            q[b] = N
            r[b] = N
            q[b, ::5] = rng.integers(0, 4, len(q[b, ::5]))
            r[b, ::3] = rng.integers(0, 4, len(r[b, ::3]))
        elif kind == 'mid_pad':
            _place(r[b], end - Lq // 2, q[b])
            q[b, Lq // 2] = PAD
            r[b, end - 1] = PAD
        elif kind == 'twins_tiles':
            m = max(1, min(24, Lq, T // 2))
            motif = rng.integers(0, 4, m).astype(np.int8)
            q[b] = N
            r[b] = N
            _place(q[b], Lq - m, motif)
            _place(r[b], k * T - m // 2, motif)
            _place(r[b], (k + 1) * T + T // 2, motif)
        elif kind == 'twins_rows':
            m = max(1, min(8, Lq - 3))
            q[b] = N
            r[b] = N
            run = min(m + 3, Lq)
            q[b, Lq - run:] = 0
            _place(r[b], k * T, np.zeros(m, np.int8))
    return q, r


def wave_cases(rng, Lr, lqs=WAVE_LQ):
    """[B, max(lqs)] queries and [B, Lr] references, int8 codes PAD
    suffixed: one row of random codes 0-4 for each real query length of
    ``lqs`` (every other one with a random reference PAD suffix), then one
    row of each WAVE_SPECIAL kind at the longest length: a PAD in the middle
    of both rows, an all-PAD query, an all-PAD reference, twins (an N
    background with a motif at three query rows in strips far apart and at
    two reference columns: every pairing ties, the first pair must win) and
    all-N rows with a few codes."""
    Lq = max(lqs)
    rows = len(lqs) + len(WAVE_SPECIAL)
    q = np.full((rows, Lq), PAD, np.int8)
    r = np.full((rows, Lr), PAD, np.int8)
    for b, lq in enumerate(lqs):
        q[b, :lq] = rng.integers(0, 5, lq)
        lr = int(rng.integers(1, Lr + 1)) if b % 2 else Lr
        r[b, :lr] = rng.integers(0, 5, lr)
    for t, kind in enumerate(WAVE_SPECIAL):
        b = len(lqs) + t
        q[b] = rng.integers(0, 5, Lq)
        r[b] = rng.integers(0, 5, Lr)
        if kind == 'mid_pad':
            q[b, Lq // 2] = PAD
            r[b, Lr // 2] = PAD
        elif kind == 'pad_query':
            q[b] = PAD
        elif kind == 'pad_ref':
            r[b] = PAD
        elif kind == 'twins':
            m = max(1, min(24, Lr // 3, Lq // 4))
            motif = rng.integers(0, 4, m).astype(np.int8)
            q[b] = N
            r[b] = N
            for at in (Lq // 8, Lq // 2, Lq - m):
                _place(q[b], at, motif)
            _place(r[b], 0, motif)
            _place(r[b], Lr - m, motif)
        elif kind == 'n_rows':
            q[b] = N
            r[b] = N
            q[b, ::7] = rng.integers(0, 4, len(q[b, ::7]))
            r[b, ::5] = rng.integers(0, 4, len(r[b, ::5]))
    return q, r


def chain_cases(rng, B, Lq, Lr):
    """[B, Lq] queries and [B, Lr] references, int8 codes; job b is of kind
    CHAIN_KINDS[b % len(CHAIN_KINDS)] on random codes 0-3: 'last_col' ends
    a copy of the query's last m codes at the job's last column (m = min(24,
    Lq, Lr)), 'first_col' starts a copy of its first m codes at column 0,
    'pad_ref' and 'pad_query' are all PAD, 'twins' puts one motif at two
    query rows and two reference columns (every pairing ties: the first
    pair wins), 'n_rows' is all N with a few codes, 'random' has codes 0-4
    with random PAD suffixes."""
    q = rng.integers(0, 4, (B, Lq)).astype(np.int8)
    r = rng.integers(0, 4, (B, Lr)).astype(np.int8)
    m = max(1, min(24, Lq, Lr))
    for b in range(B):
        kind = CHAIN_KINDS[b % len(CHAIN_KINDS)]
        if kind == 'last_col':
            r[b, Lr - m:] = q[b, Lq - m:]
        elif kind == 'first_col':
            r[b, :m] = q[b, :m]
        elif kind == 'pad_ref':
            r[b] = PAD
        elif kind == 'pad_query':
            q[b] = PAD
        elif kind == 'twins':
            k = max(1, m // 2)
            motif = rng.integers(0, 4, k).astype(np.int8)
            q[b] = N
            r[b] = N
            _place(q[b], 0, motif)
            _place(q[b], Lq - k, motif)
            _place(r[b], Lr // 3, motif)
            _place(r[b], Lr - k, motif)
        elif kind == 'n_rows':
            q[b] = N
            r[b] = N
            q[b, ::5] = rng.integers(0, 4, len(q[b, ::5]))
            r[b, ::3] = rng.integers(0, 4, len(r[b, ::3]))
        else:
            q[b] = rng.integers(0, 5, Lq)
            r[b] = rng.integers(0, 5, Lr)
            q[b, int(rng.integers(1, Lq + 1)):] = PAD
            r[b, int(rng.integers(max(1, Lr // 2), Lr + 1)):] = PAD
    return q, r
