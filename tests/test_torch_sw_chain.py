"""The chained wavefront of the SW variant harness, on the CPU.

csrc/sw_chain.cu runs the SW wavefront (csrc/sw_score_ends.cu's) over a
stream of C jobs' references laid back to back behind boundary codes
(misc/kexp.py::chain_layout): a block of K warps per stream, a strip of
32*R query rows a warp, warp k two 32-step chunks behind warp k-1 through
a 128-slot ring, a handoff row between groups of K strips; a chunk that
holds no boundary runs the branch-free step, one that holds one the masked
step, in which a lane at a boundary takes the border, sets its job's best
aside and turns to the other of its two score tables; at the chunk's end
the lanes that crossed flush the ended job's best into its key (atomicMax
of score << 32 | 2^32-1 - (j*Lq + i)) and fill the table they left with
the job after next.
The kernel runs only on the card (tests/test_torch_cuda.py); here
``emulate_chain``, a numpy emulation of that schedule step by step (every
warp of a stream in lockstep, the ring, the handoff row and the two tables
indexed as the kernel indexes them, asserting that no slot is overwritten
before it is read, that every read finds the slot it wants, that a cell
reads the table of its own job, that a lane crosses at most one boundary a
chunk and that a chunk run branch-free holds no boundary and no slot
outside the stream), equals the JAX package's ``sw_score_ends`` (XLA on the
CPU) on tools/sw_cases.py's cases, wavefront and chain, under three
SWParams, several plans and C in {1, 2, 4, B}, with queries longer than
the references.  Integer DP: tolerance 0.  ``chain_plan`` is held to its
rule.
"""

import functools

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import sw as jsw
from ciri_long_tpu_torch.misc import kexp
from ciri_long_tpu_torch.ops import sw as tsw
from ciri_long_tpu_torch.tools.sw_cases import chain_cases, wave_cases

torch.set_num_threads(1)

NEG = tsw.NEG
RING = tsw.WAVE_RING
BOUNDARY = kexp.BOUNDARY
PARAMS = [(1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1)]
# (R, K): one warp a stream over several strips, pipelines of two, three
# and four warps
PLANS = [(1, 1), (2, 3), (4, 2), (1, 4)]
MAX32 = np.uint64(0xffffffff)


def _before(s, i, j, bs, bi, bj):
    """The contract's order: higher score, then smaller j, then smaller i."""
    return (s > bs) | ((s == bs) & ((j < bj) | ((j == bj) & (i < bi))))


def _table(qc, params):
    """[..., R, 6] scores of query codes ``qc`` against codes 0..5, plus
    gO: NEG for PAD or a code outside 0..4, 0 for N (the kernel's
    fill_table); ``params`` broadcasts against qc's leading axes."""
    m, x, g = (params[..., t, None, None] for t in (0, 1, 2))
    qx, cx = qc[..., None], np.arange(6)
    return np.where((qx < 0) | (qx >= 5) | (cx == 5), NEG,
                    np.where((qx == 4) | (cx == 4), 0,
                             np.where(qx == cx, m, -x))) + g


def emulate_chain(q, r, params, C, R, K):
    """(score, q_end, r_end) [B] of the chained wavefront with C jobs a
    stream, R rows a lane and K warps a stream, emulated chunk by chunk and
    step by step on the kernel's layout.  ``params`` is one (match,
    mismatch, gap_open, gap_extend) per stream ([B/C, 4])."""
    ref = kexp.chain_pad(torch.from_numpy(r))
    qrows, stream = (x.numpy() for x in kexp.chain_layout(
        torch.from_numpy(q), ref, C))
    S, T = stream.shape
    Lq = q.shape[1]
    span = ref.shape[1] + 1
    gE = params[:, 3, None, None]
    MB = -params[:, 2, None, None]             # M = H - gO of the border
    SR = 32 * R
    strips = -(-Lq // SR)
    groups = -(-strips // K)
    chunks = (T + 62) // 32
    lanes = np.arange(32)
    warps = np.arange(K)
    srow = np.arange(S)[:, None, None]
    p4 = params[:, None, None, :]

    ring = np.zeros((S, K, RING, 2), np.int64)
    ring_col = np.full((S, K, RING), -1)
    ring_read = np.full((S, K, RING), -1)
    edge = np.zeros((S, T, 2), np.int64)
    edge_gen = np.full((S, T), -1)
    edge_read = np.full((S, T), -1)
    clock = 0                                  # 2 per iteration
    keys = np.zeros(S * C, np.uint64)
    border = np.stack(np.broadcast_arrays(MB[:, 0, 0, None],
                                          np.full((S, 1), NEG)), -1)

    def rows_of(job, i):
        """Query codes [S, K, 32, R] of job ``job`` [S, K, 32] at rows i;
        PAD past the query or the stream's last job."""
        ok = (job[..., None] < C) & (i < Lq)
        col = np.clip(job[..., None], 0, C - 1) * Lq + np.minimum(i, Lq - 1)
        return np.where(ok, qrows[srow[..., None], col], 5).astype(np.int64)

    for g in range(groups):
        s = g * K + warps[None, :, None]                       # [1, K, 1]
        live = np.broadcast_to(s < strips, (S, K, 1))
        i0 = s * SR + lanes[None, None, :] * R                 # [1, K, 32]
        i = np.broadcast_to(i0[..., None] + np.arange(R), (S, K, 32, R))
        job = np.full((S, K, 32), -1)
        # the two tables (job m's is table m & 1) and the job each holds
        tab = np.stack([_table(rows_of(np.zeros((S, K, 32), int), i), p4),
                        _table(np.full((S, K, 32, R), 5), p4)], 3)
        tab_job = np.stack([np.zeros((S, K, 32), int),
                            np.full((S, K, 32), -2)], 3)
        crossed = np.zeros((S, K, 32), bool)
        M = np.broadcast_to(MB[..., None], (S, K, 32, R)).copy()
        E = np.full((S, K, 32, R), NEG, np.int64)
        bm = M.copy()
        bp = np.zeros((S, K, 32, R), np.int64)
        pbm, pbp = bm.copy(), bp.copy()      # the ended job's, until flushed
        out_M = np.broadcast_to(MB, (S, K, 32)).copy()
        out_F = np.full((S, K, 32), NEG, np.int64)
        dgM = out_M.copy()
        cur = np.broadcast_to(border[:, None, :, :], (S, K, 32, 2)).copy()
        nxt = cur[:, 0].copy()

        def read_edge(slots):
            """Warp 0's fetch of handoff slots [S, 32]: each must hold group
            g-1's slot."""
            ok = slots < T
            c = np.minimum(slots, T - 1)
            gen = edge_gen[srow[:, :, 0], c]
            assert (gen[ok] == g - 1).all(), 'handoff slot not written'
            bi, ti = ok.nonzero()
            edge_read[bi, c[bi, ti]] = clock
            return np.where(ok[..., None], edge[srow[:, :, 0], c], border)

        from_edge = g > 0 and strips > g * K
        if from_edge:
            clock += 1                         # the prefetch at group start
            cur[:, 0] = read_edge(np.broadcast_to(lanes, (S, 32)))
            nxt = read_edge(np.broadcast_to(32 + lanes, (S, 32)))
        to_ring = live & (warps[None, :, None] + 1 < K) & (s + 1 < strips)
        to_edge = live & (warps[None, :, None] + 1 == K) & (s + 1 < strips)
        for it in range(chunks + 2 * (K - 1)):
            clock += 2
            c = it - 2 * warps                                     # [K]
            active = live & ((c >= 0) & (c < chunks))[None, :, None]
            for k in range(1, K):
                if not active[0, k, 0]:
                    continue
                cols = c[k] * 32 + lanes
                slot = cols & (RING - 1)
                want = cols < T
                held = ring_col[:, k - 1, slot]
                assert (held[:, want] == cols[want]).all(), \
                    'ring slot overwritten or not yet written'
                ring_read[:, k - 1, slot[want]] = clock
                cur[:, k] = ring[:, k - 1, slot]
            if it > 0 and from_edge and active[0, 0, 0]:
                cur[:, 0] = nxt
                nxt = read_edge(np.broadcast_to(it * 32 + 32 + lanes,
                                                (S, 32)))
            # the kernel's test for the branch-free chunk
            lo = c * 32 - 31
            nb = np.where(lo <= 0, 0, -(-lo // span) * span)
            plain = (lo >= 0) & (c * 32 + 31 < T) & (nb > c * 32 + 31)
            for kk in range(32):
                d = c * 32 + kk                                    # [K]
                p = d[None, :, None] - lanes[None, None, :]        # [1,K,32]
                inside = active & (p >= 0) & (p < T)
                code = np.where(inside, stream[srow, np.clip(p, 0, T - 1)],
                                5).astype(np.int64)
                at_b = inside & (code == BOUNDARY)
                run = active & plain[None, :, None]
                assert not (run & (at_b | ~inside)).any(), \
                    'a branch-free chunk holds a boundary or an edge'
                cell = inside & ~at_b
                tc = np.where((code < 0) | (code > 5), 5, code)
                buf = job & 1
                held = np.take_along_axis(tab_job, buf[..., None], 3)[..., 0]
                assert (held[cell] == job[cell]).all(), \
                    'a cell read a table not filled for its job'
                tjob = np.take_along_axis(
                    tab, buf[..., None, None, None], 3)[:, :, :, 0]
                upM = np.concatenate([cur[:, :, kk, None, 0],
                                      out_M[:, :, :-1]], 2)
                upF = np.concatenate([cur[:, :, kk, None, 1],
                                      out_F[:, :, :-1]], 2)
                dg = dgM
                dgM = np.where(active, upM, dgM)
                mu, fu = upM, upF
                for u in range(R):
                    left = M[..., u].copy()
                    e = np.maximum(E[..., u] - gE, left)
                    f = np.maximum(fu - gE, mu)
                    sc = np.take_along_axis(tjob[..., u, :], tc[..., None],
                                            -1)[..., 0]
                    h = np.maximum(np.maximum(dg + sc, e), np.maximum(f, 0))
                    m = np.where(cell, h + MB, MB)
                    e = np.where(cell, e, NEG)
                    f = np.where(cell, f, NEG)
                    better = active & (m > bm[..., u])
                    bm[..., u] = np.where(better, m, bm[..., u])
                    bp[..., u] = np.where(better, p, bp[..., u])
                    dg = left
                    mu, fu = m, f
                    M[..., u] = np.where(active, m, M[..., u])
                    E[..., u] = np.where(active, e, E[..., u])
                out_M = np.where(active, mu, out_M)
                out_F = np.where(active, fu, out_F)
                # lane 31 hands its slot to warp k+1 or to the next group
                p31 = p[0, :, 31]
                for k in range(K):
                    put = inside[:, k, 31] & to_ring[:, k, 0]
                    if put.any():
                        b = put.nonzero()[0]
                        slot = p31[k] & (RING - 1)
                        old = ring_col[b, k, slot]
                        seen = ring_read[b, k, slot]
                        assert ((old < 0) | ((seen >= 0) & (seen < clock))
                                ).all(), 'ring slot overwritten unread'
                        ring_col[b, k, slot] = p31[k]
                        ring_read[b, k, slot] = -1
                        ring[b, k, slot] = np.stack([mu[b, k, 31],
                                                     fu[b, k, 31]], -1)
                    put = inside[:, k, 31] & to_edge[:, k, 0]
                    if put.any():
                        b = put.nonzero()[0]
                        old = edge_gen[b, p31[k]]
                        seen = edge_read[b, p31[k]]
                        assert ((old < 0) | ((seen >= 0) & (seen < clock))
                                ).all(), 'handoff slot overwritten unread'
                        edge_gen[b, p31[k]] = g
                        edge_read[b, p31[k]] = -1
                        edge[b, p31[k]] = np.stack([mu[b, k, 31],
                                                    fu[b, k, 31]], -1)
                # a lane at a boundary sets its best aside and starts the
                # next job, on the other table
                if at_b.any():
                    assert not (at_b & crossed).any(), \
                        'two boundaries in one chunk'
                    crossed = crossed | at_b
                    pbm = np.where(at_b[..., None], bm, pbm)
                    pbp = np.where(at_b[..., None], bp, pbp)
                    job = np.where(at_b, job + 1, job)
                    bm = np.where(at_b[..., None], MB[..., None], bm)
                    bp = np.where(at_b[..., None], p[..., None], bp)
            # the chunk's end: the lanes that crossed flush the ended job
            # and fill the table they left with the job after next
            if crossed.any():
                ended = job - 1
                sc = pbm - MB[..., None]
                ok = (crossed & (ended >= 0))[..., None] & (i < Lq) & (sc > 0)
                j = pbp - (ended[..., None] * span + 1)
                ij = (j * Lq + i).astype(np.uint64)
                key = (sc.astype(np.uint64) << np.uint64(32)) | (MAX32 - ij)
                key = np.where(ok, key, np.uint64(0)).max(-1)
                flat = srow * C + np.clip(ended, 0, C - 1)
                hit = key > 0
                np.maximum.at(keys, flat[hit], key[hit])
                other = ((job + 1) & 1)[..., None] == np.arange(2)
                fill = crossed[..., None] & other
                tab = np.where(fill[..., None, None],
                               _table(rows_of(job + 1, i), p4)[:, :, :, None],
                               tab)
                tab_job = np.where(fill, (job + 1)[..., None], tab_job)
                crossed[:] = False
        assert (job[live[..., 0]] == C).all(), 'a lane missed a boundary'

    score = (keys >> np.uint64(32)).astype(np.int64)
    ij = (MAX32 - (keys & MAX32)).astype(np.int64)
    none = keys == 0
    return [np.where(none, 0, score).astype(np.int32),
            np.where(none, -1, ij % Lq).astype(np.int32),
            np.where(none, -1, ij // Lq).astype(np.int32)]


def _jax(q, r, params):
    return [np.asarray(t) for t in jsw.sw_score_ends(
        q, r, jsw.SWParams(*params))]


def _check(q, r, params, C, R, K):
    want = _jax(q, r, params)
    per_stream = np.tile(params, (q.shape[0] // C, 1))
    got = emulate_chain(q, r, per_stream, C, R, K)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return want


# (B, Lq, Lr): jobs of one strip and of several, Lq far above Lr, a job of
# one column, references under one chunk and across several
SHAPES = [(14, 40, 7), (8, 150, 33), (7, 70, 64), (12, 9, 90)]


@functools.lru_cache(maxsize=None)
def _chain_case(B, Lq, Lr, seed):
    return chain_cases(np.random.default_rng(seed), B, Lq, Lr)


@pytest.mark.parametrize('R,K', PLANS)
@pytest.mark.parametrize('params', PARAMS)
def test_chain_emulation_matches_jax(R, K, params):
    """tools/sw_cases.py's chain jobs (best cell in a job's last column and
    in its first, all-PAD jobs, twins, N rows, PAD suffixes) at every SHAPE,
    C in {1, 2, 4, B} where it divides B: the emulation equals JAX."""
    positive = 0
    for t, (B, Lq, Lr) in enumerate(SHAPES):
        q, r = _chain_case(B, Lq, Lr, 100 * t + R + 10 * K)
        for C in sorted({1, 2, 4, B}):
            if B % C == 0:
                positive += int((_check(q, r, params, C, R, K)[0] > 0).sum())
    assert positive > 0


def test_best_cell_in_the_last_column_before_a_boundary():
    """A job whose only match ends in its last column, the slot before the
    next job's boundary, and the job after it all PAD: the flush at the
    boundary carries the cell, and the PAD job stays (0, -1, -1)."""
    Lq, Lr = 20, 31
    q = np.full((4, Lq), 4, np.int8)
    r = np.full((4, Lr), 4, np.int8)
    q[0, 5:13] = [0, 1, 2, 3, 3, 2, 1, 0]
    r[0, Lr - 8:] = q[0, 5:13]
    r[1] = 5
    q[2, -6:] = [1, 1, 2, 2, 3, 3]
    r[2, -6:] = q[2, -6:]
    want = _check(q, r, PARAMS[0], 4, 1, 1)
    assert want[0][0] == 8 and want[2][0] == Lr - 1
    assert list(x[1] for x in want) == [0, -1, -1]
    assert want[2][2] == Lr - 1 and want[1][2] == Lq - 1


def test_wave_cases_through_the_chain():
    """tools/sw_cases.py's wavefront rows (every real query length at an
    edge of a strip and of a group, N, mid-row PAD, all-PAD rows, twins in
    strips far apart) chained two at a time."""
    for w in (1, 63, 65):
        q, r = wave_cases(np.random.default_rng(w), w,
                          (1, 31, 33, 63, 65, 127, 129))
        q, r = q[:len(q) // 2 * 2], r[:len(r) // 2 * 2]
        for params in PARAMS[1:]:
            _check(q, r, params, 2, 2, 2)


def test_a_ring_of_64_slots_fails():
    """With a ring of 64 slots the same schedule hands warp k-1's writes
    to slots warp k reads in that chunk: the emulation's check fires."""
    global RING
    q, r = _chain_case(8, 150, 33, 5)
    p = np.tile(PARAMS[0], (4, 1))
    saved, RING = RING, 64
    try:
        with pytest.raises(AssertionError, match='ring slot'):
            emulate_chain(q, r, p, 2, 1, 3)
    finally:
        RING = saved


def test_chain_keys_order_as_the_contract():
    """The packed key orders (score, j, i) as the contract does: higher
    score, then smaller j, then smaller i; and j*Lq + i fits 32 bits at the
    wrapper's limit."""
    rng = np.random.default_rng(3)
    Lq = 50
    cells = rng.integers(0, [9, 40, Lq], (400, 3))
    key = (cells[:, 0].astype(np.uint64) << np.uint64(32)) | (
        MAX32 - (cells[:, 1] * Lq + cells[:, 2]).astype(np.uint64))
    for a in range(0, 400, 7):
        for b in range(1, 400, 11):
            s, j, i = cells[a]
            os_, oj, oi = cells[b]
            assert (key[a] > key[b]) == bool(
                _before(s, i, j, os_, oi, oj))
    assert (kexp.CHAIN_MAX_CELLS - 1) <= 0xffffffff


@pytest.mark.parametrize('shape,plan', [
    ((512, 1024, 4096, 2), (4, 8, 1, 'smem', 'none')),   # the bench shape
    ((512, 1024, 4096, 4), (4, 8, 1, 'smem', 'none')),
    ((512, 2048, 4096, 4), (4, 8, 1, 'smem', 'smem')),   # two groups
    ((4096, 32, 128, 2), (1, 1, 8, 'smem', 'none')),     # one strip of 32
    ((64, 28, 16384, 2), (1, 1, 8, 'smem', 'none')),     # call's shapes
    ((128, 54, 16384, 4), (1, 2, 1, 'smem', 'none')),  # R 1 for K 2
    ((8, 1100, 30000, 2), (4, 8, 1, 'smem', 'global')),  # 480 KB handoff
    ((4096, 2000, 128, 4096), (4, 8, 1, 'global', 'global')),  # C = B
    ((17000, 200, 70, 2), (4, 1, 8, 'smem', 'smem')),    # a warp a stream
    ((17000, 200, 9000, 2), (4, 1, 1, 'smem', 'smem')),  # one row fits
    ((17000, 200, 20000, 2), (4, 1, 8, 'smem', 'global')),
    ((2100, 2000, 9, 2100), (4, 8, 1, 'global', 'smem')),  # keys > 16 KB
])
def test_chain_plan(shape, plan):
    B, Lq, Lr, C = shape
    T = C * (Lr + 1) + 1
    assert kexp.chain_plan(B // C, Lq, T, C) == kexp.ChainPlan(*plan)


def test_chain_plan_rows():
    """R is the rule's unless a strip of fewer rows holds the query or
    fewer rows a lane give a stream more warps; a plan never asks more of a
    block than the kernel takes."""
    assert kexp.CHAIN_ROWS == 4
    assert kexp.chain_plan(256, 1024, 8195, 2, rows=2).rows == 2
    assert kexp.chain_plan(5000, 100, 8195, 2).rows == 4
    assert kexp.chain_plan(5000, 64, 8195, 2).rows == 2
    assert kexp.chain_plan(5000, 1, 8195, 2).rows == 1
    assert kexp.chain_plan(256, 100, 8195, 2)[:2] == (1, 4)
    for streams in (1, 64, 512, 4224, 10000):
        for Lq in (1, 32, 65, 1024, 8192):
            for T in (3, 131, 8195, 30001, 60001):
                for C in (1, 4, 1000):
                    R, K, P, keys, edge = kexp.chain_plan(streams, Lq, T, C)
                    assert R in (1, 2, 4) and 1 <= K * P <= kexp.CHAIN_WARPS
                    assert P == 1 or K == 1
                    used = kexp._chain_static_bytes(R)
                    if edge == 'smem':
                        used += P * T * 8
                    if keys == 'smem':
                        used += -(-P * C * 8 // 16) * 16
                    assert used <= kexp.BLOCK_SMEM
