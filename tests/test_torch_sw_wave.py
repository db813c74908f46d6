"""The wavefront route of the port's SW kernel, on the CPU.

csrc/sw_score_ends.cu's wavefront runs a block of K warps per row: a strip
is 32*R query rows (R a lane), warp k sweeps strips k, k+K, ... in groups
of K, two 32-step chunks behind warp k-1, whose bottom row it reads through
a 128-column ring; warp 0 of the next group reads a handoff row written by
warp K-1; each row is swept only to its real lengths; the best cell is
folded on the whole (score, j, i).  The kernel runs only on the card
(tests/test_torch_cuda.py); here ``emulate_wave``, a numpy emulation of
that schedule step by step (every warp of a row in lockstep, the ring and
the handoff row as the kernel indexes them, asserting that no slot is
overwritten before it is read and that every read finds the column it
wants), equals the JAX package's ``sw_score_ends`` (XLA on the CPU) on
tools/sw_cases.py's wavefront rows, under three SWParams and several plans.
Integer DP: tolerance 0.  ``_wave_plan`` is held to its rule.
"""

import functools

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import sw as jsw
from ciri_long_tpu_torch.ops import sw as tsw
from ciri_long_tpu_torch.tools.sw_cases import WAVE_LR, WAVE_LQ, wave_cases

torch.set_num_threads(1)

NEG = tsw.NEG
RING = tsw.WAVE_RING
PARAMS = [(1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1)]
# (R, K): one warp a row with several strips, pipelines of two, three, four
# and eight warps, each R
PLANS = [(1, 8), (2, 3), (4, 4), (2, 1), (4, 2)]


def real_lengths(x):
    """One past the last code in 0..4 of each row (0 for an all-PAD row)."""
    ok = (x >= 0) & (x < 5)
    last = np.where(ok.any(1), x.shape[1] - np.argmax(ok[:, ::-1], 1), 0)
    return last.astype(np.int64)


def _before(s, i, j, bs, bi, bj):
    """The contract's order: higher score, then smaller j, then smaller i."""
    return (s > bs) | ((s == bs) & ((j < bj) | ((j == bj) & (i < bi))))


def _fold(best, cand, take):
    return [np.where(take, c, b) for b, c in zip(best, cand)]


def emulate_wave(q, r, params, R, K):
    """(score, q_end, r_end) of the wavefront with R rows a lane and K warps
    a row, emulated chunk by chunk and step by step.  ``params`` is one
    (match, mismatch, gap_open, gap_extend) per row ([B, 4])."""
    B = q.shape[0]
    Lr = r.shape[1]
    gO, gE = params[:, 2, None, None], params[:, 3, None, None]
    MB = -gO                                   # M = H - gO of the border
    lq, lr = real_lengths(q), real_lengths(r)
    SR = 32 * R
    strips = np.where(lr > 0, -(-lq // SR), 0)
    groups = -(-strips // K)
    chunks = (lr + 62) // 32
    lanes = np.arange(32)
    warps = np.arange(K)
    rows = np.arange(B)[:, None, None]
    lq3, lr3 = lq[:, None, None], lr[:, None, None]

    # the ring between warps k and k+1 and the handoff row, with the column
    # each slot holds and when it was written and last read
    ring = np.zeros((B, K, RING, 2), np.int64)
    ring_col = np.full((B, K, RING), -1)
    ring_read = np.full((B, K, RING), -1)
    edge = np.zeros((B, Lr, 2), np.int64)
    edge_gen = np.full((B, Lr), -1)
    edge_read = np.full((B, Lr), -1)
    clock = 0                                  # 2 per iteration

    best = [np.zeros((B, K, 32), np.int64), np.full((B, K, 32), -1),
            np.full((B, K, 32), np.iinfo(np.int32).max)]
    for g in range(int(groups.max(initial=0))):
        s = g * K + warps[None, :, None]                       # [1, K, 1]
        live = (s < strips[:, None, None]) & (g < groups[:, None, None])
        i0 = s * SR + lanes[None, None, :] * R                 # [1, K, 32]
        # the score table of each lane's rows against codes 0..5, plus gO
        i = i0[..., None] + np.arange(R)                        # [1,K,32,R]
        idx = np.broadcast_to(np.minimum(i, q.shape[1] - 1), (B, K, 32, R))
        qc = q[np.arange(B)[:, None, None, None], idx].astype(np.int64)
        qc = np.where(idx == i, qc, 5)
        qc = np.where(i < lq[:, None, None, None], qc, 5)
        qx, cx = qc[..., None], np.arange(6)
        m4 = params[:, 0, None, None, None, None]
        x4 = params[:, 1, None, None, None, None]
        g4 = params[:, 2, None, None, None, None]
        tab = np.where((qx < 0) | (qx >= 5) | (cx == 5), NEG,
                       np.where((qx == 4) | (cx == 4), 0,
                                np.where(qx == cx, m4, -x4))) + g4
        M = np.broadcast_to(MB[..., None], (B, K, 32, R)).copy()
        E = np.full((B, K, 32, R), NEG, np.int64)
        bm = M.copy()
        bd = np.zeros((B, K, 32, R), np.int64)
        out_M = np.broadcast_to(MB, (B, K, 32)).copy()
        out_F = np.full((B, K, 32), NEG, np.int64)
        dgM = out_M.copy()
        border = np.stack(np.broadcast_arrays(MB[:, 0, 0, None],
                                              np.full((B, 1), NEG)), -1)
        cur = np.broadcast_to(border[:, None, :, :], (B, K, 32, 2)).copy()
        nxt = cur[:, 0].copy()

        def read_edge(cols, need):
            """Warp 0's fetch of handoff columns ``cols`` [B, 32] for the
            rows ``need``: each must hold group g-1's column."""
            ok = need & (cols < lr[:, None])
            c = np.minimum(cols, Lr - 1)
            gen = edge_gen[rows[:, :, 0], c]
            assert (gen[ok] == g - 1).all(), 'handoff column not written'
            bi, ti = ok.nonzero()
            edge_read[bi, c[bi, ti]] = clock
            return np.where(ok[..., None], edge[rows[:, :, 0], c], border)

        from_edge = live[:, 0, 0] & (g > 0)
        if g > 0:
            clock += 1                         # the prefetch at group start
            cur[:, 0] = np.where(from_edge[:, None, None],
                                 read_edge(lanes[None, :] + 0 * rows[:, 0],
                                           from_edge[:, None]), cur[:, 0])
            nxt = np.where(from_edge[:, None, None],
                           read_edge(32 + lanes[None, :] + 0 * rows[:, 0],
                                     from_edge[:, None]), nxt)
        to_ring = live & (warps[None, :, None] + 1 < K) & (
            s + 1 < strips[:, None, None])
        to_edge = live & (warps[None, :, None] + 1 == K) & (
            s + 1 < strips[:, None, None])
        iters = int((chunks + 2 * (K - 1)).max())
        for it in range(iters):
            clock += 2
            c = it - 2 * warps                                     # [K]
            active = live & (c[None, :, None] >= 0) & (
                c[None, :, None] < chunks[:, None, None])          # [B,K,1]
            # chunk start: warps k >= 1 take 32 columns from the ring,
            # warp 0 of a later group its prefetched handoff columns
            cols = c[:, None] * 32 + lanes[None, :]                # [K, 32]
            for k in range(1, K):
                act = active[:, k, 0]
                if not act.any():
                    continue
                slot = cols[k] & (RING - 1)
                want = act[:, None] & (cols[k][None, :] < lr[:, None])
                held = ring_col[:, k - 1, slot]
                assert (held[want] == cols[k][None, :].repeat(B, 0)[want]
                        ).all(), 'ring slot overwritten or not yet written'
                rr_, ss_ = want.nonzero()
                ring_read[rr_, k - 1, slot[ss_]] = clock
                cur[:, k] = np.where(act[:, None, None],
                                     ring[:, k - 1, slot], cur[:, k])
            if it > 0:
                step0 = active[:, 0, 0] & from_edge
                cur[:, 0] = np.where(step0[:, None, None], nxt, cur[:, 0])
                fetched = read_edge(np.full((B, 32), it * 32 + 32) + lanes,
                                    step0[:, None])
                nxt = np.where(step0[:, None, None], fetched, nxt)
            for kk in range(32):
                d = c * 32 + kk                                    # [K]
                j = d[None, :, None] - lanes[None, None, :]        # [1,K,32]
                cell = active & (j >= 0) & (j < lr3)
                rc = r[rows, np.clip(j, 0, Lr - 1)].astype(np.int64)
                rc = np.where(cell, rc, 5)
                rc = np.where((rc < 0) | (rc > 5), 5, rc)
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
                    sc = np.take_along_axis(tab[..., u, :], rc[..., None],
                                            -1)[..., 0]
                    h = np.maximum(np.maximum(dg + sc, e), np.maximum(f, 0))
                    m = np.where(cell, h + MB, MB)
                    e = np.where(cell, e, NEG)
                    f = np.where(cell, f, NEG)
                    better = active & (m > bm[..., u])
                    bm[..., u] = np.where(better, m, bm[..., u])
                    bd[..., u] = np.where(better, d[None, :, None],
                                          bd[..., u])
                    dg = left
                    mu, fu = m, f
                    M[..., u] = np.where(active, m, M[..., u])
                    E[..., u] = np.where(active, e, E[..., u])
                out_M = np.where(active, mu, out_M)
                out_F = np.where(active, fu, out_F)
                # lane 31 hands its column to warp k+1 or to the next group
                w31 = cell[:, :, 31]
                j31 = j[0, :, 31]
                for k in range(K):
                    put = w31[:, k] & to_ring[:, k, 0]
                    if put.any():
                        b = put.nonzero()[0]
                        slot = j31[k] & (RING - 1)
                        old = ring_col[b, k, slot]
                        seen = ring_read[b, k, slot]
                        assert ((old < 0) | ((seen >= 0) & (seen < clock))
                                ).all(), 'ring slot overwritten unread'
                        ring_col[b, k, slot] = j31[k]
                        ring_read[b, k, slot] = -1
                        ring[b, k, slot, 0] = mu[b, k, 31]
                        ring[b, k, slot, 1] = fu[b, k, 31]
                    put = w31[:, k] & to_edge[:, k, 0]
                    if put.any():
                        b = put.nonzero()[0]
                        old = edge_gen[b, j31[k]]
                        seen = edge_read[b, j31[k]]
                        assert ((old < 0) | ((seen >= 0) & (seen < clock))
                                ).all(), 'handoff column overwritten unread'
                        edge_gen[b, j31[k]] = g
                        edge_read[b, j31[k]] = -1
                        edge[b, j31[k], 0] = mu[b, k, 31]
                        edge[b, j31[k], 1] = fu[b, k, 31]
        # the strip's rows into the lane's best, in row order
        for u in range(R):
            iu = np.broadcast_to(i0 + u, (B, K, 32))
            sc = bm[..., u] - MB
            ju = bd[..., u] - lanes
            ok = live & (iu < lq3) & (sc > 0)
            take = ok & _before(sc, iu, ju, *best)
            best = _fold(best, (sc, iu, ju), take)

    # the lanes (shuffle down by 16, 8, 4, 2, 1), then warps 1..K-1 into 0
    for off in (16, 8, 4, 2, 1):
        other = [np.concatenate([x[:, :, off:], x[:, :, :off]], 2)
                 for x in best]
        take = _before(*other, *best) & (lanes < 32 - off)
        best = _fold(best, other, take)
    s_, i_, j_ = (x[:, 0, 0] for x in best)
    for k in range(1, K):
        other = [x[:, k, 0] for x in best]
        take = _before(*other, s_, i_, j_)
        s_, i_, j_ = _fold((s_, i_, j_), other, take)
    none = s_ <= 0
    return [np.where(none, 0, s_).astype(np.int32),
            np.where(none, -1, i_).astype(np.int32),
            np.where(none, -1, j_).astype(np.int32)]


def _jax(q, r, params):
    return [np.asarray(t) for t in jsw.sw_score_ends(
        q, r, jsw.SWParams(*params))]


def plan_lengths(R, K):
    """Real query lengths at the edges of a plan's schedule: a lane's rows
    (32R +- 1), a group of K strips (32RK +- 1) and one past it (32RK +
    33), with 1, 31, 32 and 33."""
    return tuple(sorted({1, 31, 32, 33, 32 * R - 1, 32 * R + 1,
                         32 * R * K - 1, 32 * R * K + 1, 32 * R * K + 33}))


@functools.lru_cache(maxsize=None)
def _cases():
    """For each plan, SWParams and WAVE_LR width, tools/sw_cases.py's
    wavefront rows at the plan's lengths; all PAD-padded to one shape, with
    per-row params, the plan each row is for and the JAX package's
    answers."""
    qs, rs, ps, tags = [], [], [], []
    Lq = max(plan_lengths(R, K)[-1] for R, K in PLANS)
    Lr = max(WAVE_LR)
    for t, (R, K) in enumerate(PLANS):
        for params in PARAMS:
            for w in WAVE_LR:
                rng = np.random.default_rng(1000 * t + w + 7 * sum(params))
                q, r = wave_cases(rng, w, plan_lengths(R, K))
                qp = np.full((len(q), Lq), 5, np.int8)
                rp = np.full((len(r), Lr), 5, np.int8)
                qp[:, :q.shape[1]] = q
                rp[:, :w] = r
                qs.append(qp)
                rs.append(rp)
                ps.append(np.tile(params, (len(q), 1)))
                tags.append(np.full(len(q), t))
    q, r = np.concatenate(qs), np.concatenate(rs)
    p, tag = np.concatenate(ps), np.concatenate(tags)
    want = np.zeros((3, len(q)), np.int32)
    for params in PARAMS:
        mine = (p == params).all(1)
        want[:, mine] = _jax(q[mine], r[mine], params)
    return q, r, p, tag, want


@pytest.mark.parametrize('R,K', PLANS)
def test_wave_emulation_matches_jax(R, K):
    """The plan's rows (every length of plan_lengths, N, mid-row PAD,
    all-PAD rows, twins in strips far apart) against every WAVE_LR width
    under three SWParams: the emulation equals JAX on every row."""
    q, r, p, tag, want = _cases()
    mine = tag == PLANS.index((R, K))
    cut = plan_lengths(R, K)[-1]
    assert (real_lengths(q[mine]) <= cut).all()
    got = emulate_wave(q[mine, :cut], r[mine], p[mine], R, K)
    for a, b in zip(got, want[:, mine]):
        np.testing.assert_array_equal(a, b)
    assert (want[0, mine] > 0).sum() > mine.sum() // 2


def test_wave_cases_reach_every_edge():
    """WAVE_LQ (the card's cases) holds the edges of every R in 1, 2, 4 and
    K in 2, 4, 8; in the twins row every pairing ties and the first query
    copy against the first reference copy wins."""
    for R in (1, 2, 4):
        for K in (2, 4, 8):
            assert set(plan_lengths(R, K)) <= set(WAVE_LQ)
    q, r = wave_cases(np.random.default_rng(0), 130)
    assert sorted(set(real_lengths(q[:len(WAVE_LQ)]))) == list(WAVE_LQ)
    s, i, j = _jax(q, r, (1, 1, 1, 1))
    twin = len(WAVE_LQ) + 3                    # WAVE_SPECIAL's 'twins'
    m = min(24, 130 // 3, q.shape[1] // 4)
    assert (s[twin], j[twin], i[twin]) == (m, m - 1, q.shape[1] // 8 + m - 1)


def test_a_ring_of_64_columns_fails():
    """With a ring of 64 columns the same schedule hands warp k-1's writes
    to slots warp k reads in that chunk: the emulation's check fires."""
    global RING
    q, r = wave_cases(np.random.default_rng(1), 130, (100, 200))
    p = np.tile(PARAMS[0], (len(q), 1))
    saved, RING = RING, 64
    try:
        with pytest.raises(AssertionError, match='ring slot'):
            emulate_wave(q, r, p, 1, 3)
    finally:
        RING = saved


@pytest.mark.parametrize('shape,plan', [
    ((512, 1024, 4096), (4, 8, 1, 'none')),      # the bench shape
    ((512, 2048, 4096), (4, 8, 1, 'smem')),      # two groups
    ((1488, 773, 776), (4, 3, 1, 'smem')),       # collapse's largest round
    ((4, 8192, 16384), (4, 8, 1, 'smem')),       # K3: 128 KB handoff row
    ((2, 1100, 30000), (4, 8, 1, 'global')),     # 240 KB: global memory
    ((2, 300, 30000), (4, 3, 1, 'none')),        # one group: no handoff
    ((4096, 32, 128), (1, 1, 8, 'none')),        # one strip of 32
    ((8, 33, 512), (2, 1, 8, 'none')),           # one strip of 64
    ((4400, 200, 70), (4, 1, 8, 'smem')),        # one warp a row, 2 strips
    ((5000, 1000, 30000), (4, 1, 8, 'global')),
    ((5000, 1000, 5000), (4, 1, 5, 'smem')),     # 5 rows' handoff rows fit
])
def test_wave_plan(shape, plan):
    assert tsw._wave_plan(*shape) == tsw.WavePlan(*plan)


def test_wave_plan_rows():
    """R is the rule's unless a strip of fewer rows holds the query; a plan
    never asks more of a block than the kernel takes."""
    assert tsw.WAVE_ROWS == 4
    assert tsw._wave_plan(512, 1024, 4096, rows=2).rows == 2
    assert tsw._wave_plan(512, 100, 4096).rows == 4
    assert tsw._wave_plan(512, 64, 4096).rows == 2
    assert tsw._wave_plan(512, 1, 4096).rows == 1
    for B in (1, 64, 512, 4224, 10000):
        for Lq in (1, 32, 65, 1024, 8192):
            for Lr in (1, 130, 4096, 26000, 30000):
                R, K, P, edge = tsw._wave_plan(B, Lq, Lr)
                assert R in (1, 2, 4) and 1 <= K * P <= tsw.WAVE_WARPS
                assert P == 1 or K == 1
                if edge == 'smem':
                    assert P * Lr * 8 + tsw._wave_static_bytes(R) \
                        <= tsw.BLOCK_SMEM
