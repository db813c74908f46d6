"""The row scan of the SW variant harness, on the CPU.

csrc/sw_rowscan.cu sweeps the query a row at a time over all reference
columns: a thread owns a run of W columns whose H (as M = H - gO) and F stay
in its registers, NW warps cover a batch row, and per row a thread runs
pass 1 (F, H0 and the E leaving its run from NEG), a shuffle scan of the
runs' maps over its warp, then takes the E entering its warp and M of warp
w-1's last column from a ring of DEPTH rows in shared memory (spinning on
warp w-1's count of rows done), runs pass 2 (E, H, the row's first maximum
along its run), and hands its own pair to warp w+1 once warp w+1 has read the slot it reuses.
The kernel runs only on the card (tests/test_torch_cuda.py); here
``emulate_rowscan``, a numpy emulation of that schedule (each warp a
program of three phases a row, interleaved by a seeded scheduler under the
kernel's two waits, asserting that every read finds the row it wants and
that no slot is overwritten before it is read), equals the JAX package's
``sw_score_ends`` (XLA on the CPU) on tools/sw_cases.py's cases under
three SWParams, every W and several interleavings.  Integer DP: tolerance
0.  ``rowscan_plan`` is held to its rule.
"""

import functools

import numpy as np
import pytest

from ciri_long_tpu.ops import sw as jsw
from ciri_long_tpu_torch.misc import kexp
from ciri_long_tpu_torch.ops import sw as tsw
from ciri_long_tpu_torch.tools.sw_cases import chain_cases, wave_cases

NEG = tsw.NEG
DEPTH = 16                  # sw_rowscan.cu's ring of rows between two warps
PARAMS = [(1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1)]
POLICIES = ('random', 'low_first', 'high_first')
INT_MAX = np.iinfo(np.int32).max


def _shift(x, d, fill):
    """x[..., t - d] along the lane axis (-1), ``fill`` for t < d: a
    shuffle up by d."""
    out = np.full_like(x, fill)
    out[..., d:] = x[..., :-d]
    return out


def emulate_rowscan(q, r, params, W, policy='random', seed=0,
                    reader_wait=True):
    """(score, q_end, r_end) of the row scan with W columns a thread.
    ``params`` is one (match, mismatch, gap_open, gap_extend) per row ([B,
    4]); ``policy`` picks the next warp among those free to run ('random'
    from ``seed``, or always the lowest or the highest); ``reader_wait``
    False drops the writer's wait for warp w+1 (the check then fires)."""
    B, Lq = q.shape
    Lr = r.shape[1]
    NW = -(-Lr // (32 * W))
    match, mism, gO, gE = (params[:, t, None, None] for t in range(4))
    MB = -gO
    WgE = W * gE
    col = (np.arange(NW)[:, None, None] * 32 + np.arange(32)[:, None]) * W \
        + np.arange(W)                                       # [NW, 32, W]
    valid = col < Lr
    code = np.where(valid, r[:, np.minimum(col, Lr - 1)], 5).astype(np.int64)
    code = np.where((code < 0) | (code > 5), 5, code)        # [B, NW, 32, W]
    lane = np.arange(32)

    M = np.broadcast_to(MB[..., None], code.shape).astype(np.int64)
    M = M.copy()
    F = np.full(code.shape, NEG, np.int64)
    left_M = np.broadcast_to(MB, (B, NW, 1)).astype(np.int64).copy()
    best = np.broadcast_to(MB, (B, NW, 32)).astype(np.int64).copy()
    best_i = np.full((B, NW, 32), -1, np.int64)
    best_j = np.full((B, NW, 32), INT_MAX, np.int64)
    ring_e = np.zeros((B, NW, DEPTH), np.int64)
    ring_m = np.zeros((B, NW, DEPTH), np.int64)
    ring_row = np.full((NW, DEPTH), -1)
    ring_seen = np.ones((NW, DEPTH), bool)
    done = np.zeros(NW, int)
    phase = np.zeros(NW, int)          # 0 pass 1 + scan, 1 pass 2, 2 hand
    keep = {}                          # a warp's values between its phases
    rng = np.random.default_rng(seed)

    def ready(w):
        i = done[w]
        if i >= Lq:
            return False
        if phase[w] == 1:
            return w == 0 or done[w - 1] > i
        if phase[w] == 2:
            return (not reader_wait or w + 1 == NW
                    or done[w + 1] > i - DEPTH)
        return True

    while (done < Lq).any():
        free = [w for w in range(NW) if ready(w)]
        assert free, 'deadlock'
        w = (free[0] if policy == 'low_first' else
             free[-1] if policy == 'high_first' else int(rng.choice(free)))
        i = done[w]
        if phase[w] == 0:
            qc = q[:, i].astype(np.int64)[:, None]
            cx = np.arange(6)
            tab = np.where((qc < 0) | (qc >= 5) | (cx == 5), NEG,
                           np.where((qc == 4) | (cx == 4), 0,
                                    np.where(qc == cx, match[:, 0],
                                             -mism[:, 0]))) + gO[:, 0]
            dg = _shift(M[:, w, :, W - 1], 1, 0)
            dg[:, 0] = left_M[:, w, 0]
            x = np.full((B, 32), NEG, np.int64)
            for k in range(W):
                old = M[:, w, :, k].copy()
                f = np.maximum(F[:, w, :, k] - gE[:, 0], old)
                sc = np.take_along_axis(tab, code[:, w, :, k], 1)
                h0 = np.maximum(np.maximum(dg + sc, f), 0)
                m0 = h0 - gO[:, 0]
                F[:, w, :, k] = f
                M[:, w, :, k] = m0
                x = np.maximum(x - gE[:, 0], m0)
                dg = old
            y = x
            for d in (1, 2, 4, 8, 16):
                o = _shift(y, d, NEG)
                y = np.where(lane >= d, np.maximum(y, o - d * WgE[:, 0]), y)
            keep[w] = (_shift(y, 1, NEG), y[:, 31])
            phase[w] = 1
        elif phase[w] == 1:
            e_lanes, y31 = keep[w]
            e_warp = np.full((B,), NEG, np.int64)
            if w > 0:
                slot = i % DEPTH
                assert ring_row[w - 1, slot] == i, \
                    'ring slot overwritten or not yet written'
                ring_seen[w - 1, slot] = True
                e_warp = ring_e[:, w - 1, slot]
                left_M[:, w, 0] = ring_m[:, w - 1, slot]
            e = np.maximum(e_lanes, e_warp[:, None] - lane * WgE[:, 0])
            rb = np.broadcast_to(MB[:, 0], (B, 32)).copy()
            rk = np.zeros((B, 32), np.int64)
            for k in range(W):
                m0 = M[:, w, :, k]
                m = np.maximum(m0, e - gO[:, 0])
                e = np.maximum(e - gE[:, 0], m0)
                M[:, w, :, k] = m
                better = valid[w, :, k] & (m > rb)
                rb = np.where(better, m, rb)
                rk = np.where(better, k, rk)
            j = col[w, :, 0] + rk
            take = (rb > best[:, w]) | ((rb == best[:, w]) & (j < best_j[:, w]))
            best[:, w] = np.where(take, rb, best[:, w])
            best_i[:, w] = np.where(take, i, best_i[:, w])
            best_j[:, w] = np.where(take, j, best_j[:, w])
            keep[w] = (e_warp, y31)
            phase[w] = 2
        else:
            e_warp, y31 = keep.pop(w)
            if w + 1 < NW:
                slot = i % DEPTH
                assert ring_seen[w, slot], 'ring slot overwritten unread'
                ring_e[:, w, slot] = np.maximum(e_warp - 32 * WgE[:, 0, 0],
                                                y31)
                ring_m[:, w, slot] = M[:, w, 31, W - 1]
                ring_row[w, slot] = i
                ring_seen[w, slot] = False
            done[w] = i + 1
            phase[w] = 0

    # score from M; then the contract's order over every thread
    s = best - MB
    none = s <= 0
    s = np.where(none, 0, s).reshape(B, -1)
    bi = np.where(none, -1, best_i).reshape(B, -1)
    bj = np.where(none, INT_MAX, best_j).reshape(B, -1)
    order = np.lexsort((bi, bj, -s), axis=1)[:, 0]
    rows = np.arange(B)
    s, bi, bj = s[rows, order], bi[rows, order], bj[rows, order]
    none = s <= 0
    return [np.where(none, 0, s).astype(np.int32),
            np.where(none, -1, bi).astype(np.int32),
            np.where(none, -1, bj).astype(np.int32)]


def _jax(q, r, params):
    return [np.asarray(t) for t in jsw.sw_score_ends(
        q, r, jsw.SWParams(*params))]


def width_lrs(W):
    """Reference widths at the edges of a plan's runs: one column, a run
    (W +- 1), a warp (32W +- 1) and past two warps."""
    return (1, W - 1, W + 1, 32 * W - 1, 32 * W + 1, 64 * W + 3)


@functools.lru_cache(maxsize=None)
def _cases(W, params):
    """tools/sw_cases.py's wavefront rows (queries of 1 to 65 rows, N,
    mid-row PAD, all-PAD rows, twins) and chain jobs (best cell in the
    first and the last column, twins, N rows) at each of width_lrs(W)."""
    out = []
    for t, Lr in enumerate(width_lrs(W)):
        Lr = max(1, Lr)
        rng = np.random.default_rng(97 * W + 13 * t + sum(params))
        out.append(wave_cases(rng, Lr, (1, 2, 31, 33, 40)))
        out.append(chain_cases(rng, 7, 21, Lr))
    return out


@pytest.mark.parametrize('W', kexp.ROWSCAN_WIDTHS)
@pytest.mark.parametrize('params', PARAMS)
def test_rowscan_emulation_matches_jax(W, params):
    positive = 0
    for t, (q, r) in enumerate(_cases(W, params)):
        want = _jax(q, r, params)
        got = emulate_rowscan(q, r, np.tile(params, (len(q), 1)), W,
                              POLICIES[t % 3], seed=t)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        positive += int((want[0] > 0).sum())
    assert positive > 0


@pytest.mark.parametrize('policy', POLICIES)
def test_interleavings_agree(policy):
    """Warp 0 as far ahead as the ring allows (low_first), the last warp
    waiting on every row (high_first), and random turns: one answer, that
    of JAX, on rows longer than the ring."""
    rng = np.random.default_rng(11)
    q, r = chain_cases(rng, 7, 3 * DEPTH + 5, 4 * 32 * 4 + 9)
    want = _jax(q, r, PARAMS[1])
    for seed in range(2):
        got = emulate_rowscan(q, r, np.tile(PARAMS[1], (len(q), 1)), 4,
                              policy, seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_a_writer_that_does_not_wait_fails():
    """Without the writer's wait for warp w+1, warp 0 run ahead overwrites
    a ring slot before warp 1 read it: the emulation's check fires."""
    rng = np.random.default_rng(12)
    q, r = chain_cases(rng, 3, DEPTH + 3, 2 * 32 * 4)
    with pytest.raises(AssertionError, match='overwritten unread'):
        emulate_rowscan(q, r, np.tile(PARAMS[0], (3, 1)), 4, 'low_first',
                        reader_wait=False)


def test_equal_score_and_column_keeps_the_earlier_row():
    """One motif at three query rows against one reference column run:
    every pairing ends at the same column with the same score; the
    earliest row must win, under every interleaving."""
    motif = np.array([0, 1, 2, 3, 0, 2], np.int8)
    q = np.full((2, 40), 4, np.int8)
    r = np.full((2, 300), 4, np.int8)
    for at in (3, 17, 31):
        q[:, at:at + 6] = motif
    r[:, 140:146] = motif
    r[1, 250:256] = motif
    want = _jax(q, r, PARAMS[0])
    assert list(want[1]) == [8, 8] and list(want[2]) == [145, 145]
    for policy in POLICIES:
        got = emulate_rowscan(q, r, np.tile(PARAMS[0], (2, 1)), 4, policy)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('B,Lr,plan', [
    (512, 4096, (32, 4, 2)),       # the bench shape
    (512, 1024, (16, 2, 4)),       # the square: W 32 gives 512 warps
    (64, 16384, (32, 16, 1)),      # call's shapes: 16 warps a row
    (128, 16384, (32, 16, 1)),
    (4096, 128, (4, 1, 8)),        # 4096x32x128
    (4096, 130, (8, 1, 8)),
    (1, 1, (4, 1, 8)),
    (8, 12000, (32, 12, 1)),
    (20, 4096, (8, 16, 1)),        # halved to 4 for the fill, 8 for 16 warps
])
def test_rowscan_plan(B, Lr, plan):
    assert kexp.rowscan_plan(B, Lr) == kexp.RowscanPlan(*plan)


def test_rowscan_plan_rule():
    """W is the rule's unless a warp of fewer columns a thread holds the
    reference, wider where the row would need more than 16 warps; a plan
    never asks more of a block than the kernel takes; above
    ROWSCAN_MAX_LR it raises."""
    assert kexp.ROWSCAN_WIDTH == 32 and kexp.ROWSCAN_MAX_LR == 16384
    assert kexp.rowscan_plan(512, 4096, 8) == kexp.RowscanPlan(8, 16, 1)
    assert kexp.rowscan_plan(512, 16384, 4) == kexp.RowscanPlan(32, 16, 1)
    for B in (1, 64, 512, 5000):
        for Lr in (1, 33, 127, 129, 1000, 4097, 9000, 16384):
            for width in kexp.ROWSCAN_WIDTHS:
                W, NW, P = kexp.rowscan_plan(B, Lr, width)
                assert W in kexp.ROWSCAN_WIDTHS and NW == -(-Lr // (32 * W))
                assert NW * P <= kexp.ROWSCAN_MAX_WARPS
    with pytest.raises(ValueError, match='reference columns'):
        kexp.rowscan_plan(1, kexp.ROWSCAN_MAX_LR + 1)
