"""The port's batched edit distance (ops/edit.py) against the JAX package's on
the CPU, exact: the plain PyTorch version and the CPU wrapper (the native
Myers core) against JAX ``edit_distance_batch_padded`` (XLA on the CPU) and
JAX ``edit_distance_batch``, on tools/collapse_cases.py's batches (N and
PAD codes, alen or blen 0, lengths 1-300, an odd batch, one-base rows, long
near-equal pairs, junction-curation pairs, N against N, every pair of word
and group edge lengths, a fused round of one-word and multi-word pairs) and
on a seeded random batch; the scalar ``edit_distance`` against its twin.

``emulate_kernel`` is a numpy emulation of csrc/edit_distance.cu's word
recurrence in its schedule (the pattern chosen per route, 32-row words, a
lane per word with its hout handed to the next lane a step later, groups
of 32 words joined by an int8 handoff row, the score read at bit
(n - 1) % 32 of the top word), held exactly to JAX and the plain version at
every pair of lengths in BOUNDARY and on every case; ``edit_rows_plan``
(the native round's plan, over the rows of a padded batch) routes and
refuses codes as the kernel needs."""

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import edit as jedit
from ciri_long_tpu_torch.ops import edit
from ciri_long_tpu_torch.tools.collapse_cases import BOUNDARY, N, edit_cases

CASES = edit_cases(np.random.default_rng(7))
LANES = np.arange(32)


def _peq(x, nx, g):
    """[P, 8, 32] match masks of group g's words: bit r of lane w's word
    for code c is set when x[32 * (32g + w) + r] == c inside nx."""
    P = len(x)
    peq = np.zeros((P, 8, 32), np.uint32)
    for r in range(32):
        i = 32 * (32 * g + LANES) + r                         # [32]
        inside = i[None, :] < nx[:, None]                     # [P, 32]
        code = np.take_along_axis(x, np.minimum(i, x.shape[1] - 1)[None, :]
                                  .repeat(P, 0), 1) & 7
        for c in range(8):
            peq[:, c] |= np.where(inside & (code == c), np.uint32(1) << r,
                                  np.uint32(0)).astype(np.uint32)
    return peq


def emulate_kernel(a, b, alen, blen):
    """csrc/edit_distance.cu in numpy, all pairs at once: the thread route
    (shorter sequence <= 32 codes) takes it as the pattern, the warp route
    the longer; lane w owns word 32g + w of group g and updates text column
    c at step c + w from (code, hin) that lane w - 1 handed over a step
    before (lane 0: the column's code and hin +1, or past the first group
    the hout lane 31 of the group before left in the handoff row)."""
    n = np.clip(alen, 0, a.shape[1]).astype(np.int64)
    m = np.clip(blen, 0, b.shape[1]).astype(np.int64)
    by_warp = np.minimum(n, m) > edit.WORD
    swap = np.where(by_warp, m > n, m < n)
    L = max(a.shape[1], b.shape[1], 1)
    a_, b_ = (np.pad(x.astype(np.int64), ((0, 0), (0, L - x.shape[1])))
              for x in (a, b))
    x = np.where(swap[:, None], b_, a_)
    y = np.where(swap[:, None], a_, b_)
    nx, ny = np.where(swap, m, n), np.where(swap, n, m)
    words = (nx + 31) // 32
    groups = (words + 31) // 32
    top_bit = ((nx - 1) % 32).astype(np.uint32)
    score = nx.copy()
    P = len(n)
    rows = np.arange(P)
    edge = np.ones((P, L), np.int64)             # hin of row 0: +1
    for g in range(int(groups.max(initial=0))):
        g_words = np.clip(words - 32 * g, 0, 32)
        active = LANES[None, :] < g_words[:, None]
        last = g + 1 == groups
        scorer = last[:, None] & (LANES[None, :] == g_words[:, None] - 1)
        hand_off = (~last & (g + 1 < groups))[:, None] & (LANES == 31)[None]
        peq = _peq(x, nx, g)
        pv = np.full((P, 32), 0xffffffff, np.uint32)
        mv = np.zeros((P, 32), np.uint32)
        passed = np.zeros((P, 32), np.int64)
        nxt_edge = edge.copy()
        for d in range(int((ny + g_words).max(initial=1)) - 1):
            col = min(d, L - 1)
            lane0 = np.where(d < ny, (y[:, col] & 7) | ((edge[:, col] + 1)
                                                        << 3), 0)
            inp = np.concatenate([lane0[:, None], passed[:, :-1]], 1)
            c = d - LANES
            live = active & (c[None, :] >= 0) & (c[None, :] < ny[:, None])
            code = inp & 7
            hin = (inp >> 3) - 1
            eq = np.take_along_axis(peq, code[:, None, :], 1)[:, 0]
            xv = eq | mv
            eq = eq | (hin < 0).astype(np.uint32)
            xh = (((eq & pv) + pv) ^ pv) | eq
            ph = mv | ~(xh | pv)
            mh = pv & xh
            phs = (ph << np.uint32(1)) | (hin > 0).astype(np.uint32)
            mhs = (mh << np.uint32(1)) | (hin < 0).astype(np.uint32)
            pv = np.where(live, mhs | ~(xv | phs), pv)
            mv = np.where(live, phs & xv, mv)
            hout = (ph >> np.uint32(31)).astype(np.int64) - \
                (mh >> np.uint32(31)).astype(np.int64)
            bit = top_bit[:, None]
            delta = ((ph >> bit) & 1).astype(np.int64) - \
                ((mh >> bit) & 1).astype(np.int64)
            score += np.where(live & scorer, delta, 0).sum(1)
            handed = live & hand_off
            if handed.any():
                p = rows[handed[:, 31]]
                nxt_edge[p, c[31]] = hout[p, 31]
            passed = np.where(live, code | ((hout + 1) << 3), passed)
        edge = nxt_edge
    return np.where((nx == 0) | (ny == 0), nx + ny, score).astype(np.int32)


def _boundary_batch(rng, n):
    """alen n against every blen of BOUNDARY, codes A..N, b a mutated copy
    of a; both 1025 wide."""
    L = max(BOUNDARY)
    a = np.full((len(BOUNDARY), L), 5, np.int8)
    b = np.full((len(BOUNDARY), L), 5, np.int8)
    x = rng.integers(0, 5, n).astype(np.int8)
    for k, m in enumerate(BOUNDARY):
        a[k, :n] = x
        y = np.resize(x, m) if n else rng.integers(0, 5, m).astype(np.int8)
        y[rng.random(m) < 0.1] = N
        b[k, :m] = y
    return (a, b, np.full(len(BOUNDARY), n, np.int32),
            np.array(BOUNDARY, np.int32))


@pytest.mark.parametrize('n', BOUNDARY)
def test_kernel_emulation_at_word_and_group_edges(n):
    a, b, alen, blen = _boundary_batch(np.random.default_rng(n), n)
    want = np.asarray(jedit.edit_distance_batch_padded(a, b, alen, blen))
    plain = edit.edit_distance_batch_plain(
        *(torch.from_numpy(x) for x in (a, b, alen, blen))).numpy()
    assert np.array_equal(plain, want)
    assert np.array_equal(emulate_kernel(a, b, alen, blen), want)


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_kernel_emulation_matches_jax(case):
    _, a, b, alen, blen = case
    want = np.asarray(jedit.edit_distance_batch_padded(a, b, alen, blen))
    assert np.array_equal(emulate_kernel(a, b, alen, blen), want)


def test_plan_routes_by_the_shorter_sequence_and_refuses_codes():
    a = np.zeros((5, 40), np.int8)
    b = np.zeros((5, 40), np.int8)
    alen = np.array([40, 32, 33, 0, 40], np.int32)
    blen = np.array([40, 40, 33, 40, 10], np.int32)
    def plan():
        return edit.edit_rows_plan(edit._padded_rows(a, alen),
                                   edit._padded_rows(b, blen))

    order, n_thread = plan()
    assert n_thread == 3
    assert order.tolist() == [1, 3, 4, 0, 2]
    b[2, 39] = 8               # past blen: not read, accepted
    plan()
    b[2, 5] = -1
    with pytest.raises(ValueError, match='codes must be 0..7'):
        plan()


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_plain_and_cpu_wrapper_match_jax(case):
    _, a, b, alen, blen = case
    want = np.asarray(jedit.edit_distance_batch_padded(a, b, alen, blen))
    plain = edit.edit_distance_batch_plain(
        *(torch.from_numpy(x) for x in (a, b, alen, blen)))
    assert plain.dtype == torch.int32
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(edit.edit_distance_batch(a, b, alen, blen, 'cpu'),
                          want)
    assert np.array_equal(jedit.edit_distance_batch(a, b, alen, blen), want)


def test_empty_rows_give_the_other_length(rng):
    a = rng.integers(0, 4, (5, 12)).astype(np.int8)
    b = rng.integers(0, 4, (5, 9)).astype(np.int8)
    alen = np.array([0, 12, 0, 3, 7], np.int32)
    blen = np.array([9, 0, 0, 2, 9], np.int32)
    got = edit.edit_distance_batch_plain(
        *(torch.from_numpy(x) for x in (a, b, alen, blen))).numpy()
    assert list(got[:3]) == [9, 12, 0]
    assert np.array_equal(got, edit.edit_distance_batch(a, b, alen, blen,
                                                        'cpu'))


def test_default_lengths_are_the_full_widths(rng):
    a = rng.integers(0, 5, (7, 40)).astype(np.int8)
    b = rng.integers(0, 5, (7, 33)).astype(np.int8)
    want = np.asarray(jedit.edit_distance_batch_padded(
        a, b, np.full(7, 40, np.int32), np.full(7, 33, np.int32)))
    assert np.array_equal(edit.edit_distance_batch(a, b, device='cpu'), want)


def test_lengths_outside_the_widths_raise():
    a = np.zeros((2, 4), np.int8)
    with pytest.raises(ValueError, match='alen'):
        edit.edit_distance_batch(a, a, np.array([5, 1], np.int32), None,
                                 'cpu')
    with pytest.raises(ValueError, match='blen'):
        edit.edit_distance_batch(a, a, None, np.array([-1, 1], np.int32),
                                 'cpu')


def test_auto_takes_the_plain_version_for_cpu_tensors(rng):
    a = torch.from_numpy(rng.integers(0, 5, (3, 10)).astype(np.int8))
    n = torch.full((3,), 10, dtype=torch.int32)
    assert torch.equal(edit.edit_distance_auto(a, a.flip(1), n, n),
                       edit.edit_distance_batch_plain(a, a.flip(1), n, n))


@pytest.mark.parametrize('pair', [('', ''), ('ACGT', ''), ('', 'NN'),
                                  ('ACGTTGCA', 'ACGTGCAA'),
                                  ('NNNN', 'NANA')])
def test_scalar_edit_distance_matches_jax(pair):
    assert edit.edit_distance(*pair) == jedit.edit_distance(*pair)
