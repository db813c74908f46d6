"""csrc/lag_planes.h, the packed lag primitive of csrc/lag_profile.cu and
csrc/tandem_counts.cu, emulated in numpy on the CPU, and the
value route's answer on codes outside 0..5, against the plain versions and
the JAX package:

- ``emulate_launch``: the kernels' schedule word by word (blocks of a
  segment, a chunk of lags and a read; the bit planes staged by ballot in
  one run of words or two; a lane's four lags 32 apart and its shift;
  eq, the k-run's doubling levels and its pipeline, the popcounts; each
  warp's last word; the segments' sums) equal to lag_profile_counts_plain
  and tandem_counts_plain on tools/chain_cases.py's lag_edge_cases (lags
  across words and chunks, W of 120, 4 097 and 4 127, N every 41 codes, a
  read 3 codes short) at k = 1, 2, 3, 5, 8, 11 and 15 (each k-run level
  at both ends) and at segments of 256,
  1 024 and 4 096, and on its wide_cases at the segment lag_plan picks;
- ``emulate_value``: the value route's ids rolled in uint32 equal to the
  plain versions on odd_cases (negative codes, a code 9);
- JAX's ``tandem_counts`` and ``lag_profile`` equal to the port's plain
  versions on those rows (JAX counts lag 4 of the two small rows as 0 and
  1, where ids from the codes' low two bits give 1 and 0);
- ``lag_plan``, ``odd_reads`` (the reads on the value route) and the
  device tallies that ROUTES folds in.
"""

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import period as jperiod
from ciri_long_tpu_torch.ops import period as tperiod
from ciri_long_tpu_torch.tools import chain_cases as cases
from ciri_long_tpu_torch.utils import dispatch

torch.set_num_threads(1)

# csrc/lag_planes.h's constants
WARPS, LANE_LAGS, CHUNK, AHEAD = 16, 4, 2048, 4
MASK = (1 << 32) - 1


def a_words(seg):
    return seg // 32 + AHEAD


def b_words(seg):
    return (seg + CHUNK) // 32 + AHEAD + LANE_LAGS + 3


def funnel(lo, hi, s):
    """__funnelshift_r: the low word of (hi:lo) >> s, s in 0..31."""
    lo, hi = np.asarray(lo, np.uint64), np.asarray(hi, np.uint64)
    return (((hi << np.uint64(32)) | lo) >> np.asarray(s, np.uint64)) \
        & np.uint64(MASK)


def popc(x):
    """Bits set in each word (uint64 holding 32 bits), vectorised."""
    x = np.asarray(x, np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = ((x & np.uint64(0x3333333333333333))
         + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333)))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0f0f0f0f0f0f0f0f)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(
        np.int64)


def stage(row, pos, n):
    """n plane words from position pos: (L, H, V) uint64 [n] of code bit 0,
    code bit 1 and valid (0..3), zero past the row; the last valid
    position staged + 1 (0 if none)."""
    W = len(row)
    p = pos + np.arange(32 * n)
    c = np.where(p < W, row[np.minimum(p, W - 1)].astype(np.int64), 5)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)

    def pack(bits):
        return (bits.reshape(n, 32).astype(np.uint64) * weights).sum(
            axis=1, dtype=np.uint64)

    valid = (c >= 0) & (c < 4)
    end = int(p[valid].max()) + 1 if valid.any() else 0
    return pack((c & 1) == 1), pack((c & 2) == 2), pack(valid), end


def levels(k):
    return k.bit_length() - 1


def emulate_block(row, k, p0, seg, dmin, profile):
    """One block's counts: (num, den) int64 [CHUNK] of lags dmin + 128 warp
    + 32 m + lane, laid out by (warp, m, lane) as the kernel stores them;
    every lane of the block a step at a time, each warp until its own last
    step."""
    L = levels(k)
    bw0 = dmin >> 5
    aw, bw = a_words(seg), b_words(seg)
    if bw0 <= aw:
        b_at = bw0
        ul, uh, uv, end = stage(row, p0, bw0 + bw)
    else:
        b_at = aw
        al_, ah_, av_, e1 = stage(row, p0, aw)
        bl_, bh_, bv_, e2 = stage(row, p0 + 32 * bw0, bw)
        ul, uh, uv = (np.concatenate(x) for x in ((al_, bl_), (ah_, bh_),
                                                  (av_, bv_)))
        end = max(e1, e2)
    warp = np.arange(WARPS)[:, None, None]
    m = np.arange(LANE_LAGS)[None, :, None]
    lane = np.arange(32)[None, None, :]
    wb = dmin + 128 * warp
    room = end - (k - 1) - wb - p0
    nw = np.where(room <= 0, 0, np.minimum((room + 31) >> 5, seg >> 5))
    steps = nw if profile else np.where(nw > 0, nw + L + 1, 0)
    q = b_at + ((wb + lane) >> 5) - bw0
    s = (wb + lane) & 31
    num = np.zeros((WARPS, LANE_LAGS, 32), np.int64)
    den = np.zeros_like(num)
    lv = np.zeros((L + 1, WARPS, LANE_LAGS, 32), np.uint64)
    for w in range(int(steps.max())):
        live = w < steps
        # the words this step reads: A's w (a broadcast), S_{w+m}'s two
        assert w < (aw if b_at == aw else len(ul))
        j = q + w + m
        assert (j + 1)[np.broadcast_to(live, j.shape)].max() < len(ul)
        j = np.minimum(j, len(ul) - 2)
        sl, sh, sv = (funnel(u[j], u[j + 1], s) for u in (ul, uh, uv))
        v = uv[w] & sv
        eq = v & ~((ul[w] ^ sl) | (uh[w] ^ sh)) & np.uint64(MASK)
        if profile:
            num += np.where(live, popc(eq), 0)
            den += np.where(live, popc(v), 0)
            continue
        top = eq
        for h in range(L):
            nxt = lv[h] & funnel(lv[h], top, 1 << h)
            lv[h] = top
            top = nxt
        run = lv[L] & funnel(lv[L], top, k - (1 << L))
        lv[L] = top
        if w > L:
            num += np.where(live, popc(run), 0)
    return num.reshape(-1), den.reshape(-1)


def emulate_launch(reads, max_lag, k, lag_offset, seg, profile):
    """The launch's counts at seg positions a block: (num, den) int64 [B,
    max_lag] summed over each read's segments (reads of codes 0..5: the
    packed route)."""
    B, W = reads.shape
    chunks = -(-max_lag // CHUNK)
    nseg = -(-W // seg)
    num = np.zeros((B, chunks * CHUNK), np.int64)
    den = np.zeros_like(num)
    # the block's lane (warp, m, lane) holds relative lag 128 warp + 32 m +
    # lane
    order = (128 * np.arange(WARPS)[:, None, None]
             + 32 * np.arange(LANE_LAGS)[None, :, None]
             + np.arange(32)[None, None, :]).reshape(-1)
    for b in range(B):
        for c in range(chunks):
            dmin = lag_offset + 1 + c * CHUNK
            for sg in range(nseg):
                n, d = emulate_block(reads[b].astype(np.int64), k, sg * seg,
                                     seg, dmin, profile)
                num[b, c * CHUNK + order] += n
                den[b, c * CHUNK + order] += d
    return num[:, :max_lag], den[:, :max_lag]


def _edge_cases():
    rng = np.random.default_rng(21)
    return [(label, mat, ranges)
            for label, (mat, ranges) in cases.lag_edge_cases(rng).items()]


@pytest.mark.parametrize('seg', [256, 4096])
@pytest.mark.parametrize('label,mat,ranges', _edge_cases(),
                         ids=lambda x: x if isinstance(x, str) else '')
def test_profile_emulation_equals_plain(label, mat, ranges, seg):
    for offset, M in ranges:
        num, den = emulate_launch(mat, M, 1, offset, seg, True)
        want_num, want_den = tperiod.lag_profile_counts_plain(
            torch.from_numpy(mat), M, offset)
        assert np.array_equal(num, want_num.numpy()), (offset, M)
        assert np.array_equal(den, want_den.numpy()), (offset, M)


@pytest.mark.parametrize('k', [1, 2, 3, 5, 8, 11, 15])
@pytest.mark.parametrize('label,mat,ranges', _edge_cases(),
                         ids=lambda x: x if isinstance(x, str) else '')
def test_kmer_emulation_equals_plain(label, mat, ranges, k):
    seg = {1: 4096, 2: 256, 3: 1024, 5: 256, 8: 4096, 11: 1024,
           15: 4096}[k]
    for offset, M in ranges:
        got, _ = emulate_launch(mat, M, k, offset, seg, False)
        want = tperiod.tandem_counts_plain(torch.from_numpy(mat), M, k,
                                           offset)
        assert np.array_equal(got, want.numpy()), (offset, M)
        if offset == 0:
            assert want.sum() > 0


def test_wide_cases_at_planned_segments():
    """tools/chain_cases.py's wide reads (4 097 codes) at the segment
    lag_plan picks on a card of 132 SMs, both kernels."""
    rng = np.random.default_rng(41)
    mat, ranges = cases.wide_cases(rng, (4_097,))['wide W=4097']
    seg = tperiod.lag_plan(len(mat), mat.shape[1], 2048, 132)
    assert seg == 512
    for offset, M in ranges[:4] + ranges[-2:]:
        num, den = emulate_launch(mat, M, 1, offset, seg, True)
        want_num, want_den = tperiod.lag_profile_counts_plain(
            torch.from_numpy(mat), M, offset)
        assert np.array_equal(num, want_num.numpy())
        assert np.array_equal(den, want_den.numpy())
        got, _ = emulate_launch(mat, M, 11, offset, seg, False)
        assert np.array_equal(got, tperiod.tandem_counts_plain(
            torch.from_numpy(mat), M, 11, offset).numpy())


def emulate_value(row, k, i0, i1, d):
    """lag_planes.h's value_pairs: (num, den) over windows i in [i0, i1),
    both ids rolled in uint32 from the codes by value."""
    row = [int(c) for c in row]
    num = den = 0
    if i0 >= i1:
        return 0, 0
    top = 4 ** (k - 1)
    ka = kb = 0
    bad_a = bad_b = 0
    for j in range(k):
        ka = (ka * 4 + row[i0 + j]) & MASK
        kb = (kb * 4 + row[i0 + d + j]) & MASK
        bad_a += row[i0 + j] >= 4
        bad_b += row[i0 + d + j] >= 4
    i = i0
    while True:
        if bad_a == 0 and bad_b == 0:
            den += 1
            num += ka == kb
        if i + 1 >= i1:
            return num, den
        oa, na, ob, nb = row[i], row[i + k], row[i + d], row[i + d + k]
        ka = ((ka - oa * top) * 4 + na) & MASK
        kb = ((kb - ob * top) * 4 + nb) & MASK
        bad_a += (na >= 4) - (oa >= 4)
        bad_b += (nb >= 4) - (ob >= 4)
        i += 1


def test_value_route_equals_plain_and_jax():
    """The value route on odd_cases' small rows, every lag; the port's plain
    versions equal JAX's on them, lag 4 at k = 2 counting 0 and 1."""
    mat, ranges, k = cases.odd_cases(np.random.default_rng(5))['odd W=8']
    W = mat.shape[1]
    x = torch.from_numpy(mat)
    for kk in (k, 1):
        want = tperiod.tandem_counts_plain(x, 7, kk).numpy()
        got = np.array([[emulate_value(row, kk, 0, W - kk + 1 - d, d)[0]
                         for d in range(1, 8)] for row in mat])
        assert np.array_equal(got, want)
    num, den = tperiod.lag_profile_counts_plain(x, 7)
    got = np.array([[emulate_value(row, 1, 0, W - d, d)
                     for d in range(1, 8)] for row in mat])
    assert np.array_equal(got[..., 0], num.numpy())
    assert np.array_equal(got[..., 1], den.numpy())
    jax_counts = np.asarray(jperiod.tandem_counts(mat, 6, 2))
    assert list(jax_counts[:2, 3]) == [0, 1]
    assert np.array_equal(jax_counts, tperiod.tandem_counts(mat, 6, 2,
                                                            device='cpu'))
    for offset, M in ranges:
        assert np.array_equal(
            np.asarray(jperiod.tandem_counts(mat, M, k, lag_offset=offset,
                                             pad_lags=offset + M)),
            tperiod.tandem_counts(mat, M, k, offset, device='cpu'))
        assert np.array_equal(
            np.asarray(jperiod.lag_profile(mat, M, lag_offset=offset,
                                           pad_lags=offset + M)),
            tperiod.lag_profile(mat, M, offset, device='cpu'))


def test_wide_odd_rows_equal_jax():
    """odd_cases' 4 097-code rows: the port's plain versions equal JAX's
    tandem_counts and lag_profile, and the value route's rolled ids equal
    the plain counts on the rows' first windows."""
    mat, ranges, k = cases.odd_cases(np.random.default_rng(5))['odd W=4097']
    for offset, M in ranges:
        want = np.asarray(jperiod.tandem_counts(mat, M, k, lag_offset=offset,
                                                pad_lags=offset + M))
        got = tperiod.tandem_counts(mat, M, k, offset, device='cpu')
        assert np.array_equal(got, want)
        assert np.array_equal(
            np.asarray(jperiod.lag_profile(mat, M, lag_offset=offset,
                                           pad_lags=offset + M)),
            tperiod.lag_profile(mat, M, offset, device='cpu'))
    plain = tperiod.tandem_counts_plain(torch.from_numpy(mat[:, :200]), 40,
                                        2).numpy()
    got = np.array([[emulate_value(row, 2, 0, 200 - 2 + 1 - d, d)[0]
                     for d in range(1, 41)] for row in mat[:, :200]])
    assert np.array_equal(got, plain)


def test_value_route_by_read():
    """odd_reads picks the reads with a code outside 0..5, the value route,
    whatever their width."""
    rng = np.random.default_rng(5)
    for mat, _, _ in cases.odd_cases(rng).values():
        odd = ((mat < 0) | (mat > 5)).any(axis=1)
        assert odd.any() and not odd.all()
        assert np.array_equal(odd, tperiod.odd_reads(
            torch.from_numpy(mat)).numpy())


def test_lag_plan():
    """Segments from 4 096 halved while a launch has under 2 blocks an SM,
    down to 256 and to 16 segments a read."""
    assert tperiod.lag_plan(1104, 4096, 2048, 132) == 4096
    assert tperiod.lag_plan(256, 8192, 2048, 132) == 4096
    assert tperiod.lag_plan(66, 4096, 4096, 132) == 2048
    assert tperiod.lag_plan(6, 16384, 2048, 132) == 1024
    assert tperiod.lag_plan(6, 4097, 2048, 132) == 512
    assert tperiod.lag_plan(6, 4096, 2048, 132) == 256
    assert tperiod.lag_plan(2, 192, 32, 132) == 256


def test_tallies_fold_into_routes():
    """Reads the card counted in its tally reach ROUTES once settle_routes
    runs, and each count once."""
    tally = dispatch.route_tally('lag_value', 'cpu')
    try:
        assert tally.shape == (1,) and tally.dtype == torch.int32
        before = dispatch.ROUTES['lag_value']
        tally[0] += 2
        dispatch.settle_routes()
        dispatch.settle_routes()
        assert dispatch.ROUTES['lag_value'] == before + 2
        assert dispatch.route_tally('lag_value', 'cpu') is tally
    finally:
        dispatch._TALLIES.pop(('lag_value', 'cpu'))
        dispatch.ROUTES['lag_value'] = 0
