"""The CCS tandem pre-screen (port of the screen of
``ciri_long_tpu/ops/period.py``, ROADMAP X3).

For each read, whether any candidate period could clear the host lag vote of
ops/ccs.py::_elect_period: the exact k-mer self-match count at every lag
(``tandem_counts``), summed over each period's relative window, against the
vote's bar.  Those counts dominate the host's votes lag by lag, so a read the
screen drops would get no consensus from find_consensus: the screen never
changes which reads get one.

- ``tandem_counts_plain``: out[b, j] = the positions i whose k-mer equals
  the one at i + d (both windows free of codes >= 4), d = lag_offset + j + 1
  for j in 0..max_lag-1 (JAX's ``tandem_counts``, whose lag ranges are the
  'lag' mesh axis's shards, parallel/mesh.py);
- ``tandem_counts_cuda``: csrc/tandem_counts.cu, csrc/lag_planes.h's
  packed lag primitive at any width (codes as bit planes, 32 windows a
  word, k-runs by doubling); a read with a code outside 0..5 takes its
  value route (JAX's wrapping int32 ids by value, brute force), as in
  csrc/lag_profile.cu; ``odd_reads`` says which; ``tandem_counts``: numpy
  in, numpy out, on ``device``;
- ``lag_profile_plain`` / ``lag_profile_cuda`` (csrc/lag_profile.cu, on
  csrc/lag_planes.h, with the same value route) / ``lag_profile``: JAX's
  ``lag_profile``, the float32 fraction of valid position pairs whose codes
  match at each lag of a range; ``lag_plan`` gives both packed kernels'
  positions a block;
- ``screen_periodic``: JAX's host election over ``tandem_counts`` (numpy);
- ``screen_keep_plain``: the fused election, in int32 as JAX's
  ``screen_keep``, with each read's own lag range ``max_lag`` (its screen
  bucket's b // 2: the support windows clip there, so L // 2 would be
  another function);
- ``screen_keep_cuda``: csrc/screen_keep.cu, one block a read, which counts
  only the pairs of equal k-mers (sorted hash keys, csrc/kmer_pairs.h) or,
  for a low-complexity read, every lag; ``screen_routes_plain`` says
  which;
- ``screen_keep``: numpy in, numpy out, on ``device``.

The support windows [ceil(0.94 l - 4), floor(1.06 l + 4)] come from numpy's
float64 expressions on the host (``support_windows``) and are clipped in
integers, as JAX's program does with its static tables.
"""

import ctypes

import numpy as np
import torch

from ciri_long_tpu_torch.utils.dispatch import (count_launch, resolve_device,
                                                route_tally, span)

PAD = 5
# the JAX screen's length ladder: a read is screened at its bucket's lags
SCREEN_BUCKETS = (512, 1024, 2048, 4096)
SCREEN_MAX_LEN = SCREEN_BUCKETS[-1]    # csrc/screen_keep.cu's MAX_W
MAX_LAG = SCREEN_MAX_LEN // 2
# csrc/kmer_pairs.h's route rule: keys of POS_BITS of window position under
# a hash of the k-mer id, THREADS a block, WALK_CAP keys a thread
POS_BITS = 13
THREADS = 256
WALK_CAP = 256


def screen_bucket(n):
    """The smallest screen bucket holding a read of n codes."""
    for b in SCREEN_BUCKETS:
        if n <= b:
            return b
    raise ValueError('read of {} codes is over the screen ladder'.format(n))


def support_windows(max_lag):
    """The raw (unclipped) support window [lo, hi] of every lag 1..max_lag,
    int64, from JAX's numpy float64 expressions (ops/period.py:157-158)."""
    lags = np.arange(1, max_lag + 1)
    return (np.ceil(0.94 * lags - 4).astype(np.int64),
            np.floor(1.06 * lags + 4).astype(np.int64))


def tandem_counts_plain(reads, max_lag, k=11, lag_offset=0):
    """Plain PyTorch k-mer self-match counts (any device): reads int8
    [B, W] (PAD = 5 past a read), lags lag_offset + 1 .. lag_offset +
    max_lag (those past W - 1 count 0).  Returns int32 [B, max_lag]."""
    B, W = reads.shape
    dev = reads.device
    out = torch.zeros((B, max_lag), dtype=torch.int32, device=dev)
    if W < k:
        return out
    x = reads.to(torch.int32)
    padded = torch.nn.functional.pad(x, (0, k), value=PAD)
    kid = torch.zeros((B, W), dtype=torch.int32, device=dev)
    vk = torch.ones((B, W), dtype=torch.bool, device=dev)
    for j in range(k):
        shifted = padded[:, j:j + W]
        kid = kid * 4 + torch.where(shifted < 4, shifted, 0)
        vk &= shifted < 4
    vk &= torch.arange(W, device=dev)[None, :] <= W - k
    for d in range(lag_offset + 1, min(lag_offset + max_lag, W - 1) + 1):
        eq = (kid[:, :W - d] == kid[:, d:]) & vk[:, :W - d] & vk[:, d:]
        out[:, d - lag_offset - 1] = eq.sum(dim=1, dtype=torch.int32)
    return out


_TANDEM_SYMBOLS = {
    'tandem_counts_launch': ([ctypes.c_void_p] + [ctypes.c_int] * 6
                             + [ctypes.c_void_p] * 4, ctypes.c_int),
}
# csrc/lag_planes.h (csrc/tandem_counts.cu and csrc/lag_profile.cu): lags
# a block (a grid dimension: at most 65 535
# chunks of them); positions a block from SEG_MAX down to SEG_MIN, and at
# most SEGS segments a read (each block reads its whole row once)
LAG_BLOCK = 2048
MAX_CHUNKS = 65535
SEG_MAX = 4096
SEG_MIN = 256
SEGS = 16
_SMS = {}


def lag_plan(B, W, max_lag, sms):
    """csrc/lag_planes.h's positions a block for B reads of W codes at
    max_lag lags on a card of ``sms`` SMs: SEG_MAX, halved while the
    launch's blocks (reads x chunks of lags x segments) number under 2 sms,
    down to SEG_MIN and to a segment no shorter than W / SEGS."""
    chunks = -(-max_lag // LAG_BLOCK)
    seg = SEG_MAX
    while (seg // 2 >= max(SEG_MIN, W / SEGS)
           and B * chunks * -(-W // seg) < 2 * sms):
        seg //= 2
    return seg


def _plan(dev, B, W, max_lag):
    """lag_plan on ``dev``'s SM count (read once a device)."""
    key = str(dev)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(dev).multi_processor_count
    return lag_plan(B, W, max_lag, _SMS[key])


def odd_reads(reads):
    """Which reads (int8 [B, W], any device) hold a code outside 0..5: the
    kernels' value route.  Returns bool [B]."""
    return ((reads < 0) | (reads > 5)).any(dim=1)


def tandem_counts_cuda(reads, max_lag, k=11, lag_offset=0, routes=None):
    """csrc/tandem_counts.cu on a CUDA tensor: reads int8 [B, W] (any
    codes), contiguous; max_lag >= 1, lag_offset >= 0.  Same output as
    tandem_counts_plain; a ``routes`` uint8 [B] tensor on the device, if
    given, gets each read's route (0 the bit planes, 1 the value route of a
    read with a code outside 0..5, counted in reads in
    ROUTES['tandem_value'] once settle_routes runs; odd_reads says which).
    Raises on anything else and when the launch is refused."""
    from ciri_long_tpu_torch.ops import _build

    if reads.dtype != torch.int8 or reads.dim() != 2:
        raise TypeError('tandem_counts_cuda needs int8 reads [B, W] (got {} '
                        '{})'.format(reads.dtype, tuple(reads.shape)))
    B, W = reads.shape
    if not (W >= 1 and 1 <= k <= 15 and 1 <= max_lag <= LAG_BLOCK
            * MAX_CHUNKS and lag_offset >= 0):
        raise ValueError('tandem_counts_cuda takes W >= 1, k in 1..15, '
                         'max_lag in 1..{} and lag_offset >= 0 (got W={}, '
                         'k={}, max_lag={}, lag_offset={})'.format(
                             LAG_BLOCK * MAX_CHUNKS, W, k, max_lag,
                             lag_offset))
    if not reads.is_cuda:
        raise ValueError('tandem_counts_cuda needs a CUDA tensor (got {})'
                         .format(reads.device))
    if not reads.is_contiguous():
        raise ValueError('tandem_counts_cuda needs contiguous reads')
    dev = reads.device
    if routes is not None and (routes.device != dev
                               or routes.dtype != torch.uint8
                               or tuple(routes.shape) != (B,)
                               or not routes.is_contiguous()):
        raise ValueError('tandem_counts_cuda: routes must be a contiguous '
                         'uint8 [B] tensor on the reads\' device')
    seg = _plan(dev, B, W, max_lag)
    # the blocks add into out with more than one segment a read
    out = (torch.zeros if W > seg else torch.empty)(
        (B, max_lag), dtype=torch.int32, device=dev)
    tally = route_tally('tandem_value', dev)
    lib = _build.load('tandem_counts.cu', _TANDEM_SYMBOLS)
    with torch.cuda.device(dev):
        rc = lib.tandem_counts_launch(
            reads.data_ptr(), B, W, int(k), int(lag_offset), int(max_lag),
            seg, out.data_ptr(),
            None if routes is None else routes.data_ptr(),
            tally.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('tandem_counts launch failed: cudaError {} (B={}, '
                           'W={}, max_lag={})'.format(rc, B, W, max_lag))
    count_launch('tandem_counts')
    return out


@span('tandem_counts')
def tandem_counts(reads, max_lag, k=11, lag_offset=0, pad_lags=None,
                  device='cuda'):
    """JAX's ``tandem_counts`` on ``device``: numpy reads int8 [B, L] (PAD
    = 5), lags lag_offset + 1 .. lag_offset + max_lag; numpy int32 [B,
    max_lag] out.  The kernel on the card, the plain version on the CPU.
    ``pad_lags``, JAX's static bound on lag_offset + max_lag, is checked,
    not needed."""
    if pad_lags is not None and lag_offset + max_lag > pad_lags:
        raise ValueError('lag_offset + max_lag = {} passes pad_lags = {}'
                         .format(lag_offset + max_lag, pad_lags))
    device = resolve_device(device)
    reads = torch.from_numpy(np.ascontiguousarray(reads, np.int8))
    if device.type == 'cpu':
        out = tandem_counts_plain(reads, max_lag, k, lag_offset)
    else:
        out = tandem_counts_cuda(reads.to(device), max_lag, k, lag_offset)
    return out.cpu().numpy()


def lag_profile_counts_plain(reads, max_lag, lag_offset=0):
    """The two counts of JAX's ``lag_profile`` in plain PyTorch (any
    device): reads int8 [B, W]; for lags d = lag_offset + 1 .. lag_offset +
    max_lag, num the positions i with i + d < W whose codes i and i + d are
    both valid (< 4) and equal, den those with both valid.  Returns (num,
    den), int32 [B, max_lag] each (0 for lags past W - 1)."""
    B, W = reads.shape
    x = reads.to(torch.int32)
    v = x < 4
    num = torch.zeros((B, max_lag), dtype=torch.int32, device=reads.device)
    den = torch.zeros_like(num)
    for d in range(lag_offset + 1, min(lag_offset + max_lag, W - 1) + 1):
        both = v[:, :W - d] & v[:, d:]
        num[:, d - lag_offset - 1] = (both & (x[:, :W - d] == x[:, d:])).sum(
            dim=1, dtype=torch.int32)
        den[:, d - lag_offset - 1] = both.sum(dim=1, dtype=torch.int32)
    return num, den


def lag_profile_plain(reads, max_lag, lag_offset=0):
    """JAX's ``lag_profile`` in plain PyTorch (any device): float32 [B,
    max_lag], num / max(den, 1) of lag_profile_counts_plain, the two
    counts made float32 and divided once (bit-equal to JAX's)."""
    num, den = lag_profile_counts_plain(reads, max_lag, lag_offset)
    return num.to(torch.float32) / den.clamp(min=1).to(torch.float32)


_PROFILE_SYMBOLS = {
    'lag_profile_launch': ([ctypes.c_void_p] + [ctypes.c_int] * 5
                           + [ctypes.c_void_p] * 4, ctypes.c_int),
}


def lag_profile_cuda(reads, max_lag, lag_offset=0):
    """csrc/lag_profile.cu on a CUDA tensor: reads int8 [B, W] (any width,
    any codes), contiguous; 1 <= max_lag <= LAG_BLOCK * MAX_CHUNKS,
    lag_offset >= 0.  Same output as lag_profile_plain, bit for bit; a read
    with a code outside 0..5 takes the value route, counted in reads in
    ROUTES['lag_value'] once settle_routes runs.  Raises on anything else
    and when the launch is refused."""
    from ciri_long_tpu_torch.ops import _build

    if reads.dtype != torch.int8 or reads.dim() != 2:
        raise TypeError('lag_profile_cuda needs int8 reads [B, W] (got {} {})'
                        .format(reads.dtype, tuple(reads.shape)))
    B, W = reads.shape
    if not (W >= 1 and 1 <= max_lag <= LAG_BLOCK * MAX_CHUNKS
            and lag_offset >= 0):
        raise ValueError('lag_profile_cuda takes W >= 1, max_lag in 1..{} and '
                         'lag_offset >= 0 (got W={}, max_lag={}, lag_offset='
                         '{})'.format(LAG_BLOCK * MAX_CHUNKS, W, max_lag,
                                      lag_offset))
    if not reads.is_cuda:
        raise ValueError('lag_profile_cuda needs a CUDA tensor (got {})'
                         .format(reads.device))
    if not reads.is_contiguous():
        raise ValueError('lag_profile_cuda needs contiguous reads')
    dev = reads.device
    out = torch.empty((B, max_lag), dtype=torch.float32, device=dev)
    seg = _plan(dev, B, W, max_lag)
    # with more than one segment a read: the counts (num, den) of each lag,
    # then each (read, chunk of lags)'s blocks arrived
    acc = (torch.zeros(B * (2 * max_lag + -(-max_lag // LAG_BLOCK)),
                       dtype=torch.int32, device=dev) if W > seg else None)
    tally = route_tally('lag_value', dev)
    lib = _build.load('lag_profile.cu', _PROFILE_SYMBOLS)
    with torch.cuda.device(dev):
        rc = lib.lag_profile_launch(
            reads.data_ptr(), B, W, int(lag_offset), int(max_lag), seg,
            out.data_ptr(), None if acc is None else acc.data_ptr(),
            tally.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('lag_profile launch failed: cudaError {} (B={}, '
                           'W={}, max_lag={})'.format(rc, B, W, max_lag))
    count_launch('lag_profile')
    return out


@span('lag_profile')
def lag_profile(reads, max_lag, lag_offset=0, pad_lags=None, device='cuda'):
    """JAX's ``lag_profile`` (ciri_long_tpu/ops/period.py:55) on
    ``device``: numpy reads int8 [B, L] (PAD = 5), lags lag_offset + 1 ..
    lag_offset + max_lag; numpy float32 [B, max_lag] out, the match
    fraction of each lag.  The kernel on the card, the plain version on the
    CPU.  ``pad_lags``, JAX's static bound on lag_offset + max_lag, is
    checked, not needed."""
    if pad_lags is not None and lag_offset + max_lag > pad_lags:
        raise ValueError('lag_offset + max_lag = {} passes pad_lags = {}'
                         .format(lag_offset + max_lag, pad_lags))
    device = resolve_device(device)
    reads = torch.from_numpy(np.ascontiguousarray(reads, np.int8))
    if device.type == 'cpu':
        out = lag_profile_plain(reads, max_lag, lag_offset)
    else:
        out = lag_profile_cuda(reads.to(device), max_lag, lag_offset)
    return out.cpu().numpy()


def screen_periodic(counts, lengths, min_period=30, min_units=2.0):
    """JAX's host election over tandem_counts (ciri_long_tpu/ops/
    period.py:171-200), numpy: keep[b] is False only when no candidate
    period l in [min_period, L / min_units] has support >= max(8, 0.05 L)
    within its relative window [0.94 l - 4, 1.06 l + 4] (support_windows,
    clipped); a read under 2 min_period is dropped, one whose period range
    passes the counts' lags (L / min_units > max_lag) is kept."""
    counts = np.asarray(counts)
    max_lag = counts.shape[1]
    lags = np.arange(1, max_lag + 1)
    lo_raw, hi_raw = support_windows(max_lag)
    lo = np.clip(lo_raw, 1, max_lag + 1)
    hi = np.clip(hi_raw, 0, max_lag)
    keep = np.zeros(len(lengths), bool)
    for b, L in enumerate(lengths):
        if L < 2 * min_period:
            continue
        if L / min_units > max_lag:
            keep[b] = True
            continue
        cs = np.concatenate([[0], np.cumsum(counts[b])])
        sup = cs[hi] - cs[lo - 1]
        valid_l = (lags >= min_period) & (lags <= L / min_units)
        keep[b] = bool(np.any(sup[valid_l] >= max(8, 0.05 * L)))
    return keep


def screen_keys(row, k=11):
    """csrc/kmer_pairs.h's sorted keys of one read's codes (numpy int
    [W]): hash(kid) << POS_BITS | i for each valid window i, the hash
    Fibonacci hashing of the k-mer id to 32 - POS_BITS bits; uint64 values
    of 32 bits, ascending."""
    x = np.asarray(row).astype(np.int64)
    n = len(x) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    ok = x < 4
    kid = np.zeros(n, np.int64)
    valid = np.ones(n, bool)
    for j in range(k):
        kid = kid * 4 + np.where(ok[j:j + n], x[j:j + n], 0)
        valid &= ok[j:j + n]
    pos = np.nonzero(valid)[0].astype(np.uint64)
    h = ((kid[valid].astype(np.uint64) * np.uint64(2654435761))
         & np.uint64(0xffffffff)) >> np.uint64(POS_BITS)
    return np.sort((h << np.uint64(POS_BITS)) | pos)


def _lag_route(row, lo, hi, k):
    """Whether csrc/kmer_pairs.h counts lags lo..hi of one read on its lag
    route: thread t of the block walks, for each sorted key s = t, t +
    THREADS, ..., the keys in [key_s + lo, key_s + min(hi, nwin - 1)] (nwin
    the last valid window + 1); a read whose walk passes WALK_CAP keys in
    some thread is low-complexity and counts every lag.  A read with
    nothing to count walks no key."""
    keys = screen_keys(row, k)
    if not len(keys):
        return False
    hi = min(int(hi), int((keys & np.uint64(2 ** POS_BITS - 1)).max()))
    if lo > hi:
        return False
    walk = (np.searchsorted(keys, keys + np.uint64(hi), 'right')
            - np.searchsorted(keys, keys + np.uint64(lo), 'left'))
    per_thread = np.bincount(np.arange(len(keys)) % THREADS, walk,
                             minlength=THREADS)
    return bool((per_thread > WALK_CAP).any())


def screen_routes_plain(reads, max_lag, k=11):
    """Which route csrc/screen_keep.cu takes for each read (numpy reads
    [B, W], max_lag an int or [B] ints): True for the lag route, over lags
    1..M (``_lag_route``).  Returns bool [B]."""
    reads = np.asarray(reads)
    lags = np.broadcast_to(np.asarray(max_lag, np.int64), (len(reads),))
    return np.array([_lag_route(row, 1, M, k)
                     for row, M in zip(reads, lags)], bool)


def _lag_ranges(max_lag, B, device):
    m = torch.as_tensor(max_lag, dtype=torch.int32, device=device)
    m = m.expand(B) if m.dim() == 0 else m
    if B and (int(m.min()) < 1 or int(m.max()) > MAX_LAG):
        raise ValueError('max_lag must lie in 1..{}'.format(MAX_LAG))
    return m


def screen_keep_plain(reads, lengths, max_lag, k=11, min_period=30,
                      min_units=2.0):
    """Plain PyTorch screen (any device): reads int8 [B, W], lengths [B],
    max_lag an int or [B] ints.  keep[b] is True when some lag l in
    1..max_lag[b] with l >= min_period and l * min_units <= L (float32) has
    support sup >= 8 and 20 sup >= L.  Returns bool [B]."""
    B = reads.shape[0]
    dev = reads.device
    m = _lag_ranges(max_lag, B, dev)
    if B == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    mmax = int(m.max())
    counts = tandem_counts_plain(reads, mmax, k)
    cs = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                    torch.cumsum(counts, dim=1, dtype=torch.int32)], dim=1)
    lo_raw, hi_raw = (torch.from_numpy(t).to(dev)
                      for t in support_windows(mmax))
    M = m.to(torch.int64)[:, None]
    lo = torch.minimum(lo_raw.clamp(min=1)[None, :], M + 1)
    hi = torch.minimum(hi_raw.clamp(min=0)[None, :], M)
    sup = torch.gather(cs, 1, hi) - torch.gather(cs, 1, lo - 1)
    L = torch.as_tensor(lengths, device=dev).to(torch.int32)[:, None]
    lags = torch.arange(1, mmax + 1, dtype=torch.int32, device=dev)[None, :]
    valid = ((lags <= M) & (lags >= min_period)
             & (lags.to(torch.float32) * min_units <= L.to(torch.float32)))
    ok = (sup >= 8) & (20 * sup >= L)
    return (valid & ok).any(dim=1)


_SYMBOLS = {
    'screen_keep_launch': ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                           + [ctypes.c_float] + [ctypes.c_void_p] * 3,
                           ctypes.c_int),
}
_WINDOWS = {}


def card_windows(device):
    """support_windows(MAX_LAG) as int32 tensors on ``device``, uploaded
    once a device (every lag range is a prefix of it)."""
    key = str(device)
    if key not in _WINDOWS:
        _WINDOWS[key] = tuple(torch.from_numpy(t.astype(np.int32)).to(device)
                              for t in support_windows(MAX_LAG))
    return _WINDOWS[key]


def screen_keep_cuda(reads, lengths, max_lag, k=11, min_period=30,
                     min_units=2.0, routes=None):
    """csrc/screen_keep.cu on CUDA tensors: reads int8 [B, W] (W <=
    SCREEN_MAX_LEN), lengths and max_lag int32 [B] (each in 1..MAX_LAG),
    contiguous, on one device.  Same output as screen_keep_plain; a
    ``routes`` uint8 [B] tensor on the device, if given, gets each read's
    route (1 the lag route, 0 the pair route; screen_routes_plain).
    Raises on anything else and when the launch is refused."""
    from ciri_long_tpu_torch.ops import _build

    tensors = (reads, lengths, max_lag)
    dev = reads.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError('screen_keep_cuda needs its tensors on one CUDA '
                         'device (got {})'.format([str(t.device)
                                                   for t in tensors]))
    if (reads.dtype != torch.int8 or lengths.dtype != torch.int32
            or max_lag.dtype != torch.int32):
        raise TypeError('screen_keep_cuda needs int8 reads and int32 lengths '
                        'and lag ranges')
    B = reads.shape[0] if reads.dim() == 2 else -1
    if (reads.dim() != 2 or tuple(lengths.shape) != (B,)
            or tuple(max_lag.shape) != (B,)):
        raise ValueError('screen_keep_cuda needs [B, W], [B] and [B] (got {})'
                         .format([tuple(t.shape) for t in tensors]))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('screen_keep_cuda needs contiguous inputs')
    if routes is not None and (routes.device != dev
                               or routes.dtype != torch.uint8
                               or tuple(routes.shape) != (B,)
                               or not routes.is_contiguous()):
        raise ValueError('screen_keep_cuda: routes must be a contiguous '
                         'uint8 [B] tensor on the reads\' device')
    W = reads.shape[1]
    if W > SCREEN_MAX_LEN or not 1 <= k <= 15:
        raise ValueError('screen_keep_cuda takes W <= {} and k in 1..15 (got '
                         'W={}, k={})'.format(SCREEN_MAX_LEN, W, k))
    lo_raw, hi_raw = card_windows(dev)
    keep = torch.empty(B, dtype=torch.uint8, device=dev)
    lib = _build.load('screen_keep.cu', _SYMBOLS)
    with torch.cuda.device(dev):
        rc = lib.screen_keep_launch(
            reads.data_ptr(), B, W, lengths.data_ptr(), max_lag.data_ptr(),
            lo_raw.data_ptr(), hi_raw.data_ptr(), int(k), int(min_period),
            float(min_units), keep.data_ptr(),
            None if routes is None else routes.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('screen_keep launch failed: cudaError {} (B={}, '
                           'W={})'.format(rc, B, W))
    count_launch('screen_keep')
    return keep.bool()


@span('screen_keep')
def screen_keep(reads, lengths, max_lag, k=11, min_period=30, min_units=2.0,
                device='cuda'):
    """The screen of padded reads on ``device``: numpy reads int8 [B, W]
    (PAD = 5 past each read), lengths [B], max_lag an int or [B] ints in
    1..MAX_LAG; numpy bool keep [B] out.  The kernel on the card, the plain
    version on the CPU."""
    device = resolve_device(device)
    reads = torch.from_numpy(np.ascontiguousarray(reads, np.int8))
    B = reads.shape[0]
    lengths = torch.from_numpy(np.ascontiguousarray(lengths, np.int32))
    m = _lag_ranges(max_lag, B, 'cpu').contiguous()
    if device.type == 'cpu':
        keep = screen_keep_plain(reads, lengths, m, k, min_period, min_units)
    else:
        keep = screen_keep_cuda(reads.to(device), lengths.to(device),
                                m.to(device), k, min_period, min_units)
    return keep.cpu().numpy()
