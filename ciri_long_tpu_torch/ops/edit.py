"""Batched global edit distance (Levenshtein) on PyTorch.

Port of ``ciri_long_tpu/ops/edit.py``.  The pipeline's bulk use is collapse's
pairwise distance matrix over homopolymer-compressed cluster sequences and
its junction curation (reference collapse.py:161-173, 467-473): one batched
call of [B] pairs instead of per-pair native calls.

``edit_distance_batch_plain`` is the plain PyTorch version (the JAX
formulation: a scan over the rows of ``a``, insertions resolved exactly by a
prefix min, D[i][j] = min_k<=j (C[k] + (j - k)) = cummin(C[k] - k) + j,
valid because an insertion costs exactly 1).  The hand-written kernel
``csrc/edit_distance.cu`` (Myers/Hyyro bit-parallel: a thread per pair
whose shorter sequence fits one 32-bit word, a warp per longer pair) has
one host driver, ``edit_distance_rows``: on the card one native call over
ragged row views (ops/rows.py; csrc/edit_distance.cu::edit_rows_run plans
the routes, refuses codes outside 0..7, uploads, expands and launches),
on the CPU ``edit_distance_batch`` on the rows padded.  ``edit_rows_plan``
and ``edit_distance_rows_plain`` are its plan in numpy and its round with
the plain version.  ``edit_distance_batch`` is the numpy entry point on
``device`` (default 'cuda', resolved by ``resolve_device``, which raises
without a GPU): on the card ``edit_distance_rows`` over views of its
padded rows, on the CPU the native Myers core (native/alncore.cpp) when it
is built, as the JAX package does on a host backend, else the plain
version.  ``edit_distance_cuda`` is the same round on CUDA tensors and
``edit_distance_auto`` takes it for CUDA tensors and the plain version for
CPU tensors, nothing else.  ``edit_distance_batch_padded`` is JAX's padded
entry (explicit lengths) over ``edit_distance_batch``.  Equality is on
codes: N (4) equals N.

The JAX package pads batches and lengths onto bucket ladders to bound XLA
compiles; the outputs do not depend on them, so the port pads to the batch's
own maxima.
"""

import ctypes
import time

import numpy as np
import torch

from ciri_long_tpu_torch.ops.rows import Rows, check_rows, padded, row_stage
from ciri_long_tpu_torch.utils.dispatch import (count_launch, resolve_device,
                                                span)

BIG = 1 << 28


def edit_distance_batch_plain(a: torch.Tensor, b: torch.Tensor,
                              alen: torch.Tensor, blen: torch.Tensor):
    """Plain PyTorch edit distances (any device): a [B, La] and b [B, Lb]
    integer codes, alen and blen [B].  Returns int32 [B], the distance
    between a[i, :alen[i]] and b[i, :blen[i]]."""
    B, La = a.shape
    Lb = b.shape[1]
    dev = a.device
    i32 = torch.int32
    a = a.to(i32)
    b = b.to(i32)
    alen = alen.to(device=dev, dtype=i32)
    blen = blen.to(device=dev, dtype=torch.int64)
    j_idx = torch.arange(Lb + 1, dtype=i32, device=dev).expand(B, Lb + 1)
    D = j_idx.clone()
    # column 0 of bsub never matches a code; C's column 0 is reset anyway
    bsub = torch.cat([torch.full((B, 1), -1, dtype=i32, device=dev), b], 1)
    big = torch.full((B, 1), BIG, dtype=i32, device=dev)
    for i in range(La):
        sub_cost = (a[:, i:i + 1] != bsub).to(i32)
        diag = torch.cat([big, D[:, :-1]], 1)
        C = torch.minimum(diag + sub_cost, D + 1)
        C[:, 0] = i + 1
        m = torch.cummin(C - j_idx, dim=1).values
        Dn = torch.minimum(C, m + j_idx)
        # rows past this element's length keep their last row
        D = torch.where((i < alen)[:, None], Dn, D)
    return torch.gather(D, 1, blen[:, None])[:, 0]


_ROWS_SYMBOLS = {
    'edit_rows_stage_new': ([ctypes.c_int], ctypes.c_void_p),
    'edit_rows_run': ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p], ctypes.c_int),
}
# edit_rows_run's refusal of a code outside 0..7
_BAD_CODES = -2
# codes csrc/edit_distance.cu's match masks cover: 0..7
CODES = 8
# longest sequence of one word: the kernel's thread route
WORD = 32
# longest pattern of one warp's 32 words; longer ones hand off between
# groups through a scratch row
GROUP = 32 * WORD


def _padded_rows(x, lens):
    """Rows of numpy [B, L] codes, row k the first lens[k] codes of x[k]."""
    B, L = x.shape
    if x.size >= 2 ** 31:
        raise ValueError('edit distance: {}x{} codes exceed int32 '
                         'offsets'.format(B, L))
    return Rows(np.ascontiguousarray(x, np.int8).reshape(-1),
                (np.arange(B) * L).astype(np.int32),
                np.ascontiguousarray(lens, np.int32))


def edit_distance_cuda(a: torch.Tensor, b: torch.Tensor,
                       alen: torch.Tensor, blen: torch.Tensor):
    """edit_distance_rows' native round on CUDA tensors: a int8 [B, La], b
    int8 [B, Lb], alen and blen int32 [B], contiguous, on one device,
    codes 0..7 inside the lengths.  Same output as
    edit_distance_batch_plain (lengths clamped to [0, La] and [0, Lb]), on
    a's device.  Raises on anything else, and when the round fails."""
    tensors = (a, b, alen, blen)
    if not all(t.is_cuda and t.device == a.device for t in tensors):
        raise ValueError('edit_distance_cuda needs a, b, alen and blen on '
                         'one CUDA device (got {})'.format(
                             [str(t.device) for t in tensors]))
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError('edit_distance_cuda needs int8 codes (got {} and '
                        '{})'.format(a.dtype, b.dtype))
    if alen.dtype != torch.int32 or blen.dtype != torch.int32:
        raise TypeError('edit_distance_cuda needs int32 lengths (got {} and '
                        '{})'.format(alen.dtype, blen.dtype))
    B = a.shape[0] if a.dim() == 2 else -1
    if (a.dim() != 2 or b.dim() != 2 or b.shape[0] != B
            or tuple(alen.shape) != (B,) or tuple(blen.shape) != (B,)):
        raise ValueError('edit_distance_cuda needs [B, La], [B, Lb], [B] and '
                         '[B] (got {})'.format([tuple(t.shape)
                                                for t in tensors]))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('edit_distance_cuda needs contiguous inputs')
    x, y, n, m = (t.cpu().numpy() for t in tensors)
    d = edit_distance_rows(_padded_rows(x, np.clip(n, 0, x.shape[1])),
                           _padded_rows(y, np.clip(m, 0, y.shape[1])),
                           a.device)
    return torch.from_numpy(d).to(a.device)


def edit_distance_auto(a: torch.Tensor, b: torch.Tensor, alen: torch.Tensor,
                       blen: torch.Tensor):
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if a.is_cuda:
        return edit_distance_cuda(a, b, alen, blen)
    if all(t.device.type == 'cpu' for t in (a, b, alen, blen)):
        return edit_distance_batch_plain(a, b, alen, blen)
    raise ValueError('edit_distance_auto: unsupported devices {}'.format(
        [str(t.device) for t in (a, b, alen, blen)]))


def _lengths(lens, B, L, name):
    lens = np.full(B, L, np.int32) if lens is None else \
        np.ascontiguousarray(lens, np.int32)
    if lens.shape != (B,) or (B and (lens.min() < 0 or lens.max() > L)):
        raise ValueError('edit_distance_batch: {} must be [B] lengths in '
                         '[0, {}]'.format(name, L))
    return lens


@span('edit_distance_batch')
def edit_distance_batch(a, b, alen=None, blen=None, device='cuda'):
    """Edit distances of padded code batches on ``device``: numpy a [B, La],
    b [B, Lb] and lengths [B] (default: the full widths) in, numpy int32 [B]
    out."""
    device = resolve_device(device)
    a = np.ascontiguousarray(a, np.int8)
    b = np.ascontiguousarray(b, np.int8)
    B = a.shape[0]
    alen = _lengths(alen, B, a.shape[1], 'alen')
    blen = _lengths(blen, B, b.shape[1], 'blen')
    if device.type == 'cpu':
        from ciri_long_tpu_torch.ops.sw import _alncore
        core = _alncore()
        if core is not None:
            return np.frombuffer(core.edit_many(
                a, b, B, a.shape[1], b.shape[1], alen, blen),
                np.int32).copy()
    if device.type == 'cpu':
        return edit_distance_batch_plain(*(torch.from_numpy(x) for x in (
            a, b, alen, blen))).numpy()
    return edit_distance_rows(_padded_rows(a, alen), _padded_rows(b, blen),
                              device)


def _codes_error():
    return ValueError('edit distance kernel: codes must be 0..{} inside '
                      'the lengths'.format(CODES - 1))


def edit_rows_plan(a, b):
    """csrc/edit_distance.cu::edit_rows_run's plan of two ops/rows.py::Rows
    in numpy: (order int32 [B], n_thread), the pairs whose shorter row fits
    one word (the thread route) first, then the rest (the warp route), each
    in pair order.  Raises on a code outside 0..7 inside a row: the
    kernel's match masks cover no other code."""
    for rows in (a, b):
        codes, off, lens = rows
        if len(codes) and (codes.min() < 0 or codes.max() >= CODES):
            at = np.repeat(off.astype(np.int64), lens) + (
                np.arange(int(lens.sum())) -
                np.repeat(np.cumsum(lens) - lens, lens))
            bad = codes[at]
            if ((bad < 0) | (bad >= CODES)).any():
                raise _codes_error()
    by_warp = np.minimum(a.lens, b.lens) > WORD
    order = np.argsort(by_warp, kind='stable').astype(np.int32)
    return order, int(len(order) - by_warp.sum())


def edit_distance_rows(a, b, device='cuda', phases=None):
    """Edit distances of every row pair (a[k], b[k]) of two ops/rows.py::
    Rows: int32 [B], equal to edit_distance_batch_plain on the rows padded.
    Raises on a code outside 0..7 inside a row.  On the card: one call of
    csrc/edit_distance.cu::edit_rows_run with the interpreter's lock
    released, on the device's ops/rows.py::row_stage, one edit_distance
    launch (each route with pairs counted) and one ``fused_rows`` launch
    counted; ``phases`` (a dict) gets the round's ops/sw.py::ROW_PHASES ns
    added.  On the CPU: edit_distance_batch on the rows padded."""
    from ciri_long_tpu_torch.ops import _build
    from ciri_long_tpu_torch.ops.sw import ROW_PHASES, _add_phases

    t0 = time.perf_counter_ns()
    device = resolve_device(device)
    check_rows(a, 'edit_distance_rows a')
    check_rows(b, 'edit_distance_rows b')
    B = len(a.lens)
    if len(b.lens) != B:
        raise ValueError('edit_distance_rows: {} and {} rows'.format(
            B, len(b.lens)))
    if device.type == 'cpu':
        (apad, alen), (bpad, blen) = padded(a), padded(b)
        return edit_distance_batch(apad, bpad, alen, blen, device)
    La = int(a.lens.max(initial=1))
    Lb = int(b.lens.max(initial=1))
    if max(B, La, Lb + 64) >= 2 ** 31:
        raise ValueError("edit_distance_rows shape {}x{}x{} exceeds the "
                         "kernel's int arguments".format(B, La, Lb))
    views = np.stack([a.off, a.lens, b.off, b.lens])
    out = np.empty(B, np.int32)
    info = np.zeros(2, np.int32)
    acodes = np.ascontiguousarray(a.codes)
    bcodes = np.ascontiguousarray(b.codes)
    ns = np.zeros(len(ROW_PHASES), np.float64)
    lib = _build.load('edit_distance.cu', _ROWS_SYMBOLS)
    stage = row_stage(device)
    with stage.lock:
        ns[0] = time.perf_counter_ns() - t0
        rc = lib.edit_rows_run(
            stage.handle(lib, 'edit_rows'), acodes.ctypes.data, len(acodes),
            bcodes.ctypes.data, len(bcodes), views.ctypes.data, B,
            out.ctypes.data, info.ctypes.data, ns[1:4].ctypes.data)
    t1 = time.perf_counter_ns()
    if rc == _BAD_CODES:
        raise _codes_error()
    if rc != 0:
        raise RuntimeError('edit_distance_rows: native round failed: '
                           'cudaError {} (B={}, La={}, Lb={})'.format(
                               rc, B, La, Lb))
    if B:
        count_launch('edit_distance', *[route for route, k in zip(
            ('edit_thread', 'edit_warp'), info.tolist()) if k])
        count_launch('fused_rows')
    ns[4] = time.perf_counter_ns() - t1
    _add_phases(phases, ns)
    return out


def edit_distance_rows_plain(a, b, device='cpu'):
    """edit_distance_rows' native round with the plain version (on
    ``device``): the plan of edit_rows_plan (the code check and the
    routes), the pairs expanded to the widest row of each side, the
    distances in the plan's order."""
    order, _ = edit_rows_plan(a, b)
    (apad, alen), (bpad, blen) = padded(a), padded(b)
    out = np.empty(len(order), np.int32)
    out[order] = edit_distance_batch_plain(
        *(torch.from_numpy(np.ascontiguousarray(x[order])).to(device)
          for x in (apad, bpad, alen, blen))).cpu().numpy()
    return out


def edit_distance_batch_padded(a, b, alen, blen, device='cuda'):
    """JAX's edit_distance_batch_padded (ciri_long_tpu/ops/edit.py:27-58):
    numpy a [B, La], b [B, Lb] (codes 0..7) and lengths alen, blen [B] in,
    int32 [B] out, the distance between a[i, :alen[i]] and b[i, :blen[i]];
    edit_distance_batch on ``device``, the same kernel."""
    return edit_distance_batch(a, b, alen, blen, device=device)


def edit_distance(x: str, y: str) -> int:
    """Scalar edit distance between two strings -- reference parity for
    utils.py:153-159 (`distance`).  Host numpy DP; the batched kernel above
    is the production path."""
    if len(x) == 0:
        return len(y)
    if len(y) == 0:
        return len(x)
    xa = np.frombuffer(x.encode(), np.uint8)
    ya = np.frombuffer(y.encode(), np.uint8)
    prev = np.arange(len(ya) + 1, dtype=np.int32)
    for i, cx in enumerate(xa):
        cur = np.empty_like(prev)
        cur[0] = i + 1
        sub = prev[:-1] + (ya != cx)
        dele = prev[1:] + 1
        np.minimum(sub, dele, out=cur[1:])
        # insertions: prefix-min pass
        np.minimum.accumulate(cur - np.arange(len(ya) + 1), out=cur)
        cur += np.arange(len(ya) + 1)
        prev = cur
    return int(prev[-1])
