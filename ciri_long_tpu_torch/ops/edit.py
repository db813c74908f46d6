"""Batched global edit distance (Levenshtein) on PyTorch.

Port of ``ciri_long_tpu/ops/edit.py``.  The pipeline's bulk use is collapse's
pairwise distance matrix over homopolymer-compressed cluster sequences and
its junction curation (reference collapse.py:161-173, 467-473): one batched
call of [B] pairs instead of per-pair native calls.

``edit_distance_batch_plain`` is the plain PyTorch version (the JAX
formulation: a scan over the rows of ``a``, insertions resolved exactly by a
prefix min, D[i][j] = min_k<=j (C[k] + (j - k)) = cummin(C[k] - k) + j,
valid because an insertion costs exactly 1); ``edit_distance_cuda`` launches
the hand-written kernel ``csrc/edit_distance.cu`` (Myers/Hyyro bit-parallel:
a thread per pair whose shorter sequence fits one 32-bit word, a warp per
longer pair, the routes planned per pair by ``edit_plan``, which also
refuses codes outside 0..7); ``edit_distance_auto``
takes the kernel for CUDA tensors and the plain version for CPU tensors,
nothing else.  ``edit_distance_batch`` is the numpy entry point on
``device`` (default 'cuda', resolved by ``resolve_device``, which raises
without a GPU): the kernel on the card, and on the CPU the native Myers core
(native/alncore.cpp) when it is built, as the JAX package does on a host
backend, else the plain version.  ``edit_distance_batch_padded`` is JAX's
padded entry (explicit lengths) over it.  Equality is on codes: N (4)
equals N.

The JAX package pads batches and lengths onto bucket ladders to bound XLA
compiles; the outputs do not depend on them, so the port pads to the batch's
own maxima.
"""

import ctypes

import numpy as np
import torch

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


_SYMBOLS = {
    'edit_distance_launch': ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                             + [ctypes.c_void_p] + [ctypes.c_int] * 2
                             + [ctypes.c_void_p] + [ctypes.c_int]
                             + [ctypes.c_void_p] * 2, ctypes.c_int),
}
# codes csrc/edit_distance.cu's match masks cover: 0..7
CODES = 8
# longest sequence of one word: the kernel's thread route
WORD = 32
# longest pattern of one warp's 32 words; longer ones hand off between
# groups through a scratch row
GROUP = 32 * WORD


def _bad_codes(x, lens):
    """True when a code outside 0..CODES-1 lies inside a row's length."""
    if x.size == 0 or (x.min() >= 0 and x.max() < CODES):
        return False
    inside = np.arange(x.shape[1])[None, :] < lens[:, None]
    return bool((((x < 0) | (x >= CODES)) & inside).any())


def edit_plan(a, b, alen, blen, device):
    """The routes of one launch of csrc/edit_distance.cu over numpy a
    [B, La], b [B, Lb] and lengths [B]: (order int32 [B] on ``device``,
    n_thread), the pairs whose shorter sequence fits one word (the thread
    route, lengths clamped as the kernel clamps them) first, then the rest
    (the warp route).  Raises on a code outside 0..7 inside a row's length:
    the kernel's match masks cover no other code."""
    n = np.clip(alen, 0, a.shape[1])
    m = np.clip(blen, 0, b.shape[1])
    if _bad_codes(a, n) or _bad_codes(b, m):
        raise ValueError('edit distance kernel: codes must be 0..{} inside '
                         'the lengths'.format(CODES - 1))
    by_warp = np.minimum(n, m) > WORD
    order = np.argsort(by_warp, kind='stable').astype(np.int32)
    return (torch.from_numpy(order).to(device),
            int(len(order) - by_warp.sum()))


def edit_distance_cuda(a: torch.Tensor, b: torch.Tensor,
                       alen: torch.Tensor, blen: torch.Tensor, plan=None):
    """The hand-written CUDA kernel (csrc/edit_distance.cu) on CUDA tensors:
    a int8 [B, La], b int8 [B, Lb], alen and blen int32 [B], contiguous, on
    one device, codes 0..7.  Same output as edit_distance_batch_plain
    (lengths clamped to [0, La] and [0, Lb]).  ``plan`` is edit_plan's
    answer for these inputs when the caller has it (no copy back from the
    card), else computed from the inputs read back.  Raises on anything
    else, and when the launch is refused.  One launch runs both routes;
    ROUTES counts it once for each route that has pairs."""
    from ciri_long_tpu_torch.ops import _build

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
    La, Lb = a.shape[1], b.shape[1]
    if max(B, La, Lb + 64) >= 2 ** 31:
        raise ValueError("edit_distance_cuda shape {}x{}x{} exceeds the "
                         "kernel's int arguments".format(B, La, Lb))
    dev = a.device
    order, n_thread = plan or edit_plan(
        *(t.cpu().numpy() for t in tensors), dev)
    n_warp = B - n_thread
    lib = _build.load('edit_distance.cu', _SYMBOLS)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    # the group handoff rows; only warp-route patterns over GROUP use them
    edge_len = max(La, Lb)
    edge = torch.empty((n_warp, edge_len) if edge_len > GROUP and n_warp
                       else (1,), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.edit_distance_launch(
            a.data_ptr(), b.data_ptr(), alen.data_ptr(), blen.data_ptr(), La,
            Lb, order.data_ptr(), n_thread, n_warp, edge.data_ptr(),
            edge_len, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('edit_distance launch failed: cudaError {} (B={}, '
                           'La={}, Lb={})'.format(rc, B, La, Lb))
    count_launch('edit_distance', *[route for route, k in
                                    (('edit_thread', n_thread),
                                     ('edit_warp', n_warp)) if k])
    return out


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
    args = [torch.from_numpy(x).to(device) for x in (a, b, alen, blen)]
    if device.type == 'cpu':
        return edit_distance_batch_plain(*args).numpy()
    return edit_distance_cuda(*args, plan=edit_plan(
        a, b, alen, blen, device)).cpu().numpy()


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
