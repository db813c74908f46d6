"""Batched affine-gap local alignment (Smith-Waterman) on PyTorch.

Port of ``ciri_long_tpu/ops/sw.py``: same names, same contract, same
bucketing.  Codes A0 C1 G2 T3 N4 PAD5; N scores 0 against everything, PAD
poisons the diagonal term so padded rows and columns never win; a gap of
length L costs gap_open + (L-1)*gap_extend, and gap_open >= gap_extend is
required.  Coordinates are 0-based inclusive (the SSW convention).

``sw_score_ends`` is the plain PyTorch version (the JAX row scan with the
within-row gap resolved by a prefix max); ``sw_score_ends_cuda`` launches
the hand-written kernel ``csrc/sw_score_ends.cu``.  ``sw_score_ends_auto``
takes the kernel for CUDA tensors and the plain version for CPU tensors,
nothing else: a CUDA tensor never falls through to the plain version.

Host arrays come in as numpy; every batch function takes the ``device`` to
run on and returns numpy.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ciri_long_tpu_torch.utils.dispatch import LAUNCHES
from ciri_long_tpu_torch.utils.dispatch import count_dispatch as _count_dispatch

NEG = -(1 << 28)
PAD = 5


class SWParams(NamedTuple):
    match: int = 1
    mismatch: int = 1
    gap_open: int = 1
    gap_extend: int = 1


class SWResult(NamedTuple):
    """Mirrors the fields of the reference PyAlignRes (ssw_wrap.py:267-379)."""
    score: np.ndarray
    query_begin: np.ndarray
    query_end: np.ndarray
    ref_begin: np.ndarray
    ref_end: np.ndarray


def _check_params(params: SWParams):
    if params.gap_open < params.gap_extend:
        raise ValueError('sw_score_ends requires gap_open >= gap_extend '
                         '(got {})'.format(params))


def sw_score_ends(query: torch.Tensor, ref: torch.Tensor, params: SWParams):
    """Plain PyTorch SW score + end coordinates (any device).

    query [B, Lq], ref [B, Lr] integer codes.  Returns int32 score, q_end,
    r_end [B]: the inclusive ends of the optimal local alignment, ties to
    the smallest r_end then the smallest q_end; (0, -1, -1) when no cell
    is positive.  A row scan over the query; within a row the horizontal
    gap is E[j] = max_{k<j}(H0[k] + k*gE) - gO - (j-1)*gE, one cummax."""
    _check_params(params)
    B, Lq = query.shape
    Lr = ref.shape[1]
    dev = query.device
    i32 = torch.int32
    q = query.to(i32)
    r = ref.to(i32)
    gO, gE = params.gap_open, params.gap_extend
    j_idx = torch.arange(Lr, dtype=i32, device=dev).expand(B, Lr)
    j_gE = j_idx * gE
    e_off = gO + (j_idx - 1) * gE
    r_n = r == 4
    r_pad = r >= PAD
    match = torch.tensor(params.match, dtype=i32, device=dev)
    mism = torch.tensor(-params.mismatch, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    col0 = torch.zeros((B, 1), dtype=i32, device=dev)
    col_neg = torch.full((B, 1), NEG, dtype=i32, device=dev)
    no_j = torch.full((), Lr, dtype=i32, device=dev)

    H = torch.zeros((B, Lr), dtype=i32, device=dev)
    F = torch.full((B, Lr), NEG, dtype=i32, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    best_j = torch.full((B,), Lr, dtype=i32, device=dev)
    best_i = torch.full((B,), -1, dtype=i32, device=dev)
    for i in range(Lq):
        qc = q[:, i:i + 1]
        s = torch.where(qc == r, match, mism)
        s = torch.where((qc == 4) | r_n, zero, s)
        s = torch.where((qc >= PAD) | r_pad, neg, s)
        F = torch.maximum(F - gE, H - gO)
        H_diag = torch.cat([col0, H[:, :-1]], dim=1)
        H0 = torch.maximum(H_diag + s, F).clamp_min(0)
        p = torch.cummax(H0 + j_gE, dim=1).values
        E = torch.cat([col_neg, p[:, :-1]], dim=1) - e_off
        H = torch.maximum(H0, E)
        row_best = H.amax(dim=1)
        row_j = torch.where(H == row_best[:, None], j_idx, no_j).amin(dim=1)
        better = (row_best > best) | ((row_best == best) & (row_j < best_j))
        best = torch.where(better, row_best, best)
        best_j = torch.where(better, row_j, best_j)
        best_i = torch.where(better, torch.full_like(best_i, i), best_i)
    none = best <= 0
    return (torch.where(none, zero, best),
            torch.where(none, -1, best_i).to(i32),
            torch.where(none, -1, best_j).to(i32))


_SW_SYMBOLS = {
    'sw_score_ends_launch': (
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
        + [ctypes.c_void_p] * 5, ctypes.c_int),
}


def sw_score_ends_cuda(query: torch.Tensor, ref: torch.Tensor,
                       params: SWParams):
    """The hand-written CUDA kernel (csrc/sw_score_ends.cu) on CUDA tensors:
    query int8 [B, Lq] and ref int8 [B, Lr], contiguous, on one device.
    Same outputs as sw_score_ends.  Raises on anything else, and when the
    launch is refused."""
    from ciri_long_tpu_torch.ops import _build

    _check_params(params)
    if not (query.is_cuda and ref.is_cuda and query.device == ref.device):
        raise ValueError('sw_score_ends_cuda needs query and ref on one CUDA '
                         'device (got {} and {})'.format(query.device,
                                                         ref.device))
    if query.dtype != torch.int8 or ref.dtype != torch.int8:
        raise TypeError('sw_score_ends_cuda needs int8 codes (got {} and '
                        '{})'.format(query.dtype, ref.dtype))
    if query.dim() != 2 or ref.dim() != 2 or query.shape[0] != ref.shape[0]:
        raise ValueError('sw_score_ends_cuda needs [B, Lq] and [B, Lr] '
                         '(got {} and {})'.format(tuple(query.shape),
                                                  tuple(ref.shape)))
    if not (query.is_contiguous() and ref.is_contiguous()):
        raise ValueError('sw_score_ends_cuda needs contiguous inputs')
    B, Lq = query.shape
    Lr = ref.shape[1]
    if max(B, Lq, Lr + 32) >= 2 ** 31:
        raise ValueError('sw_score_ends_cuda shape {}x{}x{} exceeds the '
                         "kernel's int arguments".format(B, Lq, Lr))
    lib = _build.load('sw_score_ends.cu', _SW_SYMBOLS)
    dev = query.device
    score = torch.empty(B, dtype=torch.int32, device=dev)
    q_end = torch.empty(B, dtype=torch.int32, device=dev)
    r_end = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = torch.empty((B, Lr, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_score_ends_launch(
            query.data_ptr(), ref.data_ptr(), B, Lq, Lr, params.match,
            params.mismatch, params.gap_open, params.gap_extend,
            scratch.data_ptr(), score.data_ptr(), q_end.data_ptr(),
            r_end.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('sw_score_ends kernel launch failed: cudaError {} '
                           '(B={}, Lq={}, Lr={})'.format(rc, B, Lq, Lr))
    LAUNCHES['sw_score_ends'] += 1
    return score, q_end, r_end


def sw_score_ends_auto(query: torch.Tensor, ref: torch.Tensor,
                       params: SWParams):
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if query.is_cuda:
        return sw_score_ends_cuda(query, ref, params)
    if query.device.type == 'cpu' and ref.device.type == 'cpu':
        return sw_score_ends(query, ref, params)
    raise ValueError('sw_score_ends_auto: unsupported devices {} and '
                     '{}'.format(query.device, ref.device))


def _reverse_prefix(x: torch.Tensor, end: torch.Tensor, L: int):
    """x[b, end[b] - t] for t in [0, L); positions past the prefix -> PAD.
    One gather (ROADMAP X1)."""
    t = torch.arange(L, device=x.device)
    idx = end.to(torch.int64)[:, None] - t[None, :]
    gathered = torch.gather(x, 1, idx.clamp(0, max(L - 1, 0)))
    return torch.where(idx >= 0, gathered,
                       torch.full_like(gathered, PAD)).contiguous()


def _sw_align_fused(query: torch.Tensor, ref: torch.Tensor, params: SWParams,
                    score_fn=sw_score_ends_auto):
    """Forward ends, then begins from a second scoring pass over the
    reversed prefixes (the reference's reverse pass, ssw.c:836-849),
    batched.  Returns (score, q_begin, q_end, r_begin, r_end) tensors.
    ``score_fn`` is the scorer of both passes; the default routes by
    device."""
    Lq = query.shape[1]
    Lr = ref.shape[1]
    score, q_end, r_end = score_fn(query, ref, params)
    rq = _reverse_prefix(query, q_end, Lq)
    rr = _reverse_prefix(ref, r_end, Lr)
    _, q_off, r_off = score_fn(rq, rr, params)
    none = score <= 0
    minus1 = torch.full_like(score, -1)
    return (score, torch.where(none, minus1, q_end - q_off), q_end,
            torch.where(none, minus1, r_end - r_off), r_end)


_ALNCORE = None


def _alncore():
    global _ALNCORE
    if _ALNCORE is None:
        try:
            from ciri_long_tpu import _alncore as core
            _ALNCORE = core
        except ImportError:
            _ALNCORE = False
    return _ALNCORE or None


def _real_lens(arr):
    """Per-row real length of PAD(5)-suffixed code arrays."""
    is_pad = arr == PAD
    lens = np.where(is_pad.any(axis=1),
                    np.argmax(is_pad, axis=1), arr.shape[1])
    return lens.astype(np.int32)


def _to_device(arr, device):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(arr, np.int8))).to(device)


def _host_align(query, ref, params: SWParams) -> SWResult:
    """sw_align_batch on the native C++ core (native/alncore.cpp) over the
    real (unpadded) lengths; bit-identical to the scorer path."""
    _check_params(params)
    q = np.ascontiguousarray(np.asarray(query, np.int8))
    r = np.ascontiguousarray(np.asarray(ref, np.int8))
    B = q.shape[0]
    out = np.frombuffer(_alncore().sw_align_many(
        q, r, B, q.shape[1], r.shape[1],
        np.ascontiguousarray(_real_lens(q)),
        np.ascontiguousarray(_real_lens(r)),
        params.match, params.mismatch, params.gap_open,
        params.gap_extend), np.int32).reshape(B, 5)
    return SWResult(score=out[:, 0].copy(), query_begin=out[:, 1].copy(),
                    query_end=out[:, 2].copy(), ref_begin=out[:, 3].copy(),
                    ref_end=out[:, 4].copy())


def _result(fields) -> SWResult:
    score, q_begin, q_end, r_begin, r_end = (t.cpu().numpy() for t in fields)
    return SWResult(score=score, query_begin=q_begin, query_end=q_end,
                    ref_begin=r_begin, ref_end=r_end)


@_count_dispatch('sw_align_batch')
def sw_align_batch(query, ref, params: SWParams, device='cpu') -> SWResult:
    """Batched SW with begin and end coordinates on ``device``.

    Inputs are [B, Lq] / [B, Lr] padded code arrays (numpy).  On the CPU the
    native C++ core runs when it is built (as ciri_long_tpu/ops/sw.py:259-275
    does), else the plain PyTorch scorer; on CUDA the kernel."""
    return sw_align_batch_collect(
        sw_align_batch_submit(query, ref, params, device))


def sw_align_batch_submit(query, ref, params: SWParams, device='cpu'):
    """Async half of sw_align_batch: enqueue the device work (or run the
    host core eagerly) and return a handle for sw_align_batch_collect."""
    device = torch.device(device)
    if device.type == 'cpu' and _alncore() is not None:
        return ('host', _host_align(query, ref, params))
    return ('dev', _sw_align_fused(_to_device(query, device),
                                   _to_device(ref, device), params))


def sw_align_batch_collect(handle) -> SWResult:
    kind, payload = handle
    if kind == 'host':
        return payload
    return _result(payload)


def _window_plan(Lq, Lr, params: SWParams, chunk):
    """Chunk starts and width for one window: overlapping chunks whose
    overlap exceeds the widest reference span a positive local alignment
    can reach (span < Lq * (1 + match / gap_extend)), so the optimum lies
    whole inside some chunk.  None when the window is one chunk."""
    span_bound = Lq * (1 + params.match // max(1, params.gap_extend)) + 128
    if Lr <= max(chunk, 2 * span_bound):
        return None
    overlap = span_bound
    csize = max(chunk, 4 * overlap)
    stride = csize - overlap
    starts = list(range(0, max(1, Lr - overlap), stride))
    if starts[-1] + csize < Lr:
        starts.append(Lr - csize)
    return starts, csize


def sw_window_align(query, ref, params: SWParams, chunk=16384,
                    device='cpu'):
    """Local alignment of one query against a very long reference window
    (the reference's +-200 kb SSW clip re-alignment, find_bsj.py:196-215):
    the window is tiled into overlapping chunks that become the batch axis
    of one scorer call (see _window_plan), exact.

    Returns (score, q_begin, q_end, r_begin, r_end) python ints with
    reference coordinates global to ``ref``; score 0 => (-1 ...) coords."""
    device = torch.device(device)
    query = np.asarray(query)
    ref = np.asarray(ref)
    Lq = len(query)
    plan = _window_plan(Lq, len(ref), params, chunk)
    if plan is None:
        res = sw_align_batch(query[None, :], ref[None, :], params, device)
        return (int(res.score[0]), int(res.query_begin[0]),
                int(res.query_end[0]), int(res.ref_begin[0]),
                int(res.ref_end[0]))
    starts, csize = plan
    K = len(starts)
    refs = np.full((K, csize), PAD, np.int8)
    for t, s in enumerate(starts):
        piece = ref[s:s + csize]
        refs[t, :len(piece)] = piece
    queries = np.broadcast_to(query[None, :], (K, Lq))
    score, q_end, r_end = (t.cpu().numpy() for t in sw_score_ends_auto(
        _to_device(queries, device), _to_device(refs, device), params))
    if score.max() <= 0:
        return 0, -1, -1, -1, -1
    g_end = np.where(score > 0, np.asarray(starts) + r_end, 1 << 60)
    # pick: max score, then smallest global r_end, then smallest q_end
    w = np.lexsort((q_end, g_end, -score))[0]

    # begins via reverse pass restricted to the winning chunk
    sub_r = refs[w, :r_end[w] + 1][::-1]
    sub_q = query[:q_end[w] + 1][::-1]
    _, q_off, r_off = (t.cpu().numpy() for t in sw_score_ends_auto(
        _to_device(sub_q[None, :], device),
        _to_device(sub_r[None, :], device), params))
    q_begin = int(q_end[w]) - int(q_off[0])
    r_begin = int(r_end[w]) - int(r_off[0])
    return (int(score[w]), q_begin, int(q_end[w]),
            int(starts[w]) + r_begin, int(starts[w]) + int(r_end[w]))


_WINDOW_ROW_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def sw_window_align_many(pairs, params: SWParams, chunk=16384,
                         device='cpu'):
    """Batched sw_window_align: every pair's window chunks stack into one
    sw_align_batch (cross-read batching of the +-200 kb clip windows).
    Per-pair results are identical to sw_window_align(query, ref, params):
    rows are independent, PAD padding cannot change a row's outcome, and
    the per-item winner rule (max score, then smallest global r_end, then
    smallest q_end) is the same.

    Returns a list of (score, q_begin, q_end, r_begin, r_end) int tuples,
    reference coordinates global to each pair's ``ref``."""
    if not pairs:
        return []
    rows_q, rows_r, row_item, row_gstart = [], [], [], []
    chunked = []  # did this item take the multi-chunk route?
    for item, (query, ref) in enumerate(pairs):
        query = np.asarray(query)
        ref = np.asarray(ref)
        plan = _window_plan(len(query), len(ref), params, chunk)
        if plan is None:
            starts, csize = [0], len(ref)
        else:
            starts, csize = plan
        chunked.append(plan is not None)
        for s in starts:
            rows_q.append(query)
            rows_r.append(ref[s:s + csize])
            row_item.append(item)
            row_gstart.append(s)

    n_rows = len(rows_q)
    wq = max(len(x) for x in rows_q)
    wr = max(len(x) for x in rows_r)
    rows = next((b for b in _WINDOW_ROW_BUCKETS if n_rows <= b), n_rows)
    qpad = np.full((rows, wq), PAD, np.int8)
    rpad = np.full((rows, wr), PAD, np.int8)
    for t in range(n_rows):
        qpad[t, :len(rows_q[t])] = rows_q[t]
        rpad[t, :len(rows_r[t])] = rows_r[t]
    res = sw_align_batch(qpad, rpad, params, device)
    score = res.score[:n_rows]
    q_begin = res.query_begin[:n_rows]
    q_end = res.query_end[:n_rows]
    r_begin = res.ref_begin[:n_rows]
    r_end = res.ref_end[:n_rows]
    gstart = np.asarray(row_gstart, np.int64)
    g_end = np.where(score > 0, gstart + r_end, 1 << 60)

    out = []
    row_item = np.asarray(row_item)
    for item in range(len(pairs)):
        mine = np.flatnonzero(row_item == item)
        order = np.lexsort((q_end[mine], g_end[mine], -score[mine]))
        w = mine[order[0]]
        if chunked[item] and score[w] <= 0:
            out.append((0, -1, -1, -1, -1))
            continue
        out.append((int(score[w]), int(q_begin[w]), int(q_end[w]),
                    int(gstart[w]) + int(r_begin[w]),
                    int(gstart[w]) + int(r_end[w])))
    return out
