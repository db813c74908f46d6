"""Batched affine-gap local alignment (Smith-Waterman) on PyTorch.

Port of ``ciri_long_tpu/ops/sw.py``: same names, same contract, same
bucketing.  Codes A0 C1 G2 T3 N4 PAD5; N scores 0 against everything, PAD
poisons the diagonal term so padded rows and columns never win; a gap of
length L costs gap_open + (L-1)*gap_extend, and gap_open >= gap_extend is
required.  Coordinates are 0-based inclusive (the SSW convention).

``sw_score_ends`` is the plain PyTorch version (the JAX row scan with the
within-row gap resolved by a prefix max); ``sw_score_ends_cuda`` launches
the hand-written kernel ``csrc/sw_score_ends.cu`` by one of its two routes
(``_tile_plan``): reference tiles with an exact halo for a short query
against a long reference, the anti-diagonal wavefront (a block of warps
per row, pipelined over the query's strips, ``_wave_plan``) for every
other shape.  ``sw_score_ends_auto`` takes the kernel for CUDA tensors and the
plain version for CPU tensors, nothing else: a CUDA tensor never falls
through to the plain version.

``sw_align_rows`` is collapse's fused round over ragged row views
(ops/rows.py): on the card one native call (csrc/sw_score_ends.cu::
sw_rows_run: upload, expand, forward, reverse prefixes, reverse, the
``[B, 5]`` answers), on the CPU the host core a length group;
``sw_align_rows_plain`` is its schedule in numpy and the plain scorer.

Host arrays come in as numpy; every batch function takes the ``device`` to
run on (default 'cuda', resolved by ``resolve_device``, which raises when
no GPU is visible; pass 'cpu' for the host) and returns numpy.
"""

import ctypes
import time
from typing import NamedTuple

import numpy as np
import torch

from ciri_long_tpu_torch.ops.rows import (check_rows, padded, row_groups,
                                          row_stage)
from ciri_long_tpu_torch.utils.dispatch import (count_launch, resolve_device,
                                                span)

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
    'sw_wave_launch': (
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 11
        + [ctypes.c_void_p] * 5, ctypes.c_int),
    'sw_tiles_launch': (
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 10
        + [ctypes.c_void_p] * 5, ctypes.c_int),
}

_ROWS_SYMBOLS = {
    'sw_rows_stage_new': ([ctypes.c_int], ctypes.c_void_p),
    'sw_rows_run': ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
}
# the phases of a native round: its Python before the call (pack), the
# call's own (csrc/row_views.h: upload, device_wait, download) and its
# Python after it (unpack)
ROW_PHASES = ('pack', 'upload', 'device_wait', 'download', 'unpack')

# The tiled route's rule: a tile owns the smallest multiple of 32 columns
# that is at least TILE_MIN_COLS and TILE_HALOS halos, and the route is
# taken when the reference holds at least two such tiles.  Four halos beat
# one, two and eight at both main-path shapes on the H100 with the
# wavefront's step body in the tiles (PERF.md section 6).
TILE_MIN_COLS = 256
TILE_HALOS = 4
# shared memory a Hopper block may opt into; one tile warp's (H, F)
# handoff row of T + halo int2 must fit it beside the score table
BLOCK_SMEM = 232448
TILE_WARPS = 4         # csrc/sw_score_ends.cu: (row, tile) warps a block


# The wavefront's rule (sw_wave_kernel): R query rows a lane, a block of
# WAVE_WARPS warps (K warps on one row, or P rows of one warp when K = 1).
# R = 4 was the fastest of 1, 2 and 4 at the bench shape and at collapse's
# largest wavefront launch on the H100 (PERF.md section 6).
WAVE_ROWS = 4
WAVE_WARPS = 8
WAVE_RING = 128
# warps that fill the card: 32 a SM on 132 SMs (eight a scheduler, enough
# to cover a step's latency); K grows until B * K reaches it
WAVE_FILL = 32 * 132


class WavePlan(NamedTuple):
    """The wavefront's launch: ``rows`` (R) query rows a lane, ``warps`` (K)
    warps a row, ``per_block`` (P) rows a block, and where the handoff row
    between groups of K strips lives: 'none' (no row has more than K
    strips), 'smem' (P * Lr * 8 bytes of dynamic shared memory) or
    'global' (a [B, Lr] int2 scratch)."""
    rows: int
    warps: int
    per_block: int
    edge: str


def _lane_rows(Lq, rows):
    """Query rows a lane, R: ``rows``, halved while a strip of half as
    many rows (32 R / 2) still holds the whole query."""
    R = rows
    while R > 1 and 32 * (R // 2) >= Lq:
        R //= 2
    return R


def _wave_static_bytes(R):
    """sw_wave_kernel<R>'s static shared memory, with room to spare: the
    rings, the score table ([6 codes][R rows][256 threads] int32) and the
    folds' and lengths' arrays."""
    return ((WAVE_WARPS - 1) * WAVE_RING * 8 + 6 * R * WAVE_WARPS * 32 * 4
            + 5 * WAVE_WARPS * 4 + 512)


def _wave_plan(B, Lq, Lr, rows=WAVE_ROWS):
    """WavePlan of the wavefront for a [B, Lq] x [B, Lr] call.  R is
    ``rows`` (the rule's WAVE_ROWS; other values only to time them), halved
    while a strip of half as many rows still holds the whole query.  K is
    the query's strips, at most WAVE_WARPS, and no more than B * K warps
    fill the card (WAVE_FILL).  With K = 1 a block holds WAVE_WARPS rows,
    fewer when their handoff rows would not fit its shared memory.  The
    handoff row is needed only when a row has more than K strips, and lives
    in shared memory when it fits beside the static arrays."""
    R = _lane_rows(Lq, rows)
    strips = max(1, -(-Lq // (32 * R)))
    K = max(1, min(WAVE_WARPS, strips, -(-WAVE_FILL // max(B, 1))))
    P = WAVE_WARPS if K == 1 else 1
    if strips <= K:
        return WavePlan(R, K, P, 'none')
    room = BLOCK_SMEM - _wave_static_bytes(R)
    row_bytes = max(1, Lr) * 8
    if K == 1:
        P = max(1, min(WAVE_WARPS, room // row_bytes))
    if P * row_bytes <= room:
        return WavePlan(R, K, P, 'smem')
    return WavePlan(R, K, WAVE_WARPS if K == 1 else 1, 'global')


def _tile_halo(Lq, params: SWParams):
    """Lq + floor(Lq * match / gap_extend) + 1 columns: more than the
    reference span of any positive local alignment, which has at most Lq
    diagonal steps and fewer than Lq * match / gap_extend gap columns (each
    costs at least gap_extend, as gap_open >= gap_extend, and the matches
    bring at most Lq * match); the bound _window_plan rests on too."""
    return Lq + (Lq * params.match) // params.gap_extend + 1


def _tile_rows(Lq):
    """Query rows a lane of the tiled route for a query of Lq codes: the
    wavefront's WAVE_ROWS, halved while half as many still hold it in one
    strip (R = 1 up to 32 rows, 2 up to 64, else 4)."""
    return _lane_rows(Lq, WAVE_ROWS)


def _tile_static_bytes(R):
    """sw_tile_kernel<R>'s static shared memory, with room to spare: the
    score table, [6 codes][R rows][TILE_WARPS * 32 threads] int32."""
    return 6 * R * TILE_WARPS * 32 * 4 + 512


def _tile_plan(Lq, Lr, params: SWParams, halos=TILE_HALOS):
    """(T, halo) of the tiled route for a [*, Lq] x [*, Lr] call, or None
    for the wavefront.  A tile owns T columns and sweeps from _tile_halo
    columns before them, so the optimum ending in an owned column lies
    whole in the tile.  ``halos`` is the tile width in halos (the rule's
    constant; other values only to time other widths).  The launch takes
    _tile_rows(Lq) query rows a lane; None too where a row's packed best
    could overflow (Lq * match or gap_open of 2^16 or more), which sends
    such calls to the wavefront."""
    if params.match < 1 or params.gap_extend < 1:
        return None
    halo = _tile_halo(Lq, params)
    T = -(-max(TILE_MIN_COLS, halos * halo) // 32) * 32
    room = BLOCK_SMEM - _tile_static_bytes(_tile_rows(Lq))
    if Lr < 2 * T or (T + halo) * 8 > room:
        return None
    # a row's best packed in an int32: |M| < 2^16, under 2^15 steps
    if (Lq * params.match >= 1 << 16 or params.gap_open >= 1 << 16
            or T + halo + 62 >= 1 << 15):
        return None
    return T, halo


def check_cuda_codes(name, query: torch.Tensor, ref: torch.Tensor,
                     params: SWParams):
    """The inputs every SW kernel takes: int8 codes query [B, Lq] and ref
    [B, Lr], contiguous, on one CUDA device, with gap_open >= gap_extend and
    shapes within the kernels' int arguments.  Raises on anything else."""
    _check_params(params)
    if not (query.is_cuda and ref.is_cuda and query.device == ref.device):
        raise ValueError('{} needs query and ref on one CUDA device (got {} '
                         'and {})'.format(name, query.device, ref.device))
    if query.dtype != torch.int8 or ref.dtype != torch.int8:
        raise TypeError('{} needs int8 codes (got {} and {})'.format(
            name, query.dtype, ref.dtype))
    if query.dim() != 2 or ref.dim() != 2 or query.shape[0] != ref.shape[0]:
        raise ValueError('{} needs [B, Lq] and [B, Lr] (got {} and {})'.format(
            name, tuple(query.shape), tuple(ref.shape)))
    if not (query.is_contiguous() and ref.is_contiguous()):
        raise ValueError('{} needs contiguous inputs'.format(name))
    B, Lq = query.shape
    Lr = ref.shape[1]
    if max(B, Lq, Lr + 32) >= 2 ** 31:
        raise ValueError("{} shape {}x{}x{} exceeds the kernel's int "
                         'arguments'.format(name, B, Lq, Lr))


def _launch(query, ref, params, route, plan):
    """Launch csrc/sw_score_ends.cu on checked inputs: the wavefront of
    ``plan`` (a WavePlan) for route 'wave', else the tiles of ``plan`` =
    (T, halo) and their merge.  Outputs and scratch come from torch.empty;
    raises if the launch is refused; counts one launch in LAUNCHES and one
    in ROUTES."""
    from ciri_long_tpu_torch.ops import _build

    B, Lq = query.shape
    Lr = ref.shape[1]
    lib = _build.load('sw_score_ends.cu', _SW_SYMBOLS)
    dev = query.device
    score = torch.empty(B, dtype=torch.int32, device=dev)
    q_end = torch.empty(B, dtype=torch.int32, device=dev)
    r_end = torch.empty(B, dtype=torch.int32, device=dev)
    if route == 'wave':
        fn = lib.sw_wave_launch
        args = (plan.rows, plan.warps, plan.per_block, plan.edge == 'smem')
        scratch = (torch.empty((B, Lr, 2), dtype=torch.int32, device=dev)
                   if plan.edge == 'global' else None)
    else:
        fn, args = lib.sw_tiles_launch, (_tile_rows(Lq), *plan)
        scratch = torch.empty((B, -(-Lr // plan[0]), 3), dtype=torch.int32,
                              device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(query.data_ptr(), ref.data_ptr(), B, Lq, Lr, params.match,
                params.mismatch, params.gap_open, params.gap_extend, *args,
                None if scratch is None else scratch.data_ptr(),
                score.data_ptr(), q_end.data_ptr(), r_end.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError('sw_score_ends {} launch failed: cudaError {} '
                           '(B={}, Lq={}, Lr={}, plan {})'.format(
                               route, rc, B, Lq, Lr, plan))
    count_launch('sw_score_ends', route)
    return score, q_end, r_end


def sw_score_ends_wave_cuda(query: torch.Tensor, ref: torch.Tensor,
                            params: SWParams, plan=None):
    """The wavefront route of csrc/sw_score_ends.cu, forced, on anything
    sw_score_ends_cuda takes, with ``plan`` (a WavePlan) or by default
    _wave_plan's."""
    check_cuda_codes('sw_score_ends_wave_cuda', query, ref, params)
    B, Lq = query.shape
    return _launch(query, ref, params, 'wave',
                   plan or _wave_plan(B, Lq, ref.shape[1]))


def sw_score_ends_tiled_cuda(query: torch.Tensor, ref: torch.Tensor,
                             params: SWParams, plan=None):
    """The tiled route of csrc/sw_score_ends.cu (one warp per row and
    tile, _tile_rows(Lq) query rows a lane), forced, with ``plan`` = (T,
    halo) or by default _tile_plan's.
    Raises where _tile_plan gives no plan, as on anything
    sw_score_ends_cuda refuses."""
    check_cuda_codes('sw_score_ends_tiled_cuda', query, ref, params)
    plan = plan or _tile_plan(query.shape[1], ref.shape[1], params)
    if plan is None:
        raise ValueError('sw_score_ends_tiled_cuda: no tile plan for Lq={}, '
                         'Lr={}, {}'.format(query.shape[1], ref.shape[1],
                                            params))
    return _launch(query, ref, params, 'tiled', plan)


def sw_score_ends_cuda(query: torch.Tensor, ref: torch.Tensor,
                       params: SWParams):
    """The hand-written CUDA kernel (csrc/sw_score_ends.cu) on CUDA tensors:
    query int8 [B, Lq] and ref int8 [B, Lr], contiguous, on one device.
    Same outputs as sw_score_ends for codes 0..5 (the kernel scores any
    code outside 0..4 as PAD).  Routed by _tile_plan: the tiled route for a
    short query against a long reference, the wavefront for every other
    shape.  Raises on anything else, and when the launch is refused."""
    check_cuda_codes('sw_score_ends_cuda', query, ref, params)
    B, Lq = query.shape
    Lr = ref.shape[1]
    plan = _tile_plan(Lq, Lr, params)
    if plan is None:
        return _launch(query, ref, params, 'wave', _wave_plan(B, Lq, Lr))
    return _launch(query, ref, params, 'tiled', plan)


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
            from ciri_long_tpu_torch import _alncore as core
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


@span('sw_align_batch')
def sw_align_batch(query, ref, params: SWParams, device='cuda') -> SWResult:
    """Batched SW with begin and end coordinates on ``device``.

    Inputs are [B, Lq] / [B, Lr] padded code arrays (numpy).  On the CPU the
    native C++ core runs when it is built (as ciri_long_tpu/ops/sw.py:259-275
    does), else the plain PyTorch scorer; on CUDA the kernel."""
    return sw_align_batch_collect(
        sw_align_batch_submit(query, ref, params, device))


def sw_align_batch_submit(query, ref, params: SWParams, device='cuda'):
    """Async half of sw_align_batch: enqueue the device work (or run the
    host core eagerly) and return a handle for sw_align_batch_collect."""
    device = resolve_device(device)
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
                    device='cuda'):
    """Local alignment of one query against a very long reference window
    (the reference's +-200 kb SSW clip re-alignment, find_bsj.py:196-215):
    the window is tiled into overlapping chunks that become the batch axis
    of one scorer call (see _window_plan), exact.

    Returns (score, q_begin, q_end, r_begin, r_end) python ints with
    reference coordinates global to ``ref``; score 0 => (-1 ...) coords."""
    device = resolve_device(device)
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
                         device='cuda'):
    """Batched sw_window_align: every pair's window chunks stack into one
    sw_align_batch (cross-read batching of the +-200 kb clip windows).
    Per-pair results are identical to sw_window_align(query, ref, params):
    rows are independent, PAD padding cannot change a row's outcome, and
    the per-item winner rule (max score, then smallest global r_end, then
    smallest q_end) is the same.

    Returns a list of (score, q_begin, q_end, r_begin, r_end) int tuples,
    reference coordinates global to each pair's ``ref``."""
    device = resolve_device(device)
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


def _rows_plan(groups, params):
    """int32 [G, 13] plan rows of csrc/sw_score_ends.cu::sw_rows_run for
    ops/rows.py::row_groups' ``groups``: start, rows, Lq, Lr, the params,
    then the route _tile_plan gives (1: R, T, halo) or the wavefront's
    (0: R, K, P and the handoff row's place, 0 none, 1 shared memory, 2
    global)."""
    plan = np.zeros((len(groups), 13), np.int32)
    for g, (start, n, Lq, Lr, k) in enumerate(groups.tolist()):
        p = params[k]
        _check_params(p)
        if max(n, Lq, Lr + 32) >= 2 ** 31:
            raise ValueError("sw_align_rows: group {}x{}x{} exceeds the "
                             "kernel's int arguments".format(n, Lq, Lr))
        tiles = _tile_plan(Lq, Lr, p)
        if tiles is None:
            w = _wave_plan(n, Lq, Lr)
            route = (0, w.rows, w.warps, w.per_block,
                     ('none', 'smem', 'global').index(w.edge))
        else:
            route = (1, _tile_rows(Lq), *tiles, 0)
        plan[g] = (start, n, Lq, Lr, *p, *route)
    return plan


def _host_rows(q, r, order, groups, params):
    """[5, B] answers of sw_align_batch on the CPU, a length group at a
    time, each padded to its own widths."""
    out = np.empty((5, len(order)), np.int32)
    for start, n, Lq, Lr, k in groups.tolist():
        rows = order[start:start + n]
        res = sw_align_batch(
            padded((q.codes, q.off[rows], q.lens[rows]), Lq)[0],
            padded((r.codes, r.off[rows], r.lens[rows]), Lr)[0], params[k],
            'cpu')
        out[:, rows] = np.stack(res)
    return out


def sw_align_rows(q, r, pid, params, device='cuda', phases=None):
    """SW with begin and end coordinates of every row pair (q[k], r[k]) of
    two ops/rows.py::Rows, under ``params[pid[k]]``: int32 [5, B] (score,
    q_begin, q_end, r_begin, r_end a row), equal to sw_align_batch on the
    rows padded.  Rows are grouped by row_groups.  On the card: one call of
    csrc/sw_score_ends.cu::sw_rows_run with the interpreter's lock
    released, on the device's ops/rows.py::row_stage, two sw_score_ends
    launches a group on its route and three ``fused_rows`` launches
    counted; ``phases`` (a dict) gets the round's ROW_PHASES ns added.  On
    the CPU: sw_align_batch's host core a group."""
    from ciri_long_tpu_torch.ops import _build

    t0 = time.perf_counter_ns()
    device = resolve_device(device)
    check_rows(q, 'sw_align_rows query')
    check_rows(r, 'sw_align_rows reference')
    B = len(q.lens)
    if len(r.lens) != B or len(pid) != B:
        raise ValueError('sw_align_rows: {} queries, {} references and {} '
                         'params indices'.format(B, len(r.lens), len(pid)))
    order, groups = row_groups(q.lens, r.lens, pid)
    if device.type == 'cpu':
        return _host_rows(q, r, order, groups, params)
    plan = _rows_plan(groups, params)
    views = np.stack([q.off[order], q.lens[order], r.off[order],
                      r.lens[order]])
    res = np.empty((B, 5), np.int32)
    qcodes = np.ascontiguousarray(q.codes)
    rcodes = np.ascontiguousarray(r.codes)
    ns = np.zeros(len(ROW_PHASES), np.float64)
    lib = _build.load('sw_score_ends.cu', dict(_SW_SYMBOLS, **_ROWS_SYMBOLS))
    stage = row_stage(device)
    with stage.lock:
        ns[0] = time.perf_counter_ns() - t0
        rc = lib.sw_rows_run(
            stage.handle(lib, 'sw_rows'), qcodes.ctypes.data, len(qcodes),
            rcodes.ctypes.data, len(rcodes), views.ctypes.data, B,
            plan.ctypes.data, len(plan), res.ctypes.data,
            ns[1:4].ctypes.data)
    t1 = time.perf_counter_ns()
    if rc != 0:
        raise RuntimeError('sw_align_rows: native round failed: cudaError '
                           '{} ({} rows in {} groups)'.format(rc, B,
                                                              len(plan)))
    for route, n in zip(*np.unique(plan[:, 8], return_counts=True)):
        count_launch('sw_score_ends', ('wave', 'tiled')[route],
                     times=2 * int(n))
    if B:
        count_launch('fused_rows', times=3)
    out = np.empty((5, B), np.int32)
    out[:, order] = res.T
    ns[4] = time.perf_counter_ns() - t1
    _add_phases(phases, ns)
    return out


def _add_phases(phases, ns):
    if phases is not None:
        for name, v in zip(ROW_PHASES, ns.tolist()):
            phases[name] = phases.get(name, 0.0) + v


def _reverse_rows(x, ends):
    """csrc/sw_score_ends.cu::reverse_prefix_kernel on numpy [n, L] codes:
    row b's x[b, end - t] at t <= end, PAD past it."""
    t = np.arange(x.shape[1])
    idx = ends[:, None] - t[None, :]
    return np.where(idx >= 0, np.take_along_axis(x, np.maximum(idx, 0), 1),
                    np.int8(PAD)).astype(np.int8)


def sw_align_rows_plain(q, r, pid, params, device='cpu'):
    """sw_align_rows' native round in numpy and the plain scorer (on
    ``device``): the same groups, each expanded to its padded widths, the
    forward pass, the reversed prefixes (as the kernel builds them), the
    reverse pass, the answers assembled as the result kernel does; int32
    [5, B]."""
    def scored(x, y, p):
        return (t.cpu().numpy() for t in sw_score_ends(
            torch.from_numpy(x).to(device), torch.from_numpy(y).to(device),
            p))

    order, groups = row_groups(q.lens, r.lens, pid)
    out = np.empty((5, len(order)), np.int32)
    for start, n, Lq, Lr, k in groups.tolist():
        rows = order[start:start + n]
        qp = padded((q.codes, q.off[rows], q.lens[rows]), Lq)[0]
        rp = padded((r.codes, r.off[rows], r.lens[rows]), Lr)[0]
        score, q_end, r_end = scored(qp, rp, params[k])
        _, q_off, r_off = scored(_reverse_rows(qp, q_end),
                                 _reverse_rows(rp, r_end), params[k])
        none = score <= 0
        out[:, rows] = (score, np.where(none, -1, q_end - q_off), q_end,
                        np.where(none, -1, r_end - r_off), r_end)
    return out
