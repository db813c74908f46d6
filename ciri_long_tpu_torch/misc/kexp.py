"""SW kernel variant harness on one CUDA GPU: the port of misc/kexp.py.

    python -m ciri_long_tpu_torch.misc.kexp [--r3 | --wave | --chain C]
        [--B 512] [--Lq 1024] [--Lr 4096] [--iters 8] [--skipcheck]
        [--device cuda]

Runs one design family of the ``sw_score_ends`` contract (ops/sw.py) at one
shape and prints one JSON line: ``variant``, ``gcups``, ``ms`` per launch,
``bound_ms`` and what bounds it, ``device`` and the card's ``nvidia-smi``
name and power limit.  The families are the counterparts of the three
``pallas_call`` sites of misc/kexp.py::make_call, each a hand-written
kernel:

- row (``--r3``, the default; kexp.py:1586, ``build_kernel``/``_r3``):
  csrc/sw_rowscan.cu, the query swept a row at a time over all reference
  columns, the horizontal gap resolved by a prefix max (a thread's run of
  W columns in registers, ``rowscan_plan``);
- wave (``--wave``; kexp.py:1534, ``build_kernel_wave*``): the
  anti-diagonal wavefront route of csrc/sw_score_ends.cu, forced at every
  shape (``call`` takes that kernel's tiled route where it applies);
- chain (``--chain C``; kexp.py:1462, ``build_kernel_chain*``):
  csrc/sw_chain.cu, the wavefront over C jobs' references laid back to back
  behind boundary codes (``chain_layout``, ``chain_plan``), B % C == 0.

Before timing, the variant is held to the plain version (ops/sw.py::
sw_score_ends) on 32 rows of random codes with N, at 300x517 and at the
timed shape less 7/3 (kexp.py's check shapes); a mismatch raises.  The
timing is ``--iters`` dependent launches, each launch's query xored with
``score & 1`` of the launch before, between two CUDA events
(``time_launches``, which can also time a CUDA graph of the launches to
leave the host's cost out).  ``--device cpu`` runs the plain versions (the
counterpart of kexp's ``--interpret``) on the host clock; ``--device cuda``
without a card raises.

The bound (``sw_bound``) is the larger of the cells at the card's peak
rate for one cell update (``cell_rate``, measured in the same run) and the
codes read once plus the ends written once at 3.35 TB/s.
"""

import argparse
import ctypes
import json
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from ciri_long_tpu_torch.ops.sw import (BLOCK_SMEM, PAD, WAVE_FILL,
                                        WAVE_RING, SWParams,
                                        check_cuda_codes, sw_score_ends,
                                        sw_score_ends_wave_cuda)
from ciri_long_tpu_torch.utils.dispatch import LAUNCHES, resolve_device

PARAMS = SWParams(10, 4, 8, 2)
CHECK_ROWS = 32          # kexp's check batch (its default --btile)
BOUNDARY = 6             # the chain stream's job boundary code

HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)


def nvidia_smi(query='name,power.limit'):
    """First line of ``nvidia-smi --query-gpu=<query>``."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=' + query, '--format=csv,noheader'],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


_CELL_RATE_SYMBOLS = {
    'cell_rate_launch': ([ctypes.c_int] * 8 + [ctypes.c_void_p] * 2,
                         ctypes.c_int),
    'recurrence_rate_launch': ([ctypes.c_int] * 8 + [ctypes.c_void_p] * 2,
                               ctypes.c_int),
    'cell_rate_block_cells': ([], ctypes.c_int),
    'serial_step_launch': ([ctypes.c_int] + [ctypes.c_void_p] * 2,
                           ctypes.c_int),
}
# recurrence_rate's kinds: the updates of collapse's kernels, the edit
# distance's by its bit-parallel word (32 rows of one column) and, to
# compare with a cell-by-cell design, by its DP cell; the POA graph
# alignment's cell with one predecessor; call's chaining DP by its float64
# candidate, the tandem screen by one window at one lag, and the lag
# profile by a packed word of 32 (position, lag) pairs (LAG_WORD_PAIRS),
# with the valid pairs' popcount or, for a read of one valid run, without
RECURRENCES = {'edit_cell': 0, 'sw_traceback': 1, 'edit_distance': 2,
               'poa_align': 3, 'chain_dp': 4, 'screen_keep': 5,
               'nw_traceback': 6, 'lag_profile': 7, 'lag_matches': 8}
LAG_WORD_PAIRS = 32


def _rate(device, launcher, form):
    """Cell updates a second of op_rate.cu's ``launcher`` in ``form``, 16
    blocks a SM, over five launches between CUDA events."""
    from ciri_long_tpu_torch.ops import _build

    lib = _build.load('op_rate.cu', _CELL_RATE_SYMBOLS)
    fn = getattr(lib, launcher)
    steps = 4096
    blocks = 16 * torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.zeros(1, dtype=torch.int32, device=device)

    def launch():
        with torch.cuda.device(device):
            rc = fn(form, blocks, steps, 3, *PARAMS, out.data_ptr(),
                    _stream(device))
        if rc != 0:
            raise RuntimeError('{} launch failed: cudaError {}'.format(
                launcher, rc))

    ms = time_launches(launch, 5, device)       # ~6 ms a launch on an H100
    return blocks * lib.cell_rate_block_cells() * steps / (ms * 1e-3)


def recurrence_rate(device, kernel):
    """``cell_rate``'s measure for the update of one of collapse's kernels
    (``RECURRENCES``: 'edit_distance', a Myers/Hyyro word update of 32 rows
    and one column; 'sw_traceback', a cell; 'edit_cell', one DP cell of the
    edit distance; 'poa_align', a graph-alignment cell with one
    predecessor; 'chain_dp', a chaining candidate; 'screen_keep', a window
    at one lag; 'nw_traceback', a banded NW cell with its code;
    'lag_profile', a packed word of LAG_WORD_PAIRS (position, lag) pairs;
    'lag_matches', that word's matches alone), from
    csrc/op_rate.cu's register-only loop of that update: the operations
    bound of that kernel."""
    return _rate(device, 'recurrence_rate_launch', RECURRENCES[kernel])


def serial_step_s(device, steps=1 << 16):
    """Seconds of one step of the chaining DP's serial path (a float64 add
    and subtract, a compare and a select, each step's inputs but f known
    before it): csrc/op_rate.cu's one-warp chain of ``steps`` such steps,
    over five launches between CUDA events.  A row of n anchors takes at
    least n of them: the DP's serial bound."""
    from ciri_long_tpu_torch.ops import _build

    lib = _build.load('op_rate.cu', _CELL_RATE_SYMBOLS)
    out = torch.zeros(1, dtype=torch.float64, device=device)

    def launch():
        with torch.cuda.device(device):
            rc = lib.serial_step_launch(steps, out.data_ptr(),
                                        _stream(device))
        if rc != 0:
            raise RuntimeError('serial_step_launch failed: cudaError '
                               '{}'.format(rc))

    return time_launches(launch, 5, device) * 1e-3 / steps


def cell_rate(device, dpx):
    """Cell updates a second that the card runs on registers alone, 16
    blocks a SM, over five launches between CUDA events: the
    operations bound of every SW kernel.  csrc/op_rate.cu runs the fewest
    instructions one update needs, 7 in the DPX form (``dpx``):
      hm = H - gO                        1 sub, once a cell: E to the right
                                           and F below both read it
      E  = max(E_left - gE, hm)          1 __viaddmax_s32
      F  = max(F_up - gE, hm)            1 __viaddmax_s32
      s  = q == r ? match : -mismatch    1 compare, 1 select
      H  = max(H_diag + s, E, F, 0)      1 add, 1 __vimax3_s32_relu
    and 11 written as plain int32 adds and maxes, which ptxas for sm_90a
    fuses into nearly the same DPX instructions.  The card runs the update
    faster than 7 instructions at 64 INT32 lanes a SM would allow, so that
    count alone does not bound the time; the measured rate does."""
    return _rate(device, 'cell_rate_launch', int(dpx))


def peak_cell_rate(device):
    """The faster form's ``cell_rate``: the rate the SW bounds rest on."""
    return max(cell_rate(device, True), cell_rate(device, False))


def sw_bound(B, Lq, Lr, cells_per_s):
    """(least ms, 'operations' or 'bytes') of one B x Lq x Lr scoring call:
    every cell at ``cells_per_s`` (``peak_cell_rate``), or the codes read
    once and the ends written once at the HBM rate."""
    ops_ms = B * Lq * Lr / cells_per_s * 1e3
    bytes_ms = (B * (Lq + Lr) + 12 * B) / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, 'operations'
    return bytes_ms, 'bytes'


def _ends(B, dev, Lq, Lr):
    """Empty (score, q_end, r_end) outputs; filled with the no-alignment
    answer when there is no cell to score."""
    out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)]
    if Lq == 0 or Lr == 0:
        out[0].zero_()
        out[1].fill_(-1)
        out[2].fill_(-1)
    return out


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


_ROWSCAN_SYMBOLS = {
    'sw_rowscan_launch': ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                          + [ctypes.c_void_p] * 4, ctypes.c_int),
}

# The row scan's rule (sw_rowscan_kernel): W reference columns a thread, a
# warp covering 32 W columns, at most ROWSCAN_MAX_WARPS warps a block (NW
# warps a batch row, P rows a block).
ROWSCAN_WIDTHS = (4, 8, 16, 32)
ROWSCAN_WIDTH = 32
ROWSCAN_MAX_WARPS = 16
ROWSCAN_BLOCK_WARPS = 8
# warps that fill the card: 4 a SM on 132 SMs, one a scheduler
ROWSCAN_FILL = 4 * 132
# the widest reference a launch takes: 16 warps of 32 threads of 32 columns
ROWSCAN_MAX_LR = ROWSCAN_MAX_WARPS * 32 * max(ROWSCAN_WIDTHS)


class RowscanPlan(NamedTuple):
    """The row scan's launch: ``width`` (W) reference columns a thread,
    ``warps`` (NW) warps a batch row, ``per_block`` (P) rows a block."""
    width: int
    warps: int
    per_block: int


def rowscan_plan(B, Lr, width=ROWSCAN_WIDTH):
    """RowscanPlan for B rows of Lr reference columns: W is ``width`` (the
    rule's ROWSCAN_WIDTH; other values only to time them), halved while a
    warp of half as many columns a thread still covers the reference, then
    while the B * NW warps do not fill the card (ROWSCAN_FILL: 512x1024x1024
    runs 1.5x faster at W = 16 than at 32 on the H100, PERF.md section 6),
    and doubled while the row would need more than ROWSCAN_MAX_WARPS warps;
    a block holds ROWSCAN_BLOCK_WARPS warps' worth of rows (at least one
    row).  Raises above ROWSCAN_MAX_LR."""
    if Lr > ROWSCAN_MAX_LR:
        raise ValueError('sw_rowscan_cuda: Lr={} is above the {} reference '
                         'columns the kernel takes'.format(Lr, ROWSCAN_MAX_LR))
    W = width
    while W > ROWSCAN_WIDTHS[0] and 32 * (W // 2) >= Lr:
        W //= 2
    while W > ROWSCAN_WIDTHS[0] and B * -(-Lr // (32 * W)) < ROWSCAN_FILL:
        W //= 2
    while -(-Lr // (32 * W)) > ROWSCAN_MAX_WARPS:
        W *= 2
    NW = max(1, -(-Lr // (32 * W)))
    return RowscanPlan(W, NW, max(1, ROWSCAN_BLOCK_WARPS // NW))


def sw_rowscan_cuda(query: torch.Tensor, ref: torch.Tensor, params: SWParams,
                    plan=None):
    """The row-scan kernel (csrc/sw_rowscan.cu) on CUDA tensors, with
    ``plan`` (a RowscanPlan) or by default rowscan_plan's; the inputs and
    outputs of ops/sw.py::sw_score_ends_cuda.  Raises on anything else, for
    a reference above ROWSCAN_MAX_LR columns (16 warps of 32 threads, each
    holding 32 columns' H and F in registers), and when the launch is
    refused."""
    from ciri_long_tpu_torch.ops import _build

    check_cuda_codes('sw_rowscan_cuda', query, ref, params)
    B, Lq = query.shape
    Lr = ref.shape[1]
    plan = plan or rowscan_plan(B, Lr)
    lib = _build.load('sw_rowscan.cu', _ROWSCAN_SYMBOLS)
    dev = query.device
    score, q_end, r_end = _ends(B, dev, Lq, Lr)
    if B == 0 or Lq == 0 or Lr == 0:
        return score, q_end, r_end
    with torch.cuda.device(dev):
        rc = lib.sw_rowscan_launch(
            query.data_ptr(), ref.data_ptr(), B, Lq, Lr, plan.width,
            plan.per_block, params.match, params.mismatch, params.gap_open,
            params.gap_extend, score.data_ptr(), q_end.data_ptr(),
            r_end.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError('sw_rowscan kernel launch failed: cudaError {} '
                           '(B={}, Lq={}, Lr={}, plan {})'.format(
                               rc, B, Lq, Lr, plan))
    LAUNCHES['sw_rowscan'] += 1
    return score, q_end, r_end


def sw_rowscan(query: torch.Tensor, ref: torch.Tensor, params: SWParams):
    """The row-scan kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if query.is_cuda:
        return sw_rowscan_cuda(query, ref, params)
    if query.device.type == 'cpu' and ref.device.type == 'cpu':
        return sw_score_ends(query, ref, params)
    raise ValueError('sw_rowscan: unsupported devices {} and {}'.format(
        query.device, ref.device))


def sw_wave(query: torch.Tensor, ref: torch.Tensor, params: SWParams):
    """The wavefront route of csrc/sw_score_ends.cu for CUDA tensors, the
    plain version for CPU tensors."""
    if query.is_cuda:
        return sw_score_ends_wave_cuda(query, ref, params)
    if query.device.type == 'cpu' and ref.device.type == 'cpu':
        return sw_score_ends(query, ref, params)
    raise ValueError('sw_wave: unsupported devices {} and {}'.format(
        query.device, ref.device))


def _chain_rows(B, C):
    if C < 1 or B % C:
        raise ValueError('the chain needs a batch divisible by C (B={}, '
                         'C={})'.format(B, C))
    return B // C


def chain_layout(query: torch.Tensor, ref: torch.Tensor, C: int):
    """The chain kernel's inputs (the counterpart of kexp.py:1412-1438):
    queries [B/C, C*Lq], job k of stream s at row s, columns k*Lq..; and
    streams [B/C, C*(Lr+1) + 1] = [6, r_0, 6, r_1, ..., 6, r_{C-1}, 6], each
    job's reference codes (every code >= PAD as PAD) behind a boundary code
    6, and one closing boundary.  Job k of stream s is batch row s*C + k.
    Raises ValueError unless C >= 1 divides B."""
    B, Lq = query.shape
    Lr = ref.shape[1]
    rows = _chain_rows(B, C)
    codes = torch.clamp_max(ref, PAD)
    bound = torch.full((B, 1), BOUNDARY, dtype=ref.dtype, device=ref.device)
    body = torch.cat([bound, codes], dim=1).reshape(rows, C * (Lr + 1))
    stream = torch.cat([body, bound[:rows]], dim=1)
    return query.reshape(rows, C * Lq).contiguous(), stream.contiguous()


_CHAIN_SYMBOLS = {
    'sw_chain_launch': ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 13
                        + [ctypes.c_void_p] * 6, ctypes.c_int),
}

# The chained wavefront's rule (sw_chain_kernel): R query rows a lane, a
# block of CHAIN_WARPS warps (K warps on one stream, or P streams of one
# warp when K = 1), as ops/sw.py::_wave_plan gives the wavefront's;
# CHAIN_ROWS from the H100 runs in PERF.md section 6.
CHAIN_ROWS = 4
CHAIN_WARPS = 8
# the job keys (8 bytes a job) a block keeps in shared memory at most;
# more go to a global [B] uint64 scratch
CHAIN_KEY_SMEM = 16384
# the kernel's limits: T = C*(Lr+1)+1 stream slots in an int with room for
# a chunk, and a best cell (j, i) packed as j*Lq + i in 32 bits
CHAIN_MAX_SLOTS = 2 ** 31 - 65
CHAIN_MAX_CELLS = 2 ** 32
# a job spans at least 32 slots (a lane crosses one boundary a chunk at
# most): shorter references are padded with PAD to CHAIN_MIN_LR columns
CHAIN_MIN_LR = 31


class ChainPlan(NamedTuple):
    """The chained wavefront's launch: ``rows`` (R) query rows a lane,
    ``warps`` (K) warps a stream, ``per_block`` (P) streams a block, where
    the job keys live ('smem' or 'global') and where the handoff row between
    groups of K strips lives: 'none' (no stream has more than K strips),
    'smem' (P * T * 8 bytes of dynamic shared memory) or 'global' (a
    [B/C, T] int2 scratch)."""
    rows: int
    warps: int
    per_block: int
    keys: str
    edge: str


def _chain_static_bytes(R):
    """sw_chain_kernel<R>'s shared memory besides the keys and the handoff
    rows, with room to spare: the rings and the two score tables ([2 jobs]
    [6 codes][R rows][256 threads] int32)."""
    return ((CHAIN_WARPS - 1) * WAVE_RING * 8
            + 2 * 6 * R * CHAIN_WARPS * 32 * 4 + 512)


def chain_pad(ref: torch.Tensor):
    """``ref`` with PAD columns appended up to CHAIN_MIN_LR: every result
    stays, since a trailing PAD column's H comes from a gap out of an
    earlier cell of the row, lower and later in the contract's order."""
    short = CHAIN_MIN_LR - ref.shape[1]
    if short <= 0:
        return ref
    return torch.nn.functional.pad(ref, (0, short), value=PAD)


def _chain_warps(streams, Lq, R):
    """(strips, K): the query's strips of 32 R rows, and the warps a stream:
    the strips, at most CHAIN_WARPS, and no more than streams * K warps fill
    the card (WAVE_FILL)."""
    strips = max(1, -(-Lq // (32 * R)))
    return strips, max(1, min(CHAIN_WARPS, strips,
                              -(-WAVE_FILL // max(streams, 1))))


def chain_plan(streams, Lq, T, C, rows=CHAIN_ROWS):
    """ChainPlan for ``streams`` streams of T slots (C jobs each) against
    queries of Lq rows, by the rule of ops/sw.py::_wave_plan: R is ``rows``
    (the rule's CHAIN_ROWS; other values only to time them), halved while a
    strip of half as many rows still holds the query, and while half as
    many rows a lane give a stream more warps (few streams of a short
    query: 128x54x16384 runs 1.4x faster at R = 1, K = 2 than at R = 2,
    K = 1 on the H100, PERF.md section 6); K from _chain_warps; with K = 1
    a block holds CHAIN_WARPS streams, fewer when
    their handoff rows would not fit its shared memory.  The handoff row is
    needed only when a stream has more than K strips and lives in shared
    memory when it fits beside the static arrays; the keys of a block's jobs
    live in shared memory when they take at most CHAIN_KEY_SMEM bytes and
    fit beside the handoff rows."""
    R = rows
    while R > 1 and (32 * (R // 2) >= Lq or _chain_warps(
            streams, Lq, R // 2)[1] > _chain_warps(streams, Lq, R)[1]):
        R //= 2
    strips, K = _chain_warps(streams, Lq, R)
    P = CHAIN_WARPS if K == 1 else 1
    room = BLOCK_SMEM - _chain_static_bytes(R)
    row_bytes = max(1, T) * 8
    if strips <= K:
        edge = 'none'
    else:
        if K == 1:
            P = max(1, min(CHAIN_WARPS, room // row_bytes))
        edge = 'smem' if P * row_bytes <= room else 'global'
        if edge == 'global':
            P = CHAIN_WARPS if K == 1 else 1
    key_bytes = -(-P * C * 8 // 16) * 16
    free = room - (P * row_bytes if edge == 'smem' else 0)
    keys = 'smem' if key_bytes <= min(CHAIN_KEY_SMEM, free) else 'global'
    return ChainPlan(R, K, P, keys, edge)


def sw_chain_cuda(query: torch.Tensor, ref: torch.Tensor, params: SWParams,
                  C: int, plan=None):
    """The chained wavefront kernel (csrc/sw_chain.cu) on CUDA tensors, C
    jobs per stream, with ``plan`` (a ChainPlan) or by default
    chain_plan's; the inputs and outputs of ops/sw.py::sw_score_ends_cuda.
    Raises on anything else, when C does not divide B, above the kernel's
    limits (Lq * Lr above 2^32 cells a job, or C*(Lr+1)+1 stream slots
    above 2^31 - 65), and when the launch is refused."""
    from ciri_long_tpu_torch.ops import _build

    check_cuda_codes('sw_chain_cuda', query, ref, params)
    B, Lq = query.shape
    Lr = ref.shape[1]
    dev = query.device
    score, q_end, r_end = _ends(B, dev, Lq, Lr)
    if Lr == 0:
        _chain_rows(B, C)
        return score, q_end, r_end
    ref = chain_pad(ref)
    qrows, stream = chain_layout(query, ref, C)
    rows, T = stream.shape
    if T > CHAIN_MAX_SLOTS or Lq * ref.shape[1] > CHAIN_MAX_CELLS:
        raise ValueError("sw_chain_cuda: {}x{} jobs in streams of {} slots "
                         "exceed the kernel's limits (Lq*Lr <= 2^32, "
                         "C*(Lr+1)+1 <= 2^31-65)".format(Lq, Lr, T))
    plan = plan or chain_plan(rows, Lq, T, C)
    lib = _build.load('sw_chain.cu', _CHAIN_SYMBOLS)
    if B == 0 or Lq == 0:
        return score, q_end, r_end
    scratch = (torch.empty((rows, T, 2), dtype=torch.int32, device=dev)
               if plan.edge == 'global' else None)
    keys = (torch.empty(B, dtype=torch.int64, device=dev)
            if plan.keys == 'global' else None)
    with torch.cuda.device(dev):
        rc = lib.sw_chain_launch(
            qrows.data_ptr(), stream.data_ptr(), rows, C, Lq, ref.shape[1],
            params.match, params.mismatch, params.gap_open,
            params.gap_extend, plan.rows, plan.warps, plan.per_block,
            plan.keys == 'smem', plan.edge == 'smem',
            None if scratch is None else scratch.data_ptr(),
            None if keys is None else keys.data_ptr(),
            score.data_ptr(), q_end.data_ptr(), r_end.data_ptr(),
            _stream(dev))
    if rc != 0:
        raise RuntimeError('sw_chain kernel launch failed: cudaError {} '
                           '(B={}, Lq={}, Lr={}, C={}, plan {})'.format(
                               rc, B, Lq, Lr, C, plan))
    LAUNCHES['sw_chain'] += 1
    return score, q_end, r_end


def sw_chain(query: torch.Tensor, ref: torch.Tensor, params: SWParams,
             C: int):
    """The chain kernel for CUDA tensors; for CPU tensors the plain version
    on the un-chained batch.  Raises unless C divides B."""
    if query.is_cuda:
        return sw_chain_cuda(query, ref, params, C)
    if query.device.type == 'cpu' and ref.device.type == 'cpu':
        _chain_rows(query.shape[0], C)
        return sw_score_ends(query, ref, params)
    raise ValueError('sw_chain: unsupported devices {} and {}'.format(
        query.device, ref.device))


def family(args):
    """(name, scorer) of the family the flags select."""
    if args.wave:
        return 'wave', sw_wave
    if args.chain:
        C = args.chain
        return 'chain', lambda q, r, p: sw_chain(q, r, p, C)
    return 'row', sw_rowscan


def _codes(rng, shape, high, dev):
    return torch.from_numpy(rng.integers(0, high, shape).astype(np.int8)).to(
        dev)


def check(fn, params, dev, rng, Lq, Lr, rows=CHECK_ROWS):
    """Hold ``fn`` to the plain version at kexp's check shapes (300x517 and
    the timed shape less 7/3) on ``rows`` rows of codes A/C/G/T/N; raises
    AssertionError at the first mismatch."""
    shapes = [(300, 517)]
    timed = (max(64, Lq - 7), max(64, Lr - 3))
    if timed != shapes[0]:
        shapes.append(timed)
    for lq, lr in shapes:
        q = _codes(rng, (rows, lq), 5, dev)
        r = _codes(rng, (rows, lr), 5, dev)
        got = fn(q, r, params)
        want = sw_score_ends(q, r, params)
        for g, w, name in zip(got, want, ('score', 'q_end', 'r_end')):
            if not torch.equal(g, w):
                bad = torch.nonzero(g != w).flatten()[:5]
                raise AssertionError(
                    'MISMATCH {} ({}x{}) at rows {}: got {} want {}'.format(
                        name, lq, lr, bad.tolist(), g[bad].tolist(),
                        w[bad].tolist()))


def time_launches(step, n_iter, device, graph=False):
    """ms per call of ``step()`` over n_iter calls, after one call to warm
    up (and build).  On the card: CUDA events around the calls, or with
    ``graph`` around one replay of a CUDA graph that captured them (after
    one replay to warm up), so that the host's cost per launch is left out
    and the kernels run back to back, the graph's gaps between them
    included.  A launch captured into the graph counts once in LAUNCHES,
    though the graph runs it twice.  On the CPU: the host clock."""
    step()
    if device.type != 'cuda':
        t0 = time.perf_counter()
        for _ in range(n_iter):
            step()
        return (time.perf_counter() - t0) * 1e3 / n_iter
    torch.cuda.synchronize(device)
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured, capture_error_mode='relaxed'):
            for _ in range(n_iter):
                step()
        captured.replay()
        torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    if graph:
        captured.replay()
    else:
        for _ in range(n_iter):
            step()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / n_iter


def gcups(fn, q, r, params, n_iter, graph=False):
    """(GCUPS, ms per launch) of ``fn`` over n_iter launches, timed by
    ``time_launches``.  Without ``graph`` the launches are dependent: each
    launch's query is the last one's xor (score & 1) of its result, so no
    launch can start before the one before it ends (codes 0-3 xor 1 stay
    0-3).  In a graph they are independent, since the graph runs its
    kernels one after another."""
    carry = q.clone()

    def step():
        nonlocal carry
        score = fn(carry, r, params)[0]
        if not graph:
            carry = carry ^ (score & 1).to(carry.dtype)[:, None]

    ms = time_launches(step, n_iter, q.device, graph)
    B, Lq = q.shape
    return B * Lq * r.shape[1] / (ms * 1e-3) / 1e9, ms


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m ciri_long_tpu_torch.misc.kexp',
        description='Time one SW design family on the card.')
    fam = ap.add_mutually_exclusive_group()
    fam.add_argument('--r3', '--row', dest='row', action='store_true',
                     help='row scan, csrc/sw_rowscan.cu (the default)')
    fam.add_argument('--wave', action='store_true',
                     help='anti-diagonal wavefront, the wave route of '
                          'csrc/sw_score_ends.cu')
    fam.add_argument('--chain', type=int, default=0, metavar='C',
                     help='chained wavefront over C jobs per warp, '
                          'csrc/sw_chain.cu (B %% C == 0)')
    ap.add_argument('--B', type=int, default=512)
    ap.add_argument('--Lq', type=int, default=1024)
    ap.add_argument('--Lr', type=int, default=4096)
    ap.add_argument('--iters', type=int, default=8)
    ap.add_argument('--skipcheck', action='store_true')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                    help='cpu runs the plain versions, (default: '
                         '%(default)s)')
    args = ap.parse_args(argv)
    if args.chain < 0:
        ap.error('--chain takes C >= 1')
    return args


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    name, fn = family(args)
    rng = np.random.default_rng(0)
    if not args.skipcheck:
        C = max(args.chain, 1)
        check(fn, PARAMS, dev, rng, args.Lq, args.Lr,
              rows=-(-CHECK_ROWS // C) * C)
    B, Lq, Lr = args.B, args.Lq, args.Lr
    q = _codes(rng, (B, Lq), 4, dev)
    r = _codes(rng, (B, Lr), 4, dev)
    rate, ms = gcups(fn, q, r, PARAMS, args.iters)
    bound_ms = bound_by = smi = None
    card = 'cpu'
    if dev.type == 'cuda':
        bound_ms, bound_by = sw_bound(B, Lq, Lr, peak_cell_rate(dev))
        card = torch.cuda.get_device_name(dev)
        smi = nvidia_smi()
    line = {'variant': {'family': name, 'chain': args.chain}, 'B': B,
            'Lq': Lq, 'Lr': Lr, 'iters': args.iters, 'gcups': rate, 'ms': ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'device': card,
            'nvidia_smi': smi}
    print(json.dumps(line), flush=True)
    return line


if __name__ == '__main__':
    main()
