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
  csrc/sw_rowscan.cu, one block per batch row sweeping the query rows, the
  horizontal gap resolved by a prefix max over all reference columns;
- wave (``--wave``; kexp.py:1534, ``build_kernel_wave*``): the
  anti-diagonal wavefront route of csrc/sw_score_ends.cu, forced at every
  shape (``call`` takes that kernel's tiled route where it applies);
- chain (``--chain C``; kexp.py:1462, ``build_kernel_chain*``):
  csrc/sw_chain.cu, the wavefront over C jobs' references laid back to back
  behind boundary codes (``chain_layout``), B % C == 0.

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

import numpy as np
import torch

from ciri_long_tpu_torch.ops.sw import (BLOCK_SMEM, PAD, SWParams,
                                        check_cuda_codes, sw_score_ends,
                                        sw_score_ends_wave_cuda)
from ciri_long_tpu_torch.utils.dispatch import LAUNCHES, resolve_device

PARAMS = SWParams(10, 4, 8, 2)
CHECK_ROWS = 32          # kexp's check batch (its default --btile)
BOUNDARY = 6             # the chain stream's job boundary code

HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
# dynamic shared memory a block may opt into on Hopper less the row scan's
# static arrays
ROWSCAN_SMEM_LIMIT = BLOCK_SMEM - 512


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
}
# recurrence_rate's kinds: the updates of collapse's two kernels, the edit
# distance's by its bit-parallel word (32 rows of one column) and, to
# compare with a cell-by-cell design, by its DP cell
RECURRENCES = {'edit_cell': 0, 'sw_traceback': 1, 'edit_distance': 2}


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
    edit distance), from csrc/op_rate.cu's register-only loop of that
    update: the operations bound of that kernel."""
    return _rate(device, 'recurrence_rate_launch', RECURRENCES[kernel])


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
    'sw_rowscan_launch': ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                          + [ctypes.c_void_p] * 4, ctypes.c_int),
    'sw_rowscan_smem_bytes': ([ctypes.c_int], ctypes.c_int),
}


def sw_rowscan_cuda(query: torch.Tensor, ref: torch.Tensor, params: SWParams):
    """The row-scan kernel (csrc/sw_rowscan.cu) on CUDA tensors; the inputs
    and outputs of ops/sw.py::sw_score_ends_cuda.  Raises on anything else,
    for a reference whose H/F rows do not fit a block's shared memory
    (Lr above about 25 000), and when the launch is refused."""
    from ciri_long_tpu_torch.ops import _build

    check_cuda_codes('sw_rowscan_cuda', query, ref, params)
    B, Lq = query.shape
    Lr = ref.shape[1]
    lib = _build.load('sw_rowscan.cu', _ROWSCAN_SYMBOLS)
    smem = lib.sw_rowscan_smem_bytes(Lr)
    if smem > ROWSCAN_SMEM_LIMIT:
        raise ValueError('sw_rowscan_cuda: Lr={} needs {} bytes of shared '
                         'memory, above the {} a block may have'.format(
                             Lr, smem, ROWSCAN_SMEM_LIMIT))
    dev = query.device
    score, q_end, r_end = _ends(B, dev, Lq, Lr)
    if B == 0 or Lq == 0 or Lr == 0:
        return score, q_end, r_end
    with torch.cuda.device(dev):
        rc = lib.sw_rowscan_launch(
            query.data_ptr(), ref.data_ptr(), B, Lq, Lr, params.match,
            params.mismatch, params.gap_open, params.gap_extend,
            score.data_ptr(), q_end.data_ptr(), r_end.data_ptr(),
            _stream(dev))
    if rc != 0:
        raise RuntimeError('sw_rowscan kernel launch failed: cudaError {} '
                           '(B={}, Lq={}, Lr={})'.format(rc, B, Lq, Lr))
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
    'sw_chain_launch': ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                        + [ctypes.c_void_p] * 6, ctypes.c_int),
}


def sw_chain_cuda(query: torch.Tensor, ref: torch.Tensor, params: SWParams,
                  C: int):
    """The chained wavefront kernel (csrc/sw_chain.cu) on CUDA tensors, C
    jobs per warp; the inputs and outputs of ops/sw.py::sw_score_ends_cuda.
    Raises on anything else, when C does not divide B, and when the launch
    is refused."""
    from ciri_long_tpu_torch.ops import _build

    check_cuda_codes('sw_chain_cuda', query, ref, params)
    B, Lq = query.shape
    Lr = ref.shape[1]
    qrows, stream = chain_layout(query, ref, C)
    rows, T = stream.shape
    if T >= 2 ** 31 - 32:
        raise ValueError("sw_chain_cuda stream of {} slots exceeds the "
                         "kernel's int arguments".format(T))
    lib = _build.load('sw_chain.cu', _CHAIN_SYMBOLS)
    dev = query.device
    score, q_end, r_end = _ends(B, dev, Lq, Lr)
    if B == 0 or Lq == 0:
        return score, q_end, r_end
    scratch = torch.empty((rows, T, 2), dtype=torch.int32, device=dev)
    records = torch.empty((rows, C, 32, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.sw_chain_launch(
            qrows.data_ptr(), stream.data_ptr(), rows, C, Lq, T,
            params.match, params.mismatch, params.gap_open,
            params.gap_extend, scratch.data_ptr(), records.data_ptr(),
            score.data_ptr(), q_end.data_ptr(), r_end.data_ptr(),
            _stream(dev))
    if rc != 0:
        raise RuntimeError('sw_chain kernel launch failed: cudaError {} '
                           '(B={}, Lq={}, Lr={}, C={})'.format(rc, B, Lq, Lr,
                                                              C))
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
