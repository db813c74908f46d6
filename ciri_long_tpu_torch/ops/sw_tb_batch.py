"""Batched Smith-Waterman WITH traceback on PyTorch.

Port of ``ciri_long_tpu/ops/sw_tb_batch.py``: a drop-in for
``[sw_traceback(q, r, ...) for q, r in zip(qs, rs)]`` (ops/traceback.py),
byte-identical, for collapse's rotation step, which aligns every
full-length cluster read (doubled) against its ~50 bp junction window
(reference collapse.py:373-382).

Orientation as in the JAX program: rows run over the short reference and
the long query lies along the other axis.  Direction codes per cell, in host
semantics:

  bits 0-1  case: 0=STOP (H==0 or no producer), 1=M (diag), 2=E (gap
            consuming reference), 3=F (gap consuming query) -- priority
            STOP > M > E > F, the host's traceback order
  bit 2     E-stay: E[i,j]==E[i,j-1]-ge and E[i,j]!=H[i,j-1]-go
  bit 3     F-stay: F[i,j]==F[i-1,j]-ge and F[i,j]!=H[i-1,j]-go

and the traceback walks them with the host's state machine.  The end cell
is the maximum score, then the smallest reference end, then the smallest
query end.

``sw_traceback_batch_plain`` is the plain PyTorch version (the JAX
recurrence, the within-row gap by a cummax); ``sw_traceback_cuda`` launches
the hand-written kernel ``csrc/sw_traceback.cu`` (one block a job, a warp a
32-row strip of the reference; the direction bytes in shared memory when
they fit a block's budget, else in global scratch: ``tb_plan`` picks the
route per job); both take padded code tensors with per-job lengths and
return (out [B, 6] int32 = score, q_begin, q_end, r_begin, r_end, run count;
runs [B, cap, 2] int32 with the path's (length, op) runs at the end of each
row, host ops 0=M 1=I 2=D, 0 elsewhere), which ``tb_results`` turns into the
host's tuples.  ``sw_traceback_batch`` is the entry point on ``device``
(default 'cuda', resolved by ``resolve_device``, which raises without a GPU):
the kernel on the card, the host ``sw_traceback`` per job on the CPU, which
is what the JAX package does where its device path is off.
"""

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ciri_long_tpu_torch.ops.sw import BLOCK_SMEM
from ciri_long_tpu_torch.utils.dispatch import (count_launch, resolve_device,
                                                span)

NEG = -(1 << 28)
PAD = 5

STOP, CM, CE, CF = 0, 1, 2, 3

# global-route direction bytes and handoff rows of one launch; the jobs are
# chunked to stay under it
MEM_BUDGET = 1 << 28
# csrc/sw_traceback.cu: a block's most warps, the ring of (H, E) columns
# between two of them, and the dynamic shared memory it opts into
MAX_WARPS = 8
RING_BYTES = 128 * 8
TB_SMEM = BLOCK_SMEM - 8192
# a job's direction bytes on the shared-memory route, beside the most rings
SMEM_CODES = TB_SMEM - (MAX_WARPS - 1) * RING_BYTES


def _cap(W, M):
    """Width of the runs rows: a path has at most W + M steps."""
    return W + M + 8


def _score_matrix(match, mismatch, device):
    S = np.full((6, 6), -mismatch, np.int32)
    np.fill_diagonal(S, match)
    S[4, :] = 0
    S[:, 4] = 0
    S[5, :] = NEG
    S[:, 5] = NEG
    return torch.from_numpy(S).to(device)


def sw_traceback_batch_plain(q: torch.Tensor, r: torch.Tensor,
                             n: torch.Tensor, m: torch.Tensor, match=1,
                             mismatch=1, gap_open=1, gap_extend=1):
    """Plain PyTorch SW with traceback (any device): q [B, W] and r [B, M]
    integer codes (PAD past each job's length), n and m [B] the real
    lengths.  Returns (out [B, 6] int32, runs [B, W + M + 8, 2] int32) as
    sw_traceback_cuda does: a job with no positive cell has out (0, -1, -1,
    -1, -1, 0).  The DP runs over the batch a reference row at a time; the
    traceback walks each job's codes on the host, merging the ops into
    runs as the kernel does."""
    B, W = q.shape
    M = r.shape[1]
    dev = q.device
    i32 = torch.int32
    go, ge = int(gap_open), int(gap_extend)
    S = _score_matrix(int(match), int(mismatch), dev)
    qi = q.to(torch.int64).clamp_max(PAD)
    ri = r.to(torch.int64).clamp_max(PAD)
    m = m.to(device=dev, dtype=i32)
    uu = torch.arange(W + 1, dtype=i32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)

    # carries: the previous row's H, E (vert) and h (max(diag, F, 0), the
    # E chain's origin, which excludes E itself)
    Hp = torch.zeros((B, W + 1), dtype=i32, device=dev)
    vp = torch.full((B, W + 1), NEG, dtype=i32, device=dev)
    ap = torch.full((B, W + 1), NEG, dtype=i32, device=dev)
    codes = torch.zeros((B, M + 1, W + 1), dtype=torch.int8, device=dev)
    best = torch.zeros(B, dtype=i32, device=dev)
    bt = torch.zeros(B, dtype=i32, device=dev)
    bu = torch.zeros(B, dtype=i32, device=dev)
    for t in range(1, M + 1):
        s = S[ri[:, t - 1:t], qi]                                  # [B, W]
        diag = torch.cat([neg_col, Hp[:, :-1] + s], 1)
        vert = torch.maximum(vp - ge, ap - go)
        g = torch.maximum(torch.maximum(diag, vert), torch.zeros_like(diag))
        g[:, 0] = 0
        # the gap consuming the query by the prefix-max identity
        p = torch.cummax(g + uu * ge, dim=1).values
        horiz = torch.cat([neg_col, p[:, :-1] - go - (uu[1:] - 1) * ge], 1)
        Hrow = torch.maximum(g, horiz)
        Hleft = torch.cat([zero_col, Hrow[:, :-1]], 1)
        horizleft = torch.cat([neg_col, horiz[:, :-1]], 1)
        case = torch.where(
            Hrow == 0, STOP,
            torch.where(Hrow == diag, CM,
                        torch.where(Hrow == vert, CE,
                                    torch.where(Hrow == horiz, CF, STOP))))
        estay = (t > 1) & (vert == vp - ge) & (vert != Hp - go)
        fstay = (uu > 1) & (horiz == horizleft - ge) & (horiz != Hleft - go)
        crow = case + (estay.to(i32) << 2) + (fstay.to(i32) << 3)
        live = (t <= m)[:, None]
        codes[:, t] = torch.where(live, crow, 0).to(torch.int8)
        # strict > keeps the smallest reference end t, the first argmax
        # the smallest query end u
        rmax, uarg = Hrow.max(dim=1)
        better = (t <= m) & (rmax > best)
        best = torch.where(better, rmax, best)
        bt = torch.where(better, t, bt)
        bu = torch.where(better, uarg.to(i32), bu)
        hA = torch.maximum(torch.maximum(diag, horiz), torch.zeros_like(diag))
        hA[:, 0] = NEG
        Hp = torch.where(live, Hrow, Hp)
        vp = torch.where(live, vert, vp)
        ap = torch.where(live, hA, ap)

    codes = codes.cpu().numpy()
    best, bt, bu = (x.cpu().numpy() for x in (best, bt, bu))
    cap = _cap(W, M)
    out = np.zeros((B, 6), np.int32)
    out[:, 1:5] = -1
    runs = np.zeros((B, cap, 2), np.int32)
    for b in range(B):
        if best[b] <= 0:
            continue
        # the host state machine: i = query position (u), j = reference
        # position (t); states H 0, E 1, F 2; host ops 0 M, 1 I, 2 D
        i, j, state, cnt = int(bu[b]), int(bt[b]), 0, 0
        run_op, run_len = -1, 0
        while i > 0 and j > 0:
            c = int(codes[b, j, i])
            if state == 0:
                case = c & 3
                if case == STOP:
                    break
                if case != CM:
                    state = 1 if case == CE else 2
                    continue
                op = 0
                i -= 1
                j -= 1
            elif state == 1:
                op = 2
                if not (c >> 2) & 1:
                    state = 0
                j -= 1
            else:
                op = 1
                if not (c >> 3) & 1:
                    state = 0
                i -= 1
            if op == run_op:
                run_len += 1
            else:
                if run_len:
                    runs[b, cap - 1 - cnt] = (run_len, run_op)
                    cnt += 1
                run_op, run_len = op, 1
        if run_len:
            runs[b, cap - 1 - cnt] = (run_len, run_op)
            cnt += 1
        out[b] = (best[b], i, bu[b] - 1, j, bt[b] - 1, cnt)
    return torch.from_numpy(out).to(dev), torch.from_numpy(runs).to(dev)


_SYMBOLS = {
    'sw_traceback_launch': ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
                            + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                            + [ctypes.c_void_p] * 3, ctypes.c_int),
}


def code_bytes(n, m):
    """Direction bytes of one job in csrc/sw_traceback.cu's (strip, step,
    lane) layout: ceil(m / 32) strips of n + 31 steps, rounded up to whole
    32-step chunks, of 32 lanes (numpy arrays or ints)."""
    n, m = np.asarray(n, np.int64), np.asarray(m, np.int64)
    return np.where((n > 0) & (m > 0),
                    -(-m // 32) * -(-(n + 31) // 32) * 1024, 0)


def global_bytes(n, m):
    """The direction bytes a job puts in global scratch: 0 on the
    shared-memory route."""
    size = code_bytes(n, m)
    return np.where(size <= SMEM_CODES, 0, size)


class TbLaunch(NamedTuple):
    """One launch of csrc/sw_traceback.cu: its route ('tb_smem' or
    'tb_global'), the jobs (int32 indices on the device), warps a block,
    dynamic shared memory a block, on the global route the jobs' code
    offsets (int64 on the device) and their bytes in all, and the most
    32-row strips a job has (more than ``warps``: a handoff row a job)."""
    route: str
    jobs: torch.Tensor
    warps: int
    smem: int
    code_off: Optional[torch.Tensor]
    code_bytes: int
    strips: int


def tb_plan(n_host, m_host, W, M, device) -> List[TbLaunch]:
    """The launches of a batch of jobs of real lengths ``n_host`` and
    ``m_host`` (numpy), clamped to the widths W and M as the kernel clamps
    them: the jobs whose direction bytes fit a block's shared memory next
    to the rings (SMEM_CODES) on the shared-memory route, the others on the
    global route; a route with no job has no launch."""
    n = np.clip(np.asarray(n_host), 0, W)
    m = np.clip(np.asarray(m_host), 0, M)
    sizes = code_bytes(n, m)
    on_smem = sizes <= SMEM_CODES
    launches = []
    for route, sel in (('tb_smem', on_smem), ('tb_global', ~on_smem)):
        idx = np.flatnonzero(sel).astype(np.int32)
        if not len(idx):
            continue
        strips = int(-(-m[idx].max() // 32))
        warps = min(MAX_WARPS, max(1, strips))
        rings = (warps - 1) * RING_BYTES
        jobs = torch.from_numpy(idx).to(device)
        if route == 'tb_smem':
            launches.append(TbLaunch(route, jobs, warps,
                                     rings + int(sizes[idx].max()), None, 0,
                                     strips))
        else:
            off = np.concatenate([[0], np.cumsum(sizes[idx])[:-1]])
            launches.append(TbLaunch(
                route, jobs, warps, rings,
                torch.from_numpy(off.astype(np.int64)).to(device),
                int(sizes[idx].sum()), strips))
    return launches


def sw_traceback_cuda(q: torch.Tensor, r: torch.Tensor, n: torch.Tensor,
                      m: torch.Tensor, match=1, mismatch=1, gap_open=1,
                      gap_extend=1, plan=None):
    """The hand-written CUDA kernel (csrc/sw_traceback.cu) on CUDA tensors:
    q int8 [B, W], r int8 [B, M], n and m int32 [B], contiguous, on one
    device.  Same outputs as sw_traceback_batch_plain.  The routes and the
    direction bytes are planned from each job's real n and m: ``plan`` is
    tb_plan's answer for them when the caller has it (no copy back from the
    card), else computed from n and m read back.  One launch a route, each
    counted in LAUNCHES and ROUTES.  Raises on anything else, when gap_open
    < gap_extend, and when a launch is refused."""
    from ciri_long_tpu_torch.ops import _build

    tensors = (q, r, n, m)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError('sw_traceback_cuda needs q, r, n and m on one CUDA '
                         'device (got {})'.format([str(t.device)
                                                   for t in tensors]))
    if q.dtype != torch.int8 or r.dtype != torch.int8:
        raise TypeError('sw_traceback_cuda needs int8 codes (got {} and '
                        '{})'.format(q.dtype, r.dtype))
    if n.dtype != torch.int32 or m.dtype != torch.int32:
        raise TypeError('sw_traceback_cuda needs int32 lengths (got {} and '
                        '{})'.format(n.dtype, m.dtype))
    B = q.shape[0] if q.dim() == 2 else -1
    if (q.dim() != 2 or r.dim() != 2 or r.shape[0] != B
            or tuple(n.shape) != (B,) or tuple(m.shape) != (B,)):
        raise ValueError('sw_traceback_cuda needs [B, W], [B, M], [B] and [B] '
                         '(got {})'.format([tuple(t.shape) for t in tensors]))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('sw_traceback_cuda needs contiguous inputs')
    if gap_open < gap_extend:
        raise ValueError('sw_traceback_cuda requires gap_open >= gap_extend')
    W, M = q.shape[1], r.shape[1]
    cap = _cap(W, M)
    if max(B, cap + 32) >= 2 ** 31:
        raise ValueError("sw_traceback_cuda shape {}x{}x{} exceeds the "
                         "kernel's int arguments".format(B, W, M))
    dev = q.device
    if plan is None:
        plan = tb_plan(n.cpu().numpy(), m.cpu().numpy(), W, M, dev)
    lib = _build.load('sw_traceback.cu', _SYMBOLS)
    runs = torch.zeros((B, cap, 2), dtype=torch.int32, device=dev)
    out = torch.empty((B, 6), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for launch in plan:
        jobs = launch.jobs.numel()
        codes = torch.empty(max(1, launch.code_bytes), dtype=torch.uint8,
                            device=dev)
        # the group handoff rows: only jobs of more strips than warps
        edge = torch.empty((jobs, W, 2) if launch.strips > launch.warps
                           else (1,), dtype=torch.int32, device=dev)
        # the shared-memory route reads no code offsets: NULL
        code_off = None if launch.code_off is None else \
            launch.code_off.data_ptr()
        with torch.cuda.device(dev):
            rc = lib.sw_traceback_launch(
                q.data_ptr(), r.data_ptr(), n.data_ptr(), m.data_ptr(),
                launch.jobs.data_ptr(), jobs, launch.warps,
                int(launch.route == 'tb_smem'), launch.smem, W, M,
                int(match), int(mismatch), int(gap_open), int(gap_extend),
                code_off, codes.data_ptr(), edge.data_ptr(), cap,
                runs.data_ptr(), out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError('sw_traceback launch failed: cudaError {} '
                               '({} route, {} jobs, W={}, M={})'.format(
                                   rc, launch.route, jobs, W, M))
        count_launch('sw_traceback', launch.route)
    return out, runs


def sw_traceback_auto(q, r, n, m, match=1, mismatch=1, gap_open=1,
                      gap_extend=1):
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return sw_traceback_cuda(q, r, n, m, match, mismatch, gap_open,
                                 gap_extend)
    if all(t.device.type == 'cpu' for t in (q, r, n, m)):
        return sw_traceback_batch_plain(q, r, n, m, match, mismatch,
                                        gap_open, gap_extend)
    raise ValueError('sw_traceback_auto: unsupported devices {}'.format(
        [str(t.device) for t in (q, r, n, m)]))


def pack_jobs(qs: Sequence[np.ndarray], rs: Sequence[np.ndarray]):
    """(q [B, W], r [B, M], n [B], m [B]) numpy: each job's codes, PAD
    behind them, W and M the longest query and reference."""
    n = np.array([len(x) for x in qs], np.int32)
    m = np.array([len(x) for x in rs], np.int32)
    q = np.full((len(qs), max(1, int(n.max(initial=0)))), PAD, np.int8)
    r = np.full((len(rs), max(1, int(m.max(initial=0)))), PAD, np.int8)
    for b, (x, y) in enumerate(zip(qs, rs)):
        q[b, :len(x)] = x
        r[b, :len(y)] = y
    return q, r, n, m


def tb_results(out, runs) -> List[Optional[Tuple]]:
    """The host's (score, q_begin, q_end, r_begin, r_end, cigar) tuples, or
    None for a job with no positive cell, from (out, runs): the cigar is
    the (length, op) runs at the end of each row (host ops 0=M 1=I 2=D)."""
    out = out.cpu().numpy() if torch.is_tensor(out) else out
    runs = runs.cpu().numpy() if torch.is_tensor(runs) else runs
    cap = runs.shape[1]
    res: List[Optional[Tuple]] = []
    for row, (score, qb, qe, rb, re_, cnt) in zip(runs, out.tolist()):
        res.append((score, qb, qe, rb, re_,
                    [tuple(x) for x in row[cap - cnt:].tolist()])
                   if score > 0 else None)
    return res


def _chunks(qs, rs):
    """Consecutive job ranges whose global-route direction bytes and
    handoff rows stay under MEM_BUDGET (a job over it alone is a range of
    its own)."""
    budget = MEM_BUDGET
    lo, code, W = 0, 0, 0
    for b, (x, y) in enumerate(zip(qs, rs)):
        job = int(global_bytes(len(x), len(y)))
        if b > lo and (code + job + 8 * (b + 1 - lo) * max(W, len(x))
                       > budget):
            yield lo, b
            lo, code, W = b, 0, 0
        code += job
        W = max(W, len(x))
    if lo < len(qs):
        yield lo, len(qs)


@span('sw_traceback_batch')
def sw_traceback_batch(qs: Sequence[np.ndarray], rs: Sequence[np.ndarray],
                       match=1, mismatch=1, gap_open=1, gap_extend=1,
                       device='cuda') -> List[Optional[Tuple]]:
    """Batched drop-in for [sw_traceback(q, r) for q, r in zip(qs, rs)] on
    ``device``: the kernel on the card, in chunks under MEM_BUDGET bytes of
    global scratch; the host DP per job on the CPU."""
    from ciri_long_tpu_torch.ops.traceback import sw_traceback

    device = resolve_device(device)
    scores = (int(match), int(mismatch), int(gap_open), int(gap_extend))
    if device.type == 'cpu':
        return [sw_traceback(q, r, *scores) for q, r in zip(qs, rs)]
    res: List[Optional[Tuple]] = []
    for lo, hi in _chunks(qs, rs):
        q, r, n, m = pack_jobs(qs[lo:hi], rs[lo:hi])
        args = upload((q, r, n, m), device)
        plan = tb_plan(n, m, q.shape[1], r.shape[1], device)
        res += tb_results(*download(sw_traceback_cuda(*args, *scores,
                                                      plan=plan)))
    return res


# sw_traceback_batch's copies, named so that a run can time each stage of
# the batch apart (chip_smoke.py phase 8)
def upload(arrays, device):
    """numpy arrays to ``device``."""
    return [torch.from_numpy(x).to(device) for x in arrays]


def download(tensors):
    """Tensors to numpy; the copy waits for the kernels that write them."""
    return [t.cpu().numpy() for t in tensors]
