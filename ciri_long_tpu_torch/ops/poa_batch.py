"""Batched sequence-to-graph alignment of collapse's POA rounds on PyTorch.

Port of ``ciri_long_tpu/ops/poa_batch.py`` (ROADMAP X6).  Each job aligns a
sequence to a partial-order graph whose nodes are in topological rank order
(ops/poa.py::_flatten_graph), with spoa's two-piece affine gaps in overlap
mode; the semantics, values and ties are those of native/poacore.cpp's
AlignCore and of the JAX program: stored E first, then M with the
predecessors tried in caller order before the virtual source, then F, else
stop.  The traceback gives (rank | -1, pos | -1) pairs in forward order.

A batch of B jobs:
  bases [B, Vmax]    node codes in rank order (int)
  offs  [B, Vmax+1]  CSR offsets into ``preds``, absolute (int32)
  preds [E]          predecessor rows, rank + 1 in insertion order (row 0 is
                     the virtual source; an empty list stands for [0])
  seqs  [B, nmax]    sequence codes 0-4, padded with 5 (int)
  nv, ns [B]         nodes and sequence length of each job
CSR takes any in-degree: the JAX program's P <= 8 cap and its fallback to
the native core were there for Mosaic's fixed shapes.

``poa_align_batch_plain`` is the plain PyTorch version (JAX's
``_align_one`` with the jobs in lockstep, a row of every job at a time);
``poa_align_batch_cuda`` launches the hand-written kernel
``csrc/poa_align.cu`` under a plan (``poa_plan``: its ring depth and the
rows it spills to global memory); ``poa_align_batch`` takes the kernel for
CUDA tensors and the plain version for CPU tensors, nothing else.  All return
(score int32 [B], aln int32 [B, CAP, 2], acnt int32 [B]) in JAX's layout:
CAP = Vmax + nmax + 1, job b's acnt[b] pairs at the end of aln[b] in forward
order, -2 before them.  collapse itself reaches the kernel through the
round loop of the same source (ops/poa.py::poa_consensus_many), whose
csrc/poa_graph.h packs each round in this same layout.
"""

import ctypes
from collections import namedtuple

import numpy as np
import torch

from ciri_long_tpu_torch.utils.dispatch import count_launch

NEG = -(1 << 28)
STOP, GAPSEQ, MATCH, GAPGRAPH = 0, 1, 2, 3
# spoa's scores as collapse calls poa (m, x, o1, e1, o2, e2)
SCORES = (10, -4, -8, -2, -24, -1)
# bytes a cell that the alignment and its walk must keep in memory: the
# 32-bit direction word (case << 30 | the predecessor's row), the only
# plane csrc/poa_align.cu writes out; H, F1 and F2 stay on chip but for
# the rows it spills
DIR_BYTES = 4


def _pred_lists(offs, preds):
    """Dense [B, Vmax, P] predecessor rows and their mask from CSR (numpy),
    an empty list as [0]."""
    B, V1 = offs.shape
    deg = np.diff(offs, axis=1)
    P = max(1, int(deg.max(initial=0)))
    pr = np.zeros((B, V1 - 1, P), np.int64)
    mask = np.zeros((B, V1 - 1, P), bool)
    for b in range(B):
        for i in range(V1 - 1):
            lo, hi = int(offs[b, i]), int(offs[b, i + 1])
            if hi > lo:
                pr[b, i, :hi - lo] = preds[lo:hi]
                mask[b, i, :hi - lo] = True
            else:
                mask[b, i, 0] = True
    return pr, mask


def _first(hit, k_idx, none):
    """Index of the first True along dim 1 (``none`` where there is none)."""
    return torch.where(hit, k_idx, torch.full_like(k_idx, none)).amin(1)


def poa_align_batch_plain(bases, offs, preds, seqs, nv, ns, scores=SCORES):
    """Plain PyTorch graph alignments (any device; the rows of all jobs in
    lockstep, the walk on the host).  See the module docstring."""
    m, x, o1, e1, o2, e2 = (int(v) for v in scores)
    dev = bases.device
    B, Vmax = bases.shape
    nmax = seqs.shape[1]
    W = nmax + 1
    CAP = Vmax + W
    i32 = torch.int32
    offs_np = offs.cpu().numpy().astype(np.int64)
    preds_np = preds.cpu().numpy().astype(np.int64)
    nv_np = nv.cpu().numpy().astype(np.int64)
    ns_np = ns.cpu().numpy().astype(np.int64)
    pr_np, mask_np = _pred_lists(offs_np, preds_np)
    P = pr_np.shape[2]
    pr = torch.from_numpy(pr_np).to(dev)
    kmask = torch.from_numpy(mask_np).to(dev)
    bases = bases.to(i32)
    seqs = seqs.to(i32)

    jj = torch.arange(W, dtype=i32, device=dev)
    h0 = torch.maximum(o1 + (jj - 1) * e1, o2 + (jj - 1) * e2)
    h0[0] = 0
    H = torch.full((B, Vmax + 1, W), NEG, dtype=i32, device=dev)
    H[:, 0] = h0
    F1 = torch.full_like(H, NEG)
    F2 = torch.full_like(H, NEG)
    case = torch.zeros_like(H)
    pidx = torch.zeros_like(H)
    rows = torch.arange(B, device=dev)[:, None]
    k_all = torch.arange(P + 1, dtype=torch.int64, device=dev)[None, :, None]
    k_pred = k_all[:, :P]
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    live_v = torch.from_numpy(nv_np).to(dev)

    for i in range(1, Vmax + 1):
        b = bases[:, i - 1]
        prr = pr[:, i - 1]                       # [B, P] rows
        km = kmask[:, i - 1][:, :, None]         # [B, P, 1]
        Hp = torch.where(km, H[rows, prr], NEG)  # [B, P, W]
        F1g = torch.where(km, F1[rows, prr], NEG)
        F2g = torch.where(km, F2[rows, prr], NEG)

        hmax = Hp.amax(1)
        F1p = torch.maximum(F1g.amax(1) + e1, hmax + o1)
        F2p = torch.maximum(F2g.amax(1) + e2, hmax + o2)

        # M over the predecessors, then the source (first maximum wins)
        hp_prev = torch.cat([Hp, H[:, 0:1]], 1)[:, :, :-1]   # [B, P+1, W-1]
        mval = hp_prev.amax(1)
        midx = _first(hp_prev == mval[:, None], k_all, P)
        s = torch.where(seqs == b[:, None], m, x).to(i32)
        Mrow = torch.cat([neg_col, mval + s], 1)
        pidxM = torch.cat([zero_col, midx], 1)

        Hpre = torch.maximum(Mrow, torch.maximum(F1p, F2p))
        Hpre[:, 0] = Hpre[:, 0].clamp_min(0)     # free leading overhang

        c1 = torch.cummax(Hpre - jj * e1, 1).values
        c2 = torch.cummax(Hpre - jj * e2, 1).values
        E1r = torch.cat([neg_col, c1[:, :-1] + o1 + (jj[1:] - 1) * e1], 1)
        E2r = torch.cat([neg_col, c2[:, :-1] + o2 + (jj[1:] - 1) * e2], 1)
        Hrow = torch.maximum(Hpre, torch.maximum(E1r, E2r))

        isE = (Hrow == E1r) | (Hrow == E2r)
        isM = Hrow == Mrow
        valk = torch.maximum(torch.maximum(F1g + e1, Hp + o1),
                             torch.maximum(F2g + e2, Hp + o2))
        hitk = valk == Hrow[:, None]
        anyF = hitk.any(1)
        pidxF = torch.where(anyF, _first(hitk, k_pred, P), 0)
        isF = ((Hrow == F1p) | (Hrow == F2p)) & anyF
        crow = torch.where(isE, GAPSEQ, torch.where(
            isM, MATCH, torch.where(isF, GAPGRAPH, STOP)))
        prow = torch.where(isM & ~isE, pidxM, pidxF)

        live = (i <= live_v)[:, None]
        H[:, i] = torch.where(live, Hrow, NEG)
        F1[:, i] = torch.where(live, F1p, NEG)
        F2[:, i] = torch.where(live, F2p, NEG)
        case[:, i] = torch.where(live, crow, STOP).to(i32)
        pidx[:, i] = torch.where(live, prow, 0).to(i32)

    # free trailing overhang: the first maximum of column n
    ncol = torch.from_numpy(ns_np).to(dev)
    Hcol = H.gather(2, ncol[:, None, None].expand(B, Vmax + 1, 1))[:, :, 0]
    best = Hcol.amax(1)
    rank_idx = torch.arange(Vmax + 1, device=dev)[None, :]
    end = torch.where(Hcol == best[:, None], rank_idx, Vmax + 1).amin(1)

    case_np = case.cpu().numpy()
    pidx_np = pidx.cpu().numpy()
    end_np = end.cpu().numpy()
    aln = np.full((B, CAP, 2), -2, np.int32)
    acnt = np.zeros(B, np.int32)
    for bi in range(B):
        acnt[bi] = _walk(case_np[bi], pidx_np[bi], offs_np[bi], preds_np,
                         int(end_np[bi]), int(ns_np[bi]), aln[bi])
    return (best.to(i32), torch.from_numpy(aln).to(dev),
            torch.from_numpy(acnt).to(dev))


def _walk(case, pidx, offs, preds, i, j, out):
    """The traceback over one job's planes from (i, j) = (end rank, n):
    pairs written from the end of ``out`` back; returns their count."""
    cap = out.shape[0]
    t = 0
    stopped = False
    while j > 0:
        c, k = GAPSEQ, 0
        if not stopped and i > 0:
            c, k = int(case[i, j]), int(pidx[i, j])
        if c == STOP:
            stopped = True
            continue
        if c == GAPSEQ:
            pair = (-1, j - 1)
            j -= 1
        else:
            lo, hi = int(offs[i - 1]), int(offs[i])
            pair = (i - 1, j - 1 if c == MATCH else -1)
            if c == MATCH:
                j -= 1
                i = int(preds[lo + k]) if k < hi - lo else 0
            else:
                i = int(preds[lo + k]) if hi > lo else 0
        t += 1
        out[cap - t] = pair
    return t


# csrc/poa_align.cu's C functions: one launch, and the round loop of
# ops/poa.py::poa_consensus_many
SYMBOLS = {
    'poa_align_launch': ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                         + [ctypes.c_int, ctypes.c_void_p]
                         + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5,
                         ctypes.c_int),
    'poa_consensus_run': ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                          + [ctypes.c_void_p] * 5
                          + [ctypes.c_int] + [ctypes.c_void_p] * 3
                          + [ctypes.c_int], ctypes.c_int),
}
# the largest row csrc/poa_align.cu's direction word holds (its row field,
# 30 bits): graphs of more nodes are refused
MAX_ROW = (1 << 30) - 1
# csrc/poa_align.cu's launch constants: warps a block at most (8 at 8
# columns a lane), the dynamic shared memory a block takes at most, the
# words a row pads to
MAX_WARPS = 16
SMEM_BYTES = 232448 - 1024
ROW_ALIGN = 8
# a launch's plan (poa_plan): C columns a lane, warps, ring depth, the
# longest job's list entries, the spill rows a job needs at most and each
# row's spill slot (int32 [B, Vmax+1] on the device, -1 for none; None
# without spill rows)
PoaPlan = namedtuple('PoaPlan', 'cols warps depth emax spill_rows sidx')


def max_warps(C):
    """csrc/poa_align.cu::max_warps."""
    return 8 if C == 8 else MAX_WARPS


def launch_shape(nmax):
    """csrc/poa_align.cu::launch_shape: (C columns a lane, threads), a warp
    for each chunk of 32 C columns up to max_warps(C)."""
    W = nmax + 1
    C = 1 if W <= 512 else 2 if W <= 1024 else 4 if W <= 2048 else 8
    return C, 32 * min(-(-W // (32 * C)), max_warps(C))


def padded_width(nmax):
    """Wp: the words of a ring, spill or direction row."""
    return -(-(nmax + 1) // ROW_ALIGN) * ROW_ALIGN


def stage_bytes(Vmax, nmax, emax):
    """Shared memory of the staged inputs: offs, preds, sidx, bases and
    the sequence, each rounded up to 16 bytes (csrc/poa_align.cu::
    make_layout)."""
    def r16(x):
        return -(-x // 16) * 16
    return 2 * r16(4 * (Vmax + 1)) + r16(4 * emax) + r16(Vmax) + r16(nmax)


def check_batch(offs, preds, nv, ns, Vmax, nmax):
    """Raise unless a batch of [B, Vmax] nodes and [B, nmax] codes holds
    its lengths (numpy nv, ns [B]), has at most MAX_ROW nodes, and its CSR
    lists (numpy offs [B, Vmax+1], preds [E]) are ordered and name rows
    before their own (rank order: 0 <= p < i), all the kernel takes."""
    nv = np.asarray(nv, np.int64)
    ns = np.asarray(ns, np.int64)
    if len(nv) and (nv.min() < 0 or nv.max() > Vmax or ns.min() < 0
                    or ns.max() > nmax):
        raise ValueError('poa_align: nv must lie in [0, {}] and ns in [0, '
                         '{}]'.format(Vmax, nmax))
    if Vmax > MAX_ROW:
        raise ValueError('poa_align: {} nodes exceed the direction word\'s '
                         'row field ({} at most)'.format(Vmax, MAX_ROW))
    offs = np.asarray(offs, np.int64)
    preds = np.asarray(preds, np.int64)
    deg = np.diff(offs, axis=1)
    if deg.size and (deg.min() < 0 or offs.min() < 0
                     or offs.max() > len(preds)):
        raise ValueError('poa_align: predecessor lists must be CSR into '
                         'preds')
    for b in range(len(nv)):
        o = offs[b, :nv[b] + 1]
        rows = np.repeat(np.arange(1, nv[b] + 1), np.diff(o))
        p = preds[o[0]:o[-1]]
        if p.size and (p.min() < 0 or (p >= rows).any()):
            raise ValueError('poa_align: a predecessor must come before its '
                             'node (rank order, rows 0 <= p < i)')


def poa_plan(offs, preds, nv, ns, Vmax, nmax, device='cpu', depth=None,
             shape=None):
    """The plan of one launch of csrc/poa_align.cu over numpy offs [B,
    Vmax+1] (absolute), preds [E], nv and ns [B] (checked by check_batch):
    csrc/poa_align.cu::plan_launch's twin.  The ring gets ``depth`` rows,
    by default the farthest lookback, within the shared memory the staged
    inputs leave (all of it when they do not fit); a row is spilled when a
    successor reaches it from farther.  ``depth`` forces a depth and
    ``shape`` (C, threads) a block (tests, timing); by default
    launch_shape(nmax)."""
    check_batch(offs, preds, nv, ns, Vmax, nmax)
    offs = np.asarray(offs, np.int64)
    preds = np.asarray(preds, np.int64)
    C, threads = shape or launch_shape(nmax)
    if C not in (1, 2, 4, 8) or threads % 32 or not \
            32 <= threads <= 32 * max_warps(C):
        raise ValueError('poa_plan: no block of {} columns a lane and {} '
                         'threads'.format(C, threads))
    edges = []
    for b in range(len(nv)):
        o = offs[b, :int(nv[b]) + 1]
        rows = np.repeat(np.arange(1, int(nv[b]) + 1), np.diff(o))
        edges.append((rows, preds[o[0]:o[-1]]))
    emax = max([len(p) for _, p in edges], default=0)
    look = max([int((r - p)[p > 0].max(initial=0)) for r, p in edges],
               default=0)
    row = 12 * padded_width(nmax)
    stage = stage_bytes(Vmax, nmax, emax)
    room = SMEM_BYTES - stage if stage <= SMEM_BYTES else SMEM_BYTES
    if depth is None:
        depth = min(look, room // row)
    elif depth < 0 or depth * row > SMEM_BYTES:
        raise ValueError('poa_plan: a ring of {} rows of {} bytes does not '
                         'fit {} bytes'.format(depth, row, SMEM_BYTES))
    sidx = np.full((len(nv), Vmax + 1), -1, np.int32)
    for b, (r, p) in enumerate(edges):
        far = np.unique(p[(p > 0) & (r - p > depth)])
        sidx[b, far] = np.arange(len(far))
    spill_rows = int((sidx >= 0).sum(1).max(initial=0))
    return PoaPlan(C, threads // 32, depth, emax, spill_rows,
                   torch.from_numpy(sidx).to(device) if spill_rows else None)


def poa_align_batch_cuda(bases, offs, preds, seqs, nv, ns, scores=SCORES,
                         plan=None, stamps=None):
    """The hand-written CUDA kernel (csrc/poa_align.cu) on CUDA tensors of
    one device: bases [B, Vmax] and seqs [B, nmax] integer codes, offs
    int32 [B, Vmax+1] absolute into preds int32 [E], nv and ns [B].  Same
    output as poa_align_batch_plain.  ``plan`` is poa_plan's answer for
    these inputs when the caller has it (nothing is read back from the
    card, as a CUDA graph's capture needs), else made from the inputs read
    back.  ``stamps`` (int64 [B, 3] on the device) gets each block's
    %globaltimer in ns at its start, after its rows and after its walk.
    Raises on anything else, and when the launch is refused."""
    from ciri_long_tpu_torch.ops import _build

    tensors = (bases, offs, preds, seqs, nv, ns)
    if not all(t.is_cuda and t.device == bases.device for t in tensors):
        raise ValueError('poa_align_batch_cuda needs its inputs on one CUDA '
                         'device (got {})'.format(
                             [str(t.device) for t in tensors]))
    if offs.dtype != torch.int32 or preds.dtype != torch.int32:
        raise TypeError('poa_align_batch_cuda needs int32 offs and preds')
    B, Vmax = bases.shape if bases.dim() == 2 else (-1, -1)
    nmax = seqs.shape[1] if seqs.dim() == 2 else -1
    if (B < 0 or tuple(offs.shape) != (B, Vmax + 1) or seqs.dim() != 2
            or seqs.shape[0] != B or tuple(nv.shape) != (B,)
            or tuple(ns.shape) != (B,) or preds.dim() != 1):
        raise ValueError('poa_align_batch_cuda needs bases [B, Vmax], offs '
                         '[B, Vmax+1], preds [E], seqs [B, nmax], nv and ns '
                         '[B] (got {})'.format(
                             [tuple(t.shape) for t in tensors]))
    if Vmax > MAX_ROW:
        raise ValueError('poa_align_batch_cuda: {} nodes exceed the '
                         "direction word's row field ({} at most)".format(
                             Vmax, MAX_ROW))
    if B * (Vmax + nmax + 1) * 2 >= 2 ** 31 or nmax >= 2 ** 30:
        raise ValueError('poa_align_batch_cuda: {} x {} x {} exceeds the '
                         "kernel's int sizes".format(B, Vmax, nmax))
    if stamps is not None and (not stamps.is_cuda or stamps.dtype !=
                               torch.int64 or tuple(stamps.shape) != (B, 3)):
        raise ValueError('poa_align_batch_cuda: stamps must be int64 [B, 3] '
                         'on the card')
    dev = bases.device
    if plan is None:
        plan = poa_plan(offs.cpu().numpy(), preds.cpu().numpy(),
                        nv.cpu().numpy(), ns.cpu().numpy(), Vmax, nmax, dev)
    if plan.sidx is not None and plan.sidx.device != dev:
        raise ValueError('poa_align_batch_cuda: the plan lies on {}'.format(
            plan.sidx.device))
    lib = _build.load('poa_align.cu', SYMBOLS)
    u8, i32 = torch.uint8, torch.int32
    bases8 = bases.to(u8).contiguous()
    seqs8 = seqs.to(u8).contiguous()
    nv32 = nv.to(i32).contiguous()
    ns32 = ns.to(i32).contiguous()
    offs = offs.contiguous()
    preds = preds.contiguous() if preds.numel() else \
        torch.zeros(1, dtype=i32, device=dev)
    Wp = padded_width(nmax)
    dirs = torch.empty(max(B * (Vmax + 1) * Wp, 1), dtype=i32, device=dev)
    spill = torch.empty(max(B * plan.spill_rows * 3 * Wp, 1), dtype=i32,
                        device=dev)
    score = torch.empty(B, dtype=i32, device=dev)
    acnt = torch.empty(B, dtype=i32, device=dev)
    aln = torch.full((B, Vmax + nmax + 1, 2), -2, dtype=i32, device=dev)
    if B == 0:
        return score, aln, acnt
    with torch.cuda.device(dev):
        rc = lib.poa_align_launch(
            B, Vmax, nmax, bases8.data_ptr(), offs.data_ptr(),
            preds.data_ptr(), seqs8.data_ptr(), nv32.data_ptr(),
            ns32.data_ptr(), plan.cols, plan.warps, plan.emax, plan.depth,
            None if plan.sidx is None else plan.sidx.data_ptr(),
            spill.data_ptr(), plan.spill_rows, dirs.data_ptr(),
            *(int(v) for v in scores), score.data_ptr(), acnt.data_ptr(),
            aln.data_ptr(), None if stamps is None else stamps.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError('poa_align launch failed: cudaError {} (B={}, '
                           'Vmax={}, nmax={}, plan {})'.format(
                               rc, B, Vmax, nmax, plan[:5]))
    count_launch('poa_align')
    return score, aln, acnt


def poa_align_batch(bases, offs, preds, seqs, nv, ns, scores=SCORES):
    """The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    tensors = (bases, offs, preds, seqs, nv, ns)
    if bases.is_cuda:
        return poa_align_batch_cuda(*tensors, scores)
    if all(t.device.type == 'cpu' for t in tensors):
        return poa_align_batch_plain(*tensors, scores)
    raise ValueError('poa_align_batch: unsupported devices {}'.format(
        [str(t.device) for t in tensors]))


def batch_arrays(graphs, seqs):
    """numpy inputs of one batch from flattened graphs ((bases [V], offs
    [V+1] from 0, preds [E]) each, ops/poa.py::_flatten_graph) and their
    sequences (codes): (bases [B, Vmax], offs [B, Vmax+1] absolute, preds,
    seqs [B, nmax] padded with 5, nv, ns)."""
    B = len(graphs)
    Vmax = max([len(g[0]) for g in graphs], default=0)
    nmax = max([len(s) for s in seqs], default=0)
    bases = np.zeros((B, Vmax), np.int32)
    offs = np.zeros((B, Vmax + 1), np.int32)
    seqs_a = np.full((B, nmax), 5, np.int32)
    nv = np.zeros(B, np.int32)
    ns = np.zeros(B, np.int32)
    chunks = []
    base = 0
    for b, ((gb, go, gp), s) in enumerate(zip(graphs, seqs)):
        V = len(gb)
        bases[b, :V] = gb
        offs[b, :V + 1] = np.asarray(go) + base
        offs[b, V + 1:] = base + len(gp)
        seqs_a[b, :len(s)] = s
        nv[b], ns[b] = V, len(s)
        chunks.append(np.asarray(gp, np.int32))
        base += len(gp)
    preds = np.concatenate(chunks) if chunks else np.zeros(0, np.int32)
    return bases, offs, preds.astype(np.int32), seqs_a, nv, ns


def split_inputs(buf, B, Vmax, nmax, E):
    """batch_arrays' arrays from one int32 buffer holding them one after
    another (csrc/poa_graph.h's Rounds::copy_inputs): bases [B, Vmax], offs
    [B, Vmax+1], preds [E], seqs [B, nmax], nv and ns [B]."""
    sizes = (B * Vmax, B * (Vmax + 1), E, B * nmax, B, B)
    cuts = np.cumsum(sizes)[:-1]
    bases, offs, preds, seqs, nv, ns = np.split(np.asarray(buf, np.int32),
                                                cuts)
    return (bases.reshape(B, Vmax), offs.reshape(B, Vmax + 1), preds,
            seqs.reshape(B, nmax), nv, ns)
