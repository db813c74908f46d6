"""Partial-order alignment (POA) consensus.

Replaces pyspoa (C++ SIMD, reference calls at collapse.py:267,504 and the
pyccs consensus contract exercised by tests/test_poa.py:19-32) with a
self-contained implementation: a DAG of base nodes, sequence-to-graph
alignment with spoa's two-piece ("convex") affine gap model, and a
heaviest-bundle consensus walk.

Scoring matches the reference's invocation
``poa(seqs, 2, False, 10, -4, -8, -2, -24, -1)``: match 10, mismatch -4,
gap piece 1 (open -8, extend -2), gap piece 2 (open -24, extend -1); a gap
of length L scores max over the two pieces -- cheap opening for short gaps,
cheap extension for long ones.

Alignment mode follows spoa's kOV (overlap) semantics as used here: the
sequence is fully consumed, graph overhangs on both sides are free.

The per-sequence DP runs one numpy-vectorized row per graph node in
topological order, with the within-row gap dependency resolved by the
prefix-max identity (exact while |open| >= |extend|, which holds for both
pieces).  ``poa`` is the host half of ciri_long_tpu/ops/poa.py: the native
core (native/poacore.cpp) when built, this Python graph otherwise.

``poa_consensus_many`` runs a batch of independent ``poa`` calls: on a CUDA
device in rounds, every job's next alignment in one launch of
csrc/poa_align.cu, the graphs kept and fused in host C++
(csrc/poa_graph.h) by the same source's round loop, called through
ctypes (the interpreter lock released for the whole call); on the CPU as
``poa`` calls.  ``poa_consensus_many_plain`` is the same round structure in
Python on ops/poa_batch.py::poa_align_batch_plain (the JAX package's device
branch, ciri_long_tpu/ops/poa.py:393-485, with CSR predecessor lists in
place of its P <= 8 slots, so no alignment falls back to the native core).
The results are byte-identical on every route.
"""

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ciri_long_tpu_torch.utils.seq import decode_seq, encode_seq

NEG = -(1 << 28)


class _Graph:
    __slots__ = ("base", "ring", "in_edges", "out_edges", "support")

    def __init__(self):
        self.base: List[int] = []
        # ring[v]: list of node ids occupying the same alignment column
        self.ring: List[List[int]] = []
        self.in_edges: List[dict] = []    # v -> {pred: weight}
        self.out_edges: List[dict] = []
        self.support: List[int] = []      # sequences passing through node

    def new_node(self, b: int) -> int:
        v = len(self.base)
        self.base.append(int(b))
        self.ring.append([v])
        self.in_edges.append({})
        self.out_edges.append({})
        self.support.append(0)
        return v

    def add_edge(self, p: int, v: int):
        self.in_edges[v][p] = self.in_edges[v].get(p, 0) + 1
        self.out_edges[p][v] = self.out_edges[p].get(v, 0) + 1

    def topo_order(self) -> List[int]:
        n = len(self.base)
        indeg = np.zeros(n, np.int32)
        for v in range(n):
            indeg[v] = len(self.in_edges[v])
        order = []
        stack = sorted([v for v in range(n) if indeg[v] == 0])
        indeg_l = indeg.tolist()
        while stack:
            v = stack.pop()
            order.append(v)
            for w in self.out_edges[v]:
                indeg_l[w] -= 1
                if indeg_l[w] == 0:
                    stack.append(w)
        return order


def _gap_row(n, o1, e1, o2, e2):
    """max of the two affine pieces for gap lengths 0..n (index = length)."""
    L = np.arange(n + 1, dtype=np.int64)
    g = np.maximum(o1 + (L - 1) * e1, o2 + (L - 1) * e2)
    g[0] = 0
    return g


def _align_to_graph_native(g: _Graph, seq: np.ndarray, m, x, o1, e1, o2, e2):
    """C++ twin of _align_to_graph (native/poacore.cpp): same DP, same
    traceback tie order, rank indices mapped back to node ids here."""
    from ciri_long_tpu_torch import _poacore

    order = g.topo_order()
    rank = {v: i for i, v in enumerate(order)}
    bases = bytes(bytearray(g.base[v] for v in order))
    offs = np.zeros(len(order) + 1, np.int32)
    preds: List[int] = []
    for i, v in enumerate(order):
        for p in g.in_edges[v]:
            preds.append(rank[p] + 1)
        offs[i + 1] = len(preds)
    score, buf = _poacore.align_graph(
        bases, offs.tobytes(), np.asarray(preds, np.int32).tobytes(),
        np.ascontiguousarray(seq, np.uint8).tobytes(),
        m, x, o1, e1, o2, e2)
    pairs = np.frombuffer(buf, np.int32).reshape(-1, 2)
    aln = [(order[r] if r >= 0 else None, int(j) if j >= 0 else None)
           for r, j in pairs]
    return int(score), aln


def _align_to_graph(g: _Graph, seq: np.ndarray, m, x, o1, e1, o2, e2):
    """Align seq (codes) to graph; returns the alignment as a list of
    (node_or_None, seqpos_or_None) pairs in order."""
    try:
        return _align_to_graph_native(g, seq, m, x, o1, e1, o2, e2)
    except ImportError:
        pass
    order = g.topo_order()
    rank = {v: i for i, v in enumerate(order)}
    V = len(order)
    n = len(seq)

    # DP matrices over [V+1, n+1]; row 0 = virtual source.
    H = np.full((V + 1, n + 1), NEG, np.int64)
    M = np.full((V + 1, n + 1), NEG, np.int64)
    F1 = np.full((V + 1, n + 1), NEG, np.int64)
    F2 = np.full((V + 1, n + 1), NEG, np.int64)
    E1s = np.full((V + 1, n + 1), NEG, np.int64)
    E2s = np.full((V + 1, n + 1), NEG, np.int64)

    H[0] = _gap_row(n, o1, e1, o2, e2)      # consume seq prefix before graph
    jj = np.arange(n + 1, dtype=np.int64)

    seq_arr = np.asarray(seq, np.int64)
    for v in order:
        i = rank[v] + 1
        preds = list(g.in_edges[v].keys())
        pred_rows = [rank[p] + 1 for p in preds] if preds else [0]
        # also allow starting fresh from the virtual source (free graph
        # overhang): source row 0 is an implicit predecessor of every node
        if 0 not in pred_rows:
            pred_rows_all = pred_rows + [0]
        else:
            pred_rows_all = pred_rows

        Hp = H[pred_rows_all]               # [P, n+1]
        F1p = np.maximum(F1[pred_rows, :].max(axis=0) + e1,
                         H[pred_rows, :].max(axis=0) + o1)
        F2p = np.maximum(F2[pred_rows, :].max(axis=0) + e2,
                         H[pred_rows, :].max(axis=0) + o2)

        s = np.where(seq_arr == g.base[v], m, x)
        Mrow = np.full(n + 1, NEG, np.int64)
        Mrow[1:] = Hp[:, :-1].max(axis=0) + s

        Hpre = np.maximum(Mrow, np.maximum(F1p, F2p))
        # free leading graph overhang: starting at this node with nothing
        # consumed
        Hpre[0] = max(Hpre[0], 0)

        # E within row via prefix-max (restricted donors exact for |o|>=|e|)
        p1 = np.maximum.accumulate(Hpre - jj * e1)
        E1r = np.full(n + 1, NEG, np.int64)
        E1r[1:] = p1[:-1] + o1 + (jj[1:] - 1) * e1
        p2 = np.maximum.accumulate(Hpre - jj * e2)
        E2r = np.full(n + 1, NEG, np.int64)
        E2r[1:] = p2[:-1] + o2 + (jj[1:] - 1) * e2

        Hrow = np.maximum(Hpre, np.maximum(E1r, E2r))
        H[i] = Hrow
        M[i] = Mrow
        F1[i] = F1p
        F2[i] = F2p
        E1s[i] = E1r
        E2s[i] = E2r

    # Free trailing graph overhang: end at any node with the whole sequence
    # consumed.
    end_rank = int(np.argmax(H[:, n]))
    score = int(H[end_rank, n])

    # Traceback.
    aln: List[Tuple[Optional[int], Optional[int]]] = []
    i, j = end_rank, n
    while j > 0 or (i > 0 and False):
        if i == 0:
            aln.append((None, j - 1))
            j -= 1
            continue
        v = order[i - 1]
        preds = list(g.in_edges[v].keys())
        pred_rows = [rank[p] + 1 for p in preds] if preds else [0]
        pred_rows_all = pred_rows if 0 in pred_rows else pred_rows + [0]
        h = H[i, j]
        if h == E1s[i, j] or h == E2s[i, j]:
            # gap consuming seq chars at this node position: walk left
            aln.append((None, j - 1))
            j -= 1
            continue
        if h == M[i, j]:
            s = m if seq_arr[j - 1] == g.base[v] else x
            took = False
            for pr in pred_rows_all:
                if H[pr, j - 1] + s == h:
                    aln.append((v, j - 1))
                    i, j = pr, j - 1
                    took = True
                    break
            if took:
                continue
        if h == F1[i, j] or h == F2[i, j]:
            took = False
            for pr in pred_rows:
                if max(F1[pr, j] + e1, H[pr, j] + o1) == h or \
                        max(F2[pr, j] + e2, H[pr, j] + o2) == h:
                    aln.append((v, None))
                    i = pr
                    took = True
                    break
            if took:
                continue
        if h == 0 and j == 0:
            break
        # started fresh at this node (free leading overhang) with j == 0
        if j == 0:
            break
        # numerical dead end: treat as fresh start
        break
    while j > 0:
        aln.append((None, j - 1))
        j -= 1
    aln.reverse()
    return score, aln


def _fuse(g: _Graph, seq: np.ndarray, aln) -> None:
    """Integrate an alignment into the graph (spoa-style node merging)."""
    prev = None
    for node, jpos in aln:
        if jpos is None:
            continue  # graph node skipped; no seq char consumed
        b = int(seq[jpos])
        if node is not None and g.base[node] == b:
            cur = node
        elif node is not None:
            # look for a ring partner with this base
            cur = None
            for r in g.ring[node]:
                if g.base[r] == b:
                    cur = r
                    break
            if cur is None:
                cur = g.new_node(b)
                ring = g.ring[node]
                ring.append(cur)
                g.ring[cur] = ring
        else:
            cur = g.new_node(b)
        g.support[cur] += 1
        if prev is not None:
            g.add_edge(prev, cur)
        prev = cur


def _consensus(g: _Graph) -> np.ndarray:
    """Heaviest-bundle walk (spoa's GenerateConsensus idea) with a
    length-bias correction: each edge contributes (2w - 1) so a
    single-support detour (two weight-1 edges, 1+1) can never tie the
    direct backbone edge (weight >= 2) it bypasses -- without the -1
    discount, 3-deep coverage ties its own error branches and the
    consensus drifts long."""
    order = g.topo_order()
    best = {v: (0, 0) for v in order}   # v -> (discounted_weight, support_sum)
    back = {v: None for v in order}
    for v in order:
        for p, w in g.in_edges[v].items():
            cand = (best[p][0] + 2 * w - 1, best[p][1] + g.support[p])
            if cand > best[v]:
                best[v] = cand
                back[v] = p
    if not order:
        return np.zeros(0, np.int8)
    # choose end node maximising total path weight then support
    end = max(order, key=lambda v: (best[v][0], g.support[v]))
    path = []
    v = end
    while v is not None:
        path.append(v)
        v = back[v]
    path.reverse()
    return np.array([g.base[v] for v in path], np.int8)


def _flatten_graph(g: _Graph):
    """Rank-space CSR of ``g`` for ops/poa_batch.py: (order, bases int32
    [V], offs int32 [V+1] from 0, preds int32 [E]), each node's
    predecessors as rank + 1 in insertion order, [0] (the virtual source)
    for a node without any (ciri_long_tpu/ops/poa.py::_flatten_graph with
    lists in place of its P slots)."""
    order = g.topo_order()
    rank = {v: i for i, v in enumerate(order)}
    bases = np.array([g.base[v] for v in order], np.int32)
    offs = np.zeros(len(order) + 1, np.int32)
    preds: List[int] = []
    for i, v in enumerate(order):
        preds.extend([rank[p] + 1 for p in g.in_edges[v]] or [0])
        offs[i + 1] = len(preds)
    return order, bases, offs, np.asarray(preds, np.int32)


def _queues(jobs):
    """Each job's sequences as int8 codes, and whether it came as strings."""
    as_str = [bool(seqs) and isinstance(seqs[0], str) for seqs in jobs]
    codes = [[encode_seq(s) if isinstance(s, str) else np.asarray(s, np.int8)
              for s in seqs] for seqs in jobs]
    return codes, as_str


def _result(job, as_str, cons):
    """A job's consensus in its input's form; ``cons`` None when the job
    had no non-empty sequence (poa()'s empty result)."""
    if cons is None:
        return "" if (not job or as_str) else np.zeros(0, np.int8)
    return decode_seq(cons) if as_str else cons


def poa_consensus_many_plain(jobs: Sequence[Sequence], m: int = 10,
                             x: int = -4, o1: int = -8, e1: int = -2,
                             o2: int = -24, e2: int = -1):
    """The rounds of ``poa_consensus_many`` in Python, each round's
    alignments one call of the plain ops/poa_batch.py::
    poa_align_batch_plain on CPU tensors: the JAX package's device branch
    (ciri_long_tpu/ops/poa.py:393-485), byte-identical to ``poa`` per
    job."""
    import torch

    from ciri_long_tpu_torch.ops.poa_batch import (batch_arrays,
                                                   poa_align_batch_plain)

    codes, as_str = _queues(jobs)
    queues = [[c for c in q if len(c) > 0] for q in codes]
    graphs: List[Optional[_Graph]] = [None] * len(jobs)
    cursor = [0] * len(jobs)
    for t, q in enumerate(queues):
        if not q:
            continue
        g = _Graph()
        prev = None
        for b in q[0]:
            cur = g.new_node(int(b))
            g.support[cur] += 1
            if prev is not None:
                g.add_edge(prev, cur)
            prev = cur
        graphs[t] = g
        cursor[t] = 1

    while True:
        pending = [t for t in range(len(jobs))
                   if graphs[t] is not None and cursor[t] < len(queues[t])]
        if not pending:
            break
        flats = [_flatten_graph(graphs[t]) for t in pending]
        seqs = [queues[t][cursor[t]] for t in pending]
        arrays = batch_arrays([f[1:] for f in flats], seqs)
        _, aln, acnt = poa_align_batch_plain(
            *(torch.from_numpy(a) for a in arrays), (m, x, o1, e1, o2, e2))
        aln, acnt = aln.numpy(), acnt.numpy()
        cap = aln.shape[1]
        for b, t in enumerate(pending):
            order = flats[b][0]
            pairs = aln[b, cap - int(acnt[b]):]
            _fuse(graphs[t], seqs[b],
                  [(order[r] if r >= 0 else None, int(p) if p >= 0 else None)
                   for r, p in pairs])
            cursor[t] += 1

    return [_result(job, a, None if g is None else _consensus(g))
            for job, a, g in zip(jobs, as_str, graphs)]


_STREAMS = threading.local()
# the fields of csrc/poa_align.cu::poa_consensus_run's stats, after
# 'launches' those of its largest launch (by cells)
STATS_FIELDS = ('launches', 'largest_round', 'largest_jobs', 'largest_vmax',
                'largest_nmax', 'largest_preds', 'largest_cells')


def _thread_stream(device):
    """This thread's own stream on ``device``: one cluster's rounds never
    wait on another's."""
    import torch

    streams = getattr(_STREAMS, 'by_device', None)
    if streams is None:
        streams = _STREAMS.by_device = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def _poa_consensus_cuda(jobs, scores, device, stats=None, keep=None):
    """``poa_consensus_many`` on the card: one call of csrc/poa_align.cu's
    round loop for all the jobs.  ``stats`` (a dict) gets the loop's counts
    (STATS_FIELDS, 'device_ms', 'largest_ms'); ``keep`` is an earlier such
    dict of the same jobs, whose largest launch's inputs are kept and
    returned beside the consensus list."""
    import torch

    from ciri_long_tpu_torch.ops import _build
    from ciri_long_tpu_torch.ops.poa_batch import (MAX_INDEGREE, SYMBOLS,
                                                   split_inputs)
    from ciri_long_tpu_torch.utils.dispatch import count_launch

    codes, as_str = _queues(jobs)
    lens = np.array([len(c) for q in codes for c in q], np.int32)
    counts = np.array([len(q) for q in codes], np.int32)
    flat = [np.ascontiguousarray(c, np.uint8) for q in codes for c in q]
    concat = np.concatenate(flat) if lens.sum() else np.zeros(1, np.uint8)
    cons = np.zeros(max(1, int(lens.sum())), np.uint8)
    cons_len = np.zeros(max(1, len(jobs)), np.int32)
    counted = np.zeros(len(STATS_FIELDS), np.int64)
    device_ms = np.zeros(2, np.float64)
    kept, shape = None, None
    if keep is not None:
        shape = [keep['largest_' + k]
                 for k in ('jobs', 'vmax', 'nmax', 'preds')]
        B, V, n, E = shape
        kept = np.zeros(B * V + B * (V + 1) + E + B * n + 2 * B + 1,
                        np.int32)
    lib = _build.load('poa_align.cu', SYMBOLS)
    with torch.cuda.device(device):
        stream = _thread_stream(device)
        rc = lib.poa_consensus_run(
            concat.ctypes.data, lens.ctypes.data if len(lens) else None,
            counts.ctypes.data if len(counts) else None, len(jobs),
            *scores, stream.cuda_stream, cons.ctypes.data,
            cons_len.ctypes.data, counted.ctypes.data, device_ms.ctypes.data,
            -1 if keep is None else keep['largest_round'],
            None if kept is None else kept.ctypes.data)
    if counted[0]:
        count_launch('poa_align', times=int(counted[0]),
                     device_ms=float(device_ms[0]))
    if rc == -1:
        raise ValueError('poa_consensus_many: a graph node has more than {} '
                         'predecessors, which csrc/poa_align.cu cannot '
                         'store'.format(MAX_INDEGREE))
    if rc != 0:
        raise RuntimeError('poa_align round loop failed: cudaError {} ({} '
                           'jobs)'.format(rc, len(jobs)))
    if stats is not None:
        stats.update(zip(STATS_FIELDS, counted.tolist()),
                     device_ms=float(device_ms[0]),
                     largest_ms=float(device_ms[1]))
    out, off = [], 0
    for t, job in enumerate(jobs):
        k = int(cons_len[t])
        out.append(_result(job, as_str[t], cons[off:off + k].astype(np.int8)
                           if k else None))
        off += int(sum(len(c) for c in codes[t]))
    if keep is None:
        return out
    if counted[1:].tolist() != [keep[k] for k in STATS_FIELDS[1:]]:
        raise RuntimeError('poa_launch_inputs: the replayed rounds differ '
                           'from the stats given')
    return out, split_inputs(kept[:-1], *shape)


def poa_launch_inputs(jobs, stats, device='cuda', m=10, x=-4, o1=-8, e1=-2,
                      o2=-24, e2=-1):
    """For measurement: the inputs (ops/poa_batch.py::batch_arrays' layout)
    of the largest launch of an earlier ``poa_consensus_many(jobs,
    device=device, stats=stats)``, the rounds replayed on the card (they
    are deterministic), and the replay's consensus list."""
    from ciri_long_tpu_torch.utils.dispatch import resolve_device

    return _poa_consensus_cuda(jobs, (m, x, o1, e1, o2, e2),
                               resolve_device(device), keep=stats)


def poa_consensus_many(jobs: Sequence[Sequence], m: int = 10, x: int = -4,
                       o1: int = -8, e1: int = -2, o2: int = -24,
                       e2: int = -1, device='cuda', stats=None):
    """A batch of independent ``poa(seqs)`` calls, byte-identical results,
    on ``device`` (resolved by ``resolve_device``, which raises for 'cuda'
    without a GPU): on the card, csrc/poa_align.cu's round loop, one
    launch a round for every job with a sequence left (the graphs fused and
    the consensus taken in host C++), its counts put in ``stats`` when it
    is a dict; on the CPU, ``poa`` (the native ``poa_all``) for each job,
    as the JAX package's ``use_device=False``.  A build or launch failure
    raises: there is no host retry."""
    from ciri_long_tpu_torch.utils.dispatch import resolve_device

    device = resolve_device(device)
    if device.type == 'cuda':
        return _poa_consensus_cuda(jobs, (m, x, o1, e1, o2, e2), device,
                                   stats)
    return [poa(seqs, 2, False, m, x, o1, e1, o2, e2)[0] for seqs in jobs]


def poa(seqs: Sequence, algorithm: int = 2, genmsa: bool = False,
        m: int = 10, x: int = -4, o1: int = -8, e1: int = -2,
        o2: int = -24, e2: int = -1):
    """pyspoa-compatible entry point: returns (consensus, msa_or_None).

    ``seqs`` may be ASCII strings or int8 code arrays; the consensus is
    returned in the same representation as the inputs.
    """
    if len(seqs) == 0:
        return ("", None) if not seqs or isinstance(seqs, list) else (np.zeros(0, np.int8), None)
    as_str = isinstance(seqs[0], str)
    codes = [encode_seq(s) if isinstance(s, str) else np.asarray(s, np.int8)
             for s in seqs]

    try:
        from ciri_long_tpu_torch import _poacore
        poa_all = _poacore.poa_all
    except ImportError:
        poa_all = None
    if poa_all is not None:
        # full-native pipeline (graph build + fuse + consensus), a twin of
        # the Python graph path; parity fuzz: tests/test_poa_native.py
        lens = np.array([len(c) for c in codes], np.int32)
        concat = (np.concatenate([np.ascontiguousarray(c, np.uint8)
                                  for c in codes if len(c)])
                  if lens.sum() else np.zeros(0, np.uint8))
        buf = poa_all(concat.tobytes(), lens.tobytes(),
                      m, x, o1, e1, o2, e2)
        cons = np.frombuffer(buf, np.uint8).astype(np.int8)
    else:
        cons = _poa_python(codes, m, x, o1, e1, o2, e2)
    out = decode_seq(cons) if as_str else cons
    return out, None


def _poa_python(codes, m, x, o1, e1, o2, e2):
    """The host-graph poa() path (kept as the parity oracle for poa_all and
    as the fallback when the extension is unavailable)."""
    g = _Graph()
    for seq in codes:
        if len(seq) == 0:
            continue
        if not g.base:
            prev = None
            for b in seq:
                cur = g.new_node(int(b))
                g.support[cur] += 1
                if prev is not None:
                    g.add_edge(prev, cur)
                prev = cur
            continue
        _, aln = _align_to_graph(g, seq, m, x, o1, e1, o2, e2)
        _fuse(g, seq, aln)
    return _consensus(g)
