"""The ``poa_align`` check of ``collapse``: sub-cluster consensus sequences.

``collapse`` builds each sub-cluster's consensus with
``poa_consensus_many`` (on the card, csrc/poa_align.cu's round loop).  The
check records every job (the reads of a sub-cluster) and its consensus in
the window, and afterwards recomputes a sample of them with a frozen copy
of the port's host-graph POA in NumPy (``ops/poa.py``: ``_Graph``,
``_align_to_graph``'s Python path, ``_fuse``, ``_consensus``,
``_poa_python``; spoa's two-piece affine gaps with the reference's scores
10, -4, -8, -2, -24, -1, overlap alignment, heaviest-bundle consensus).
The sample is stratified: the jobs fall into the kernel's column classes
by their longest read (csrc/poa_align.cu's ``launch_shape``: rows of up to
512, 1 024, 2 048 columns or more), and from each class present the check
takes its largest job (by bases) and ``PER_CLASS`` more drawn from the
seed.  The number compared is the share of sampled jobs whose consensus is
not the reference's, byte for byte.

The control breaks the guarantee that every read of a sub-cluster enters
its consensus: the reference built from the first ``CONTROL_READS`` reads
of a job (the cap the TPU build had, P <= 8), put in the program's place.
"""

import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from checks._patch import Patches

NAME = 'poa_jobs_differ'
LIMIT = 0.0          # an exact comparison
PER_CLASS = 1        # jobs drawn from the seed a class, beside its largest
CLASS_COLUMNS = (512, 1024, 2048)
CONTROL_READS = 8
SCORES = (10, -4, -8, -2, -24, -1)
NEG = -(1 << 28)
_ENCODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate('ACGT'):
    _ENCODE[ord(_b)] = _i
    _ENCODE[ord(_b.lower())] = _i
_DECODE = np.frombuffer(b'ACGTN?', dtype=np.uint8)


def _codes(seq):
    if isinstance(seq, str):
        return _ENCODE[np.frombuffer(seq.encode('ascii'), np.uint8)]
    return np.asarray(seq, np.int8)


def _text(codes):
    return _DECODE[np.clip(np.asarray(codes), 0, 5)].tobytes().decode(
        'ascii')


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


def _align_to_graph(g: _Graph, seq: np.ndarray, m, x, o1, e1, o2, e2):
    """Align seq (codes) to graph; returns the alignment as a list of
    (node_or_None, seqpos_or_None) pairs in order."""
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


def reference(job, reads=None):
    """The consensus of ``job`` (a list of strings or code arrays) as a
    string, from its first ``reads`` reads (all by default)."""
    codes = [_codes(s) for s in job[:reads]]
    return _text(_poa_python(codes, *SCORES))


def _as_text(result):
    return result if isinstance(result, str) else _text(result)


def column_class(job):
    """The kernel's column class of a job alone: 0-3 for rows of up to 512,
    1 024, 2 048 or more columns (the longest read + 1)."""
    width = max(len(r) for r in job) + 1
    return sum(width > c for c in CLASS_COLUMNS)


def pick(jobs, rng, per_class=PER_CLASS):
    """Indices of the jobs to recompute: in each column class, its largest
    job by bases and ``per_class`` more drawn by ``rng``."""
    classes = {}
    for i, job in enumerate(jobs):
        classes.setdefault(column_class(job), []).append(i)
    picked = []
    for cls in sorted(classes):
        members = classes[cls]
        largest = max(members, key=lambda i: sum(len(r) for r in jobs[i]))
        rest = [i for i in members if i != largest]
        drawn = rng.choice(len(rest), min(per_class, len(rest)),
                           replace=False).tolist() if rest else []
        picked += [largest] + [rest[k] for k in drawn]
    return sorted(picked)


class Check:
    """Records ``poa_consensus_many``'s jobs and results in the window."""

    def __init__(self, seed, world=None):
        self.rng = np.random.default_rng([int(seed), 23])
        self.jobs = []
        self.picked = None
        self.want = None
        self.patches = Patches()

    def install(self):
        def record(orig, jobs, *args, **kwargs):
            out = orig(jobs, *args, **kwargs)
            self.jobs.extend(zip(jobs, out))
            return out
        self.patches.wrap('ciri_long_tpu_torch.ops.poa',
                          'poa_consensus_many', record)

    def uninstall(self):
        self.patches.undo()

    def _references(self, jobs, reads=None):
        """``reference`` of each job, on a spawn pool of the host's cores
        (the reference is pure Python over NumPy rows), the largest jobs
        first."""
        workers = max(1, min(len(jobs), os.cpu_count() or 1))
        order = sorted(range(len(jobs)),
                       key=lambda i: -sum(len(r) for r in jobs[i]))
        ctx = multiprocessing.get_context('spawn')
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            done = list(pool.map(reference, [jobs[i] for i in order],
                                 [reads] * len(jobs)))
        out = [None] * len(jobs)
        for i, res in zip(order, done):
            out[i] = res
        return out

    def judge(self, rec=None, control=False):
        """{NAME: (value, LIMIT)} over the sampled jobs; with ``control``
        the control's consensus stands in for the program's."""
        if not self.jobs:
            return {NAME: (1.0, LIMIT)}
        if self.picked is None:
            t0 = time.perf_counter()
            self.picked = pick([j for j, _ in self.jobs], self.rng)
            self.want = self._references(
                [self.jobs[i][0] for i in self.picked])
            print('poa check: {} jobs; picked (class, reads, longest, bases) '
                  '{}; reference {:.1f} s'.format(
                      len(self.jobs),
                      [(column_class(self.jobs[i][0]), len(self.jobs[i][0]),
                        max(map(len, self.jobs[i][0])),
                        sum(map(len, self.jobs[i][0])))
                       for i in self.picked],
                      time.perf_counter() - t0), file=sys.stderr)
        if control:
            got = self._references([self.jobs[i][0] for i in self.picked],
                                   CONTROL_READS)
        else:
            got = [_as_text(self.jobs[i][1]) for i in self.picked]
        differ = sum(g != w for g, w in zip(got, self.want))
        return {NAME: (differ / len(self.picked), LIMIT)}
