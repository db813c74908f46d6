"""Greedy chain extraction: the host half of ``ciri_long_tpu/ops/chain.py``.

The chaining DP itself (``_chain_dp``) runs on the host here, in
models/aligner.py (native/chaincore.cpp or its numpy twin); its device form
(``chain_extract_batch``, ROADMAP X2) is not ported yet.  What remains are
the host-side extraction routines with their JAX-package names and
semantics: the greedy walk in descending-score order, and the decode of the
packed device output that X2 will produce.
"""

import numpy as np

from ciri_long_tpu_torch.utils.dispatch import count_dispatch as _count_dispatch


def _greedy_chains(order, scores, delta_b, used, min_score, min_anchors,
                   max_chains):
    """One row's greedy walk over candidates in descending-f order."""
    chains = []
    for oi in range(len(order)):
        idx = int(order[oi])
        if used[idx] or scores[oi] < min_score:
            continue
        path = []
        v = idx
        while v != -1 and not used[v]:
            path.append(v)
            used[v] = True
            d = int(delta_b[v])
            v = v - d if d > 0 else -1
        if len(path) < min_anchors:
            continue
        path.reverse()
        chains.append((np.array(path, np.int64), float(scores[oi])))
        if len(chains) >= max_chains:
            break
    return chains


def decode_chains(packed, scores, nch):
    """Decode packed chain ids (two 4-bit (chain id + 1) values per byte,
    the output layout of chain_extract_batch) into the backtrack_chains
    return shape: per row a list of (ascending anchor-index array, float
    score)."""
    packed = np.asarray(packed)
    scores = np.asarray(scores)
    nch = np.asarray(nch)
    B, A2 = packed.shape
    cid = np.empty((B, 2 * A2), np.int16)
    cid[:, 0::2] = (packed & 0xF).astype(np.int16)
    cid[:, 1::2] = (packed >> 4).astype(np.int16)
    cid -= 1
    out = []
    for b in range(B):
        chains = []
        for c in range(int(nch[b])):
            idx = np.nonzero(cid[b] == c)[0]
            chains.append((idx.astype(np.int64), float(scores[b, c])))
        out.append(chains)
    return out


@_count_dispatch('chain.backtrack')
def backtrack_chains(f, pre, valid, min_score, min_anchors, max_chains=10):
    """Greedy per-read chain extraction from (f, pre), identical to
    models/aligner.py::_chain's backtrack.  Native C++ core when built
    (native/chaincore.cpp::backtrack); numpy otherwise."""
    f = np.asarray(f)
    pre = np.asarray(pre)
    valid = np.asarray(valid)
    try:
        from ciri_long_tpu import _chaincore
        native = getattr(_chaincore, 'backtrack', None)
    except ImportError:
        native = None
    if native is not None:
        out = []
        for b in range(f.shape[0]):
            rows = native(
                np.ascontiguousarray(f[b], np.float64),
                np.ascontiguousarray(pre[b], np.int64),
                np.ascontiguousarray(valid[b], np.uint8),
                float(min_score), int(min_anchors), int(max_chains))
            out.append([(np.frombuffer(p, np.int64).copy(), s)
                        for p, s in rows])
        return out
    out = []
    for b in range(f.shape[0]):
        order = np.argsort(-f[b], kind='stable')
        used = np.zeros(f.shape[1], bool)
        chains = []
        for idx in order:
            if not valid[b, idx] or used[idx] or f[b, idx] < min_score:
                continue
            path = []
            v = idx
            while v != -1 and not used[v]:
                path.append(v)
                used[v] = True
                v = pre[b, v]
            if len(path) < min_anchors:
                continue
            path.reverse()
            chains.append((np.array(path, np.int64), float(f[b, idx])))
            if len(chains) >= max_chains:
                break
        out.append(chains)
    return out
