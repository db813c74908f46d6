"""Pairs (q, r) of codes at the edges of the center-star polish's banded NW
(ops/nw_tb_batch.py, csrc/nw_traceback.cu).  tests/test_torch_nw_tb.py
holds the plain version and the kernel's schedule to the JAX package on
them, chip_smoke.py phase 4b and tests/test_torch_cuda.py the kernel to the
plain version and the native core.

Each case is a list of (q, r) int8 pairs with both sides non-empty; the
first band of a pair is |n - m| + 16 (FIRST_BAND).
"""

import numpy as np

from ciri_long_tpu_torch.tools.simulate import mutate
from ciri_long_tpu_torch.utils.seq import encode_seq


def _dna(rng, n, high=4):
    return rng.integers(0, high, n).astype(np.int8)


def _mutated(rng, m, **rates):
    """A random reference of m codes and a copy mutated at ``rates``."""
    r = _dna(rng, m)
    q = encode_seq(mutate(rng, ''.join('ACGT'[c] for c in r), **rates))
    return q, r


def drifted(rng, m, shifts):
    """(q, r) of m codes each whose best path steps off the diagonal by
    each of ``shifts`` in turn: q drops that many codes of r at evenly
    spaced places and gains as many random ones at its end.  A band that
    reaches the first k steps scores above one that reaches k - 1, so the
    band ladder doubles until it reaches them all."""
    r = _dna(rng, m)
    cuts = [m * (k + 1) // (len(shifts) + 1) for k in range(len(shifts))]
    keep, at = [], 0
    for cut, shift in zip(cuts, shifts):
        keep.append(r[at:cut])
        at = cut + shift
    keep += [r[at:], _dna(rng, sum(shifts))]
    return np.concatenate(keep), r


def nw_cases(rng):
    """{name: [(q, r)]} in this order: one-base sides; pairs whose first
    band already covers max(n, m); paths down the j == 0 edge (q opens with
    codes r lacks) and along row 0 (r does); E and F ties at H
    (homopolymers of unequal lengths, one gap placed many ways); long gap
    runs, so the stay flags chain; N codes (salted, all N, N against
    everything); pairs that need one and two doublings of the band; the
    widest band and the longest pair in one launch; a launch of mixed
    sizes."""
    cases = {}
    one = np.array([1], np.int8)
    cases['one_base'] = [(one, one), (one, np.array([2], np.int8)),
                         (one, _dna(rng, 20)), (_dna(rng, 20), one),
                         (np.array([4], np.int8), _dna(rng, 5))]
    cases['band_covers_first'] = [(_dna(rng, a), _dna(rng, b)) for a, b in
                                  ((5, 12), (16, 3), (9, 9), (17, 2))]
    r = _dna(rng, 120)
    cases['j0_edge'] = [(np.concatenate([_dna(rng, 10), r]), r),
                        (np.concatenate([_dna(rng, 3), r[:40]]), r[:40]),
                        (r, np.concatenate([_dna(rng, 10), r]))]
    runs = [np.full(k, c, np.int8) for k, c in ((7, 0), (4, 2), (9, 1))]
    cases['e_f_ties'] = [
        (np.concatenate(runs), np.concatenate([runs[0][:4], runs[1],
                                               runs[2][:5]])),
        (np.concatenate([runs[0][:3], runs[1], runs[2]]),
         np.concatenate(runs)),
        (np.array([0, 1] * 20, np.int8), np.array([0, 1] * 17, np.int8)),
        (np.array([0, 1] * 17, np.int8), np.array([0, 1] * 20, np.int8))]
    r = _dna(rng, 300)
    cases['long_gaps'] = [
        (np.concatenate([r[:100], r[130:]]), r),
        (r, np.concatenate([r[:150], r[190:]])),
        (np.concatenate([r[:60], _dna(rng, 25), r[60:]]), r)]
    q, r = _mutated(rng, 200, sub=0.05, ins=0.03, dele=0.03)
    q = q.copy()
    q[rng.integers(0, len(q), 12)] = 4
    cases['n_codes'] = [(q, r), (np.full(30, 4, np.int8), _dna(rng, 40)),
                        (_dna(rng, 50, 5), _dna(rng, 45, 5))]
    cases['one_doubling'] = [drifted(rng, 200, (24,)),
                             drifted(rng, 150, (20,))]
    cases['two_doublings'] = [drifted(rng, 300, (24, 24)),
                              drifted(rng, 260, (22, 26))]
    q, r = _mutated(rng, 3000, sub=0.02, ins=0.01, dele=0.01)
    cases['widest_longest'] = [(q, r), drifted(rng, 800, (24, 24, 48, 96)),
                               (_dna(rng, 60), _dna(rng, 400))]
    mixed = []
    for m in rng.integers(1, 700, 40):
        mixed.append(_mutated(rng, int(m), sub=0.03, ins=0.02, dele=0.02))
    cases['mixed'] = [(q, r) for q, r in mixed if len(q)]
    return cases
