"""Seeded inputs for collapse's graph-alignment kernel, csrc/poa_align.cu,
with its edge cases.

``poa_cases`` gives (label, arrays) batches, ``arrays`` as
ops/poa_batch.py::batch_arrays makes them (bases, offs, preds, seqs, nv,
ns): graphs grown by fusing mutated copies of a template (the graphs
collapse's rounds align to), a one-node graph against sequences of 0, 1 and
5 codes, an empty sequence against a graph, identical copies, indel-heavy
reads, in-degree 12 (above the JAX program's 8 slots) and 130 (above an
int8 slot) on a star graph, long back edges from a repeated template, a
round of mixed sizes, an insertion of 150 codes (gaps in the sequence
across several warps' columns) and, with ``wide``, sequences at the edges of the
kernel's run widths (columns 256, 512, 1024 and 2048 a block) and past one
tile.  The CPU tests, the card's tests and chip_smoke.py share them.
"""

import numpy as np

from ciri_long_tpu_torch.ops.poa import (_align_to_graph, _flatten_graph,
                                         _fuse, _Graph)
from ciri_long_tpu_torch.ops.poa_batch import SCORES, batch_arrays
from ciri_long_tpu_torch.tools.simulate import mutate
from ciri_long_tpu_torch.utils.seq import encode_seq

# sequence lengths at the edges of csrc/poa_align.cu's launch shapes: one
# column a thread up to 256 columns, then 2, 4 and 8, then tiles of 2048
WIDE_LENGTHS = (255, 256, 511, 512, 1023, 1024, 2047, 2048, 2600)


def _template(rng, n):
    return "".join(rng.choice(list("ACGT"), size=int(n)))


def backbone(codes):
    """A graph of one sequence."""
    g = _Graph()
    prev = None
    for b in codes:
        cur = g.new_node(int(b))
        g.support[cur] += 1
        if prev is not None:
            g.add_edge(prev, cur)
        prev = cur
    return g


def fused_graph(reads):
    """The graph of ``reads`` (strings), fused in order as poa() does."""
    g = backbone(encode_seq(reads[0]))
    for r in reads[1:]:
        codes = encode_seq(r)
        _, aln = _align_to_graph(g, codes, *SCORES)
        _fuse(g, codes, aln)
    return g


def star_graph(rng, k, tail):
    """k one-node sources, all into one node, then a chain of ``tail``:
    that node's in-degree is k."""
    g = _Graph()
    centre_base = int(rng.integers(0, 4))
    heads = [g.new_node(int(rng.integers(0, 4))) for _ in range(k)]
    centre = g.new_node(centre_base)
    for h in heads:
        g.add_edge(h, centre)
    prev = centre
    for _ in range(tail):
        cur = g.new_node(int(rng.integers(0, 4)))
        g.add_edge(prev, cur)
        prev = cur
    return g


def batch(graphs, seqs):
    """batch_arrays of _Graphs and code sequences."""
    return batch_arrays([_flatten_graph(g)[1:] for g in graphs],
                        [np.asarray(s, np.int8) for s in seqs])


def _fused(rng, n, k, sub=0.05, ins=0.03, dele=0.03):
    """A graph of k mutated copies of a template of n bases, and one more
    copy to align to it."""
    t = _template(rng, n)
    reads = [mutate(rng, t, sub, ins, dele) for _ in range(k + 1)]
    return fused_graph(reads[:k]), encode_seq(reads[k])


def poa_cases(rng, wide=False):
    """(label, batch arrays) of the cases above."""
    cases = []
    graphs, seqs = zip(*[_fused(rng, int(rng.integers(20, 220)),
                                int(rng.integers(2, 7))) for _ in range(6)])
    cases.append(('fused graphs', batch(graphs, seqs)))
    one = backbone([int(rng.integers(0, 4))])
    cases.append(('one node', batch([one] * 3, [
        np.zeros(0, np.int8), encode_seq('A'), encode_seq('ACGTN')])))
    g, _ = _fused(rng, 60, 3)
    cases.append(('empty sequence', batch([g, g], [
        np.zeros(0, np.int8), encode_seq(_template(rng, 30))])))
    t = _template(rng, 90)
    cases.append(('identical copies', batch(
        [fused_graph([t] * 4)] * 2, [encode_seq(t), encode_seq(t[::2])])))
    graphs, seqs = zip(*[_fused(rng, int(rng.integers(30, 120)), 4, 0.05,
                                0.12, 0.12) for _ in range(4)])
    cases.append(('indel-heavy', batch(graphs, seqs)))
    stars = [star_graph(rng, 12, 40), star_graph(rng, 130, 25)]
    cases.append(('in-degree 12 and 130', batch(stars, [
        encode_seq(_template(rng, 30)), encode_seq(_template(rng, 20))])))
    t = _template(rng, 40)
    rep = fused_graph([t * 3, t * 2 + mutate(rng, t), mutate(rng, t * 3,
                                                          sub=0.08)])
    cases.append(('long back edges', batch([rep], [encode_seq(mutate(
        rng, t * 3))])))
    graphs, seqs = zip(_fused(rng, 40, 3), _fused(rng, 400, 2),
                       _fused(rng, 8, 5))
    cases.append(('mixed sizes', batch(graphs, seqs)))
    t = _template(rng, 160)
    g = fused_graph([mutate(rng, t) for _ in range(3)])
    cases.append(('long insertion', batch([g], [encode_seq(
        t[:60] + _template(rng, 150) + t[60:])])))
    if wide:
        for n in WIDE_LENGTHS:
            g, s = _fused(rng, n, 2, 0.03, 0.02, 0.02)
            s = np.resize(s, n)     # exactly n codes
            cases.append(('{} codes'.format(n), batch([g], [s])))
    return cases
