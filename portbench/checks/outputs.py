"""The output files of ``collapse`` against the world's truth.

The world knows each read's sample and true circRNA (its name) and each
circRNA's back-splice junction and exons.  After the window, every unit's
``.expression`` and ``.isoforms`` are read (the ``.info`` ids are theirs)
and held to that truth, a circRNA matched to a true locus where both ends
lie within ``TOL`` bp (the 5 bp rule of the port's benchmarks/validate.py,
rewritten here).  For each sample, with D(L) its circular reads drawn from
locus L:

- ``expression_gap``: (sum over loci of |counted(L) - D(L)| plus the reads
  counted at circRNAs that match no locus) over the sum of D(L); counted(L)
  is the sum of ``.expression``'s counts of the sample at the circRNAs that
  match L.  Reads that ``call`` or ``collapse`` lose, reads counted twice,
  a junction moved or a sample left out all raise it.
- ``isoform_gap``: 1 - (sum over loci of min(D(L), the sample's reads at
  L's circRNAs times their ``.isoforms`` usage of isoforms whose exons all
  match L's)) over the sum of D(L).  A wrong exon chain raises it too.

Each number is the largest over the window's units and the samples.  The
control breaks the guarantee that every sample of the list is counted:
the program's ``collapse``, run once more after the window on the list
without its last sample, judged the same way.
"""

import csv
import os
from collections import defaultdict

TOL = 5
LIMITS = {'expression_gap': 0.2, 'isoform_gap': 0.2}


def _parse_circ(circ_id):
    ctg, span = circ_id.rsplit(':', 1)
    st, en = span.split('-')
    return ctg, int(st), int(en)


def match_locus(circ_id, truth, tol=TOL):
    """The index of the truth locus whose junction lies within ``tol`` bp of
    ``circ_id``'s at both ends, or None."""
    ctg, st, en = _parse_circ(circ_id)
    for i, (t_ctg, t_st, t_en, _exons) in enumerate(truth):
        if ctg == t_ctg and abs(st - t_st) <= tol and abs(en - t_en) <= tol:
            return i
    return None


def exons_match(iso_id, exons, tol=TOL):
    """Whether an isoform's exon chain (``start-end,start-end``) is the
    locus's, each end within ``tol`` bp."""
    got = [tuple(int(v) for v in e.split('-')) for e in iso_id.split(',')
           if e]
    return len(got) == len(exons) and all(
        abs(a - c) <= tol and abs(b - d) <= tol
        for (a, b), (c, d) in zip(got, exons))


def _table(path):
    """{row id: {column: float}} of a tab-separated matrix."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        rows = list(csv.reader(f, delimiter='\t'))
    if not rows:
        return {}
    head = rows[0][1:]
    return {r[0]: {c: float(v or 0) for c, v in zip(head, r[1:])}
            for r in rows[1:] if r}


def gaps(out_dir, prefix, truth, drawn):
    """{'expression_gap': g, 'isoform_gap': g} of one ``collapse`` output,
    each the largest over the samples of ``drawn`` ({sample: reads a
    locus})."""
    expr = _table(os.path.join(out_dir, prefix + '.expression'))
    iso = _table(os.path.join(out_dir, prefix + '.isoforms'))
    locus_of = {c: match_locus(c, truth) for c in expr}
    worst = {'expression_gap': 0.0, 'isoform_gap': 0.0}
    for sample, want in drawn.items():
        total = float(sum(want))
        counted = defaultdict(float)
        stray = 0.0
        for circ, cols in expr.items():
            n = cols.get(sample, 0.0)
            if locus_of[circ] is None:
                stray += n
            else:
                counted[locus_of[circ]] += n
        miss = sum(abs(counted[li] - d) for li, d in enumerate(want))
        right = defaultdict(float)
        for key, cols in iso.items():
            circ, iso_id = key.split('|', 1)
            li = locus_of.get(circ)
            if li is None or not exons_match(iso_id, truth[li][3]):
                continue
            right[li] += cols.get(sample, 0.0) * expr[circ].get(sample, 0.0)
        kept = sum(min(d, right[li]) for li, d in enumerate(want))
        worst['expression_gap'] = max(worst['expression_gap'],
                                      (miss + stray) / total)
        worst['isoform_gap'] = max(worst['isoform_gap'], 1.0 - kept / total)
    return worst


class Check:
    def __init__(self, seed, world):
        self.world = world
        self.drawn = {s: v['drawn'] for s, v in world['samples'].items()}

    def install(self):
        pass

    def uninstall(self):
        pass

    def _control_output(self, unit):
        """The program's ``collapse`` of the unit's list without its last
        sample, run once; its output directory."""
        from ciri_long_tpu_torch.cli.main import main

        out = unit['out'] + '.control'
        lst = out + '.lst'
        with open(lst, 'w') as f:
            for sample, cand in unit['listed'][:-1]:
                f.write('{}\t{}\n'.format(sample, cand))
        argv = list(unit['argv'])
        argv[argv.index('-i') + 1] = lst
        argv[argv.index('-o') + 1] = out
        main(argv)
        return out

    def judge(self, rec, control=False):
        units = [u for u in rec['units'] if 'out' in u]
        if not units:
            return {k: (1.0, lim) for k, lim in LIMITS.items()}
        if control:
            outs = [(self._control_output(units[-1]), units[-1]['prefix'])]
        else:
            outs = [(u['out'], u['prefix']) for u in units]
        worst = {k: 0.0 for k in LIMITS}
        for out, prefix in outs:
            for k, v in gaps(out, prefix, self.world['truth'],
                             self.drawn).items():
                worst[k] = max(worst[k], v)
        return {k: (worst[k], LIMITS[k]) for k in LIMITS}
