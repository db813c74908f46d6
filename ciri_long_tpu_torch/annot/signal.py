"""Splice-signal search and BSJ correction.

Behavioral parity with reference align.py:474-796: homology 'free-sliding'
region computation, annotated-site search, de novo motif scan on host then
antisense strand, tiered deterministic tie-break, and host-gene / intron /
exon overlap lookups.  All functions take the explicit Context instead of
module globals (env.py).

The free-sliding computation is vectorised over the packed genome codes
(ciri_long_tpu_torch.io.genome) instead of 100 indexed string fetches per side.
"""

from typing import Dict, Optional, Tuple

import numpy as np

from ciri_long_tpu_torch.utils.seq import revcomp

# signal weights (align.py:32-45): lower is better
SPLICE_SIGNAL = {
    ('GT', 'AG'): 0,   # U2-type
    ('GC', 'AG'): 1,   # U2-type
    ('AT', 'AC'): 2,   # U12-type
    ('GT', 'AC'): 2,   # U12-type
    ('AT', 'AG'): 2,   # U12-type
}

BIN = 500


def free_sliding(ctx, contig, start, end) -> Tuple[int, int]:
    """Homology lengths around the BSJ (align.py:477-494): how far the
    junction can slide up/downstream without changing the circular sequence.

    ds_free: longest common prefix of genome[start:] and genome[end:]
    us_free: longest common suffix of genome[:start] and genome[:end]
    both capped at 99 and at the contig bounds.
    """
    clen = ctx.contig_len[contig]
    ds_cap = min(100, clen - end + 1)
    a = ctx.genome.codes_of(contig, start, start + max(0, ds_cap - 1))
    b = ctx.genome.codes_of(contig, end, end + max(0, ds_cap - 1))
    n = min(len(a), len(b))
    neq = np.nonzero(a[:n] != b[:n])[0]
    ds_free = int(neq[0]) if len(neq) else n

    us_cap = min(100, start + 1)
    a = ctx.genome.codes_of(contig, start - max(0, us_cap - 1), start)
    b = ctx.genome.codes_of(contig, end - max(0, us_cap - 1), end)
    n = min(len(a), len(b))
    if n:
        ar, br = a[-n:][::-1], b[-n:][::-1]
        neq = np.nonzero(ar != br)[0]
        us_free = int(neq[0]) if len(neq) else n
    else:
        us_free = 0
    return us_free, ds_free


def get_ss_altered_length(i, j, us_free, ds_free, clip_base):
    """(align.py:698-702)"""
    clip_altered = min(abs(j - i - clip_base), abs(j - i + clip_base))
    us_altered = min(abs(i + us_free), abs(i - ds_free))
    ds_altered = min(abs(j + us_free), abs(j - ds_free))
    return abs(i - j), clip_altered, us_altered + ds_altered


def sort_ss(sites, us, ds, clip_base):
    """Tiered deterministic splice-site tie-break (align.py:705-733).

    Site tuples: (ss_id, strand, us_shift, ds_shift, weight, altered_len,
    clip_altered, altered_total)."""
    from operator import itemgetter
    get_ss = itemgetter(0, 1, 2, 3)

    # sorted: ties under the itemgetter keys must not depend on set
    # iteration order (hash-seed nondeterminism in the reference)
    tmp_sites = sorted(set(sites))

    clipped = [s for s in tmp_sites if -clip_base <= s[2] - s[3] <= clip_base]
    if clipped:
        return get_ss(sorted(clipped, key=itemgetter(6, 5, 4, 7))[0])
    tmp_sites = sorted(set(tmp_sites) - set(clipped))

    confident = [s for s in tmp_sites
                 if -us <= s[2] <= ds and -us <= s[3] <= ds]
    if confident:
        return get_ss(sorted(confident, key=itemgetter(5, 4, 6, 7))[0])
    tmp_sites = sorted(set(tmp_sites) - set(confident))

    ambiguous = [s for s in tmp_sites
                 if -clip_base <= s[2] <= 0 <= s[3] <= clip_base]
    if ambiguous:
        return get_ss(sorted(ambiguous, key=itemgetter(4, 5, 6, 7))[0])
    tmp_sites = sorted(set(tmp_sites) - set(ambiguous))

    if tmp_sites:
        return get_ss(sorted(tmp_sites, key=itemgetter(4, 5, 6, 7))[0])
    return None


def find_annotated_signal(ctx, contig, start, end, clip_base,
                          search_length=10, shift_threshold=3):
    """Annotated splice-site pairing around a candidate BSJ
    (align.py:474-568).  Returns (site-or-None, us_free, ds_free,
    tmp_signal) where tmp_signal maps strand -> (us_shifts, ds_shifts) of
    nearby annotated sites for reuse in the de novo pass."""
    tmp_signal: Dict[str, Tuple[list, list]] = {}
    us_free, ds_free = free_sliding(ctx, contig, start, end)

    if start - search_length - us_free - 2 < 0 or \
            end + search_length + ds_free + 2 > ctx.contig_len[contig]:
        return None, us_free, ds_free, tmp_signal

    ss_index = ctx.ss_index
    if ss_index is not None and contig in ss_index:
        idx = ss_index[contig]
        anno_ss = []
        for strand in ('+', '-'):
            tmp_us = []
            for shift in range(-search_length, search_length):
                pos = start + shift + 1
                if pos in idx and strand in idx[pos] and 'start' in idx[pos][strand]:
                    tmp_us.append(shift)
            for shift in range(-search_length, search_length):
                pos = start + shift
                if pos in idx and strand in idx[pos] and 'end' in idx[pos][strand]:
                    tmp_us.append(shift)

            tmp_ds = []
            for shift in range(-search_length, search_length):
                pos = end + shift + 1
                if pos in idx and strand in idx[pos] and 'start' in idx[pos][strand]:
                    tmp_ds.append(shift)
            for shift in range(-search_length, search_length):
                pos = end + shift
                if pos in idx and strand in idx[pos] and 'end' in idx[pos][strand]:
                    tmp_ds.append(shift)

            tmp_signal[strand] = (tmp_us, tmp_ds)
            if not tmp_us or not tmp_ds:
                continue

            for i in tmp_us:
                for j in tmp_ds:
                    if abs(i - j) > shift_threshold + clip_base:
                        continue
                    us_ss = ctx.genome.seq(contig, start + i - 2, start + i)
                    ds_ss = ctx.genome.seq(contig, end + j, end + j + 2)
                    if strand == '-':
                        us_ss, ds_ss = revcomp(ds_ss), revcomp(us_ss)
                    ss_id = '{}-{}|{}-{}'.format(us_ss, ds_ss, i, j)
                    weight = SPLICE_SIGNAL.get((ds_ss, us_ss), 3)
                    anno_ss.append((ss_id, strand, i, j, weight,
                                    *get_ss_altered_length(i, j, us_free, ds_free, clip_base)))

        if anno_ss:
            return sort_ss(anno_ss, us_free, ds_free, clip_base), \
                us_free, ds_free, tmp_signal

    return None, us_free, ds_free, tmp_signal


def _motif_hits(seq, motif):
    """All occurrence positions of motif in seq with start offset > 0 (the
    reference's .find(x, start+1) walk skips position 0,
    align.py:598-616)."""
    sites = []
    p = 0
    while True:
        p = seq.find(motif, p + 1)
        if p == -1:
            break
        sites.append(p)
    return sites


def _denovo_scan(ctx, contig, start, end, strands, tmp_signal, us_free,
                 ds_free, clip_base, search_length, shift_threshold,
                 is_canonical):
    us_len = search_length + us_free
    ds_len = search_length + ds_free
    us_seq = ctx.genome.seq(contig, start - us_len - 2, start + ds_len)
    ds_seq = ctx.genome.seq(contig, end - us_len, end + ds_len + 2)

    if us_seq is None or len(us_seq) < ds_len - us_len + 2:
        return None
    if ds_seq is None or len(ds_seq) < ds_len - us_len + 2:
        return None

    found = []
    for strand in strands:
        for (tmp_ds_ss, tmp_us_ss), weight in SPLICE_SIGNAL.items():
            if is_canonical and weight != 0:
                continue
            if strand == '-':
                ds_ss, us_ss = revcomp(tmp_us_ss), revcomp(tmp_ds_ss)
            else:
                ds_ss, us_ss = tmp_ds_ss, tmp_us_ss

            tmp_us = [p - us_len for p in _motif_hits(us_seq, us_ss)]
            tmp_ds = [p - us_len for p in _motif_hits(ds_seq, ds_ss)]

            if strand in tmp_signal:
                sig_us, sig_ds = tmp_signal[strand]
                tmp_us = sorted(set(tmp_us + sig_us))
                tmp_ds = sorted(set(tmp_ds + sig_ds))

            if not tmp_us or not tmp_ds:
                continue
            for i in tmp_us:
                for j in tmp_ds:
                    if abs(i - j) > clip_base + shift_threshold:
                        continue
                    ss_id = '{}-{}*|{}-{}'.format(tmp_us_ss, tmp_ds_ss, i, j)
                    found.append((ss_id, strand, i, j, weight,
                                  *get_ss_altered_length(i, j, us_free, ds_free, clip_base)))
    return found or None


def find_denovo_signal(ctx, contig, start, end, host_strand, tmp_signal,
                       us_free, ds_free, clip_base, search_length=10,
                       shift_threshold=3, is_canonical=False):
    """De novo splice-signal scan (align.py:571-695): host-gene strand(s)
    first, then the antisense strand(s)."""
    if host_strand:
        prior = sorted(set(host_strand))
        ss = _denovo_scan(ctx, contig, start, end, prior, tmp_signal,
                          us_free, ds_free, clip_base, search_length,
                          shift_threshold, is_canonical)
        if ss:
            return sort_ss(ss, us_free, ds_free, clip_base)

    other = sorted({'+', '-'} - set(host_strand)) if host_strand else ['+', '-']
    if other:
        ss = _denovo_scan(ctx, contig, start, end, other, tmp_signal,
                          us_free, ds_free, clip_base, search_length,
                          shift_threshold, is_canonical)
        if ss:
            return sort_ss(ss, us_free, ds_free, clip_base)
    return None


def search_splice_signal(ctx, contig, start, end, clip_base,
                         search_length=10, shift_threshold=3):
    """Combined annotated + de novo search returning (site, us_free,
    ds_free) -- the legacy single-call interface (find_bsj.py:17-136,
    retained by the reference for its commented-out recovery paths)."""
    ss_site, us_free, ds_free, tmp_signal = find_annotated_signal(
        ctx, contig, start, end, clip_base, search_length, shift_threshold)
    if ss_site is not None:
        return ss_site, us_free, ds_free
    if start - search_length - us_free - 2 < 0 or \
            end + search_length + ds_free + 2 > ctx.contig_len[contig]:
        return None, us_free, ds_free
    ss_site = find_denovo_signal(ctx, contig, start, end, None, tmp_signal,
                                 us_free, ds_free, clip_base, search_length,
                                 shift_threshold, False)
    return ss_site, us_free, ds_free


def find_host_gene(ctx, ctg, start, end) -> Optional[dict]:
    """Genes overlapping the candidate locus, keyed by strand
    (align.py:736-755)."""
    if ctx.gtf_index is None or ctg not in ctx.gtf_index:
        return None
    host = {}
    for b in range(start // BIN, end // BIN + 1):
        for element in ctx.gtf_index[ctg].get(b, []):
            if element.end < start or element.start > end:
                continue
            if element.start - BIN <= start <= element.end + BIN or \
                    element.start - BIN <= end <= element.end + BIN:
                host.setdefault(element.strand, []).append(element)
    return host or None


def find_retained_introns(ctx, ctg, start, end) -> Optional[dict]:
    """Introns containing the locus with 25 bp slack (align.py:758-774)."""
    if ctx.intron_index is None or ctg not in ctx.intron_index:
        return None
    host = {}
    for b in range(start // BIN, end // BIN + 1):
        for st, en, strand in ctx.intron_index[ctg].get(b, []):
            if st - 25 <= start and end <= en + 25:
                host.setdefault(strand, []).append((st, en, strand))
    return host or None


def find_overlap_exons(ctx, ctg, start, end) -> Optional[dict]:
    """Exons overlapping the locus by >=25 bp (align.py:777-796)."""
    if ctx.gtf_index is None or ctg not in ctx.gtf_index:
        return None
    host = {}
    for b in range(start // BIN, end // BIN + 1):
        for element in ctx.gtf_index[ctg].get(b, []):
            if element.type != 'exon':
                continue
            if element.end - 25 < start or end < element.start + 25:
                continue
            host.setdefault(element.strand, []).append(
                (element.start, element.end, element.strand))
    return host or None


def equivalent_seq(genome, contig, start, end, strand) -> str:
    """Sliding-ambiguity string of a circRNA (collapse.py:990-1016)."""
    if strand is None:
        return 'Unknown'
    clen = genome.contig_len[contig]

    ds_seq = ''
    for i in range(100):
        if end + i > clen:
            break
        if genome.seq(contig, start - 1, start - 1 + i) == genome.seq(contig, end, end + i):
            ds_seq = genome.seq(contig, start - 1, start - 1 + i)
        else:
            break

    us_seq = ''
    for j in range(100):
        if start - j < 0:
            break
        if genome.seq(contig, start - 1 - j, start - 1) == genome.seq(contig, end - j, end):
            us_seq = genome.seq(contig, start - 1 - j, start - 1)
        else:
            break

    tmp = us_seq + ds_seq
    return tmp if strand == '+' else revcomp(tmp)
