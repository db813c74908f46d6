"""Alignment hit objects and cigar/block utilities.

Mirrors the mappy hit surface the reference pipeline consumes
(ctg/strand/q_st/q_en/r_st/r_en/mlen/blen/cigar/is_primary) and the block
helpers of reference align.py:319-471: get_blocks, get_exons,
get_parital_blocks, merge_blocks, merge_exons, merge_clip_exon,
remove_long_insert, get_primary_alignment, find_alignment_pos.

Cigar ops are SAM codes: 0=M 1=I 2=D 3=N 4=S (align.py:11-30); cigars here
are clip-free (query extent carried by q_st/q_en, as mappy does).
"""

import re
from typing import List, Optional, Tuple

OPS = 'MIDNSHP=X'
OP_CODE = {c: i for i, c in enumerate(OPS)}

_CIGAR_RE = re.compile(r'(\d+)([MIDNSHP=X])')


def parse_cigar_string(s: str) -> List[Tuple[int, int]]:
    return [(int(l), OP_CODE[op]) for l, op in _CIGAR_RE.findall(s)]


def cigar_string(cigar) -> str:
    return ''.join('{}{}'.format(l, OPS[op]) for l, op in cigar)


class Hit:
    """An alignment of a query against one contig."""

    __slots__ = ('ctg', 'ctg_len', 'strand', 'q_st', 'q_en', 'r_st', 'r_en',
                 'mlen', 'blen', 'cigar', 'is_primary', 'score', 'mapq')

    def __init__(self, ctg, strand, q_st, q_en, r_st, r_en, mlen, blen,
                 cigar, is_primary=0, score=0, mapq=0, ctg_len=0):
        self.ctg = ctg
        self.ctg_len = ctg_len
        self.strand = strand          # +1 / -1
        self.q_st = q_st              # original-strand query coords
        self.q_en = q_en
        self.r_st = r_st              # r_st < r_en always
        self.r_en = r_en
        self.mlen = mlen              # matching bases
        self.blen = blen              # block length (M + D + N)
        self.cigar = cigar            # [(len, op)] in reference direction
        self.is_primary = is_primary
        self.score = score
        self.mapq = mapq

    @property
    def cigar_string(self):
        return cigar_string(self.cigar)

    def __str__(self):
        return '\t'.join(str(x) for x in [
            self.q_st, self.q_en, self.ctg, self.r_st, self.r_en, self.mlen,
            self.blen, self.cigar_string])


class SubHit:
    """A fragment of a hit after splitting at long insertions
    (reference align.py:120-164)."""

    __slots__ = ('ctg', 'strand', 'cigar', 'r_st', 'r_en', 'q_st', 'q_en',
                 'mlen', 'blen', 'is_primary')

    def __init__(self, hit, r_st, q_st, cigar):
        self.ctg = hit.ctg
        self.strand = hit.strand
        self.cigar = cigar
        self.r_st = r_st
        r_en, q_en = r_st, q_st
        for length, op in cigar:
            if op == 0:
                q_en += length
                r_en += length
            elif op == 1:
                q_en += length
            elif op in (2, 3):
                r_en += length
        self.r_en, self.q_st, self.q_en = r_en, q_st, q_en
        # reference's SubHit approximations (align.py:149-156)
        self.mlen = sum(l for l, o in cigar if o in (0, 1))
        self.blen = sum(l for l, o in cigar if o in (0, 1, 2))
        self.is_primary = 0

    @property
    def cigar_string(self):
        return cigar_string(self.cigar)


def get_blocks(hit) -> List[list]:
    """Reference-consuming blocks split at introns (align.py:319-343);
    each block is [r_start, r_end, r_end - r_start + 1]."""
    r_start = r_end = hit.r_st
    blocks = []
    for length, op in hit.cigar:
        if op in (0, 2):
            r_end += length
        elif op == 3:
            blocks.append([r_start, r_end, r_end - r_start + 1])
            r_start = r_end + length
            r_end = r_start
    if r_end > r_start:
        blocks.append([r_start, r_end, r_end - r_start + 1])
    return blocks


def get_exons(hit) -> List[list]:
    """Blocks carrying query extents too (align.py:346-371)."""
    r_start = r_end = hit.r_st
    q_start = q_end = hit.q_st
    blocks = []
    for length, op in hit.cigar:
        if op == 0:
            r_end += length
            q_end += length
        elif op == 1:
            q_end += length
        elif op == 2:
            r_end += length
        elif op == 3:
            blocks.append([r_start, r_end, q_start, q_end])
            r_start = r_end + length
            r_end = r_start
            q_start = q_end
    if r_end > r_start:
        blocks.append([r_start, r_end, q_start, q_end])
    return blocks


def get_parital_blocks(hit, junc) -> List[list]:
    """Blocks for partial reads; the block abutting the BSJ within 10 bp is
    open-ended ('*-' / '-*') (align.py:374-384)."""
    blocks = []
    for r_st, r_en, q_st, q_en in get_exons(hit):
        if abs(q_st - junc) <= 10:
            blocks.append([r_st, r_en, '*-'])
        elif abs(q_en - junc) <= 10:
            blocks.append([r_st, r_en, '-*'])
        else:
            blocks.append([r_st, r_en, r_en - r_st + 1])
    return blocks


def merge_blocks(blocks) -> List[list]:
    """Merge overlapping [st, en, len] blocks (align.py:387-400)."""
    tmp = sorted(blocks, key=lambda b: (b[0], b[1]))
    merged = []
    last_st, last_en = tmp[0][0], tmp[0][1]
    for st, en, _length in tmp[1:]:
        if st <= last_en:
            last_en = max(en, last_en)
            last_st = min(st, last_st)
        else:
            merged.append([last_st, last_en, last_en - last_st + 1])
            last_st, last_en = st, en
    merged.append([last_st, last_en, last_en - last_st + 1])
    return merged


def merge_exons(tail_exons, head_exons):
    """Join the two arms of a 2-hit chimeric read (align.py:403-409)."""
    if head_exons[0][0] < tail_exons[-1][1]:
        return merge_blocks(tail_exons + head_exons)
    head_exons[0] = [head_exons[0][0], head_exons[0][1], '*-']
    tail_exons[-1] = [tail_exons[-1][0], tail_exons[-1][1], '-*']
    return tail_exons + head_exons


def merge_clip_exon(exons, clip_info):
    """Extend the exon list with the SSW-re-aligned clip segment
    (align.py:412-428)."""
    clip_st, clip_en = clip_info[0], clip_info[1]
    exon_st, exon_en = exons[0][0], exons[-1][1]
    if clip_st and clip_en:
        if clip_en < exon_st:
            exons = [[clip_st, clip_en, clip_en - clip_st + 1]] + exons
        elif exon_en < clip_st:
            exons = exons + [[clip_st, clip_en, clip_en - clip_st + 1]]
        elif clip_st < exon_st < clip_en:
            exons[0] = [clip_st, exons[0][1], exons[0][1] - clip_st + 1]
        elif clip_st < exon_en < clip_en:
            exons[-1] = [exons[-1][0], clip_en, clip_en - exons[-1][0] + 1]
    return exons


def remove_long_insert(hit):
    """Split a hit at insertions > 20 bp; keep the fragment with the largest
    mlen (align.py:431-460)."""
    r_st, q_st = hit.r_st, hit.q_st
    last_r_st, last_q_st = r_st, q_st
    last_cigar = []
    sub_hits = []
    for length, op in hit.cigar:
        if op == 0:
            r_st += length
            q_st += length
        elif op == 1:
            q_st += length
            if length > 20:
                if last_cigar:
                    sub_hits.append(SubHit(hit, last_r_st, last_q_st, last_cigar))
                last_cigar = []
                last_r_st, last_q_st = r_st, q_st
                continue
        elif op in (2, 3):
            r_st += length
        last_cigar.append((length, op))
    if last_cigar:
        sub_hits.append(SubHit(hit, last_r_st, last_q_st, last_cigar))
    if not sub_hits:
        return hit
    primary = sorted(sub_hits, key=lambda x: x.mlen, reverse=True)[0]
    primary.is_primary = 1
    return primary


def get_primary_alignment(hits) -> Optional[object]:
    """First primary hit, split at long inserts (align.py:463-471)."""
    if not hits:
        return None
    for hit in hits:
        if hit.is_primary:
            return remove_long_insert(hit)
    return None


def find_alignment_pos(alignment, pos):
    """Map a reference position through an SW alignment's cigar to a query
    position (align.py:803-820).  ``alignment`` carries ref_begin,
    query_begin and cigar_string."""
    r_st = r_en = alignment.ref_begin
    q_st = q_en = alignment.query_begin
    for l, op in parse_cigar_string(alignment.cigar_string):
        if op == 0:
            r_en += l
            q_en += l
        elif op == 1:
            q_en += l
        elif op == 2:
            r_en += l
        if r_st <= pos <= r_en:
            return q_st + pos - r_st
        r_st = r_en
        q_st = q_en
    return None
