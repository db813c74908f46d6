"""Fixed-size candidate-record codec for the mesh's merges.

Port of ciri_long_tpu/parallel/records.py (numpy only; the port keeps its
own copy, over its own utils/seq.py, and its rows are bit-identical).  The
port merges the rows over torch.distributed (parallel/mesh.py).

The scan passes emit cand_circ.fa records as formatted string tuples
(pipeline/find_bsj.py; reference format find_bsj.py:363-366).  To merge
candidates across mesh shards / hosts with ONE all_gather (SURVEY.md §5:
'fixed-size record arrays + valid masks'), each record is packed into a
flat int32 row and unpacked back to the exact byte-identical string tuple
on the writing host (round-trip asserted in tests/test_cohort.py).

Layout (int32 lanes):
  0 read_idx        global input-order index (the merge sort key)
  1 ctg_idx         contig index into the genome's name list
  2 circ_start      as printed (1-based)
  3 circ_end
  4 strand_code     0 'NA', 1 '+', 2 '-'
  5 junc
  6 clip_base
  7 circ_len        the trailing field of 'junc|clip-len'
  8 ss_kind         0 'NA', 1 annotated 'US-DS|i-j', 2 denovo 'US-DS*|i-j'
  9 ss_us, 10 ss_ds 2-base signals, 4*hi+lo base codes
  11 ss_i, 12 ss_j  shift pair (offset by +4096: shifts are small ints)
  13 n_exons, 14 n_segs, 15 seq_len
  16 ..             exon triples (st, en, len; len -1='*-', -2='-*')
  ..                segment pairs (st, en)
  ..                sequence codes nibble-packed 8 per lane

Capacities are static so every shard compiles the same gather shape.
"""

from typing import List, Sequence, Tuple

import numpy as np

from ciri_long_tpu_torch.utils.seq import decode_seq, encode_seq

MAX_EXONS = 64
MAX_SEGS = 64
MAX_SEQ = 16384
HDR = 16
_EX0 = HDR
_SEG0 = _EX0 + 3 * MAX_EXONS
_SEQ0 = _SEG0 + 2 * MAX_SEGS
REC_W = _SEQ0 + MAX_SEQ // 8
_SHIFT_BIAS = 4096

_BASES = 'ACGT'


def _enc2(sig: str) -> int:
    return 4 * _BASES.index(sig[0]) + _BASES.index(sig[1])


def _dec2(code: int) -> str:
    return _BASES[code // 4] + _BASES[code % 4]


def encode_record(rec: Tuple, read_idx: int, ctg_index: dict) -> np.ndarray:
    """Pack one scan output tuple (read_id, circ_id, strand, cirexons,
    ss_id, junc|clip-len, segments, seq) into an int32 row."""
    (_read_id, circ_id, strand, cirexons, ss_id, clipfield, segments,
     seq) = rec
    row = np.zeros(REC_W, np.int32)
    row[0] = read_idx
    ctg, span = circ_id.rsplit(':', 1)
    st_s, en_s = span.rsplit('-', 1)
    row[1] = ctg_index[ctg]
    row[2] = int(st_s)
    row[3] = int(en_s)
    row[4] = {'NA': 0, '+': 1, '-': 2}[strand]

    junc_s, rest = clipfield.split('|', 1)
    clip_s, len_s = rest.split('-', 1)
    row[5] = int(junc_s)
    row[6] = int(clip_s)
    row[7] = int(len_s)

    if ss_id == 'NA':
        row[8] = 0
    else:
        sig, ij = ss_id.split('|', 1)
        if sig.endswith('*'):
            row[8] = 2
            sig = sig[:-1]
        else:
            row[8] = 1
        us, ds = sig.split('-', 1)
        row[9] = _enc2(us)
        row[10] = _enc2(ds)
        # shifts can be negative: 'i-j' splits at the LAST dash of a
        # number boundary; parse by scanning
        i_s, j_s = _split_signed_pair(ij)
        row[11] = i_s + _SHIFT_BIAS
        row[12] = j_s + _SHIFT_BIAS

    exons = []
    for part in cirexons.split(','):
        span, len_part = part.rsplit('|', 1)
        st_s, en_s = span.rsplit('-', 1)
        if len_part == '*-':
            ln = -1
        elif len_part == '-*':
            ln = -2
        else:
            ln = int(len_part)
        exons.append((int(st_s), int(en_s), ln))
    assert len(exons) <= MAX_EXONS, 'record exceeds MAX_EXONS'
    row[13] = len(exons)
    for t, (a, b, c) in enumerate(exons):
        row[_EX0 + 3 * t:_EX0 + 3 * t + 3] = (a, b, c)

    segs = []
    if segments not in ('partial',):
        for part in segments.split(';'):
            a, b = part.rsplit('-', 1)
            segs.append((int(a), int(b)))
    else:
        row[14] = -1          # literal 'partial' tag (raw-read pass)
    assert len(segs) <= MAX_SEGS, 'record exceeds MAX_SEGS'
    if row[14] != -1:
        row[14] = len(segs)
    for t, (a, b) in enumerate(segs):
        row[_SEG0 + 2 * t:_SEG0 + 2 * t + 2] = (a, b)

    codes = encode_seq(seq)
    assert len(codes) <= MAX_SEQ, 'record exceeds MAX_SEQ'
    row[15] = len(codes)
    padded = np.zeros(MAX_SEQ, np.uint32)
    padded[:len(codes)] = codes
    packed = np.zeros(MAX_SEQ // 8, np.uint32)
    for k in range(8):
        packed |= padded[k::8] << (4 * k)
    row[_SEQ0:] = packed.view(np.int32)
    return row


def _split_signed_pair(s: str) -> Tuple[int, int]:
    """Parse '{i}-{j}' where either int may be negative ('-3--5')."""
    for p in range(1, len(s)):
        if s[p] == '-' and s[p - 1].isdigit():
            return int(s[:p]), int(s[p + 1:])
    raise ValueError(s)


def decode_record(row: np.ndarray, read_ids: Sequence[str],
                  ctg_names: Sequence[str]) -> Tuple:
    """Inverse of encode_record: reproduce the exact string tuple."""
    read_id = read_ids[int(row[0])]
    circ_id = '{}:{}-{}'.format(ctg_names[int(row[1])], int(row[2]),
                                int(row[3]))
    strand = ('NA', '+', '-')[int(row[4])]
    clipfield = '{}|{}-{}'.format(int(row[5]), int(row[6]), int(row[7]))

    kind = int(row[8])
    if kind == 0:
        ss_id = 'NA'
    else:
        star = '*' if kind == 2 else ''
        ss_id = '{}-{}{}|{}-{}'.format(
            _dec2(int(row[9])), _dec2(int(row[10])), star,
            int(row[11]) - _SHIFT_BIAS, int(row[12]) - _SHIFT_BIAS)

    parts = []
    for t in range(int(row[13])):
        a, b, c = (int(x) for x in row[_EX0 + 3 * t:_EX0 + 3 * t + 3])
        ln = '*-' if c == -1 else ('-*' if c == -2 else str(c))
        parts.append('{}-{}|{}'.format(a, b, ln))
    cirexons = ','.join(parts)

    if int(row[14]) == -1:
        segments = 'partial'
    else:
        segments = ';'.join(
            '{}-{}'.format(int(row[_SEG0 + 2 * t]),
                           int(row[_SEG0 + 2 * t + 1]))
            for t in range(int(row[14])))

    n = int(row[15])
    packed = row[_SEQ0:].view(np.uint32)
    codes = np.zeros(MAX_SEQ, np.int8)
    for k in range(8):
        codes[k::8] = ((packed >> (4 * k)) & 0xF).astype(np.int8)
    seq = decode_seq(codes[:n])

    return (read_id, circ_id, strand, cirexons, ss_id, clipfield, segments,
            seq)


def encode_records(recs_with_idx, ctg_index) -> Tuple[np.ndarray, np.ndarray]:
    """[(read_idx, rec)] -> (int32 [N, REC_W], valid [N])."""
    if not recs_with_idx:
        return np.zeros((0, REC_W), np.int32), np.zeros(0, bool)
    rows = np.stack([encode_record(rec, idx, ctg_index)
                     for idx, rec in recs_with_idx])
    return rows, np.ones(len(rows), bool)
