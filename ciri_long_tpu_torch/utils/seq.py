"""Sequence primitives shared between host Python and device kernels.

Encoding: A=0 C=1 G=2 T=3, anything else (N, IUPAC ambiguity, lowercase
soft-mask is upper-cased first) = 4.  Code 4 scores 0 against everything in
the alignment kernels, matching the reference SSW wrapper's 5x5 matrix with
a zero N row/column (ssw_wrap.py:150-161).  PAD=5 marks positions beyond a
read's length in fixed-shape batches; kernels mask it out entirely.

Behavioral parity targets (reference file:line):
  revcomp            utils.py:118-120  (maps via ATCG->TAGC then reverse --
                     note the reference leaves N and lowercase untouched)
  transform_seq      utils.py:123-124
  get_junc_seq       utils.py:127-140
  compress_seq       utils.py:162-167  (homopolymer compression)
"""

import numpy as np

A, C, G, T, N, PAD = 0, 1, 2, 3, 4, 5

# host encode/decode tables
_ENCODE = np.full(256, 4, dtype=np.int8)
for _i, _b in enumerate("ACGT"):
    _ENCODE[ord(_b)] = _i
    _ENCODE[ord(_b.lower())] = _i
_ENCODE_BYTES = _ENCODE.tobytes()

_DECODE = np.frombuffer(b"ACGTN?", dtype=np.uint8)

# revcomp translation identical to the reference's
# str.maketrans("ATCG", "TAGC") (utils.py:119): bases other than ATCG
# (including N and lowercase) pass through unchanged.
_REVCOMP_TRANS = bytes.maketrans(b"ATCG", b"TAGC")


def encode_seq(seq: str) -> np.ndarray:
    """Encode an ASCII sequence into int8 codes (A0 C1 G2 T3 other4)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENCODE[raw]


def decode_seq(codes: np.ndarray) -> str:
    """Decode int8 codes back into an ACGTN string (PAD -> '?')."""
    codes = np.asarray(codes)
    return _DECODE[np.clip(codes, 0, 5)].tobytes().decode("ascii")


def revcomp(seq: str) -> str:
    """Reverse complement, reference-parity (utils.py:118-120)."""
    return seq.translate(_REVCOMP_TRANS)[::-1]


# --- 2-bit + N-interval packing (genome-scale storage, SURVEY §7 step 1:
# the reference serves the genome via htslib's lazy Faidx at 1 B/base
# decoded, align.py:184-207; the rebuild stores 2 bits/base + a sparse
# interval table for non-ACGT runs, 4x smaller resident/cached) ----------

# byte -> 4 codes lookup, little-end-first (code i of byte b is
# (b >> (2*i)) & 3)
_UNPACK_LUT = np.zeros((256, 4), np.int8)
for _b in range(256):
    for _i in range(4):
        _UNPACK_LUT[_b, _i] = (_b >> (2 * _i)) & 3


def pack_codes(codes: np.ndarray):
    """int8 codes (0..4) -> (packed uint8 [ceil(L/4)], n_intervals
    int64 [K, 2]) where n_intervals are the half-open runs of code 4 (N).
    Packed bits store N positions as 0 (A); unpack_codes restores them."""
    codes = np.asarray(codes, np.int8)
    L = len(codes)
    is_n = codes == 4
    if is_n.any():
        d = np.diff(is_n.astype(np.int8))
        starts = np.nonzero(d == 1)[0] + 1
        ends = np.nonzero(d == -1)[0] + 1
        if is_n[0]:
            starts = np.concatenate([[0], starts])
        if is_n[-1]:
            ends = np.concatenate([ends, [L]])
        n_intervals = np.stack([starts, ends], axis=1).astype(np.int64)
    else:
        n_intervals = np.zeros((0, 2), np.int64)
    two = np.where(is_n, 0, codes).astype(np.uint8)
    pad = (-L) % 4
    if pad:
        two = np.concatenate([two, np.zeros(pad, np.uint8)])
    two = two.reshape(-1, 4)
    packed = (two[:, 0] | (two[:, 1] << 2) | (two[:, 2] << 4)
              | (two[:, 3] << 6)).astype(np.uint8)
    return packed, n_intervals


def unpack_codes(packed: np.ndarray, n_intervals: np.ndarray,
                 start: int, end: int) -> np.ndarray:
    """Decode codes[start:end] from a pack_codes() pair (positions are in
    the unpacked coordinate space; caller guarantees 0 <= start <= end <=
    4 * len(packed))."""
    if end <= start:
        return np.zeros(0, np.int8)
    b0, b1 = start // 4, (end + 3) // 4
    out = _UNPACK_LUT[packed[b0:b1]].reshape(-1)[start - 4 * b0:
                                                 start - 4 * b0 + end - start]
    out = out.copy()
    if len(n_intervals):
        lo = np.searchsorted(n_intervals[:, 1], start, side='right')
        hi = np.searchsorted(n_intervals[:, 0], end, side='left')
        for s, e in n_intervals[lo:hi]:
            out[max(0, s - start):max(0, e - start)] = 4
    return out


def revcomp_encoded(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of encoded codes; N/PAD map to themselves."""
    comp = np.array([3, 2, 1, 0, 4, 5], dtype=np.int8)
    return comp[codes][::-1]


def transform_seq(seq, bsj):
    """Rotate a circular sequence so position ``bsj`` becomes the origin
    (utils.py:123-124).  Works for str and np arrays alike."""
    if isinstance(seq, str):
        return seq[bsj:] + seq[:bsj]
    return np.concatenate([seq[bsj:], seq[:bsj]])


def get_junc_seq(seq: str, bsj: int, width: int = 25) -> str:
    """Junction window with circular wraparound (utils.py:127-140)."""
    st, en = bsj - width, bsj + width
    if len(seq) <= 2 * width:
        return seq[bsj - len(seq) // 2:] + seq[:bsj - len(seq) // 2]

    if st < 0:
        if en < 0:
            return seq[st:en]
        return seq[st:] + seq[:en]
    if en > len(seq):
        return seq[st:] + seq[:en - len(seq)]
    return seq[st:en]


def compress_seq(seq: str) -> str:
    """Homopolymer compression (utils.py:162-167)."""
    if not seq:
        return seq
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    keep = np.empty(len(raw), dtype=bool)
    keep[0] = True
    np.not_equal(raw[1:], raw[:-1], out=keep[1:])
    return raw[keep].tobytes().decode("ascii")


def pad_encoded(seqs, max_len=None, pad_value=PAD, dtype=np.int8):
    """Stack variable-length encoded sequences into a [B, Lmax] batch plus a
    length vector.  This is the host->device packaging used by every batched
    kernel (replaces the reference's per-read native calls)."""
    if max_len is None:
        max_len = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), max_len), pad_value, dtype=dtype)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s, dtype=dtype)
        n = min(len(s), max_len)
        out[i, :n] = s[:n]
        lens[i] = n
    return out, lens


def bucket_lengths(lengths, ladder=(256, 512, 1024, 2048, 4096, 8192, 16384, 32768)):
    """Map each length to the smallest ladder bucket that fits; lengths above
    the ladder round up to the next power of two.  Length bucketing bounds
    padding waste without recompiling per shape (SURVEY.md §7 'hard parts')."""
    out = []
    for n in lengths:
        for b in ladder:
            if n <= b:
                out.append(b)
                break
        else:
            b = 1 << int(np.ceil(np.log2(max(n, 1))))
            out.append(b)
    return out
