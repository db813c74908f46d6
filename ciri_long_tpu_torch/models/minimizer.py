"""Minimizer extraction and genome index.

Replaces the minimap2 index (reference builds it at find_bsj.py:336,659 via
``mp.Aligner(ref, preset='splice')``) with a host-built winnowed-minimizer
table: canonical k-mers hashed with an invertible 64-bit mix, windowed
minimum winnowing (all ties kept, as minimap2 does), positions stored in
global genome coordinates and sorted by hash for binary-search lookup.

The whole build is vectorised numpy over the packed genome code array --
no per-window Python.  The index is replicated per host (SURVEY.md §2
parallelism table: read-only state is host-replicated, reads are the
sharded axis).
"""

from typing import NamedTuple, Optional

import numpy as np

_MIX_MUL1 = np.uint64(0xff51afd7ed558ccd)
_MIX_MUL2 = np.uint64(0xc4ceb9fe1a85ec53)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64-style finalizer: decorrelates k-mer codes so 'minimum
    hash' is not biased toward poly-A (minimap2 uses the same idea)."""
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(33)
    x *= _MIX_MUL1
    x ^= x >> np.uint64(33)
    x *= _MIX_MUL2
    x ^= x >> np.uint64(33)
    return x


def kmer_hashes(codes: np.ndarray, k: int, valid_mask=None):
    """Canonical k-mer identity and strand for every k-mer start position.

    Returns (code u32 [L-k+1], mixed u64 [L-k+1], strand u8, ok bool):
    ``code`` is the exact canonical 2k-bit k-mer (the stored/lookup key;
    fits u32 for k <= 15), ``mixed`` its splitmix finalisation used only
    for winnowing selection.  strand 0 = forward k-mer is canonical.
    """
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        z = np.zeros(0)
        return (z.astype(np.uint32), z.astype(np.uint64),
                z.astype(np.uint8), z.astype(bool))
    c = codes.astype(np.int64)
    base_ok = codes < 4
    if valid_mask is not None:
        base_ok = base_ok & valid_mask
    bad = (~base_ok).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    ok = (cs[k:] - cs[:-k]) == 0

    fwd = np.zeros(n, np.uint64)
    rev = np.zeros(n, np.uint64)
    for t in range(k):
        seg = c[t:n + t]
        fwd = (fwd << np.uint64(2)) | np.where(ok, seg, 0).astype(np.uint64)
        rev |= ((np.uint64(3) - np.where(ok, seg, 0).astype(np.uint64))
                << np.uint64(2 * t))
    strand = (rev < fwd).astype(np.uint8)
    canon = np.minimum(fwd, rev)
    return canon.astype(np.uint32), _mix64(canon), strand, ok


def minimizers(codes: np.ndarray, k: int, w: int, valid_mask=None,
               n_threads: int = 1):
    """Winnowed minimizers: positions p whose MIXED hash equals the minimum
    of at least one w-window (all ties kept, as minimap2 does).

    Returns (code u32, pos i64, strand u8) arrays -- codes are the exact
    canonical k-mers, which is what the index stores and looks up.
    ``n_threads`` bounds the native sketch's chunked threading (output is
    byte-identical at any count; threads only engage past ~2M bases, so
    per-read sketches are always single-thread).
    """
    if valid_mask is None:
        try:
            from ciri_long_tpu import _chaincore
            cb, pb, sb = _chaincore.sketch(
                np.ascontiguousarray(codes, np.uint8).tobytes(), k, w,
                max(1, int(n_threads)))
            return (np.frombuffer(cb, np.uint32),
                    np.frombuffer(pb, np.int64),
                    np.frombuffer(sb, np.uint8))
        except ImportError:
            pass
    code, h, strand, ok = kmer_hashes(codes, k, valid_mask)
    n = len(h)
    if n == 0:
        return code, np.zeros(0, np.int64), strand
    INF = np.uint64(0xffffffffffffffff)
    hh = np.where(ok, h, INF)
    if n < w:
        w = max(1, n)
    m = hh[:n - w + 1].copy()
    for t in range(1, w):
        np.minimum(m, hh[t:t + n - w + 1], out=m)
    flag = np.zeros(n, bool)
    for t in range(w):
        sl = hh[t:t + n - w + 1]
        flag[t:t + n - w + 1] |= (sl == m) & (sl != INF)
    pos = np.nonzero(flag)[0].astype(np.int64)
    return code[pos], pos, strand[pos]


class MinimizerIndex(NamedTuple):
    """Sorted-by-code minimizer table over the packed genome.

    Memory layout is production-scale minded: 9 bytes per minimizer
    (u32 canonical code + u32 global position + u8 strand) -- a human
    genome at w=5 is ~9 GB/host.  Genomes above 4.29 Gb would need u64
    positions (asserted at build)."""
    k: int
    w: int
    codes: np.ndarray    # u32 canonical k-mers, sorted
    pos: np.ndarray      # u32 global genome coordinate of k-mer start
    strand: np.ndarray   # u8
    buckets: Optional[np.ndarray] = None  # i64[2^bits+1] top-bits offsets
    # top-bits resolved by the bucket table.  Fixed 16 leaves ~5000-entry
    # buckets at 1 Gb (measured 12x per-read mapping slowdown vs small
    # genomes); build() sizes it so buckets average ~32 entries.
    bucket_bits: int = 16

    @classmethod
    def build(cls, genome, k: int, w: int,
              threads: int = 1) -> "MinimizerIndex":
        assert genome.total_len < (1 << 32), \
            "genomes above 4.29 Gb need a u64-position index"
        try:
            from ciri_long_tpu import _chaincore
            build_table = getattr(_chaincore, 'build_table', None)
        except ImportError:
            build_table = None
        if build_table is not None:
            # memory-bounded native build (chaincore.cpp::py_build_table):
            # two-pass exact-allocation sketch + in-stream contig-boundary
            # filter + stable triple radix sort -- peak RSS ~2x the final
            # 9 B/minimizer table vs ~4x table + 16 B/min sort temps +
            # i64 positions on the python path below (measured 37 GB at
            # 1 Gb; the native path is what makes a cold 3 Gb build fit).
            # Byte-identical outputs (tests/test_minimizer.py).
            ends = np.sort(np.asarray(
                [genome.offsets[n] + genome.contig_len[n]
                 for n in genome.names], np.int64))
            # int8 -> uint8 is a bit-reinterpret (codes are 0..6): view,
            # don't cast -- a cast would copy 1 B/base
            dense = np.ascontiguousarray(
                genome.dense_codes()).view(np.uint8)
            cb, pb, sb = build_table(dense, k, w, ends.tobytes(),
                                     max(1, int(threads)))
            del dense
            code = np.frombuffer(cb, np.uint32)
            pos = np.frombuffer(pb, np.uint32)
            strand = np.frombuffer(sb, np.uint8)
        else:
            # dense_codes materialises 1 B/base transiently for 2-bit
            # genomes; dropped right after the sketch (build is
            # once-per-genome)
            code, pos, strand = minimizers(genome.dense_codes(), k, w,
                                           n_threads=threads)
            # k-mers must not span contig boundaries: drop any whose
            # start lies within the last k-1 bases of a contig
            keep = np.ones(len(pos), bool)
            for name in genome.names:
                off = genome.offsets[name]
                ln = genome.contig_len[name]
                bad = (pos > off + ln - k) & (pos < off + ln)
                keep &= ~bad
            code, pos, strand = code[keep], pos[keep], strand[keep]
            order = np.argsort(code, kind='stable')
            code = code[order]
            pos = pos[order].astype(np.uint32)
            strand = strand[order]
        # adaptive top-bits bucket offsets: each lookup binary-searches a
        # ~32-entry bucket instead of the whole table, independent of
        # genome scale (table cost 8 B x 2^bits: 512 KB at 50 Mb, 256 MB
        # at 1 Gb -- ~3% of the 9 B/minimizer table itself)
        bits = 16
        while bits < 26 and (len(code) >> (bits + 5)):
            bits += 1
        buckets = np.searchsorted(
            code, (np.arange((1 << bits) + 1, dtype=np.int64)
                   << (32 - bits))).astype(np.int64)
        return cls(k, w, code, pos, strand, buckets, bits)

    # --- mmap-shared cache (the minimap2 .mmi role) -------------------
    # Spawn-pool workers and repeat runs load the table zero-copy via
    # np.memmap; the OS page cache shares one physical copy across every
    # process on the host (the fork-COW sharing the reference gets for
    # free, restored for spawn workers).
    _CACHE_VERSION = 2

    def save(self, cache_dir: str, fingerprint: dict) -> None:
        """Atomically persist the index under ``cache_dir`` (npy files +
        meta.json; ``fingerprint`` records the genome identity)."""
        from ciri_long_tpu.utils.diskcache import save_array_dir

        meta = dict(version=self._CACHE_VERSION, k=self.k, w=self.w,
                    bucket_bits=self.bucket_bits, **fingerprint)
        save_array_dir(cache_dir, {'codes': self.codes, 'pos': self.pos,
                                   'strand': self.strand,
                                   'buckets': self.buckets}, meta)

    @classmethod
    def load(cls, cache_dir: str, k: int, w: int,
             fingerprint: dict) -> Optional["MinimizerIndex"]:
        """Memory-mapped load; None when absent/stale/mismatched."""
        from ciri_long_tpu.utils.diskcache import load_array_dir

        got = load_array_dir(cache_dir, ['codes', 'pos', 'strand',
                                         'buckets'])
        if got is None:
            return None
        meta, arrays = got
        bits = meta.pop('bucket_bits', 16)
        want = dict(version=cls._CACHE_VERSION, k=k, w=w, **fingerprint)
        if meta != want:
            return None
        return cls(k, w, *arrays, bits)

    def lookup(self, query_codes: np.ndarray):
        """Ranges [lo, hi) into the sorted table for each query k-mer.
        Bucketed C++ search when built (chaincore.cpp::py_lookup, exact
        searchsorted equivalence asserted in tests); numpy otherwise."""
        if self.buckets is not None and len(query_codes):
            try:
                from ciri_long_tpu import _chaincore
                native = getattr(_chaincore, 'lookup', None)
            except ImportError:
                native = None
            if native is not None:
                lob, hib = native(
                    self.codes, self.buckets,
                    np.ascontiguousarray(query_codes, np.uint32),
                    int(self.bucket_bits))
                return (np.frombuffer(lob, np.int64),
                        np.frombuffer(hib, np.int64))
        lo = np.searchsorted(self.codes, query_codes, side='left')
        hi = np.searchsorted(self.codes, query_codes, side='right')
        return lo, hi
