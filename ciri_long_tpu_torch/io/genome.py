"""Reference genome access.

Replaces the reference's pysam/htslib Faidx (align.py:184-207) and the
whole-genome dict Fasta (align.py:210-223) with one packed representation:
all contigs concatenated into a single int8 code array (A0 C1 G2 T3 N4)
plus per-contig offsets.  String fetches for the host-side splice-signal
search decode on demand; device kernels slice the code array directly, so
the genome is encoded exactly once per process instead of once per fetch.
"""

import bisect
import os
from typing import Dict, List, Optional

import numpy as np

from ciri_long_tpu_torch.io.fastx import _open_any
from ciri_long_tpu_torch.utils.seq import (decode_seq, encode_seq, pack_codes,
                                           unpack_codes)

# genomes at or above this many bases store 2-bit packed (plus the sparse
# N-interval table) instead of 1 B/base int8 -- SURVEY §7 step 1's
# "2-bit+N encoding".  CIRI_PACK_GENOME=1/0 forces either representation.
PACK_THRESHOLD = 256 * 1024 * 1024


def _pack_policy(total_len: int) -> bool:
    env = os.environ.get('CIRI_PACK_GENOME')
    if env is not None and env != 'auto':
        return env not in ('0', 'false', '')
    return total_len >= PACK_THRESHOLD


class Genome:
    """seq()/contig_len API shared by Faidx and Fasta in the reference.

    Two storage modes behind one API: small genomes keep the int8 code
    array (``codes``); genome-scale inputs keep 2-bit ``packed`` bytes +
    ``n_intervals`` and decode windows on demand (``codes`` is None).
    """

    def __init__(self, path: Optional[str] = None):
        self.names: List[str] = []
        self.offsets: Dict[str, int] = {}
        self.contig_len: Dict[str, int] = {}
        self.codes: Optional[np.ndarray] = np.zeros(0, np.int8)
        self.packed: Optional[np.ndarray] = None
        self.n_intervals: Optional[np.ndarray] = None
        self.path: Optional[str] = path  # None for in-memory genomes
        if path is not None:
            self._load(path)

    @property
    def is_packed(self) -> bool:
        return self.codes is None

    @property
    def total_len(self) -> int:
        tl = getattr(self, '_total_len', None)
        if tl is None or self._total_len_n != len(self.contig_len):
            tl = self._total_len = sum(self.contig_len.values())
            self._total_len_n = len(self.contig_len)
        return tl

    def _maybe_pack(self):
        """Switch to 2-bit storage when the pack policy says so."""
        if self.codes is not None and _pack_policy(len(self.codes)):
            self.packed, self.n_intervals = pack_codes(self.codes)
            self.codes = None

    # --- mmap-shared packed-genome cache -------------------------------
    # Companion to the minimizer-index cache (models/minimizer.py): spawn
    # workers and repeat runs map one page-cached copy of the int8 code
    # array instead of each re-parsing the fasta and holding a private
    # genome-sized buffer.
    _CACHE_VERSION = 2

    def save_cache(self, cache_dir: str) -> None:
        """Atomically persist the packed genome under ``cache_dir``
        (requires an on-disk source fasta for the fingerprint).  2-bit
        genomes cache 4x fewer bytes (and page-cache 4x less when
        mmap-shared across workers)."""
        from ciri_long_tpu_torch.utils.diskcache import save_array_dir

        fp = self._fingerprint()
        if fp is None:
            raise ValueError('in-memory genomes cannot be cached')
        meta = dict(version=self._CACHE_VERSION, names=self.names,
                    offsets=[self.offsets[n] for n in self.names],
                    lens=[self.contig_len[n] for n in self.names],
                    fmt='packed2' if self.is_packed else 'int8', **fp)
        if self.is_packed:
            arrays = {'packed': self.packed, 'nint': self.n_intervals}
        else:
            arrays = {'codes': self.codes}
        save_array_dir(cache_dir, arrays, meta)

    @classmethod
    def from_cache(cls, cache_dir: str, path: str) -> Optional["Genome"]:
        """Memory-mapped load; None when absent/stale (callers fall back
        to parsing ``path``)."""
        from ciri_long_tpu_torch.utils.diskcache import load_array_dir

        got = load_array_dir(cache_dir, ['codes'])
        fmt = 'int8'
        if got is None:
            got = load_array_dir(cache_dir, ['packed', 'nint'])
            fmt = 'packed2'
        if got is None:
            return None
        meta, arrays = got
        g = cls()
        g.path = path
        fp = g._fingerprint_of(path)
        if (fp is None or meta.get('version') != cls._CACHE_VERSION
                or meta.get('fmt', 'int8') != fmt
                or any(meta.get(k) != v for k, v in fp.items())):
            return None
        if fmt == 'packed2':
            g.codes = None
            g.packed, g.n_intervals = arrays
            # n_intervals round-trips through the mmap as a 2-column array
            g.n_intervals = np.asarray(g.n_intervals).reshape(-1, 2)
        else:
            (g.codes,) = arrays
        g.names = list(meta['names'])
        g.offsets = dict(zip(g.names, meta['offsets']))
        g.contig_len = dict(zip(g.names, meta['lens']))
        return g

    def _fingerprint(self):
        return self._fingerprint_of(self.path) if self.path else None

    @staticmethod
    def _fingerprint_of(path):
        try:
            st = os.stat(path)
        except OSError:
            return None
        return dict(ref=os.path.abspath(path), size=st.st_size,
                    mtime=int(st.st_mtime))

    @classmethod
    def from_dict(cls, contigs: Dict[str, str]) -> "Genome":
        g = cls()
        chunks = []
        off = 0
        for name, seq in contigs.items():
            g.names.append(name)
            g.offsets[name] = off
            g.contig_len[name] = len(seq)
            chunks.append(encode_seq(seq))
            off += len(seq)
        g.codes = (np.concatenate(chunks) if chunks else np.zeros(0, np.int8))
        g._maybe_pack()
        return g

    def _load(self, path: str):
        # native one-pass parse+encode when the extension is built
        try:
            from ciri_long_tpu_torch import _fastxcodec as fx
        except ImportError:
            fx = None
        if fx is not None:
            off = 0
            all_chunks = []
            for name_b, codes_b in fx.parse_fastx_encoded(path):
                name = name_b.decode('ascii')
                arr = np.frombuffer(codes_b, np.int8)
                self.names.append(name)
                self.offsets[name] = off
                self.contig_len[name] = len(arr)
                all_chunks.append(arr)
                off += len(arr)
            self.codes = (np.concatenate(all_chunks) if all_chunks
                          else np.zeros(0, np.int8))
            self._maybe_pack()
            return

        name, chunks = None, []
        all_chunks = []
        off = 0
        with _open_any(path) as f:
            for line in f:
                line = line.rstrip()
                if line.startswith('>'):
                    if name is not None:
                        seq = ''.join(chunks)
                        self.names.append(name)
                        self.offsets[name] = off
                        self.contig_len[name] = len(seq)
                        all_chunks.append(encode_seq(seq))
                        off += len(seq)
                    name = line[1:].split()[0]
                    chunks = []
                else:
                    chunks.append(line)
            if name is not None:
                seq = ''.join(chunks)
                self.names.append(name)
                self.offsets[name] = off
                self.contig_len[name] = len(seq)
                all_chunks.append(encode_seq(seq))
        self.codes = (np.concatenate(all_chunks) if all_chunks
                      else np.zeros(0, np.int8))
        self._maybe_pack()

    # --- reference-parity string API (align.py:203-204,220-223) ---
    def seq(self, contig: str, start: int, end: int) -> Optional[str]:
        got = self.codes_of(contig, start, end)
        return None if got is None else decode_seq(got)

    # --- device-facing API ---
    def codes_of(self, contig: str, start: int, end: int) -> Optional[np.ndarray]:
        if contig not in self.offsets:
            return None
        n = self.contig_len[contig]
        start = max(0, start)
        end = min(n, end)
        off = self.offsets[contig]
        if self.codes is not None:
            return self.codes[off + start:off + end]
        return unpack_codes(self.packed, self.n_intervals,
                            off + start, off + end)

    def codes_window(self, g_lo: int, g_hi: int) -> np.ndarray:
        """Decoded int8 codes for GLOBAL range [g_lo, g_hi) -- the window
        interface for host kernels (e.g. the native stitcher) that read a
        bounded neighbourhood instead of the whole genome array."""
        L = self.total_len
        g_lo = max(0, g_lo)
        g_hi = min(L, g_hi)
        if g_hi <= g_lo:
            return np.zeros(0, np.int8)
        if self.codes is not None:
            return self.codes[g_lo:g_hi]
        return unpack_codes(self.packed, self.n_intervals, g_lo, g_hi)

    def dense_codes(self) -> np.ndarray:
        """Whole-genome int8 codes.  For packed genomes this MATERIALISES
        1 B/base transiently -- index builds use it once and drop it; the
        per-read paths must use codes_of/codes_window instead."""
        if self.codes is not None:
            return self.codes
        return unpack_codes(self.packed, self.n_intervals, 0, self.total_len)

    def global_pos(self, contig: str, pos: int) -> int:
        return self.offsets[contig] + pos

    def locate(self, gpos: int):
        """Global position -> (contig, local position).

        Scalar-hot (called per surviving hit); bisect over a plain list
        beats an np.searchsorted dispatch ~50x at this call shape."""
        if not self.names:
            return None, -1
        starts = getattr(self, "_starts_list", None)
        if starts is None or len(starts) != len(self.names):
            starts = [self.offsets[n] for n in self.names]
            self._starts_list = starts
        i = bisect.bisect_right(starts, gpos) - 1
        if i < 0:
            return None, -1
        name = self.names[i]
        local = gpos - self.offsets[name]
        if local >= self.contig_len[name]:
            return None, -1
        return name, local
