"""Seed-chain-extend spliced aligner (port of ciri_long_tpu/models/aligner.py;
host only in this port: the chain DP runs on the native chain core).

Replaces both native aligners of the reference -- minimap2 'splice' preset
(mappy, find_bsj.py:336,659) and BWA 'ont2d' for short reads
(find_bsj.py:457) -- with one engine parameterised two ways
(config.AlignerConfig): winnowed-minimizer seeding against the host-
replicated genome table (models/minimizer.py), colinear chaining with a
splice-tolerant gap cost (long reference gaps cheap, query gaps expensive),
and stitching of inter-anchor gaps into a full cigar with intron (N)
placement, plus extension alignment at both ends so cleanly-matching reads
reach zero soft-clip (the find_bsj rotation loop at find_bsj.py:153-176
terminates on exactly that condition).

Hit semantics follow mappy: q_st/q_en on the original query strand,
r_st < r_en, cigar in reference direction, mlen = matched bases,
blen = M+D+N, multiple non-overlapping chains reported as separate primary
hits (the 2-hit chimera geometry of scan_raw_chunk, find_bsj.py:528-539,
relies on this).
"""

from typing import List, Optional

import numpy as np

from ciri_long_tpu.config import AlignerConfig, DEFAULT
from ciri_long_tpu.io.genome import Genome
from ciri_long_tpu.utils.seq import encode_seq, revcomp_encoded
from ciri_long_tpu_torch.models.hits import Hit
from ciri_long_tpu_torch.models.minimizer import MinimizerIndex, minimizers
from ciri_long_tpu_torch.ops.traceback import (banded_global_cigar,
                                               extend_align,
                                               splice_junction_align)
from ciri_long_tpu_torch.utils.dispatch import count_dispatch as _count_dispatch

MIN_INTRON = 30        # ref gap at least this long becomes an N op
CHAIN_WINDOW = 64      # predecessors examined per anchor
MAX_HITS = 5
EXT_CAP = 1000         # max bases considered in end extension
# End-extension scoring: gap open is deliberately stiff so a run of chance
# matches threaded together with 1-bp insertions scores negative -- a soft
# extension here aligns rotated-junction tails into random flank and makes
# the find_bsj rotation loop (find_bsj.py:153-176) stop at a wrong origin
# with zero clips.
EXT_SCORES = dict(match=2, mismatch=4, gap_open=8, gap_extend=2, zdrop=100)

try:
    from ciri_long_tpu import _nwcore as _nwc
    _STITCH_NATIVE = getattr(_nwc, 'stitch', None)
    _SELECT_NATIVE = getattr(_nwc, 'select_stitch_batch', None)
except ImportError:
    _STITCH_NATIVE = None
    _SELECT_NATIVE = None


def _genome_fingerprint(genome: Genome):
    """Identity of an on-disk genome for index-cache staleness checks;
    None for in-memory genomes (never cached).  Shares the genome cache's
    own fingerprint definition so the two caches agree on staleness."""
    fp = getattr(genome, '_fingerprint', None)
    return fp() if fp is not None else None


class GenomeAligner:
    def __init__(self, genome: Genome, k: Optional[int] = None,
                 w: Optional[int] = None, cfg: AlignerConfig = DEFAULT.aligner,
                 short_mode: bool = False,
                 index_cache: Optional[str] = None,
                 build_threads: int = 1):
        self._setup(genome, cfg, short_mode, k, w)
        # ``index_cache`` points at an on-disk table (the minimap2 .mmi
        # role): loads are zero-copy np.memmap, so spawn-pool workers and
        # repeat runs share one page-cached copy instead of re-sketching
        # the genome per process.  Stale/mismatched caches rebuild.
        self.index = None
        fp = _genome_fingerprint(genome)
        if index_cache and fp is not None:
            self.index = MinimizerIndex.load(index_cache, self.k, self.w, fp)
        if self.index is None:
            self.index = MinimizerIndex.build(genome, self.k, self.w,
                                              threads=build_threads)
            if index_cache and fp is not None:
                try:
                    self.index.save(index_cache, fp)
                except OSError:
                    pass  # read-only out dirs just skip the cache

    def _setup(self, genome, cfg, short_mode, k, w):
        self.genome = genome
        self.cfg = cfg
        self.short_mode = short_mode
        if short_mode:
            self.k = k or cfg.short_k
            self.w = w or cfg.short_w
            self.min_chain_score = cfg.short_min_chain_score
            self.min_chain_anchors = cfg.short_min_chain_anchors
        else:
            self.k = k or cfg.k
            self.w = w or cfg.w
            self.min_chain_score = cfg.min_chain_score
            self.min_chain_anchors = cfg.min_chain_anchors
        # contig id per global position for cross-contig chain rejection
        self._ctg_starts = np.array(
            [genome.offsets[n] for n in genome.names], np.int64)
        self._ctg_lens = np.array(
            [genome.contig_len[n] for n in genome.names], np.int64)

    @classmethod
    def from_arrays(cls, genome: Genome, arrays, short_mode: bool = False,
                    cfg: AlignerConfig = DEFAULT.aligner) -> "GenomeAligner":
        """An aligner over an existing minimizer index instead of a fresh
        build: ``arrays`` is the JAX package's index as a dict of numpy
        arrays (``codes``, ``pos``, ``strand``, ``buckets``, as
        ciri_long_tpu.models.minimizer.MinimizerIndex holds them and its
        on-disk cache stores them), optionally with ``k``, ``w`` and
        ``bucket_bits``; k and w default to the mode's configuration."""
        self = cls.__new__(cls)
        self._setup(genome, cfg, short_mode, arrays.get('k'),
                    arrays.get('w'))
        buckets = arrays.get('buckets')
        bits = arrays.get('bucket_bits')
        if bits is None:
            bits = (int(len(buckets) - 1).bit_length() - 1
                    if buckets is not None else 16)
        idx = MinimizerIndex(int(self.k), int(self.w),
                             np.asarray(arrays['codes']),
                             np.asarray(arrays['pos']),
                             np.asarray(arrays['strand']),
                             None if buckets is None else np.asarray(buckets),
                             int(bits))
        if (idx.k, idx.w) != (self.k, self.w):
            raise ValueError('index built for k={}, w={}, aligner wants '
                             'k={}, w={}'.format(idx.k, idx.w, self.k,
                                                 self.w))
        self.index = idx
        return self

    # ------------------------------------------------------------------
    def map(self, seq, secondary: bool = False) -> List[Hit]:
        """Hits for one read.  With secondary=True, overlapping losing
        chains are also stitched and reported with is_primary=0 after the
        primaries (mappy exposes minimap2's secondary alignments the same
        way; the pipeline itself always filters on is_primary, reference
        find_bsj.py:515,544)."""
        codes = encode_seq(seq) if isinstance(seq, str) else np.asarray(seq, np.int8)
        qlen = len(codes)
        if qlen < self.k:
            return []
        anchors = self._anchors(codes, qlen)
        # gather chains from both strands with original-coordinate query
        # extents, so non-overlapping selection can run BEFORE the (much
        # more expensive) stitching
        cands = []
        for strand, (r, q) in anchors.items():
            if len(r) == 0:
                continue
            qc = codes if strand > 0 else revcomp_encoded(codes)
            for idx, score in self._chain(r, q):
                qs, qe = int(q[idx[0]]), int(q[idx[-1]]) + self.k
                if strand < 0:
                    qs, qe = qlen - qe, qlen - qs
                cands.append((score, qs, qe, strand, r, q, idx, qc))
        return self._select_and_stitch(cands, qlen, secondary=secondary)

    # how many overlapping losing chains to stitch per read when
    # secondary hits are requested (mappy's best_n analog)
    MAX_SECONDARY = 5

    def _select_and_stitch(self, cands, qlen, secondary=False) -> List[Hit]:
        """Non-overlap chain selection by extent, then stitch survivors.

        mapq follows minimap2's uniqueness model (mm_mapq in map.c): the
        best chain score s2 among candidates masked by a primary (query
        overlap > 0.5 of the shorter extent, minimap2's mask_level)
        discounts it as 40*(1 - s2/s1), clamped to [0, 60]; a hit with no
        masked competitor keeps mapq 60.  Secondary hits (is_primary=0,
        mapq 0) are stitched only on request -- the pipeline never pays
        for them."""
        cands.sort(key=lambda c: c[0], reverse=True)
        selected: List[Hit] = []
        spans = []
        rspans = []                      # winner global-ref spans + strand
        sub_best = []                    # best masked score per primary
        sec_pool = []                    # losing candidates for secondary

        def credit(si, cand):
            """A masked candidate counts toward the winner's s2 only when
            it is a genuinely different placement -- different strand or a
            non-overlapping reference span.  Fragment chains of the SAME
            alignment must not zero the mapq of a unique hit."""
            score, qs, qe, strand, r, q, idx, qc = cand
            w_lo, w_hi, w_strand = rspans[si]
            c_lo = int(r[idx[0]])
            c_hi = int(r[idx[-1]]) + self.k
            alt = (strand != w_strand) or (min(c_hi, w_hi) <= max(c_lo, w_lo))
            if alt:
                sub_best[si] = max(sub_best[si], score)
                if secondary and len(sec_pool) < self.MAX_SECONDARY:
                    sec_pool.append(cand)

        for cand in cands:
            score, qs, qe, strand, r, q, idx, qc = cand
            if len(selected) >= MAX_HITS:
                break
            clash = -1
            for si, (s_st, s_en) in enumerate(spans):
                ov = min(qe, s_en) - max(qs, s_st)
                if ov > 0.5 * min(qe - qs, s_en - s_st):
                    clash = si
                    break
            if clash >= 0:
                credit(clash, cand)
                continue
            hit = self._stitch(r[idx], q[idx], qc, qlen, strand, score)
            if hit is None:
                continue
            # re-check with the stitched (extended) extent
            clash = -1
            for si, s in enumerate(selected):
                ov = min(hit.q_en, s.q_en) - max(hit.q_st, s.q_st)
                if ov > 0.5 * min(hit.q_en - hit.q_st, s.q_en - s.q_st):
                    clash = si
                    break
            if clash >= 0:
                credit(clash, cand)
                continue
            hit.is_primary = 1
            selected.append(hit)
            spans.append((hit.q_st, hit.q_en))
            rspans.append((int(r[idx[0]]), int(r[idx[-1]]) + self.k, strand))
            sub_best.append(0.0)
        for hit, s2 in zip(selected, sub_best):
            s1 = max(float(hit.score), 1e-9)   # _stitch stores the chain score
            hit.mapq = 60 if s2 <= 0 else max(0, min(60, int(
                40.0 * (1.0 - float(s2) / s1))))
        selected.sort(key=lambda h: h.score, reverse=True)
        if secondary:
            for score, qs, qe, strand, r, q, idx, qc in sec_pool:
                hit = self._stitch(r[idx], q[idx], qc, qlen, strand, score)
                if hit is None:
                    continue
                hit.is_primary = 0
                hit.mapq = 0
                selected.append(hit)
        return selected

    # ------------------------------------------------------------------
    @_count_dispatch('aligner.map_batch')
    def map_batch(self, seqs, max_anchors: int = 8192) -> List[List[Hit]]:
        """Batched map(): one anchor table per (read, strand) row, chained
        by the host chain core, then one native selection + stitching call
        for the whole batch.  Results match map() row for row.

        The JAX package chains on the device when its cost model says so
        (ciri_long_tpu/models/aligner.py:255-328); its GPU form is ROADMAP
        X2, so this port always takes the host route (the JAX package's
        CIRI_CHAIN_ROUTE=host)."""
        from ciri_long_tpu_torch.ops.chain import backtrack_chains

        per_read = []
        rows = []          # (read_idx, strand, r_global, q)
        for bi, seq in enumerate(seqs):
            codes = encode_seq(seq) if isinstance(seq, str) else np.asarray(seq, np.int8)
            qlen = len(codes)
            per_read.append((codes, qlen))
            if qlen < self.k:
                continue
            anchors = self._anchors(codes, qlen)
            for strand, (r, q) in anchors.items():
                if len(r) == 0:
                    continue
                rows.append((bi, strand, r[:max_anchors], q[:max_anchors]))

        results: List[List[Hit]] = [[] for _ in seqs]
        if not rows:
            return results

        chains = []
        for bi, strand, r, q in rows:
            ctg_id = np.searchsorted(self._ctg_starts, r, side='right') - 1
            f, pre = self._chain_dp(r, q, ctg_id, self.cfg.max_gap_ref, 5000)
            chains.append(backtrack_chains(
                f[None, :], pre[None, :], np.ones((1, len(r)), bool),
                self.min_chain_score, self.min_chain_anchors,
                2 * MAX_HITS)[0])

        cands_by_read = {}
        for t, (bi, strand, r, q) in enumerate(rows):
            codes, qlen = per_read[bi]
            qc = codes if strand > 0 else revcomp_encoded(codes)
            for idx, score in chains[t]:
                qs, qe = int(q[idx[0]]), int(q[idx[-1]]) + self.k
                if strand < 0:
                    qs, qe = qlen - qe, qlen - qs
                cands_by_read.setdefault(bi, []).append(
                    (score, qs, qe, strand, r, q, idx, qc))
        batched = self._select_and_stitch_batch(cands_by_read, per_read)
        if batched is not None:
            for bi, hits in batched.items():
                results[bi] = hits
        else:
            for bi, cands in cands_by_read.items():
                results[bi] = self._select_and_stitch(cands, per_read[bi][1])
        return results

    def _select_and_stitch_batch(self, cands_by_read, per_read):
        """One native call for the whole chunk's selection+stitching
        (native/nwcore.cpp::select_stitch_batch) -- removes the per-read
        Python glue of _select_and_stitch/_stitch, the dominant host cost
        of the scan stage (~19k stitch calls + wrappers at 3.1k reads).
        Byte-identical to the per-read path (tests/test_select_native.py);
        returns None to fall back when the native core is absent or the
        genome is 2-bit packed (the per-candidate window decode stays on
        the scalar path)."""
        import os
        if _SELECT_NATIVE is None or self.genome.codes is None:
            return None
        reads = list(cands_by_read)
        if not reads:
            return {}
        qoff = [0]
        qcat = []
        cand_off = [0]
        scores, qss, qes, strands = [], [], [], []
        anc_off = [0]
        anc_r, anc_q = [], []
        for bi in reads:
            codes, _qlen = per_read[bi]
            qcat.append(np.ascontiguousarray(codes, np.int8))
            qoff.append(qoff[-1] + len(codes))
            cands = cands_by_read[bi]
            cand_off.append(cand_off[-1] + len(cands))
            for score, qs, qe, strand, r, q, idx, _qc in cands:
                scores.append(float(score))
                qss.append(qs)
                qes.append(qe)
                strands.append(strand)
                anc_r.append(np.asarray(r, np.int64)[idx])
                anc_q.append(np.asarray(q, np.int64)[idx])
                anc_off.append(anc_off[-1] + len(idx))
        out = _SELECT_NATIVE(
            np.concatenate(qcat) if qcat else np.zeros(0, np.int8),
            np.asarray(qoff, np.int64),
            self.genome.codes,
            self._ctg_starts, self._ctg_lens,
            np.asarray(cand_off, np.int64),
            np.asarray(scores, np.float64),
            np.asarray(qss, np.int32), np.asarray(qes, np.int32),
            np.asarray(strands, np.int8),
            np.asarray(anc_off, np.int64),
            np.concatenate(anc_r) if anc_r else np.zeros(0, np.int64),
            np.concatenate(anc_q) if anc_q else np.zeros(0, np.int64),
            MAX_HITS, self.k, MIN_INTRON, self.SPLICE_BONUS, EXT_CAP,
            2, 4, 4, 2,
            EXT_SCORES['match'], EXT_SCORES['mismatch'],
            EXT_SCORES['gap_open'], EXT_SCORES['gap_extend'],
            EXT_SCORES['zdrop'],
            int(os.environ.get('CIRI_SELECT_THREADS', '1')))
        names = self.genome.names
        batched = {}
        for pos, bi in enumerate(reads):
            hits = []
            for (ci, strand, oq_st, oq_en, local_st, local_en1, mlen,
                 blen, score, mapq, cig) in out[pos]:
                name = names[ci]
                ops = np.frombuffer(cig, np.uint32)
                cigar = list(zip((ops >> 4).tolist(), (ops & 0xF).tolist()))
                hits.append(Hit(ctg=name, strand=strand, q_st=oq_st,
                                q_en=oq_en, r_st=local_st, r_en=local_en1,
                                mlen=mlen, blen=blen, cigar=cigar,
                                is_primary=1, score=score, mapq=mapq,
                                ctg_len=self.genome.contig_len[name]))
            batched[bi] = hits
        return batched

    # ------------------------------------------------------------------
    def _anchors(self, codes, qlen):
        qh, qpos, qstrand = minimizers(codes, self.k, self.w)
        out = {1: (np.zeros(0, np.int64), np.zeros(0, np.int64)),
               -1: (np.zeros(0, np.int64), np.zeros(0, np.int64))}
        if len(qh) == 0:
            return out
        idx = self.index
        if idx.buckets is not None:
            # one native call for the whole lookup/gather/sort cascade
            # (chaincore.cpp::py_anchors; parity fuzz in
            # tests/test_chaincore.py); numpy fallback below
            try:
                from ciri_long_tpu import _chaincore
                native = getattr(_chaincore, 'anchors', None)
            except ImportError:
                native = None
            if native is not None:
                rp, qp, rm, qm = native(
                    idx.codes, idx.buckets, idx.pos, idx.strand,
                    np.ascontiguousarray(qh, np.uint32),
                    np.ascontiguousarray(qpos, np.int64),
                    np.ascontiguousarray(qstrand, np.uint8),
                    self.k, qlen, int(self.cfg.max_occ),
                    int(idx.bucket_bits))
                out[1] = (np.frombuffer(rp, np.int64),
                          np.frombuffer(qp, np.int64))
                out[-1] = (np.frombuffer(rm, np.int64),
                           np.frombuffer(qm, np.int64))
                return out
        lo, hi = self.index.lookup(qh)
        occ = hi - lo
        keep = (occ > 0) & (occ <= self.cfg.max_occ)
        if not keep.any():
            return out
        lo, hi = lo[keep], hi[keep]
        qpos, qstrand = qpos[keep], qstrand[keep]
        counts = (hi - lo).astype(np.int64)
        total = int(counts.sum())
        # gather the variable [lo, hi) ranges in one vectorised pass:
        # idx = lo_i + (output position - start of run i)
        starts = np.cumsum(counts) - counts
        idx = (np.repeat(lo, counts)
               + np.arange(total, dtype=np.int64) - np.repeat(starts, counts))
        r_all = self.index.pos[idx]
        rs_all = self.index.strand[idx]
        q_all = np.repeat(qpos, counts)
        qs_all = np.repeat(qstrand, counts)
        same = rs_all == qs_all
        # '+' anchors
        out[1] = (r_all[same], q_all[same])
        # '-' anchors: query coordinate in revcomp space
        qf = qlen - (q_all[~same] + self.k)
        out[-1] = (r_all[~same], qf)
        for s in (1, -1):
            r, q = out[s]
            order = np.lexsort((q, r))
            out[s] = (r[order], q[order])
        return out

    # ------------------------------------------------------------------
    def _chain_dp(self, r, q, ctg_id, max_gap_r, max_gap_q):
        """Windowed chaining DP -> (f, pre).  Native C++ core when built
        (native/chaincore.cpp, the analog of minimap2's mm_chain_dp);
        numpy fallback with identical scoring otherwise."""
        n = len(r)
        k = self.k
        try:
            from ciri_long_tpu import _chaincore
        except ImportError:
            _chaincore = None
        if _chaincore is not None:
            fb, pb = _chaincore.chain(
                np.ascontiguousarray(r, np.int64),
                np.ascontiguousarray(q, np.int64),
                np.ascontiguousarray(ctg_id, np.int64),
                k, CHAIN_WINDOW, max_gap_r, max_gap_q)
            return (np.frombuffer(fb, np.float64).copy(),
                    np.frombuffer(pb, np.int64).copy())

        f = np.full(n, float(k))
        pre = np.full(n, -1, np.int64)
        for i in range(1, n):
            j0 = max(0, i - CHAIN_WINDOW)
            dr = r[i] - r[j0:i]
            dq = q[i] - q[j0:i]
            ok = (dr > 0) & (dq > 0) & (dq <= max_gap_q) & (dr <= max_gap_r) \
                & (ctg_id[j0:i] == ctg_id[i])
            if not ok.any():
                continue
            alpha = np.minimum(np.minimum(dq, dr), k).astype(float)
            g = np.abs(dr - dq).astype(float)
            # intron direction (dr > dq): log cost only -- splice preset;
            # insertion direction: linear.  Both add a penalty on long
            # anchor-FREE query distance: in a correct chain exonic
            # sequence seeds densely, so a big dq with no anchors means the
            # chain is swallowing an extra tandem copy (rolling-circle
            # reads would otherwise chain 'spirally' through successive
            # copies and masquerade as one long linear alignment).
            skip = 0.1 * np.maximum(0.0, dq - 2.0 * k)
            pen = np.where(dr >= dq,
                           np.log2(g + 1.0) + skip,
                           0.5 * g + 0.5 * np.log2(g + 1.0) + skip)
            cand = f[j0:i] + alpha - pen
            cand = np.where(ok, cand, -np.inf)
            b = int(np.argmax(cand))
            if cand[b] > f[i]:
                f[i] = cand[b]
                pre[i] = j0 + b
        return f, pre

    def _chain(self, r, q):
        """Colinear chaining with splice-tolerant gap costs; greedy chain
        extraction by descending score."""
        n = len(r)
        ctg_id = np.searchsorted(self._ctg_starts, r, side='right')
        f, pre = self._chain_dp(r, q, ctg_id, self.cfg.max_gap_ref, 5000)
        # backtrack best chains greedily
        order = np.argsort(-f, kind='stable')
        used = np.zeros(n, bool)
        chains = []
        for idx in order:
            if used[idx] or f[idx] < self.min_chain_score:
                continue
            path = []
            v = idx
            while v != -1 and not used[v]:
                path.append(v)
                used[v] = True
                v = pre[v]
            if len(path) < self.min_chain_anchors:
                continue
            path.reverse()
            chains.append((np.array(path, np.int64), float(f[idx])))
            if len(chains) >= 2 * MAX_HITS:
                break
        return chains

    # ------------------------------------------------------------------
    def _stitch(self, r, q, qc, qlen, strand, score) -> Optional[Hit]:
        """Fill inter-anchor gaps into a cigar; extend both ends.

        Dispatches to the native core (native/nwcore.cpp::stitch) when
        available -- byte-identical to _stitch_py (parity fuzz:
        tests/test_stitch_native.py); the Python path runs when the core
        is not built."""
        if _STITCH_NATIVE is not None:
            r_st0 = int(r[0])
            ctg, _ = self.genome.locate(r_st0)
            if ctg is None:
                return None
            ctg_lo = int(self.genome.offsets[ctg])
            ctg_hi = ctg_lo + int(self.genome.contig_len[ctg])
            if self.genome.codes is not None:
                gcodes, g_base = self.genome.codes, 0
            else:
                # 2-bit genome: decode just the neighbourhood the stitcher
                # can touch (inter-anchor gaps + <= EXT_CAP + 64 end
                # extension, nwcore.cpp stitch bounds) and rebase
                margin = EXT_CAP + 64 + self.k + 16
                g_base = max(ctg_lo, int(min(r)) - margin)
                g_top = min(ctg_hi, int(max(r)) + self.k + margin)
                gcodes = np.ascontiguousarray(
                    self.genome.codes_window(g_base, g_top), np.int8)
                # the margin covers every position stitch can touch, so
                # clamping the contig bound to the window is behaviour-
                # identical and keeps all native reads inside gcodes
                ctg_hi = min(ctg_hi, g_top)
            ret = _STITCH_NATIVE(
                np.ascontiguousarray(qc, np.int8),
                gcodes,
                np.ascontiguousarray(np.asarray(r, np.int64) - g_base),
                np.ascontiguousarray(np.asarray(q, np.int64)),
                self.k, ctg_lo - g_base, ctg_hi - g_base, MIN_INTRON,
                self.SPLICE_BONUS,
                EXT_CAP, 2, 4, 4, 2,
                EXT_SCORES['match'], EXT_SCORES['mismatch'],
                EXT_SCORES['gap_open'], EXT_SCORES['gap_extend'],
                EXT_SCORES['zdrop'])
            q_st, r_st, q_en, r_en, mlen, blen, cig = ret
            r_st += g_base
            r_en += g_base
            cigar = [(int(x) >> 4, int(x) & 0xF)
                     for x in np.frombuffer(cig, np.uint32)]
            ctg2, local_st = self.genome.locate(r_st)
            _, local_en = self.genome.locate(r_en - 1)
            if ctg2 != ctg:
                return None
            if strand > 0:
                oq_st, oq_en = q_st, q_en
            else:
                oq_st, oq_en = qlen - q_en, qlen - q_st
            return Hit(ctg=ctg, strand=strand, q_st=oq_st, q_en=oq_en,
                       r_st=local_st, r_en=local_en + 1, mlen=mlen,
                       blen=blen, cigar=cigar, score=score, mapq=60,
                       ctg_len=self.genome.contig_len[ctg])
        return self._stitch_py(r, q, qc, qlen, strand, score)

    def _stitch_py(self, r, q, qc, qlen, strand, score) -> Optional[Hit]:
        """Python stitcher (parity oracle for the native core)."""
        k = self.k
        gcodes = self.genome.codes
        g_base = 0
        if gcodes is None:
            # 2-bit genome: decode the reachable neighbourhood and rebase
            # the anchor positions into it (mirrors the native-path window)
            ctg0, _ = self.genome.locate(int(r[0]))
            if ctg0 is None:
                return None
            lo0 = int(self.genome.offsets[ctg0])
            hi0 = lo0 + int(self.genome.contig_len[ctg0])
            margin = EXT_CAP + 64 + k + 16
            g_base = max(lo0, int(min(r)) - margin)
            g_top = min(hi0, int(max(r)) + k + margin)
            gcodes = self.genome.codes_window(g_base, g_top)
            r = np.asarray(r, np.int64) - g_base
        cigar = []

        def emit(op, length):
            if length <= 0:
                return
            if cigar and cigar[-1][1] == op:
                cigar[-1] = (cigar[-1][0] + length, op)
            else:
                cigar.append((length, op))

        q_cur, r_cur = int(q[0]), int(r[0])
        for t in range(1, len(q)):
            if int(q[t]) <= q_cur or int(r[t]) <= r_cur:
                continue  # anchor swallowed by a widened splice window
            dq = int(q[t]) - q_cur
            dr = int(r[t]) - r_cur
            if dr - dq >= MIN_INTRON:
                # Widen the junction window past the flanking anchors:
                # splice-site sliding ambiguity means an exact k-mer anchor
                # can sit ON the junction (query '...CAG|' matches the
                # genome on both the donor and the acceptor side) and pin
                # the intron to the wrong boundary.  Trim up to k+6 bases
                # of trailing M off the emitted cigar and absorb the next
                # anchor's k-mer, then let the gapped splice aligner decide.
                back = 0
                limit = k + 6
                while cigar and cigar[-1][1] == 0 and back < limit:
                    l0, _ = cigar[-1]
                    take = min(l0, limit - back)
                    if take == l0:
                        cigar.pop()
                    else:
                        cigar[-1] = (l0 - take, 0)
                    back += take
                fwd = k
                q0, r0 = q_cur - back, r_cur - back
                q1, r1 = int(q[t]) + fwd, int(r[t]) + fwd
                sub = splice_junction_align(qc[q0:q1], gcodes[r0:r1],
                                            dr - dq, bonus=self.SPLICE_BONUS)
                for l, op in sub:
                    emit(op, l)
                q_cur, r_cur = q1, r1
                continue
            if dq == dr:
                emit(0, dq)
            elif dq == 0:
                emit(2, dr)
            elif dr == 0:
                emit(1, dq)
            else:
                _, sub = banded_global_cigar(qc[q_cur:q_cur + dq],
                                             gcodes[r_cur:r_cur + dr])
                for l, op in sub:
                    emit(op, l)
            q_cur, r_cur = int(q[t]), int(r[t])
        if q_cur <= int(q[-1]):
            tail_m = int(q[-1]) + k - q_cur
            emit(0, tail_m)
            q_cur += tail_m
            r_cur += tail_m

        q_st, r_st = int(q[0]), int(r[0])
        q_en, r_en = q_cur, r_cur

        # contig bounds (rebased coords): extensions must not cross them;
        # for windowed (2-bit) genomes the window edge is equivalent (the
        # margin covers every reachable position)
        ctg, _ = self.genome.locate(r_st + g_base)
        if ctg is None:
            return None
        ctg_lo = max(self.genome.offsets[ctg] - g_base, 0)
        ctg_hi = min(self.genome.offsets[ctg]
                     + self.genome.contig_len[ctg] - g_base, len(gcodes))

        # right extension
        tail = qc[q_en:q_en + EXT_CAP]
        ref_tail = gcodes[r_en:min(r_en + len(tail) + 64, ctg_hi)]
        if len(tail) and len(ref_tail):
            _, qi, rj, ext = extend_align(tail, ref_tail, **EXT_SCORES)
            for l, op in ext:
                emit(op, l)
            q_en += qi
            r_en += rj

        # left extension (on reversed sequences)
        head = qc[max(0, q_st - EXT_CAP):q_st][::-1]
        ref_head = gcodes[max(ctg_lo, r_st - len(head) - 64):r_st][::-1]
        if len(head) and len(ref_head):
            _, qi, rj, ext = extend_align(head, ref_head, **EXT_SCORES)
            ext.reverse()
            merged = ext + cigar
            cigar = []
            for l, op in merged:
                if cigar and cigar[-1][1] == op:
                    cigar[-1] = (cigar[-1][0] + l, op)
                else:
                    cigar.append((l, op))
            q_st -= qi
            r_st -= rj

        ctg2, local_st = self.genome.locate(r_st + g_base)
        _, local_en = self.genome.locate(r_en - 1 + g_base)
        if ctg2 != ctg:
            return None

        mlen, blen = self._count_matches(qc, gcodes, q_st, r_st, cigar)
        if strand > 0:
            oq_st, oq_en = q_st, q_en
        else:
            oq_st, oq_en = qlen - q_en, qlen - q_st
        return Hit(ctg=ctg, strand=strand, q_st=oq_st, q_en=oq_en,
                   r_st=local_st, r_en=local_en + 1, mlen=mlen, blen=blen,
                   cigar=cigar, score=score, mapq=60,
                   ctg_len=self.genome.contig_len[ctg])

    # canonical splice-motif bonus (in match units): GT..AG on the chain
    # strand or its minus-strand image CT..AC.  Without it, sequencing
    # noise can shift the intron by a few bases and the downstream
    # GT-AG concordance checks (collapse.py:817-839) reject the isoform.
    SPLICE_BONUS = 6

    @staticmethod
    def _count_matches(qc, gcodes, q_st, r_st, cigar):
        mlen = 0
        blen = 0
        qi, ri = q_st, r_st
        for l, op in cigar:
            if op == 0:
                mlen += int(np.sum(qc[qi:qi + l] == gcodes[ri:ri + l]))
                blen += l
                qi += l
                ri += l
            elif op == 1:
                qi += l
            elif op in (2, 3):
                blen += l
                ri += l
        return mlen, blen
