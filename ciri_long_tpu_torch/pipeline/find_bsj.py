"""Stage 2: back-splice junction discovery (port of
ciri_long_tpu/pipeline/find_bsj.py).

Reference behavior: find_bsj.py (scan_ccs_reads find_bsj.py:328,
recover_ccs_reads find_bsj.py:451, scan_raw_reads find_bsj.py:623, the
rotation loop find_bsj find_bsj.py:139-179, clip re-alignment
align_clip_segments find_bsj.py:182-233).

The reference's per-read SSW call over a +-200 kb genomic window (its
hottest native kernel) becomes a batched SW (ops/sw.py) on the ``device``
that every function here takes: the CUDA kernel on ``cuda``, the host core
on ``cpu``.  Everything else is host logic over Context.  With ``cuda`` the
stages run in this process; with ``cpu`` at -t > 1 they fan out over spawn
pools as in the JAX package.  The JAX package's work-steal split between
pool and device (HybridDrain, find_bsj.py:556) is not ported.

Output record format is byte-compatible with the reference
(find_bsj.py:363-366):
  >read_id  circ_id  strand  cirexons  ss_id  junc|clip-len  segments
  circ_seq
"""

import multiprocessing
import os
from collections import defaultdict

import numpy as np
import torch

from ciri_long_tpu.annot.signal import (find_annotated_signal,
                                        find_denovo_signal, find_host_gene)
from ciri_long_tpu.config import DEFAULT, CLIP_SCORE
from ciri_long_tpu.utils.logger import ProgressBar
from ciri_long_tpu.utils.seq import (encode_seq, pad_encoded, revcomp,
                                     revcomp_encoded)
from ciri_long_tpu_torch.models.hits import (get_blocks, get_parital_blocks,
                                             get_primary_alignment,
                                             merge_clip_exon, merge_exons,
                                             remove_long_insert)
from ciri_long_tpu_torch.ops.sw import (SWParams, sw_align_batch,
                                        sw_window_align_many)
from ciri_long_tpu_torch.utils.dispatch import count_dispatch as _count_dispatch

CLIP_SW = SWParams(CLIP_SCORE.match, CLIP_SCORE.mismatch,
                   CLIP_SCORE.gap_open, CLIP_SCORE.gap_extend)

_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
            65536, 131072, 262144, 524288)


def _bucket(n):
    for b in _BUCKETS:
        if n <= b:
            return b
    return n


class _SSWRes:
    __slots__ = ('score', 'query_begin', 'query_end', 'ref_begin', 'ref_end')

    def __init__(self, score, qb, qe, rb, re_):
        self.score = score
        self.query_begin = qb
        self.query_end = qe
        self.ref_begin = rb
        self.ref_end = re_


def _map_many(ctx, seqs):
    """Map a list of sequences through the aligner's batched map when it
    has one (models/aligner.py::map_batch, identical hits to map()), else
    per-read."""
    if len(seqs) > 1 and hasattr(ctx.aligner, 'map_batch'):
        return ctx.aligner.map_batch(seqs)
    return [ctx.aligner.map(s) for s in seqs]


def find_bsj_batch(ctx, ccs_list, init_hits_list=None):
    """Lockstep-batched find_bsj (reference loop find_bsj.py:139-179;
    SURVEY.md §7.3): all reads advance through the rotate+remap iteration
    together, one batched map per round, with per-read done-masks -- the
    host-orchestrated masked-while-loop over the whole batch.

    Returns per read ``(circ, junc, hits)`` where ``hits`` is the full
    map() result of the final rotation (cached from the round that aligned
    it; None when the final rotation was never aligned, i.e. the
    first-round revert to junction 0 -- callers map those themselves).
    ``init_hits_list`` optionally supplies precomputed map(ccs*2) hits
    (the scan pass already has them from its filters)."""
    n = len(ccs_list)
    results = [(None, None, None)] * n

    if init_hits_list is None:
        init_hits_list = _map_many(ctx, [s * 2 for s in ccs_list])

    state = {}
    active = []
    for i, ccs in enumerate(ccs_list):
        init_hit = get_primary_alignment(init_hits_list[i])
        if init_hit is None or not len(ccs):
            continue
        state[i] = {'junc': init_hit.q_st % len(ccs), 'last_junc': 0,
                    'last_m': 0, 'itered': {}, 'cache': {}}
        active.append(i)

    while active:
        seqs = []
        for i in active:
            st = state[i]
            ccs = ccs_list[i]
            seqs.append(ccs[st['junc']:] + ccs[:st['junc']])
        # reuse hits for rotations this read already aligned (map() is
        # deterministic, so this matches the reference's re-map exactly)
        need = [t for t, i in enumerate(active)
                if state[i]['junc'] not in state[i]['cache']]
        fresh = _map_many(ctx, [seqs[t] for t in need]) if need else []
        for t, hits in zip(need, fresh):
            st = state[active[t]]
            st['cache'][st['junc']] = hits

        next_active = []
        for i in active:
            st = state[i]
            ccs = ccs_list[i]
            hits = st['cache'][st['junc']]
            circ_hit = get_primary_alignment(hits)
            done = False
            if circ_hit is None or circ_hit.mlen <= st['last_m']:
                st['junc'] = st['last_junc']
                done = True
            else:
                st['last_m'] = circ_hit.mlen
                st['last_junc'] = st['junc']
                st_clip = circ_hit.q_st
                en_clip = len(ccs) - circ_hit.q_en
                if st_clip == 0 and en_clip == 0:
                    done = True
                else:
                    if st_clip >= en_clip:
                        new_junc = (st['junc'] + st_clip) % len(ccs)
                    else:
                        new_junc = (st['junc'] + circ_hit.q_en) % len(ccs)
                    if new_junc in st['itered']:
                        st['junc'] = st['last_junc']
                        done = True
                    else:
                        st['junc'] = new_junc
                        st['itered'][new_junc] = 1
            if done:
                junc = st['junc']
                circ = ccs[junc:] + ccs[:junc]
                results[i] = (circ, junc, st['cache'].get(junc))
            else:
                next_active.append(i)
        active = next_active
    return results


def _final_circ_hits(ctx, items):
    """Fill in map() hits for (circ, junc, hits) tuples whose final
    rotation was never aligned inside find_bsj_batch."""
    missing = [t for t, (circ, _junc, hits) in enumerate(items)
               if circ is not None and hits is None]
    if missing:
        fresh = _map_many(ctx, [items[t][0] for t in missing])
        for t, hits in zip(missing, fresh):
            items[t] = (items[t][0], items[t][1], hits)
    return items


def _clip_prepare(ctx, circ, hit, cfg=DEFAULT.call):
    """First half of align_clip_segments (find_bsj.py:182-233): decide the
    path and stage the SW operands.  Returns
      ('done', result4)                 -- no SW needed / early reject
      ('sw', clip_codes, ref_codes, meta) -- needs one SW alignment
    """
    st_clip, en_clip = hit.q_st, len(circ) - hit.q_en

    if st_clip + en_clip < 20:
        clipped_circ = circ[hit.q_st:] + circ[:hit.q_st]
        clip_base = st_clip + en_clip
        return ('done', (clipped_circ, hit.r_st - 1, hit.r_en,
                         (None, None, clip_base)))

    clip_seq = circ[hit.q_en:] + circ[:hit.q_st]
    if len(clip_seq) > 0.6 * len(circ):
        return ('done', (None, None, None, None))

    tmp_start = max(hit.r_st - cfg.clip_window, 0)
    tmp_end = min(hit.r_en + cfg.clip_window, ctx.contig_len[hit.ctg])

    window = ctx.genome.codes_of(hit.ctg, tmp_start, tmp_end)
    if np.count_nonzero(window == 4) >= cfg.max_n_frac * (tmp_end - tmp_start):
        return ('done', (None, None, None, None))

    clip_codes = encode_seq(clip_seq)
    ref_codes = window if hit.strand > 0 else revcomp_encoded(window)
    return ('sw', clip_codes, ref_codes,
            (circ, hit, clip_seq, tmp_start, tmp_end))


def _clip_finish(res, meta):
    """Second half of align_clip_segments: interpret the SW result."""
    circ, hit, clip_seq, tmp_start, tmp_end = meta
    if res.score <= 0:
        return (None, None, None, None)
    q_begin = res.query_begin
    if hit.strand > 0:
        clip_r_st = tmp_start + res.ref_begin
        clip_r_en = tmp_start + res.ref_end
        moved = clip_r_st < hit.r_st
    else:
        clip_r_st = tmp_end - res.ref_end
        clip_r_en = tmp_end - res.ref_begin
        moved = clip_r_en > hit.r_en
    if moved:
        clipped_circ = clip_seq[q_begin:] + \
            circ[hit.q_st:hit.q_en] + clip_seq[:q_begin]
    else:
        clipped_circ = circ[hit.q_st:] + circ[:hit.q_st]

    clip_base = hit.q_st + len(circ) - hit.q_en \
        - (res.query_end - res.query_begin) + 1
    circ_start = min(hit.r_st, clip_r_st) - 1
    circ_end = max(hit.r_en, clip_r_en)
    return (clipped_circ, circ_start, circ_end,
            (clip_r_st, clip_r_en, clip_base))


@_count_dispatch('clip_sw_batch')
def align_clip_segments_batch(ctx, items, cfg=DEFAULT.call, device='cpu'):
    """Clip re-alignment (reference align_clip_segments, find_bsj.py:182-233)
    over (circ, hit) pairs: all short-window SW alignments in a chunk run
    as ONE bucketed batch, all +-200 kb windows as one chunked batch
    (sw_window_align_many).  Row results equal per-read alignment -- the SW
    scorer is per-row and padding rows/lengths cannot change a row's
    outcome."""
    staged = [_clip_prepare(ctx, circ, hit, cfg) for circ, hit in items]
    out = [None] * len(items)
    sw_rows = []
    long_rows = []
    for t, st in enumerate(staged):
        if st[0] == 'done':
            out[t] = st[1]
        elif len(st[2]) > 32768:
            long_rows.append(t)
        else:
            sw_rows.append(t)

    if long_rows:
        # long (+-200 kb) windows: ALL reads' window chunks stack into one
        # cross-read SW batch (ops.sw.sw_window_align_many) -- one read's
        # ~25 chunks alone under-fill the device
        got = sw_window_align_many(
            [(staged[t][1], staged[t][2]) for t in long_rows], CLIP_SW,
            device=device)
        for t, tup in zip(long_rows, got):
            out[t] = _clip_finish(_SSWRes(*tup), staged[t][3])

    if sw_rows:
        queries = [staged[t][1] for t in sw_rows]
        refs = [staged[t][2] for t in sw_rows]
        q, _ = pad_encoded(queries,
                           max_len=_bucket(max(len(x) for x in queries)))
        r, _ = pad_encoded(refs, max_len=_bucket(max(len(x) for x in refs)))
        # bucket the batch dim too (a fresh row count = a fresh compile)
        rows = next((b for b in (4, 8, 16, 32, 64, 128, 256, 512, 1024)
                     if len(sw_rows) <= b), len(sw_rows))
        if rows > len(sw_rows):
            q = np.concatenate(
                [q, np.full((rows - q.shape[0], q.shape[1]), 5, q.dtype)])
            r = np.concatenate(
                [r, np.full((rows - r.shape[0], r.shape[1]), 5, r.dtype)])
        res = sw_align_batch(q, r, CLIP_SW, device)
        score, qb, qe, rb, re_ = res
        for bi, t in enumerate(sw_rows):
            row = _SSWRes(int(score[bi]), int(qb[bi]), int(qe[bi]),
                          int(rb[bi]), int(re_[bi]))
            out[t] = _clip_finish(row, staged[t][3])
    return out


def _call_circ_from_hit(ctx, read_id, segments, junc, circ, circ_hit,
                        reads_cnt, cfg, clip_res):
    """Shared tail of the CCS scan passes: splice-signal correction,
    cirexon string, output record (find_bsj.py:275-323).  ``clip_res`` is
    the read's align_clip_segments_batch row."""
    clipped_circ, circ_start, circ_end, clip_info = clip_res
    if circ_start is None or circ_end is None:
        return None

    clip_base = clip_info[2]
    # clip-base acceptance (find_bsj.py:280; |circ| == |ccs|)
    if clip_base > cfg.clip_frac * len(circ) or clip_base > cfg.clip_max:
        return None

    reads_cnt['bsj'] += 1

    host_strand = find_host_gene(ctx, circ_hit.ctg, circ_start, circ_end)
    ss_site, us_free, ds_free, tmp_signal = find_annotated_signal(
        ctx, circ_hit.ctg, circ_start, circ_end, clip_base, clip_base + 10)
    if ss_site is None:
        ss_site = find_denovo_signal(
            ctx, circ_hit.ctg, circ_start, circ_end, host_strand, tmp_signal,
            us_free, ds_free, clip_base, clip_base + 10, 3, True)

    if ss_site is None:
        ss_id = 'NA'
        strand = 'NA'
        correction_shift = 0
    else:
        reads_cnt['signal'] += 1
        ss_id, strand, us_shift, ds_shift = ss_site
        circ_start += us_shift
        circ_end += ds_shift
        correction_shift = min(max(us_shift, us_free), ds_free)

    circ_id = '{}:{}-{}'.format(circ_hit.ctg, circ_start + 1, circ_end)

    cir_exons = get_blocks(circ_hit)
    cir_exons = merge_clip_exon(cir_exons, clip_info)
    cir_exons[0][0] = circ_start
    cir_exons[-1][1] = circ_end

    cir_exon_tag = ','.join(
        '{}-{}|{}'.format(st + 1, en, length) for st, en, length in cir_exons)

    circ_seq = clipped_circ if circ_hit.strand > 0 else revcomp(clipped_circ)
    circ_seq = circ_seq[correction_shift:] + circ_seq[:correction_shift]

    return (read_id, circ_id, strand, cir_exon_tag, ss_id,
            '{}|{}-{}'.format(junc, clip_base, len(circ)), segments, circ_seq)


def scan_ccs_chunk(ctx, chunk, is_canonical, cfg=DEFAULT.call,
                   device='cpu'):
    """Per-read CCS scan (find_bsj.py:236-325), batch-first: the two
    filter alignments run as whole-chunk batched maps, and the iterative
    BSJ rotation runs in lockstep over all surviving reads
    (find_bsj_batch) -- one device chaining program per rotation round
    instead of 3-5 map() dispatches per read."""
    reads_cnt = defaultdict(int)
    ret = []
    short_reads = []

    # one combined batched map for both filter alignments (raw read and
    # doubled CCS): map_batch is per-row exact, so fusing the lists only
    # merges device dispatches, never changes a row's hits
    both = _map_many(ctx, [c[3] for c in chunk] + [c[2] * 2 for c in chunk])
    raw_hits_all, ccs2_hits_all = both[:len(chunk)], both[len(chunk):]

    survivors = []
    for ci, (read_id, segments, ccs, raw) in enumerate(chunk):
        # Filter 1: linearly-mapped raw reads (find_bsj.py:243-246)
        raw_hit = get_primary_alignment(raw_hits_all[ci])
        if raw_hit and raw_hit.mlen > max(len(raw) * cfg.linear_frac,
                                          len(raw) - cfg.linear_margin):
            continue
        if raw_hit and raw_hit.mlen > cfg.linear_vs_ccs * len(ccs):
            continue

        raw_st = raw_hit.q_st if raw_hit else None
        raw_en = raw_hit.q_en if raw_hit else None
        reads_cnt['raw_unmapped'] += 1

        # Filter 2: mapped region disjoint from the repeat span
        seg_st = int(segments.split(';')[0].split('-')[0])
        seg_en = int(segments.split(';')[-1].split('-')[1])
        if raw_hit and (raw_en < seg_st or raw_st > seg_en):
            continue

        ccs_hit = get_primary_alignment(ccs2_hits_all[ci])
        if ccs_hit is None and len(ccs) < cfg.short_ccs_len:
            short_reads.append((read_id, segments, ccs, raw))
        if ccs_hit is None or seg_en - seg_st < ccs_hit.q_en - ccs_hit.q_st:
            continue

        reads_cnt['ccs_mapped'] += 1
        survivors.append(ci)

    bsj = find_bsj_batch(ctx, [chunk[ci][2] for ci in survivors],
                         [ccs2_hits_all[ci] for ci in survivors])
    bsj = _final_circ_hits(ctx, bsj)

    final = []
    for ci, (circ, junc, circ_hits) in zip(survivors, bsj):
        if circ is None:
            continue
        circ_hit = get_primary_alignment(circ_hits)
        if circ_hit is None or circ_hit.mlen < cfg.circ_mlen_frac * len(circ):
            continue
        final.append((ci, circ, junc, circ_hit))

    clips = align_clip_segments_batch(
        ctx, [(circ, hit) for _, circ, _, hit in final], cfg, device)
    for (ci, circ, junc, circ_hit), clip_res in zip(final, clips):
        read_id, segments, ccs, raw = chunk[ci]
        rec = _call_circ_from_hit(ctx, read_id, segments, junc, circ,
                                  circ_hit, reads_cnt, cfg,
                                  clip_res=clip_res)
        if rec is not None:
            ret.append(rec)

    return reads_cnt, short_reads, ret


_WORKER_CTX = None


def _scan_worker_init(ref_fasta, idx_file, short_mode=False,
                      index_cache=None):
    """Spawn-pool initializer (``--device cpu`` at -t > 1): build a
    per-worker Context from file paths in a clean interpreter.
    ``short_mode`` selects the denser short-read index for the recovery
    pass (reference BWA ont2d, find_bsj.py:457)."""
    global _WORKER_CTX
    import pickle

    from ciri_long_tpu.context import Context
    from ciri_long_tpu.io.genome import Genome
    from ciri_long_tpu_torch.models.aligner import GenomeAligner

    genome = None
    if index_cache:
        # companion packed-genome cache lives next to the index caches
        gdir = os.path.join(os.path.dirname(index_cache), 'gcodes')
        genome = Genome.from_cache(gdir, ref_fasta)
    if genome is None:
        genome = Genome(ref_fasta)
    aligner = GenomeAligner(genome, short_mode=short_mode,
                            index_cache=index_cache)
    gtf_idx = intron_idx = ss_idx = None
    if idx_file and os.path.exists(idx_file):
        with open(idx_file, 'rb') as f:
            gtf_idx, intron_idx, ss_idx = pickle.load(f)
    _WORKER_CTX = Context(aligner=aligner, genome=genome, gtf_index=gtf_idx,
                          intron_index=intron_idx, ss_index=ss_idx)


def _spawn_pool(n, ref_fasta, idx_file, short_mode, index_cache):
    ctx_mp = multiprocessing.get_context('spawn')
    return ctx_mp.Pool(n, _scan_worker_init,
                       (ref_fasta, idx_file, short_mode, index_cache))


def _pooled(threads, device, ref_fasta):
    """Whether a stage may fan out over a host worker pool: only on the
    CPU (CUDA stages run in this process) with threads > 1."""
    return (threads > 1 and ref_fasta is not None
            and torch.device(device).type == 'cpu')


def _scan_worker_chunk(payload):
    chunk, is_canonical, cfg = payload
    return scan_ccs_chunk(_WORKER_CTX, chunk, is_canonical, cfg)


def scan_ccs_reads(ctx, ccs_seq, is_canonical, out_dir, prefix,
                   cfg=DEFAULT.call, threads=1, ref_fasta=None,
                   idx_file=None, index_cache=None, device='cpu'):
    """Scan all CCS reads, write {prefix}.cand_circ.fa
    (find_bsj.py:328-372).

    Resume is batch-granular (SURVEY.md §5): every finished chunk appends a
    JSONL record (counters, short-read ids, output byte offset) to
    tmp/{prefix}.scan.progress; a rerun over the same input skips finished
    chunks after truncating any partial chunk's output.

    On the CPU, threads > 1 (with ref_fasta given) fans pending chunks over
    a SPAWN pool -- each worker builds its own Context in a clean
    interpreter; results are consumed in submission order so the output
    file and resume manifest are byte-identical to a serial run.  NOTE:
    spawn re-imports __main__, so scripts that call the pipeline directly
    need the standard ``if __name__ == '__main__':`` guard."""
    import json
    import zlib

    prog = ProgressBar()
    reads_count = defaultdict(int)
    short_reads = []

    items = [[rid] + ccs_seq[rid] for rid in ccs_seq]
    id_hash = zlib.crc32('\n'.join(ccs_seq).encode())
    cand_path = '{}/{}.cand_circ.fa'.format(out_dir, prefix)
    manifest_path = '{}/tmp/{}.scan.progress'.format(out_dir, prefix)

    # --- resume bookkeeping ---
    done_chunks = {}
    resume_bytes = 0
    try:
        with open(manifest_path) as mf:
            head = json.loads(mf.readline())
            if head.get('hash') == id_hash and os.path.exists(cand_path):
                for line in mf:
                    rec = json.loads(line)
                    done_chunks[rec['chunk']] = rec
                if done_chunks:
                    resume_bytes = max(r['cand_bytes']
                                       for r in done_chunks.values())
            else:
                done_chunks = {}
    except (OSError, ValueError):
        done_chunks = {}

    if done_chunks and os.path.getsize(cand_path) >= resume_bytes:
        with open(cand_path, 'r+') as f:
            f.truncate(resume_bytes)
        out = open(cand_path, 'a')
        manifest = open(manifest_path, 'a')
    else:
        done_chunks = {}
        out = open(cand_path, 'w')
        os.makedirs(os.path.dirname(manifest_path), exist_ok=True)
        manifest = open(manifest_path, 'w')
        manifest.write(json.dumps({'hash': id_hash, 'n': len(items)}) + '\n')
        manifest.flush()

    all_chunks = [(ci, items[i:i + cfg.ccs_chunk_size]) for ci, i in
                  enumerate(range(0, len(items), cfg.ccs_chunk_size))]
    pending = [(ci, chunk) for ci, chunk in all_chunks
               if ci not in done_chunks]

    pool = result_iter = None
    if _pooled(threads, device, ref_fasta) and len(pending) > 1:
        pool = _spawn_pool(min(threads, len(pending)), ref_fasta, idx_file,
                           False, index_cache)
        result_iter = pool.imap(_scan_worker_chunk,
                                [(chunk, is_canonical, cfg)
                                 for _, chunk in pending])

    done = 0
    short_by_id = {it[0]: it for it in items}
    try:
        with out, manifest:
            for ci, chunk in all_chunks:
                if ci in done_chunks:
                    rec = done_chunks[ci]
                    for key, value in rec['counts'].items():
                        reads_count[key] += value
                    short_reads += [tuple(short_by_id[rid]) for rid in
                                    rec['short_ids'] if rid in short_by_id]
                    done += len(chunk)
                    continue
                if result_iter is not None:
                    tmp_cnt, tmp_short, ret = next(result_iter)
                else:
                    tmp_cnt, tmp_short, ret = scan_ccs_chunk(
                        ctx, chunk, is_canonical, cfg, device)
                for key, value in tmp_cnt.items():
                    reads_count[key] += value
                short_reads += tmp_short
                for rec in ret:
                    out.write('>{}\t{}\t{}\t{}\t{}\t{}\t{}\n{}\n'.format(*rec))
                out.flush()
                manifest.write(json.dumps({
                    'chunk': ci, 'counts': dict(tmp_cnt),
                    'short_ids': [s[0] for s in tmp_short],
                    'cand_bytes': out.tell()}) + '\n')
                manifest.flush()
                done += len(chunk)
                prog.update(100 * done // max(1, len(items)))
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    prog.update(100)
    return reads_count, short_reads


def recover_ccs_chunk(ctx, chunk, is_canonical, cfg=DEFAULT.call,
                      device='cpu'):
    """Short-CCS recovery pass (find_bsj.py:375-448): same logic minus the
    raw-read filters, using the short-read aligner in ctx."""
    reads_cnt = defaultdict(int)
    ret = []

    ccs2_hits_all = _map_many(ctx, [c[2] * 2 for c in chunk])

    survivors = []
    for ci, (read_id, segments, ccs, raw) in enumerate(chunk):
        seg_st = int(segments.split(';')[0].split('-')[0])
        seg_en = int(segments.split(';')[-1].split('-')[1])

        ccs_hit = get_primary_alignment(ccs2_hits_all[ci])
        if ccs_hit is None or seg_en - seg_st < ccs_hit.q_en - ccs_hit.q_st:
            continue

        reads_cnt['ccs_mapped'] += 1
        survivors.append(ci)

    bsj = find_bsj_batch(ctx, [chunk[ci][2] for ci in survivors],
                         [ccs2_hits_all[ci] for ci in survivors])
    bsj = _final_circ_hits(ctx, bsj)

    final = []
    for ci, (circ, junc, circ_hits) in zip(survivors, bsj):
        if circ is None:
            continue
        circ_hit = get_primary_alignment(circ_hits)
        if circ_hit is None:
            continue
        final.append((ci, circ, junc, circ_hit))

    clips = align_clip_segments_batch(
        ctx, [(circ, hit) for _, circ, _, hit in final], cfg, device)
    for (ci, circ, junc, circ_hit), clip_res in zip(final, clips):
        read_id, segments, ccs, raw = chunk[ci]
        rec = _call_circ_from_hit(ctx, read_id, segments, junc, circ,
                                  circ_hit, reads_cnt, cfg,
                                  clip_res=clip_res)
        if rec is not None:
            ret.append(rec)

    return reads_cnt, ret


def _recover_worker_chunk(payload):
    chunk, is_canonical, cfg = payload
    return recover_ccs_chunk(_WORKER_CTX, chunk, is_canonical, cfg)


def recover_ccs_reads(ctx, short_reads, is_canonical, out_dir, prefix,
                      cfg=DEFAULT.call, threads=1, ref_fasta=None,
                      idx_file=None, index_cache=None, device='cpu'):
    """Recovery pass over the short reads; appends to {prefix}.cand_circ.fa
    (find_bsj.py:451-490).  On the CPU, threads > 1 fans chunks over a
    spawn pool like the scan pass (the reference pools this pass at
    find_bsj.py:462); workers build a short-mode aligner index.  Results
    drain in submission order, so the output bytes match a serial run."""
    prog = ProgressBar()
    prog.update(0)
    reads_count = defaultdict(int)

    chunks = [short_reads[i:i + cfg.ccs_chunk_size]
              for i in range(0, len(short_reads), cfg.ccs_chunk_size)]

    pool = result_iter = None
    if _pooled(threads, device, ref_fasta) and len(chunks) > 1:
        pool = _spawn_pool(min(threads, len(chunks)), ref_fasta, idx_file,
                           True, index_cache)
        result_iter = pool.imap(_recover_worker_chunk,
                                [(c, is_canonical, cfg) for c in chunks])

    n_done = 0
    try:
        with open('{}/{}.cand_circ.fa'.format(out_dir, prefix), 'a') as out:
            for ci, chunk in enumerate(chunks):
                if result_iter is not None:
                    tmp_cnt, ret = next(result_iter)
                else:
                    tmp_cnt, ret = recover_ccs_chunk(ctx, chunk,
                                                     is_canonical, cfg,
                                                     device)
                for key, value in tmp_cnt.items():
                    reads_count[key] += value
                for rec in ret:
                    out.write('>{}\t{}\t{}\t{}\t{}\t{}\t{}\n{}\n'.format(*rec))
                n_done += len(chunk)
                prog.update(100 * n_done // max(1, len(short_reads)))
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    prog.update(100)
    return reads_count


def scan_raw_chunk(ctx, chunk, is_canonical, circ_reads, cfg=DEFAULT.call):
    """Partial-BSJ scan over raw reads without a CCS (find_bsj.py:499-620),
    batch-first: the whole-chunk raw maps, the lockstep BSJ rotation and
    the final circular re-maps each run as one batched device program."""
    reads_cnt = defaultdict(int)
    ret = []
    short_reads = []

    todo = []
    for read_id, seq in chunk:
        if read_id in circ_reads:
            continue
        if len(seq) < cfg.min_raw_len:
            short_reads.append((read_id, seq))
            continue
        todo.append((read_id, seq))

    raw_maps = _map_many(ctx, [seq for _, seq in todo])

    # geometry gate (1-hit / 2-hit chimera checks) -> which reads need the
    # rotation loop, and the head/tail context their junction checks use
    pending = []        # (read_id, seq, raw_hits, head_tail or None)
    for (read_id, seq), hits in zip(todo, raw_maps):
        raw_hits = sorted([i for i in hits if i.is_primary],
                          key=lambda x: [x.q_st, x.q_en])
        if len(raw_hits) == 1:
            raw_hit = remove_long_insert(raw_hits[0])
            if raw_hit.mlen < len(seq) * .45 or raw_hit.mlen > len(seq) - 50:
                continue
            if raw_hit.q_st < 50 and raw_hit.q_en > len(seq) - 50:
                continue
            # the circ-vs-raw mlen comparison below uses the PRISTINE hits
            # (reference find_bsj.py:553 reads raw_hits, not the split)
            pending.append((read_id, seq, raw_hits, None))
        elif len(raw_hits) == 2:
            head, tail = remove_long_insert(raw_hits[0]), \
                remove_long_insert(raw_hits[1])
            if head.ctg != tail.ctg:
                continue
            if not head.q_st + head.mlen * 0.45 < tail.q_st:
                continue
            if head.r_en - 20 < tail.r_st:
                continue
            if head.q_en < tail.q_st - 50:
                continue
            pending.append((read_id, seq, raw_hits, (head, tail)))

    bsj = find_bsj_batch(ctx, [seq for _, seq, _, _ in pending])
    bsj = _final_circ_hits(ctx, bsj)

    for (read_id, seq, raw_hits, head_tail), (circ, junc, circ_maps) \
            in zip(pending, bsj):
        if junc is None:
            continue
        if head_tail is not None:
            head, tail = head_tail
            if junc < head.q_en - 10 or junc > tail.q_st + 10:
                continue

        circ_hits = sorted([remove_long_insert(i) for i in circ_maps
                            if i.is_primary], key=lambda x: [x.q_st, x.q_en])
        if len(circ_hits) == 0:
            continue
        elif len(circ_hits) == 1:
            circ_hit = circ_hits[0]
            if circ_hit.mlen <= max([i.mlen for i in raw_hits]):
                continue
            if min(junc, len(seq) - junc) < 30:
                continue
            if not junc + circ_hit.q_st < len(seq) < junc + circ_hit.q_en:
                continue
            circ_ctg, circ_start, circ_end, circ_strand = \
                circ_hit.ctg, circ_hit.r_st, circ_hit.r_en, circ_hit.strand
            clip_base = circ_hit.q_st + len(seq) - circ_hit.q_en
            cir_exons = get_parital_blocks(circ_hit, len(seq) - junc)
        elif len(circ_hits) == 2:
            head, tail = circ_hits[0], circ_hits[1]
            if head.ctg != tail.ctg or head.strand != tail.strand:
                continue
            if not head.q_st + (head.q_en - head.q_st) * 0.5 < tail.q_st:
                continue
            if head.r_en - 20 < tail.r_st:
                continue
            if head.q_en < tail.q_st - 20:
                continue
            circ_ctg, circ_start, circ_end, circ_strand = \
                head.ctg, tail.r_st, head.r_en, head.strand
            clip_base = abs(tail.q_st - head.q_en)

            head_exons = get_blocks(head)
            tail_exons = get_blocks(tail)
            cir_exons = merge_exons(tail_exons, head_exons)
            circ = circ[tail.q_st:] + circ[:tail.q_st]
        else:
            continue

        if clip_base > cfg.clip_max:
            continue

        host_strand = find_host_gene(ctx, circ_ctg, circ_start, circ_end)
        ss_site, us_free, ds_free, tmp_signal = find_annotated_signal(
            ctx, circ_ctg, circ_start, circ_end, clip_base, clip_base + 10)
        if ss_site is None:
            ss_site = find_denovo_signal(
                ctx, circ_ctg, circ_start, circ_end, host_strand, tmp_signal,
                us_free, ds_free, clip_base, clip_base + 10, 3, True)

        if ss_site is None:
            strand = 'NA'
            ss_id = 'NA'
            correction_shift = 0
        else:
            ss_id, strand, us_shift, ds_shift = ss_site
            circ_start += us_shift
            circ_end += ds_shift
            correction_shift = min(max(us_shift, -us_free), ds_free)

        circ_id = '{}:{}-{}'.format(circ_ctg, circ_start + 1, circ_end)
        cir_exons[0][0] = circ_start
        cir_exons[-1][1] = circ_end

        cir_exon_tag = ','.join(
            '{}-{}|{}'.format(st, en, length) for st, en, length in cir_exons)

        circ_seq = circ if circ_strand > 0 else revcomp(circ)
        circ_seq = circ_seq[correction_shift:] + circ_seq[:correction_shift]

        ret.append((read_id, circ_id, strand, cir_exon_tag, ss_id,
                    '{}|{}-NA'.format(junc, clip_base), 'partial', circ_seq))
        reads_cnt['partial'] += 1

    return reads_cnt, ret, short_reads


def _raw_worker_chunk(payload):
    chunk, is_canonical, circ_reads, cfg = payload
    return scan_raw_chunk(_WORKER_CTX, chunk, is_canonical, circ_reads, cfg)


def scan_raw_reads(ctx, in_file, is_canonical, out_dir, prefix,
                   cfg=DEFAULT.call, threads=1, ref_fasta=None,
                   idx_file=None, index_cache=None, device='cpu'):
    """Partial-read pass over the raw reads; writes
    {prefix}.low_confidence.fa (find_bsj.py:623-718).  On the CPU,
    threads > 1 uses the same
    spawn-pool pattern as scan_ccs_reads (the reference pools this pass
    too, find_bsj.py:662); results drain in submission order.  The pass
    aligns with the host aligner only (no SW), so ``device`` only decides
    whether a pool may be used."""
    from ciri_long_tpu.io.fastx import read_fastx

    circ_reads = {}
    with open('{}/{}.cand_circ.fa'.format(out_dir, prefix), 'r') as f:
        for line in f:
            circ_reads[line.rstrip().split()[0].lstrip('>')] = 1
            f.readline()

    prog = ProgressBar()
    prog.update(0)
    reads_cnt = defaultdict(int)
    short_reads = []

    items = list(read_fastx(in_file))
    chunks = [items[i:i + cfg.raw_chunk_size]
              for i in range(0, len(items), cfg.raw_chunk_size)]

    # spawn cost (~3 s/worker for interpreter + genome + index) only
    # pays off with several chunks of raw work per worker
    pool = result_iter = None
    if _pooled(threads, device, ref_fasta) and len(chunks) >= 2 * threads:
        pool = _spawn_pool(min(threads, len(chunks)), ref_fasta, idx_file,
                           False, index_cache)
        result_iter = pool.imap(_raw_worker_chunk,
                                [(c, is_canonical, circ_reads, cfg)
                                 for c in chunks])

    n_done = 0
    try:
        with open('{}/{}.low_confidence.fa'.format(out_dir, prefix),
                  'w') as out:
            for ci, chunk in enumerate(chunks):
                if result_iter is not None:
                    tmp_cnt, tmp_ret, tmp_short = next(result_iter)
                else:
                    tmp_cnt, tmp_ret, tmp_short = scan_raw_chunk(
                        ctx, chunk, is_canonical, circ_reads, cfg)
                for key, value in tmp_cnt.items():
                    reads_cnt[key] += value
                short_reads += tmp_short
                for rec in tmp_ret:
                    out.write('>{}\t{}\t{}\t{}\t{}\t{}\t{}\n{}\n'.format(*rec))
                n_done += len(chunk)
                prog.update(min(99, 100 * n_done // max(1, len(items))))
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
    prog.update(100)
    return reads_cnt, short_reads
