"""Stage `collapse`: cluster per-read BSJ calls into circRNA loci, polish
junctions, reconstruct isoforms, emit expression matrices.

Port of ``ciri_long_tpu/pipeline/collapse.py``.  Reference behavior:
collapse.py (cluster_reads :74, correct_cluster :235, curate_junction :161,
cluster_sequence :458, curate_cirexons :557, merge_isoforms :709,
cal_exp_mtx :903).

The device is passed explicitly, from ``correct_reads`` down to every SW,
edit-distance, traceback and sub-cluster POA call:
  * ``cuda``: clusters run on a pool of DEVICE_THREADS threads; their SW
    and edit-distance jobs, ragged row views over shared code buffers
    (ops/rows.py), fuse across clusters through one DeviceFuser
    (parallel/fuser.py), each fused round one native call of
    csrc/sw_score_ends.cu or csrc/edit_distance.cu; the rotation step
    launches csrc/sw_traceback.cu once per cluster; the sub-cluster
    consensus of ``cluster_sequence`` runs its alignments on the card
    (ops/poa.py::poa_consensus_many: csrc/poa_align.cu, one launch a round
    from host C++ on the calling thread's own stream); the junction
    consensus of ``correct_cluster`` stays a host ``poa`` call.  With
    threads > 1 a spawn pool of host workers takes chunks of clusters from
    the front while DEVICE_THREADS stealer threads take them from the back
    (parallel/hybrid.py::HybridDrain), every stealer's SW and edit jobs
    fused through ONE shared DeviceFuser.
  * ``cpu``: the native host cores, clusters on host threads when the mean
    cluster holds >= 100 reads, and with threads > 1 a spawn pool of host
    workers.
Either way the output is byte-identical to the JAX package's.

Accounting (utils/dispatch.py): each cluster is the span
``collapse.cluster`` on its thread, split into the states ``fuser.wait``,
``poa.rounds``, ``collapse.junction_poa``, ``collapse.rotation_tb`` and the
rest, ``collapse.cluster_host``; a pooled chunk adds the thread-seconds its
pool left idle to ``pool.tail_thread_s``.

Batched hot paths (SURVEY.md §7):
  * curate_junction -- the reference's hottest loop (~2500 SSW calls per
    cluster, collapse.py:161-173) becomes ONE batched [pairs] SW plus one
    batched edit-distance call.
  * head-anchor / template / junction scoring SSW calls are batched per
    cluster instead of per read.
  * the pairwise HPC distance matrix (collapse.py:467-473) is one batched
    edit-distance call over all i<j pairs.

Deliberate, documented deviations from the reference:
  * collapse.py:377 samples clusters > 200 reads with random.sample; we
    keep the 200 longest reads (deterministic, multi-host reproducible --
    SURVEY.md §7 'hard parts').
  * collapse.py:295-299 resets circ_type to None after the annotated pass
    sets it (an upstream counter bug); we keep the assignment so the
    Annotated/Denovo counters are truthful.
"""

import logging
import os
import time
from collections import Counter, defaultdict, namedtuple
from pathlib import Path

import numpy as np

from ciri_long_tpu_torch.annot.signal import (equivalent_seq,
                                              find_annotated_signal,
                                              find_denovo_signal,
                                              find_host_gene,
                                              find_overlap_exons,
                                              find_retained_introns)
from ciri_long_tpu_torch.config import DEFAULT, JUNC_SCORE
from ciri_long_tpu_torch.models.hits import find_alignment_pos
from ciri_long_tpu_torch.ops.edit import edit_distance_rows
from ciri_long_tpu_torch.ops.poa import poa, poa_consensus_many
from ciri_long_tpu_torch.ops.rows import (Rows, concat_rows, encoded_rows,
                                          repeat_row, rows_of)
from ciri_long_tpu_torch.ops.sw import (ROW_PHASES, SWParams, SWResult,
                                        sw_align_rows)
from ciri_long_tpu_torch.ops.sw_tb_batch import sw_traceback_batch
from ciri_long_tpu_torch.ops.traceback import cigar_to_string
from ciri_long_tpu_torch.parallel.fuser import DeviceFuser, current_fuser
from ciri_long_tpu_torch.parallel.hybrid import HybridDrain
from ciri_long_tpu_torch.utils.dispatch import (count, counters,
                                                resolve_device, span, state)
from ciri_long_tpu_torch.utils.logger import ProgressBar
from ciri_long_tpu_torch.utils.misc import (flatten, grouper,
                                            min_sorted_items, pairwise)
from ciri_long_tpu_torch.utils.seq import (compress_seq, encode_seq,
                                           get_junc_seq, revcomp,
                                           revcomp_encoded, transform_seq)

LOGGER = logging.getLogger('CIRI-long')

# typenames match the attribute names: the spawn pool pickles READs;
# the aliases load a corrected.pkl pickled under the names before the
# rename (ciri_long_tpu.pipeline.collapse.Read / .Circ, through
# annot/gtf.py::_PortUnpickler)
READ = namedtuple('READ', 'read_id circ_id strand cirexon ss clip segments seq sample type')
CIRC = namedtuple('CIRC', 'contig start end strand')
Read = READ
Circ = CIRC

JUNC_SW = SWParams(JUNC_SCORE.match, JUNC_SCORE.mismatch,
                   JUNC_SCORE.gap_open, JUNC_SCORE.gap_extend)

# clusters in flight on the cuda route: enough that their chains of small
# SW/edit calls fuse into few rounds
DEVICE_THREADS = 16


def _sw_rows(q, r, params=JUNC_SW, device='cuda'):
    """Batched SW of the row pairs (q[k], r[k]) of two ops/rows.py::Rows;
    returns SWResult.  On a registered fuser worker thread
    (parallel/fuser.py) the job is FUSED with every other cluster's pending
    SW into one round (on the fuser's device); otherwise it is a round of
    its own on ``device``, through the same executor."""
    fuser = current_fuser()
    if fuser is not None:
        return fuser.call('sw', (q, r, params))
    return _fused_sw([(q, r, params)], device)[0]


def _count_round(kind, rows, phases):
    """A native round of ``kind``: fuser.native.<kind>, its rows and the
    ns of its phases (fuser.ns.<phase>)."""
    count('fuser.native.' + kind)
    count('fuser.rows.' + kind, rows)
    for name, ns in phases.items():
        count('fuser.ns.' + name, ns)


def _fused_sw(jobs, device='cuda'):
    """Fused executor: the (q, r, params) jobs of a round, each two Rows,
    joined over one pair of code buffers (a few numpy calls a job, none a
    row) and run by ops/sw.py::sw_align_rows (on the card one native call
    on the device's staging; its rows grouped by length rungs), the
    answers sliced back per job.  Row independence and padding invariance keep fused
    results bit-identical to per-job calls.  A round on the card is counted
    (_count_round)."""
    device = resolve_device(device)
    phases = dict.fromkeys(ROW_PHASES, 0)
    t0 = time.perf_counter_ns()
    params = list(dict.fromkeys(p for _, _, p in jobs))
    n = np.fromiter((len(q.lens) for q, _, _ in jobs), np.int64, len(jobs))
    pid = np.repeat(np.fromiter((params.index(p) for _, _, p in jobs),
                                np.int64, len(jobs)), n)
    q = concat_rows([job[0] for job in jobs])
    r = concat_rows([job[1] for job in jobs])
    phases['pack'] += time.perf_counter_ns() - t0
    res = sw_align_rows(q, r, pid, params, device, phases)
    t1 = time.perf_counter_ns()
    cuts = np.r_[0, np.cumsum(n)].tolist()
    out = [SWResult(*res[:, a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    phases['unpack'] += time.perf_counter_ns() - t1
    if device.type == 'cuda':
        _count_round('sw', len(q.lens), phases)
    return out


def _edit_rows(a, b, device='cuda'):
    """Batched edit distances of the row pairs (a[k], b[k]) of two Rows;
    fused across clusters like _sw_rows."""
    fuser = current_fuser()
    if fuser is not None:
        return fuser.call('edit', (a, b))
    return _fused_edit([(a, b)], device)[0]


def _fused_edit(jobs, device='cuda'):
    """Fused executor of (a, b) Rows jobs, as _fused_sw: one
    ops/edit.py::edit_distance_rows round, sliced back per job."""
    device = resolve_device(device)
    phases = dict.fromkeys(ROW_PHASES, 0)
    t0 = time.perf_counter_ns()
    n = np.fromiter((len(a.lens) for a, _ in jobs), np.int64, len(jobs))
    a = concat_rows([job[0] for job in jobs])
    b = concat_rows([job[1] for job in jobs])
    phases['pack'] += time.perf_counter_ns() - t0
    d = edit_distance_rows(a, b, device, phases)
    t1 = time.perf_counter_ns()
    cuts = np.r_[0, np.cumsum(n)].tolist()
    out = [d[x:y] for x, y in zip(cuts[:-1], cuts[1:])]
    phases['unpack'] += time.perf_counter_ns() - t1
    if device.type == 'cuda':
        _count_round('edit', len(a.lens), phases)
    return out


class Segment(object):
    def __init__(self, start, end):
        self.start = start
        self.end = end

    def __str__(self):
        return '{}-{}'.format(self.start, self.end)


class Exon(Segment):
    def __init__(self, start, end):
        self.start = int(start)
        self.end = int(end)


def load_cand_circ(in_file):
    """Load cand_circ.fa + sibling low_confidence.fa for every sample in
    the input list (collapse.py:37-71)."""
    sample_attr = {}
    with open(in_file, 'r') as f:
        for line in f:
            content = line.rstrip().split()
            if content:
                sample, fname = content
                sample_attr[sample] = fname

    cand_reads = {}
    for sample, fname in sample_attr.items():
        cand_circ = Path(fname)
        with open(cand_circ, 'r') as f:
            for line in f:
                content = line.rstrip().lstrip('>').split('\t')
                clip_base = int(content[5].split('|')[1].split('-')[0])
                seq = f.readline().rstrip()
                if clip_base > 20:
                    continue
                cand_reads[content[0]] = READ(*content, seq, sample, 'full')

        prefix = cand_circ.name.split('.')[0]
        low_conf = cand_circ.parent / (prefix + '.low_confidence.fa')
        if low_conf.exists():
            with open(low_conf) as f:
                for line in f:
                    content = line.rstrip().lstrip('>').split('\t')
                    clip_base = int(content[5].split('|')[1].split('-')[0])
                    seq = f.readline().rstrip()
                    if clip_base > 20:
                        continue
                    cand_reads[content[0]] = READ(*content, seq, sample, 'partial')

    return cand_reads


def cluster_reads(cand_reads, cfg=DEFAULT.collapse):
    """BSJ clustering with 20 bp tolerance over 500 bp bins
    (collapse.py:74-149)."""
    import re
    from operator import itemgetter

    circ_reads = defaultdict(list)
    circ_start = defaultdict(dict)
    circ_end = defaultdict(dict)

    for read_id, read in cand_reads.items():
        contig, start, end = re.split('[:-]', read.circ_id)
        start, end = int(start), int(end)
        if end - start > cfg.max_circ_len:
            continue
        circ_reads[contig].append((start, end, read.read_id))
        circ_start[contig].setdefault(start, []).append(read.read_id)
        circ_end[contig].setdefault(end, []).append(read.read_id)

    reads_cluster = []
    for contig in circ_reads:
        circ_start_index = {}
        circ_end_index = {}

        for target, index in ((circ_start, circ_start_index),
                              (circ_end, circ_end_index)):
            tmp = [[]]
            for x in sorted(target[contig]):
                if not tmp[-1]:
                    tmp[-1].append(x)
                elif x > tmp[-1][-1] + cfg.bsj_tolerance:
                    tmp.append([x])
                else:
                    tmp[-1].append(x)
            for x in tmp:
                if not x:
                    continue
                for i in range(min(x) // cfg.bin_size, max(x) // cfg.bin_size + 1):
                    index.setdefault(i, []).append(x)

        reads_itered = {}
        for (start, end, read_id) in sorted(circ_reads[contig], key=itemgetter(0, 1)):
            if read_id in reads_itered:
                continue
            tmp_reads = []
            p = [i for i in circ_start_index[start // cfg.bin_size] if start in i][0]
            q = [i for i in circ_end_index[end // cfg.bin_size] if end in i][0]
            for i in p:
                tmp_start = circ_start[contig][i]
                for j in q:
                    tmp_end = circ_end[contig][j]
                    tmp = set(tmp_start) & set(tmp_end)
                    if tmp:
                        # sorted: set iteration order is hash-seed dependent
                        # (reference collapse.py:140-142 is nondeterministic
                        # here); deterministic order is a stated goal
                        tmp_reads += sorted(tmp)
            for i in tmp_reads:
                reads_itered[i] = 1
            reads_cluster.append(sorted([cand_reads[i] for i in tmp_reads],
                                        key=lambda x: len(x.seq), reverse=True))

    return reads_cluster


def genome_junction_seq(ctx, contig, start, end, width=25):
    return ctx.genome.seq(contig, end - width, end) + \
        ctx.genome.seq(contig, start, start + width)


def curate_junction(ctx, ctg, st, en, junc, cfg=DEFAULT.collapse,
                    device='cuda'):
    """Exhaustive junction scan (collapse.py:161-173) as ONE batched SW +
    edit-distance call over all (i, j) shift pairs.

    Score per pair: edit_distance(junction_seq, junc[qb:qe]) / 20 -- the
    reference's avg_score (collapse.py:156-158), including its slice
    convention junc[query_begin:query_end] (end-exclusive on an inclusive
    coordinate)."""
    width = cfg.curate_width
    clen = ctx.contig_len[ctg]
    junc_codes = encode_seq(junc)
    ii, jj = np.meshgrid(np.arange(max(0, min(st) - 25), max(st) + 25),
                         np.arange(min(en) - 25, min(max(en) + 25, clen)),
                         indexing='ij')
    keep = jj > ii
    ii, jj = ii[keep], jj[keep]
    K = len(ii)
    if not K:
        return []

    # reference row k: genome[j - width:j] + genome[i:i + width], each part
    # clipped to the contig, gathered from one window of the contig
    l1 = jj - np.maximum(0, jj - width)
    l2 = np.maximum(0, np.minimum(clen, ii + width) - ii)
    lo = max(0, int(min((jj - l1).min(), ii.min())))
    hi = min(clen, int(max(jj.max(), (ii + width).max())))
    window = ctx.genome.codes_of(ctg, lo, hi)
    t = np.arange(2 * width)
    rlen = (l1 + l2).astype(np.int32)
    at = np.where(t < l1[:, None], (jj - l1)[:, None] + t,
                  ii[:, None] + t - l1[:, None]) - lo
    refs = Rows(window[np.where(t < rlen[:, None], at, 0)].ravel(),
                np.arange(0, 2 * width * K, 2 * width, dtype=np.int32),
                rlen)
    res = _sw_rows(repeat_row(junc_codes, K), refs, JUNC_SW, device)

    # matched query substrings junc[qb:qe] vs the genomic junction
    qb = res.query_begin
    qe = res.query_end
    hit = qe > qb
    xs = Rows(junc_codes, np.where(hit, qb, 0).astype(np.int32),
              np.where(hit, qe - qb, 0).astype(np.int32))
    dists = _edit_rows(refs, xs, device)

    junc_scores = list(zip(ii.tolist(), jj.tolist(), dists / rlen))
    return sorted(junc_scores, key=lambda x: x[2])


def annotated_hit(ctx, contig, scores):
    """Weight candidate junctions by annotated splice sites
    (collapse.py:176-207)."""
    if ctx.ss_index is None or contig not in ctx.ss_index:
        return None
    idx = ctx.ss_index[contig]
    weighted = []
    for st, en, score in scores:
        w = 0
        if st + 1 in idx:
            tmp = set(flatten([p for _, p in idx[st + 1].items()]))
            if 'start' in tmp:
                w += 1
        elif st in idx:
            tmp = set(flatten([p for _, p in idx[st].items()]))
            if 'end' in tmp:
                w += 1

        if en in idx:
            tmp = set(flatten([p for _, p in idx[en].items()]))
            if 'end' in tmp:
                w += 1
        elif en + 1 in idx:
            tmp = set(flatten([p for _, p in idx[en + 1].items()]))
            if 'start' in tmp:
                w += 1

        weighted.append([st, en, w])
    return min_sorted_items(weighted, 2, True)


def junc_score(ctx, ctg, junc, junc_seqs, device='cuda'):
    """Mean SW score of the cluster's junction windows against the doubled
    candidate circular sequence (collapse.py:210-215), batched."""
    ref = np.concatenate([ctx.genome.codes_of(ctg, junc[0], junc[1])] * 2)
    res = _sw_rows(encoded_rows(junc_seqs), repeat_row(ref, len(junc_seqs)),
                   JUNC_SW, device)
    return float(np.mean(res.score))


def junc_scores_sorted(ctx, ctg, juncs, junc_seqs, device='cuda'):
    """Sort candidate junctions by mean junction-window SW score,
    descending (the reference sorts with one SSW round per sorted() key
    evaluation, collapse.py:268-275); here ALL (junction, window) pairs
    run as ONE batch.  Stable on ties exactly like sorted(key=junc_score,
    reverse=True): equal means keep their input order."""
    queries = encoded_rows(junc_seqs)
    refs = rows_of([np.concatenate([ctx.genome.codes_of(ctg, j[0], j[1])] * 2)
                    for j in juncs])
    Q, J = len(junc_seqs), len(juncs)
    res = _sw_rows(
        Rows(queries.codes, np.tile(queries.off, J), np.tile(queries.lens, J)),
        Rows(refs.codes, np.repeat(refs.off, Q), np.repeat(refs.lens, Q)),
        JUNC_SW, device)
    means = np.asarray(res.score, np.float64).reshape(len(juncs), Q) \
        .mean(axis=1)
    order = np.argsort(-means, kind='stable')
    return [juncs[int(i)] for i in order]


def _device_fuser(device):
    """A DeviceFuser of the SW and edit-distance jobs on ``device``."""
    return DeviceFuser({'sw': lambda jobs: _fused_sw(jobs, device),
                        'edit': lambda jobs: _fused_edit(jobs, device)})


def _correct_one(ctx, cluster, max_cluster, device):
    """correct_cluster as the span ``collapse.cluster`` of this thread, the
    time outside its other states going to ``collapse.cluster_host``."""
    with span('collapse.cluster'), state('collapse.cluster_host'):
        return correct_cluster(ctx, cluster, max_cluster=max_cluster,
                               device=device)


def correct_chunk(ctx, chunk, max_cluster=200, exec_threads=1,
                  device='cuda'):
    """Correct every cluster of a chunk on ``device``.

    ``exec_threads > 1`` runs the clusters on a thread pool
    (correct_cluster is pure in (ctx, cluster) and every shared dependency
    is read-only or thread-local, so results are identical).  On the cuda
    route every cluster's SW and edit-distance jobs funnel through ONE
    DeviceFuser; on the cpu route the workers' native SW/POA calls release
    the GIL and run side by side (funnelling them through one dispatcher
    would serialise them).  The fold runs in submission (index) order
    either way, keeping counters and corrected_reads byte-identical to a
    serial run.  A pooled chunk adds to ``pool.tail_thread_s`` its wall
    time times the pool's width less its clusters' thread-seconds: the
    time its threads sat idle, mostly waiting for the chunk's last
    clusters."""
    device = resolve_device(device)
    results = [None] * len(chunk)
    live = {i: c for i, c in enumerate(chunk) if c is not None}
    if exec_threads > 1 and len(live) > 1:
        from concurrent.futures import ThreadPoolExecutor

        fuser = _device_fuser(device) if device.type == 'cuda' else None
        busy_ns = []

        def run_one(c):
            t0 = time.perf_counter_ns()
            if fuser is not None:
                fuser.register()
            try:
                return _correct_one(ctx, c, max_cluster, device)
            finally:
                if fuser is not None:
                    fuser.unregister()
                busy_ns.append(time.perf_counter_ns() - t0)

        width = min(exec_threads, len(live))
        start = time.perf_counter_ns()
        try:
            with ThreadPoolExecutor(
                    width, thread_name_prefix='collapse-cluster') as ex:
                futs = {i: ex.submit(run_one, c) for i, c in live.items()}
                for i, fut in futs.items():
                    results[i] = fut.result()
        finally:
            if fuser is not None:
                fuser.close()
        count('pool.tail_thread_s',
              ((time.perf_counter_ns() - start) * width - sum(busy_ns))
              / 1e9)
    else:
        for i, cluster in live.items():
            results[i] = _correct_one(ctx, cluster, max_cluster, device)

    cs_cluster = []
    cnt = defaultdict(int)
    for ret in results:
        if ret is None:
            continue
        circ_type, circ_attr_ = ret
        cnt[circ_type] += 1
        cs_cluster.append(circ_attr_)
    return cs_cluster, cnt


def correct_cluster(ctx, cluster, is_debug=False, max_cluster=200,
                    cfg=DEFAULT.collapse, device='cuda'):
    """Polish one BSJ cluster (collapse.py:235-417)."""
    if cluster is None or len(cluster) <= 1:
        return None
    if 'full' not in set(i.type for i in cluster):
        return None

    counter = Counter([i.circ_id for i in cluster if i.type == 'full']).most_common(n=1)
    ref = sorted([i for i in cluster if i.circ_id == counter[0][0] and i.type == 'full'],
                 key=lambda x: len(x.seq), reverse=True)[0]

    # head-anchor: where does each read's alignment start on the reference
    # read's first 50 bp?  (collapse.py:251-256, batched; the other reads
    # encoded once for this and the template's SW)
    others = cluster[1:]
    reads = encoded_rows([q.seq for q in others])
    ref50 = encode_seq(ref.seq[:50])
    if others:
        res = _sw_rows(reads, repeat_row(ref50, len(others)), JUNC_SW,
                       device)
        head_pos = [int(x) for x in res.ref_begin]
    else:
        head_pos = [0]

    template = transform_seq(ref.seq, max(head_pos))
    junc_seqs = [get_junc_seq(template, -max(head_pos) // 2, cfg.junc_width)]
    if others:
        tcodes = encode_seq(template)
        res = _sw_rows(reads, repeat_row(tcodes, len(others)), JUNC_SW,
                       device)
        for q, qb in zip(others, res.query_begin):
            tmp = transform_seq(q.seq, int(qb))
            junc_seqs.append(get_junc_seq(tmp, -max(head_pos) // 2, cfg.junc_width))

    with state('collapse.junction_poa'):
        cs_junc, _ = poa(junc_seqs, 2, False, 10, -4, -8, -2, -24, -1)

    ctg = Counter([i.circ_id.split(':')[0] for i in cluster]).most_common()[0][0]
    tmp_st = [int(i.circ_id.split(':')[1].split('-')[0]) for i in cluster]
    tmp_en = [int(i.circ_id.split(':')[1].split('-')[1]) for i in cluster]

    scores = curate_junction(ctx, ctg, tmp_st, tmp_en, cs_junc, cfg, device)
    aval_junc = min_sorted_items(scores, 2) if scores else None
    if aval_junc:
        anno_junc = annotated_hit(ctx, ctg, aval_junc)
        if anno_junc:
            anno_junc = junc_scores_sorted(ctx, ctg, anno_junc, junc_seqs,
                                           device)
            circ_start, circ_end, circ_score = anno_junc[0]
        else:
            aval_junc = junc_scores_sorted(ctx, ctg, aval_junc, junc_seqs,
                                           device)
            circ_start, circ_end, circ_score = aval_junc[0]
    else:
        circ_start, circ_end = counter[0][0].split(':')[1].split('-')
        circ_start, circ_end = int(circ_start), int(circ_end)

    # annotated splice sites with widening shift thresholds
    circ_type = None
    ss_site = None
    us_free = ds_free = 0
    tmp_signal = {}
    for shift_threshold in (5, 10):
        ss_site, us_free, ds_free, tmp_signal = find_annotated_signal(
            ctx, ctg, circ_start, circ_end, 0, 10, shift_threshold)
        if ss_site is not None:
            ss_id, strand, us_shift, ds_shift = ss_site
            circ_start += us_shift
            circ_end += ds_shift
            circ_type = 'Annotated'
            break

    host_strand = find_host_gene(ctx, ctg, circ_start, circ_end)

    if ss_site is None:
        for shift_threshold in (5, 10):
            ss_site = find_denovo_signal(ctx, ctg, circ_start, circ_end,
                                         host_strand, tmp_signal, us_free,
                                         ds_free, 0, 10, shift_threshold, True)
            if ss_site is not None:
                ss_id, strand, us_shift, ds_shift = ss_site
                circ_start += us_shift
                circ_end += ds_shift
                circ_type = 'Annotated'
                break

    if ss_site is None:
        retained_introns = find_retained_introns(ctx, ctg, circ_start + 1, circ_end)
        overlap_exons = find_overlap_exons(ctx, ctg, circ_start + 1, circ_end)

        is_lariat = 0
        if retained_introns is not None and overlap_exons is None:
            is_lariat = 1
            retained_introns = sorted(
                set(sum([i for _, i in retained_introns.items()], [])))
            retained_strand = sorted(set(i[2] for i in retained_introns))
            tmp_circ = []
            for intron_start, intron_end, intron_strand in retained_introns:
                if abs(intron_start - circ_start) > 50 or abs(intron_end - circ_end) > 50:
                    continue
                if intron_strand == '+':
                    tmp_site = [i for i in scores if i[0] == intron_start]
                else:
                    tmp_site = [i for i in scores if i[1] == intron_end]
                if tmp_site:
                    tmp_circ.append([*tmp_site[0], intron_strand])

            ss_id = 'lariat'
            if tmp_circ:
                circ_start, circ_end, circ_score, strand = \
                    sorted(tmp_circ, key=lambda x: x[2])[0]
                circ_type = 'High confidence lariat'
            else:
                is_lariat = 0
                tmp_circ = []
                for tmp_strand in retained_strand:
                    tmp_start, tmp_end, tmp_score = recursive_splice_site(
                        ctx, scores, ctg, tmp_strand)
                    if tmp_score is not None:
                        tmp_circ.append([tmp_start, tmp_end, tmp_score, tmp_strand])
                if tmp_circ:
                    circ_start, circ_end, circ_score, strand = \
                        sorted(tmp_circ, key=lambda x: x[2])[0]
                else:
                    strand = 'None'

        if is_lariat == 0 and circ_type is None:
            ss_site = find_denovo_signal(ctx, ctg, circ_start, circ_end,
                                         host_strand, tmp_signal, us_free,
                                         ds_free, 5, 10, 3, False)
            if ss_site is not None:
                ss_id, strand, us_shift, ds_shift = ss_site
                circ_start += us_shift
                circ_end += ds_shift
                circ_type = 'Denovo signal'
            else:
                ss_id = 'None'
                strand = 'None'
                circ_type = 'Unknown signal'

    circ_id = '{}:{}-{}'.format(ctg, circ_start + 1, circ_end)

    # rotate full-length reads to the curated junction; cluster by sequence
    cluster_seq = []
    circ_junc_seq = genome_junction_seq(ctx, ctg, circ_start, circ_end)
    junc_ref = encode_seq(circ_junc_seq)

    tmp_cluster = [i for i in cluster if i.type == 'full']
    if len(tmp_cluster) > max_cluster:
        # deterministic stand-in for random.sample (collapse.py:377)
        tmp_cluster = sorted(tmp_cluster, key=lambda x: len(x.seq),
                             reverse=True)[:max_cluster]
    tmp_cluster = sorted(tmp_cluster, key=lambda x: len(x.seq), reverse=True)

    # rotation alignments: the whole cluster in one call, one kernel launch
    # on the card, the host DP per read on the CPU (byte-identical)
    tb_all = []
    if tmp_cluster:
        with state('collapse.rotation_tb'):
            tb_all = sw_traceback_batch(
                [encode_seq(q.seq * 2) for q in tmp_cluster],
                [junc_ref] * len(tmp_cluster),
                JUNC_SW.match, JUNC_SW.mismatch,
                JUNC_SW.gap_open, JUNC_SW.gap_extend, device)

    for query, tb in zip(tmp_cluster, tb_all):
        if tb is None:
            cluster_seq.append((query.read_id, query.seq))
            continue
        score, qb, qe, rb, re_, cigar = tb
        aln = _AlnView(ref_begin=rb, query_begin=qb,
                       cigar_string=cigar_to_string(cigar))
        tmp_pos = find_alignment_pos(aln, len(circ_junc_seq) // 2)
        if tmp_pos is None:
            cluster_seq.append((query.read_id, query.seq))
        else:
            tmp_seq = transform_seq(query.seq, tmp_pos % len(query.seq))
            cluster_seq.append((query.read_id, tmp_seq))

    cluster_res = batch_cluster_sequence(circ_id, cluster_seq, device)
    cluster_res = sorted(cluster_res, key=lambda x: len(x[1]), reverse=True)

    circ = CIRC(ctg, circ_start + 1, circ_end, strand)
    circ_id = '{}:{}-{}'.format(circ.contig, circ.start, circ.end)

    if len(cluster_res) > 2 and \
            len(cluster_res[0][1]) >= 0.5 * max(len(tmp_cluster), 10):
        tmp_res = correct_cluster(
            ctx, [i for i in cluster if i.read_id in cluster_res[0][1]], True,
            device=device)
        if tmp_res is not None:
            circ = tmp_res
            circ_id = '{}:{}-{}'.format(circ.contig, circ.start, circ.end)

    curated_exons = curate_cirexons(ctx, circ, cluster)
    if curated_exons is None:
        return None
    isoforms, isoform_reads, circ_len = curate_isoform(
        ctx, circ, curated_exons, cluster_res, device)
    if isoforms is None:
        return None
    if not check_isoforms(ctx, circ, isoforms):
        return None

    if is_debug:
        return circ

    return circ_type, ([i.read_id for i in cluster], isoform_reads,
                       cluster_seq, circ_id, circ.strand, ss_id, us_free,
                       ds_free, circ_len, isoforms)


class _AlnView:
    """Duck-typed SW alignment view for find_alignment_pos."""

    def __init__(self, ref_begin, query_begin, cigar_string):
        self.ref_begin = ref_begin
        self.query_begin = query_begin
        self.cigar_string = cigar_string


def batch_cluster_sequence(circ_id, x, device='cuda'):
    """(collapse.py:419-436)"""
    sequence = {}
    hpc_freq = []
    for read_id, read_seq in x:
        sequence[read_id] = read_seq
        hpc_freq.append((compress_seq(read_seq), [read_id]))

    res = iter_cluster_sequence(circ_id, hpc_freq, sequence, device=device)

    for _ in range(10):
        n_res = cluster_sequence(res, sequence, device=device)
        if len(n_res) == len(res):
            break
        res = n_res
    else:
        LOGGER.warning('Sequence not consensus for circRNA: {}'.format(circ_id))
    return res


def iter_cluster_sequence(circ_id, hpc_freq, sequence, batch=50,
                          device='cuda'):
    """(collapse.py:439-455)"""
    if len(hpc_freq) <= batch:
        return cluster_sequence(hpc_freq, sequence, device=device)

    res = []
    for tmp in grouper(hpc_freq, batch):
        chunk = [i for i in tmp if i is not None]
        res = cluster_sequence(chunk + res, sequence, device=device)
        for _ in range(10):
            n_res = cluster_sequence(res, sequence, device=device)
            if len(n_res) == len(res):
                break
            res = n_res
        else:
            LOGGER.warning('Sequence not consensus for circRNA: {}'.format(circ_id))
    return res


def cluster_sequence(hpc_freq, sequence, cfg=DEFAULT.collapse, device='cuda'):
    """Ward-linkage clustering over the pairwise HPC edit-distance matrix
    (collapse.py:458-506); the distance matrix is one batched call."""
    from scipy.cluster.hierarchy import leaves_list, linkage
    from scipy.spatial.distance import squareform

    if len(hpc_freq) == 1:
        return hpc_freq

    P = len(hpc_freq)
    seqs = encoded_rows([h[0] for h in hpc_freq])
    row, col = np.triu_indices(P, 1)
    d = _edit_rows(Rows(seqs.codes, seqs.off[row], seqs.lens[row]),
                   Rows(seqs.codes, seqs.off[col], seqs.lens[col]), device)

    dist = np.zeros((P, P))
    dist[row, col] = d / np.maximum(seqs.lens[row], seqs.lens[col])
    dist = dist + dist.T

    if dist.sum() != 0:
        z = leaves_list(linkage(squareform(dist), 'ward', optimal_ordering=True))
    else:
        z = list(range(P))

    clusters = [[z[0]]]
    for i, j in pairwise(z):
        if i > j:
            if dist[j][i] < cfg.cluster_dist_threshold:
                clusters[-1].append(j)
            else:
                clusters.append([j])
        else:
            if dist[i][j] < cfg.cluster_dist_threshold:
                clusters[-1].append(j)
            else:
                clusters.append([j])

    # multi-read sub-clusters run as one batch of POA jobs on ``device``
    # (on cuda, a launch of csrc/poa_align.cu a round for all of them)
    jobs = []
    slots = []
    ccs_seq = []
    for cluster in clusters:
        if len(cluster) == 1:
            ccs_seq.append(hpc_freq[cluster[0]])
            continue
        cluster_reads = flatten([hpc_freq[i][1] for i in cluster])
        jobs.append([sequence[i] for i in cluster_reads])
        slots.append(len(ccs_seq))
        ccs_seq.append((None, cluster_reads))
    if jobs:
        with state('poa.rounds'):
            done = poa_consensus_many(jobs, device=device)
        for slot, ccs in zip(slots, done):
            ccs_seq[slot] = (ccs, ccs_seq[slot][1])
    return ccs_seq


def recursive_splice_site(ctx, scores, ctg, strand):
    """(collapse.py:548-554)"""
    for st, en, scr in scores:
        if strand == '+' and ctx.genome.seq(ctg, st - 2, st) == 'AG' \
                and ctx.genome.seq(ctg, st, st + 2) == 'GT':
            return st, en, scr
        if strand == '-' and ctx.genome.seq(ctg, en, en + 2) == 'CT' \
                and ctx.genome.seq(ctg, en - 2, en) == 'CA':
            return st, en, scr
    return None, None, None


def parse_cirexons(circ, read):
    """(collapse.py:777-783)"""
    exons = []
    for x in read.cirexon.split(','):
        st, en = x.split('|')[0].split('-')
        exons.append([Exon(st, en), x.split('|')[1]])
    return exons


def cluster_bins(pos, dis=10):
    """(collapse.py:786-799)"""
    clustered = []
    last_i = None
    for i in sorted(pos):
        if last_i is None:
            last_i = [i]
            continue
        if i > last_i[-1] + dis:
            clustered.append(last_i)
            last_i = [i]
        else:
            last_i.append(i)
    if last_i is not None:
        clustered.append(last_i)
    return clustered


def curate_cirexons(ctx, circ, cluster, cfg=DEFAULT.collapse):
    """Canonical-site voting over exon boundaries (collapse.py:557-665)."""
    isoforms = {}
    starts = []
    ends = []
    for read in cluster:
        if read.cirexon == 'NA':
            continue
        try:
            exons = parse_cirexons(circ, read)
        except ValueError:
            continue
        if len(exons) == 0:
            continue
        for exon, exon_type in exons:
            if exon_type != '*-':
                starts.append(exon.start)
            if exon_type != '-*':
                ends.append(exon.end)
        if read.type == 'partial':
            continue
        isoforms[read.read_id] = [i[0] for i in exons]

    if len(isoforms) == 0:
        return None

    tmp_starts = cluster_bins(starts, dis=cfg.exon_cluster_dist)
    tmp_ends = cluster_bins(ends, dis=cfg.exon_cluster_dist)

    convert_st = {}
    for tmp_st in tmp_starts:
        if circ.start in tmp_st:
            for i in tmp_st:
                convert_st[i] = circ.start
        aval_st = []
        for i in sorted(set(tmp_st)):
            i_ss = ctx.genome.seq(circ.contig, i - 3, i - 1)
            if circ.strand == '+' and i_ss == 'AG':
                aval_st.append(i)
            elif circ.strand == '-' and revcomp(i_ss) == 'GT':
                aval_st.append(i)
        tmp_counter = Counter(tmp_st)
        if aval_st:
            final_st = sorted(aval_st, key=lambda x: tmp_counter[x], reverse=True)[0]
        else:
            final_st = tmp_counter.most_common(n=1)[0][0]
        for i in tmp_st:
            convert_st[i] = final_st

    convert_en = {}
    for tmp_en in tmp_ends:
        if circ.end in tmp_en:
            for i in tmp_en:
                convert_en[i] = circ.end
        aval_en = []
        for i in sorted(set(tmp_en)):
            i_ss = ctx.genome.seq(circ.contig, i, i + 2)
            if circ.strand == '+' and i_ss == 'GT':
                aval_en.append(i)
            elif circ.strand == '-' and revcomp(i_ss) == 'AG':
                aval_en.append(i)
        tmp_counter = Counter(tmp_en)
        if aval_en:
            final_en = sorted(aval_en, key=lambda x: tmp_counter[x], reverse=True)[0]
        else:
            final_en = tmp_counter.most_common(n=1)[0][0]
        for i in tmp_en:
            convert_en[i] = final_en

    curated_exons = {}
    for read_id, exons in isoforms.items():
        tmp_exons = [Exon(convert_st[exon.start], convert_en[exon.end])
                     for exon in exons]
        while tmp_exons and tmp_exons[0].end <= circ.start:
            tmp_exons = tmp_exons[1:]
        if not tmp_exons:
            continue
        while tmp_exons and tmp_exons[-1].start >= circ.end:
            tmp_exons = tmp_exons[:-1]
        if not tmp_exons:
            continue

        tmp_exons = merge_cirexons(tmp_exons)
        if tmp_exons[0].start <= circ.start + 15 and \
                tmp_exons[-1].end >= circ.end - 15:
            tmp_exons[0].start = circ.start
            tmp_exons[-1].end = circ.end
        else:
            continue
        curated_exons[read_id] = tmp_exons

    return curated_exons


def merge_cirexons(exons):
    """(collapse.py:668-682)"""
    if len(exons) == 1:
        return exons
    last_exon = exons[0]
    merged = []
    for exon in exons[1:]:
        if exon.start <= last_exon.end + 10:
            last_exon = Exon(last_exon.start, exon.end)
        else:
            merged.append(last_exon)
            last_exon = exon
    merged.append(last_exon)
    return merged


def curate_isoform(ctx, circ, curated_exons, cluster_res, device='cuda'):
    """(collapse.py:685-706)"""
    final_isoforms = {}
    for tmp_seq, tmp_ids in cluster_res:
        tmp_isoform, tmp_len = merge_isoforms(ctx, circ, curated_exons,
                                              tmp_seq, tmp_ids, device)
        if tmp_isoform is None:
            continue
        if tmp_isoform in final_isoforms:
            final_isoforms[tmp_isoform][1] += tmp_ids
        else:
            final_isoforms[tmp_isoform] = [tmp_len, tmp_ids]
    if len(final_isoforms) == 0:
        return None, None, None

    total_cnt = sum(len(i[1]) for i in final_isoforms.values())
    ret = sorted(list(final_isoforms),
                 key=lambda x: (len(final_isoforms[x][1]), final_isoforms[x][0]),
                 reverse=True)
    major_len = final_isoforms[ret[0]][0]
    major_isoforms = [i for i in ret if len(final_isoforms[i][1]) >= 0.1 * total_cnt]
    major_reads = [final_isoforms[i][1] for i in major_isoforms]
    return major_isoforms, major_reads, major_len


def merge_isoforms(ctx, circ, curated_exons, seq, ids, device='cuda'):
    """Max-flow walk over the exon graph (collapse.py:709-741); the
    exon-pair SW scores are batched."""
    seq_codes = encode_seq(seq)

    tmp = [i for i in ids if i in curated_exons]
    exons = sorted(set(str(j) for i in tmp for j in curated_exons[i]))
    if len(exons) == 0:
        return None, None

    exons = ['st'] + exons + ['en']
    edges = np.zeros([len(exons), len(exons)])
    for i in tmp:
        tmp_exons = [str(j) for j in curated_exons[i]]
        edges[exons.index('st')][exons.index(tmp_exons[0])] += 1
        edges[exons.index(tmp_exons[-1])][exons.index('en')] += 1
        for l_exon, n_exon in pairwise(tmp_exons):
            edges[exons.index(l_exon)][exons.index(n_exon)] += 1

    scorer = _ExonScorer(ctx, circ, seq_codes, device)

    cand_st, cand_en = np.where(edges == np.amax(edges))
    cand_score = [scorer.score(exons[i], exons[j])
                  for i, j in zip(cand_st, cand_en)]
    cand_idx = np.where(cand_score == np.amax(cand_score))[0][0]

    max_flow = []
    max_flow += iter_flow(scorer, exons, edges, cand_st[cand_idx], -1)
    max_flow += iter_flow(scorer, exons, edges, cand_en[cand_idx], 1)

    isoform = [exons[i] for i in max_flow]
    isoform_id = ','.join(isoform[1:-1])
    isoform_len = sum(int(i.split('-')[1]) - int(i.split('-')[0]) + 1
                      for i in isoform[1:-1])
    return isoform_id, isoform_len


class _ExonScorer:
    """Caches SW scores of exon-pair genomic sequences against a cluster
    consensus (collapse.py:760-774)."""

    def __init__(self, ctx, circ, seq_codes, device='cuda'):
        self.ctx = ctx
        self.circ = circ
        self.seq_codes = seq_codes
        self.device = device
        self.cache = {}

    def score(self, l_exon, n_exon):
        key = (l_exon, n_exon)
        if key in self.cache:
            return self.cache[key]
        ctx, circ = self.ctx, self.circ
        parts = []
        if l_exon != 'st':
            l_st, l_en = l_exon.split('-')
            parts.append(ctx.genome.codes_of(circ.contig, int(l_st) - 1, int(l_en)))
        if n_exon != 'en':
            n_st, n_en = n_exon.split('-')
            parts.append(ctx.genome.codes_of(circ.contig, int(n_st), int(n_en)))
        if parts:
            query = np.concatenate(parts)
        else:
            query = np.zeros(0, np.int8)
        if circ.strand == '-':
            query = revcomp_encoded(query)
        if len(query) == 0:
            val = 0
        else:
            res = _sw_rows(repeat_row(query, 1),
                           repeat_row(self.seq_codes, 1), JUNC_SW,
                           self.device)
            val = int(res.ref_end[0] - res.ref_begin[0])
        self.cache[key] = val
        return val


def iter_flow(scorer, exons, edges, coord, direction=-1):
    """(collapse.py:744-757)"""
    if coord == 0 or coord == edges.shape[0] - 1:
        return [coord]
    if direction == -1:
        max_l = np.where(edges[:, coord] == np.amax(edges[:, coord]))[0]
        max_score = [scorer.score(exons[i], exons[coord]) for i in max_l]
        max_idx = max_l[np.where(max_score == np.amax(max_score))[0][0]]
        return iter_flow(scorer, exons, edges, max_idx, direction) + [coord]
    max_n = np.where(edges[coord] == np.amax(edges[coord]))[0]
    max_score = [scorer.score(exons[coord], exons[i]) for i in max_n]
    max_idx = max_n[np.where(max_score == np.amax(max_score))[0][0]]
    return [coord] + iter_flow(scorer, exons, edges, max_idx, direction)


def check_isoforms(ctx, circ, isoforms):
    """Splice concordance of reconstructed isoforms (collapse.py:817-839)."""
    concordance = []
    for iso_str in isoforms:
        exons = iso_str.split(',')
        if len(exons) == 1:
            concordance.append(True)
            continue
        introns = []
        for l_str, n_str in pairwise(exons):
            l_st, l_en = l_str.split('-')
            n_st, n_en = n_str.split('-')
            l_ss = ctx.genome.seq(circ.contig, int(l_en), int(l_en) + 2)
            n_ss = ctx.genome.seq(circ.contig, int(n_st) - 3, int(n_st) - 1)
            if circ.strand == '+' and l_ss == 'GT' and n_ss == 'AG':
                introns.append(1)
            elif circ.strand == '-' and revcomp(n_ss) == 'GT' and revcomp(l_ss) == 'AG':
                introns.append(1)
            else:
                introns.append(0)
        concordance.append(sum(introns) == len(introns))
    return sum(concordance) > 0


_COLLAPSE_CTX = None


def _collapse_worker_init(ref_fasta, idx_file, gcache=None):
    """Spawn-pool initializer for the correction pass (the reference
    pools correct_chunk at collapse.py:848): the worker's own genome and
    annotation indices, on the host (the card hidden from it, as in
    find_bsj.py::_scan_worker_init)."""
    global _COLLAPSE_CTX
    os.environ['CUDA_VISIBLE_DEVICES'] = ''
    from ciri_long_tpu_torch.annot.gtf import load_index
    from ciri_long_tpu_torch.context import Context
    from ciri_long_tpu_torch.io.genome import Genome

    genome = Genome.from_cache(gcache, ref_fasta) if gcache else None
    if genome is None:
        genome = Genome(ref_fasta)
    gtf_idx = intron_idx = ss_idx = None
    if idx_file and os.path.exists(idx_file):
        gtf_idx, intron_idx, ss_idx = load_index(idx_file)
    _COLLAPSE_CTX = Context(aligner=None, genome=genome, gtf_index=gtf_idx,
                            intron_index=intron_idx, ss_index=ss_idx)


def _collapse_worker_chunk(payload):
    chunk, max_cluster = payload
    return correct_chunk(_COLLAPSE_CTX, chunk, max_cluster, device='cpu')


def _spawn_pool(n, ref_fasta, idx_file, gcache):
    """A spawn pool of ``n`` correction workers on the host."""
    import multiprocessing
    return multiprocessing.get_context('spawn').Pool(
        n, _collapse_worker_init, (ref_fasta, idx_file, gcache))


def _device_chunks(ctx, device):
    """(run, fuser) for the stealers of a HybridDrain: ONE DeviceFuser
    shared by every stealer thread (JAX collapse.py:1291-1305), so their
    clusters' SW and edit jobs fuse across chunks; run(payload) corrects a
    chunk on ``device`` with the calling thread registered with it."""
    fuser = _device_fuser(device)

    def run(payload):
        chunk, max_cluster = payload
        fuser.register()
        try:
            return correct_chunk(ctx, chunk, max_cluster, exec_threads=1,
                                 device=device)
        finally:
            fuser.unregister()
    return run, fuser


@span('collapse.correct_reads')
def correct_reads(ctx, reads_cluster, cfg=DEFAULT.collapse, threads=1,
                  ref_fasta=None, idx_file=None, gcache=None, device='cuda'):
    """The cluster-correction pass (collapse.py:842-868) on ``device``.

    cuda: the clusters run on DEVICE_THREADS threads with their SW and
    edit-distance jobs fused (correct_chunk); with threads > 1 a spawn pool
    of host workers takes chunks from the front while DEVICE_THREADS
    stealer threads run chunks on the card from the back, through one
    shared fuser (HybridDrain).  cpu: serial, on host threads when the mean
    cluster holds >= 100 reads (the hot work is GIL-released native
    POA/SW), or with threads > 1 on a spawn pool of chunks.  Results drain
    in chunk order, so corrected_reads and the counters are identical
    either way."""
    device = resolve_device(device)
    use_device = device.type == 'cuda'
    fused_before = _fuser_totals()

    prog = ProgressBar()
    prog.update(0)
    circ_num = defaultdict(int)
    corrected_reads = []
    n = len(reads_cluster)
    # individual clusters are heavy (batched POA + SW curation), so when
    # pooling use finer chunks (~4 per worker) for load balance
    cs = cfg.cluster_chunk_size
    if threads > 1:
        cs = max(1, min(cs, -(-n // (4 * threads))))
    chunks = [reads_cluster[i:i + cs] for i in range(0, n, cs)]
    if use_device:
        exec_threads = DEVICE_THREADS
    elif threads <= 1 and n and \
            sum(len(c) for c in reads_cluster) / n >= 100:
        # serial runs over BIG clusters: thread them over the idle cores
        # (measured in the JAX package: 203 -> 297 reads/s at 4k reads in
        # 250-read clusters, 211 -> 136 at 62-read clusters)
        exec_threads = max(1, os.cpu_count() or 1)
    else:
        exec_threads = 1

    pool = result_iter = drain = fuser = None
    if threads > 1 and ref_fasta is not None and len(chunks) > 1:
        pool = _spawn_pool(min(threads, len(chunks)), ref_fasta, idx_file,
                           gcache)
        payloads = [(ci, (c, cfg.max_cluster)) for ci, c in enumerate(chunks)]
        if use_device:
            run, fuser = _device_chunks(ctx, device)
            drain = HybridDrain(pool, getattr(pool, '_processes', threads),
                                _collapse_worker_chunk, run, payloads,
                                device_width=exec_threads)
        else:
            result_iter = pool.imap(_collapse_worker_chunk,
                                    [p for _, p in payloads])

    done = 0
    try:
        for ci, chunk in enumerate(chunks):
            if drain is not None:
                tmp_cluster, tmp_num = drain.result(ci)
            elif result_iter is not None:
                tmp_cluster, tmp_num = next(result_iter)
            else:
                tmp_cluster, tmp_num = correct_chunk(
                    ctx, chunk, cfg.max_cluster, exec_threads=exec_threads,
                    device=device)
            corrected_reads += tmp_cluster
            for key in tmp_num:
                circ_num[key] += tmp_num[key]
            done += len(chunk)
            prog.update(100 * done // max(1, n))
        if drain is not None:
            drain.join()
    finally:
        if pool is not None:
            pool.terminate()
            pool.join()
        if fuser is not None:
            fuser.close()
    prog.update(100)
    if drain is not None:
        LOGGER.info('hybrid collapse: device stole %d/%d chunks'
                    % (drain.stolen, len(chunks)))
    rounds, jobs = (a - b for a, b in zip(_fuser_totals(), fused_before))
    if jobs:
        LOGGER.info('collapse fuser: %d device ops fused into %d rounds'
                    % (jobs, rounds))
    return circ_num, corrected_reads


def _fuser_totals():
    """(rounds, jobs) the fusers have run, from their counters."""
    rounds = jobs = 0
    for name, value in counters().items():
        if name.startswith('fuser.fire.'):
            rounds += value
        elif name.startswith('fuser.jobs.'):
            jobs += value
    return rounds, jobs


def circ_pos(x):
    ctg, pos = x.split(':')
    st, en = pos.split('-')
    return ctg, int(st), int(en)


def by_circ(x):
    """Chromosome-aware sort key (collapse.py:877-894)."""
    ctg, pos = x.split(':')
    if ctg.startswith('chr'):
        ctg = ctg.lstrip('chr')
    try:
        idx = '{:02d}'.format(int(ctg))
    except ValueError:
        if ctg in ('X', 'x', 'Y', 'y'):
            idx = 'a'
        elif ctg in ('M', 'm'):
            idx = 'b'
        else:
            idx = 'c'
    st, en = pos.split('-')
    return idx, ctg, int(st), int(en)


def by_isoform(x):
    circ_id, iso_id = x.split('|')
    idx, ctg, st, en = by_circ(circ_id)
    return idx, ctg, st, en, iso_id


def cal_exp_mtx(ctx, cand_reads, corrected_reads, out_dir, prefix,
                cfg=DEFAULT.collapse):
    """Expression / isoform matrices and the .info GTF
    (collapse.py:903-987)."""
    import pandas as pd

    circ_reads = defaultdict(list)
    isoform_reads = defaultdict(dict)
    circ_info = {}
    reads_df = []

    for reads, tmp_iso_reads, seqs, circ_id, strand, ss_id, us_free, \
            ds_free, circ_len, isoforms in corrected_reads:
        ctg, st, en = circ_pos(circ_id)
        if en - st < cfg.min_circ_len:
            continue

        field = circ_attr(ctx.gtf_index, ctg, st, en, strand)

        tmp_attr = ('circ_id "{}"; splice_site "{}"; equivalent_seq "{}"; '
                    'circ_type "{}"; circ_len "{}";').format(
            circ_id, ss_id,
            equivalent_seq(ctx.genome, ctg, st, en, strand),
            field['circ_type'] if field else 'Unknown',
            circ_len)
        if isoforms:
            tmp_attr += ' isoform "{}";'.format('|'.join(isoforms))
        for key in ('gene_id', 'gene_name', 'gene_type'):
            if key in field:
                tmp_attr += ' {} "{}";'.format(key, field[key])
        circ_info[circ_id] = [ctg, 'CIRI-long', 'circRNA', st, en,
                              len(reads), strand, '.', tmp_attr]

        circ_reads[circ_id] += reads
        for i, j in zip(isoforms, tmp_iso_reads):
            isoform_reads[circ_id][i] = isoform_reads[circ_id].setdefault(i, []) + j

        for read_id in reads:
            read = cand_reads[read_id]
            reads_df.append([read_id, circ_id, read.circ_id, read.strand,
                             read.cirexon, read.ss, read.clip, read.segments,
                             read.sample, read.type])

    reads_df = pd.DataFrame(
        reads_df, columns=['read_id', 'circ_id', 'tmp_id', 'strand',
                           'cirexons', 'signal', 'alignment', 'segments',
                           'sample', 'type'])
    reads_df.to_csv('{}/{}.reads'.format(out_dir, prefix), sep='\t', index=False)

    sorted_circ = sorted(list(circ_info), key=by_circ)
    with open('{}/{}.info'.format(out_dir, prefix), 'w') as out:
        for circ_id in sorted_circ:
            out.write('\t'.join(str(x) for x in circ_info[circ_id]) + '\n')

    exp_df = {}
    for circ_id, reads in circ_reads.items():
        exp_df[circ_id] = Counter([cand_reads[i].sample for i in reads])
    exp_df = pd.DataFrame.from_dict(exp_df).transpose().fillna(0).reindex(sorted_circ)
    exp_df.to_csv('{}/{}.expression'.format(out_dir, prefix), sep='\t',
                  index_label='circ_ID')

    isoform_df = {}
    for circ_id in isoform_reads:
        tmp_total = []
        for _, reads in isoform_reads[circ_id].items():
            tmp_total += [cand_reads[i].sample for i in reads]
        tmp_total = Counter(tmp_total)
        for iso_id, reads in isoform_reads[circ_id].items():
            tmp_counter = Counter([cand_reads[i].sample for i in reads])
            isoform_df['{}|{}'.format(circ_id, iso_id)] = \
                {i: j / tmp_total[i] for i, j in tmp_counter.items()}
    sorted_iso = sorted(list(isoform_df), key=by_isoform)
    isoform_df = pd.DataFrame.from_dict(isoform_df).transpose().fillna(0).reindex(sorted_iso)
    isoform_df.to_csv('{}/{}.isoforms'.format(out_dir, prefix), sep='\t',
                      index_label='isoform_ID')
    return len(sorted_circ), len(sorted_iso)


def circ_attr(gtf_index, ctg, start, end, strand):
    """Gene-level annotation of a circRNA (collapse.py:1019-1138)."""
    if gtf_index is None or ctg not in gtf_index:
        return {}
    start_div, end_div = start // 500, end // 500

    host_gene = {}
    start_element = defaultdict(list)
    end_element = defaultdict(list)

    for x in range(start_div, end_div + 1):
        if x not in gtf_index[ctg]:
            continue
        for element in gtf_index[ctg][x]:
            if element.start <= start <= element.end and \
                    (element.strand == strand or strand is None):
                start_element[element.type].append(element)
            if element.start <= end <= element.end and \
                    (element.strand == strand or strand is None):
                end_element[element.type].append(element)
            if element.end < start or end < element.start:
                continue
            gid = element.attr.get('gene_id')
            if gid is not None and gid not in host_gene:
                host_gene[gid] = element

    circ_type = {}
    forward_host_gene = []
    antisense_host_gene = []

    if host_gene:
        for gene_id in host_gene:
            if strand == 'None' or host_gene[gene_id].strand == strand:
                forward_host_gene.append(host_gene[gene_id])
                if 'exon' in start_element and 'exon' in end_element:
                    circ_type['exon'] = 1
                else:
                    circ_type['intron'] = 1
            else:
                antisense_host_gene.append(host_gene[gene_id])
                circ_type['antisense'] = 1
    else:
        circ_type['intergenic'] = 1

    if len(forward_host_gene) > 1:
        circ_type['gene_intergenic'] = 1

    field = {}
    if 'exon' in circ_type:
        field['circ_type'] = 'exon'
    elif 'intron' in circ_type:
        field['circ_type'] = 'intron'
    elif 'antisense' in circ_type:
        field['circ_type'] = 'antisense'
    else:
        field['circ_type'] = 'intergenic'

    def collect(genes):
        ids, names, types = [], [], []
        for x in genes:
            attr = x.attr
            if 'gene_id' in attr:
                ids.append(attr['gene_id'])
            if 'gene_name' in attr:
                names.append(attr['gene_name'])
            if 'gene_type' in attr:
                types.append(attr['gene_type'])
            elif 'gene_biotype' in attr:
                types.append(attr['gene_biotype'])
        return ids, names, types

    if len(forward_host_gene) >= 1:
        ids, names, types = collect(forward_host_gene)
        if ids:
            field['gene_id'] = ','.join(ids)
        if names:
            field['gene_name'] = ','.join(names)
        if types:
            field['gene_type'] = ','.join(types)
    elif field['circ_type'] == 'antisense' and antisense_host_gene:
        ids, names, types = collect(antisense_host_gene)
        if ids:
            field['gene_id'] = ','.join(ids)
        if names:
            field['gene_name'] = ','.join(names)
        if types:
            field['gene_type'] = ','.join(types)

    return field
