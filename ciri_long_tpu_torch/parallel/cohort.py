"""Mesh-sharded call scan: the device-parallel analog of the reference's
chunked Pool scan (find_bsj.py:328-372).

Port of ciri_long_tpu/parallel/cohort.py.  Reads are split over the mesh's
'reads' axis: every shard runs the batched scan (pipeline/find_bsj.py::
scan_ccs_chunk, on its shard's device) over its slice of the input, the
candidate records are packed into fixed-size int32 rows
(parallel/records.py) and merged with one gather (parallel/mesh.py), and
cand_circ.fa is written in global read order -- byte-identical to a serial
scan_ccs_reads run.

Two entry points:
  scan_ccs_sharded      one process, n shards scanned in turn, each on its
                        device (a card each on cuda)
  scan_ccs_cohort_step  several processes (parallel/mesh.py::
                        init_distributed): each scans its OWN shard on its
                        device, its block joins the group's gather, and
                        every process returns the full merged table.
"""

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from ciri_long_tpu_torch.config import DEFAULT
from ciri_long_tpu_torch.parallel.mesh import (READS_AXIS, gather_candidates,
                                               make_candidate_gather)
from ciri_long_tpu_torch.parallel.records import (REC_W, decode_record,
                                                  encode_records)
from ciri_long_tpu_torch.pipeline.find_bsj import scan_ccs_chunk


def _shard_bounds(n_items: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous near-even split (first shards get the remainder)."""
    base = n_items // n_shards
    extra = n_items % n_shards
    bounds = []
    lo = 0
    for s in range(n_shards):
        hi = lo + base + (1 if s < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def scan_shard(ctx, items, lo, hi, is_canonical, cfg=DEFAULT.call,
               device='cuda'):
    """Scan items[lo:hi] on ``device``; returns (counters, short_reads,
    [(global_read_idx, record)])."""
    chunked = []
    counters = defaultdict(int)
    short_reads = []
    for st in range(lo, hi, cfg.ccs_chunk_size):
        chunk = items[st:min(hi, st + cfg.ccs_chunk_size)]
        cnt, shorts, ret = scan_ccs_chunk(ctx, chunk, is_canonical, cfg,
                                          device)
        for k, v in cnt.items():
            counters[k] += v
        short_reads += shorts
        # records come back in chunk order; recover each record's global
        # index from its read_id (unique within the input)
        id_to_idx = {c[0]: st + t for t, c in enumerate(chunk)}
        for rec in ret:
            chunked.append((id_to_idx[rec[0]], rec))
    return counters, short_reads, chunked


def write_records(path, rows, read_ids, ctg_names, mode='w'):
    """Write merged record rows (already sorted by read idx) to
    cand_circ.fa in the exact serial format."""
    with open(path, mode) as out:
        for row in rows:
            rec = decode_record(row, read_ids, ctg_names)
            out.write('>{}\t{}\t{}\t{}\t{}\t{}\t{}\n{}\n'.format(*rec))


def scan_ccs_sharded(mesh, ctx, ccs_seq: Dict, is_canonical, out_dir,
                     prefix, cfg=DEFAULT.call):
    """One-process sharded scan over the mesh's reads axis, shard s on its
    device (``mesh.shard_device(s)``).

    Returns (counters, short_reads); writes {prefix}.cand_circ.fa with
    bytes identical to pipeline.find_bsj.scan_ccs_reads."""
    if mesh.group is not None:
        raise ValueError('scan_ccs_sharded runs in one process; a process '
                         'group scans with scan_ccs_cohort_step')
    items = [[rid] + ccs_seq[rid] for rid in ccs_seq]
    read_ids = [it[0] for it in items]
    ctg_names = list(ctx.genome.names)
    ctg_index = {n: i for i, n in enumerate(ctg_names)}

    n_dp = mesh.shape[READS_AXIS]
    counters = defaultdict(int)
    short_reads = []
    all_rows = []
    for s, (lo, hi) in enumerate(_shard_bounds(len(items), n_dp)):
        cnt, shorts, recs = scan_shard(ctx, items, lo, hi, is_canonical, cfg,
                                       mesh.shard_device(s))
        for k, v in cnt.items():
            counters[k] += v
        short_reads += shorts
        rows, valid = encode_records(recs, ctg_index)
        all_rows.append(rows)

    rows = np.concatenate(all_rows) if all_rows else \
        np.zeros((0, REC_W), np.int32)
    merged, n = gather_candidates(mesh, rows, np.ones(len(rows), bool))
    assert n == len(rows)
    write_records('{}/{}.cand_circ.fa'.format(out_dir, prefix), merged,
                  read_ids, ctg_names)
    return counters, short_reads


def scan_ccs_cohort_step(mesh, ctx, items, lo, hi, read_ids, is_canonical,
                         cfg=DEFAULT.call):
    """Multi-process cohort scan step: this process scans items[lo:hi]
    (its shard) on its device, then joins the group's gather.  Every
    process returns the full merged record table (sorted by global read
    idx) plus its local counters and short reads -- the lead process
    writes the file, the others use the table for downstream work.

    ``items`` must be the GLOBAL item list (deterministically derived on
    every process, e.g. from the shared input file)."""
    ctg_names = list(ctx.genome.names)
    ctg_index = {n: i for i, n in enumerate(ctg_names)}

    counters, short_reads, recs = scan_shard(ctx, items, lo, hi,
                                             is_canonical, cfg,
                                             mesh.devices[0])
    rows, _ = encode_records(recs, ctg_index)

    # a block of capacity = the shard's size (a shard cannot yield more
    # records than reads), padded with invalid rows
    cap = max(1, hi - lo)
    block = np.zeros((cap, REC_W), np.int32)
    valid = np.zeros(cap, bool)
    block[:len(rows)] = rows
    valid[:len(rows)] = True

    all_rec, all_valid, _n = make_candidate_gather(mesh)(block, valid)
    merged = all_rec[all_valid]
    order = np.argsort(merged[:, 0], kind='stable')
    return merged[order], counters, short_reads
