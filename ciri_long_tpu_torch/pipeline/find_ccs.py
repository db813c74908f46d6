"""Stage 1: cyclic-consensus detection over the input reads.

Port of ciri_long_tpu/pipeline/find_ccs.py (reference find_ccs_reads /
load_ccs_reads, find_ccs.py:21-120) with the same output files, so the
resume logic and downstream stages are interchangeable between packages:
  tmp/{prefix}.ccs.fa : '>read_id\\tsegments\\tlen(ccs)' + consensus
  tmp/{prefix}.raw.fa : '>read_id' + raw read

This stage runs on the host in this port.  The JAX package offloads the
tandem pre-screen (ops/period.py::screen_keep, ROADMAP X3) and the
center-star NW polish (ops/nw_tb_batch.py, ROADMAP X4) when its
``_low_rtt_device_ready()`` gate says so (find_ccs.py:271-311); both gates
are pinned off here until those device programs have GPU forms.  Outputs
are byte-identical either way (the screen is sound and the device polish
falls back pair-by-pair to the same host aligner).
"""

import multiprocessing
import os

from ciri_long_tpu.io.fastx import read_fastx
from ciri_long_tpu.utils.logger import ProgressBar
from ciri_long_tpu_torch.ops.ccs import find_consensus

CHUNK_SIZE = 250  # reference job granularity (find_ccs.py:62)


def _ccs_chunk(chunk):
    """Worker: run find_consensus over one chunk of (id, seq) pairs."""
    return [(rid, find_consensus(seq)) for rid, seq in chunk]


def find_ccs_reads(in_file, out_dir, prefix, threads=1):
    """Detect rolling-circle reads; returns (total_reads, ro_reads,
    ccs_seq) with ccs_seq[read_id] = [segments, ccs, raw].

    threads > 1 fans the 250-read chunks over a fork pool, the direct
    analog of the reference's worker pool (find_ccs.py:11-26,62); the CLI
    allows that only with ``--device cpu``, since CUDA does not survive a
    fork after initialisation.  Results re-merge in input order so the
    output files are byte-identical across thread counts."""
    prog = ProgressBar()
    prog.update(0)

    ro_reads = 0
    ccs_seq = {}
    raw = dict(read_fastx(in_file))

    ccs_path = '{}/tmp/{}.ccs.fa'.format(out_dir, prefix)
    raw_path = '{}/tmp/{}.raw.fa'.format(out_dir, prefix)
    os.makedirs(os.path.dirname(ccs_path), exist_ok=True)

    items = list(raw.items())
    chunks = [items[i:i + CHUNK_SIZE] for i in range(0, len(items),
                                                      CHUNK_SIZE)]
    if threads > 1 and len(chunks) > 1:
        with multiprocessing.get_context('fork').Pool(threads) as pool:
            results = _drain(pool.imap(_ccs_chunk, chunks), prog,
                             len(chunks))
    else:
        # serial (-t 1) runs still own every core: find_consensus is
        # dominated by GIL-releasing C++ (tandem detect + center-star), so
        # a thread pool over reads gets real parallelism without a fork.
        # CIRI_SELECT_THREADS is the CLI's idle-core budget.
        host_threads = int(os.environ.get('CIRI_SELECT_THREADS', '1') or 1)
        if host_threads > 1 and len(items) > 1:
            from concurrent.futures import ThreadPoolExecutor

            def _one(item):
                rid, seq = item
                return rid, find_consensus(seq)

            with ThreadPoolExecutor(min(host_threads, 8)) as tp:
                results = _drain((list(tp.map(_one, c)) for c in chunks),
                                 prog, len(chunks))
        else:
            results = _drain((_ccs_chunk(c) for c in chunks), prog,
                             len(chunks))

    total_reads = len(items)
    with open(ccs_path, 'w') as out, open(raw_path, 'w') as trimmed:
        res_by_id = {rid: r for chunk_res in results for rid, r in chunk_res}
        for rid, _seq in items:
            segments, ccs = res_by_id.get(rid, (None, None))
            if segments is None or ccs is None:
                continue
            ro_reads += 1
            out.write('>{}\t{}\t{}\n{}\n'.format(
                rid, segments, len(ccs), ccs))
            trimmed.write('>{}\n{}\n'.format(rid, raw[rid]))
            ccs_seq[rid] = [segments, ccs, raw[rid]]
    prog.update(100)

    return total_reads, ro_reads, ccs_seq


def _drain(result_iter, prog, n_chunks):
    """Collect chunk results in submission order, ticking the bar."""
    results = []
    for i, res in enumerate(result_iter):
        results.append(res)
        prog.update(min(99, int(100 * (i + 1) / max(1, n_chunks))))
    return results


def load_ccs_reads(out_dir, prefix):
    """Reload a previous run's CCS calls (find_ccs.py:106-120)."""
    ccs_seq = {}
    with open('{}/tmp/{}.ccs.fa'.format(out_dir, prefix), 'r') as f:
        for line in f:
            content = line.rstrip().split()
            seq = f.readline().rstrip()
            ccs_seq[content[0].lstrip('>')] = [content[1], seq]

    with open('{}/tmp/{}.raw.fa'.format(out_dir, prefix), 'r') as f:
        for line in f:
            read_id = line.rstrip().split()[0].lstrip('>')
            seq = f.readline().rstrip()
            ccs_seq[read_id].append(seq)
    return ccs_seq
