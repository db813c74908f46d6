"""Multi-process smoke worker: run N of these over torch.distributed (gloo).

Port of ciri_long_tpu/parallel/multihost_worker.py.  Each process is one
shard of the mesh, on its own ``--device`` (ranks may share a card); they
meet over a gloo process group, with a timeout so that a rank that fails
makes its peers fail instead of wait.  In turn each process checks:

1. the sharded SW's positive count, psum-reduced over the group, against
   the plain version's count on the host times the number of processes
   (every rank contributes the same rows): ``MULTIHOST_RESULT``;
2. the gather of distinct candidate records from every rank:
   ``MULTIHOST_GATHER``;
3. with ``--scan-out``, the cohort scan: each rank scans its shard of
   ``build_demo_world``'s reads, the records meet in one gather, and every
   rank writes the same cand_circ.fa: ``MULTIHOST_SCAN`` (its md5).

Last it prints ``MULTIHOST_LAUNCHES``, the rank's launches of each kernel of
``call`` and of tandem_counts.

Usage (one invocation per process):
  python -m ciri_long_tpu_torch.parallel.multihost_worker \\
      --coordinator 127.0.0.1:PORT --num-processes N --process-id I \\
      [--device cuda|cuda:K|cpu] [--scan-out FILE]
"""

import argparse


def build_demo_world(seed=20260817, n_loci=3, depth=4):
    """Deterministic mini world shared by every process (and by a serial
    reference run): genome with planted circRNAs + consensus reads; the
    JAX package's world for the same seed (numpy only, the port's own
    modules).

    Defaults give the small fixed world the 2-process test asserts on;
    n_loci/depth scale it up."""
    import numpy as np

    from ciri_long_tpu_torch.context import Context
    from ciri_long_tpu_torch.io.genome import Genome
    from ciri_long_tpu_torch.models.aligner import GenomeAligner
    from ciri_long_tpu_torch.ops.ccs import find_consensus

    rng = np.random.default_rng(seed)
    size = max(40_000, 6_000 + n_loci * 11_000 + 6_000)
    chr1 = list(''.join(rng.choice(list('ACGT'), size=size)))
    loci = []
    for t in range(n_loci):
        st = 6_000 + t * 11_000
        en = st + 250 + 80 * (t % 5)
        chr1[st - 2:st] = list('AG')
        chr1[en:en + 2] = list('GT')
        loci.append((st, en))
    chr1 = ''.join(chr1)
    genome = Genome.from_dict({'chr1': chr1})
    ctx = Context(aligner=GenomeAligner(genome), genome=genome)

    def mutate(s, noise):
        out = []
        for c in s:
            r = rng.random()
            if r < noise / 2:
                continue
            out.append('ACGT'[int(rng.integers(0, 4))] if r < noise else c)
            if rng.random() < noise / 2:
                out.append('ACGT'[int(rng.integers(0, 4))])
        return ''.join(out)

    ccs_seq = {}
    n = 0
    for st, en in loci:
        unit = chr1[st:en]
        for d in range(depth):
            rot = (d * 71) % len(unit)
            u = unit[rot:] + unit[:rot]
            read = ''.join(mutate(u, 0.02) for _ in range(3 + d % 2))
            segments, ccs = find_consensus(read)
            if segments is None:
                continue
            ccs_seq['read_{:03d}'.format(n)] = [segments, ccs, read]
            n += 1
    return ctx, ccs_seq


def _check(ok, what):
    if not ok:
        raise SystemExit('multihost worker: {} disagree'.format(what))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--coordinator', required=True)
    ap.add_argument('--num-processes', type=int, required=True)
    ap.add_argument('--process-id', type=int, required=True)
    ap.add_argument('--device', default='cuda',
                    help='this rank\'s device: cuda (the current card), '
                         'cuda:K or cpu, (default: %(default)s)')
    ap.add_argument('--scan-out', default=None,
                    help='run the e2e cohort scan and write the merged '
                         'cand_circ.fa here (one file per process)')
    ap.add_argument('--bench-loci', type=int, default=3,
                    help='demo-world loci')
    ap.add_argument('--bench-depth', type=int, default=4,
                    help='reads per locus in the demo world')
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from ciri_long_tpu_torch.ops.sw import SWParams, sw_score_ends
    from ciri_long_tpu_torch.parallel.mesh import (CAND_FIELDS,
                                                   init_distributed,
                                                   make_candidate_gather,
                                                   make_mesh, sharded_sw)
    from ciri_long_tpu_torch.utils.dispatch import (CALL_KERNELS,
                                                    launch_counts,
                                                    reset_launches,
                                                    resolve_device)

    device = resolve_device(args.device)
    reset_launches()
    init_distributed(args.coordinator, args.num_processes, args.process_id)
    try:
        mesh = make_mesh(lag_parallel=1, device=device)
        per_rank = 4
        rng = np.random.default_rng(0)   # same data on every rank
        q = rng.integers(0, 4, (per_rank, 64)).astype(np.int8)
        r = rng.integers(0, 4, (per_rank, 96)).astype(np.int8)
        params = SWParams(1, 1, 1, 1)
        # each rank contributes its LOCAL batch as one shard of the global
        # batch; with identical data per rank the global counter is the
        # local count (the plain version's, on the host) times the ranks
        _, _, _, got = sharded_sw(mesh, q, r, params)
        exp_score = sw_score_ends(torch.from_numpy(q), torch.from_numpy(r),
                                  params)[0].numpy()
        expected = args.num_processes * int((exp_score > 0).sum())
        print('MULTIHOST_RESULT pid={} got={} expected={}'.format(
            args.process_id, got, expected), flush=True)
        _check(got == expected, 'the psum of the positive SW count')

        # --- candidate-record merge across processes: each process
        # contributes DISTINCT records; after the gather every process
        # holds the full table ---
        rows_local = 6
        rec = np.zeros((rows_local, CAND_FIELDS), np.int32)
        rec[:, 0] = 1000 * args.process_id + np.arange(rows_local)
        rec[:, 5] = 7 + args.process_id
        valid = np.ones(rows_local, bool)
        valid[-1] = False
        all_rec, all_valid, n = make_candidate_gather(mesh)(rec, valid)
        ids = sorted(all_rec[all_valid][:, 0].tolist())
        want = sorted([1000 * p + i for p in range(args.num_processes)
                       for i in range(rows_local - 1)])
        print('MULTIHOST_GATHER pid={} n={} ids_ok={}'.format(
            args.process_id, n, ids == want), flush=True)
        _check(ids == want, 'the gathered record ids')

        # --- full cohort scan e2e: each process scans its own shard of
        # the shared read set on its device, records merge in the group's
        # gather, every process writes the identical file ---
        if args.scan_out:
            import hashlib
            import time
            from ciri_long_tpu_torch.parallel.cohort import (
                _shard_bounds, scan_ccs_cohort_step, write_records)

            ctx, ccs_seq = build_demo_world(n_loci=args.bench_loci,
                                            depth=args.bench_depth)
            items = [[rid] + ccs_seq[rid] for rid in ccs_seq]
            read_ids = [it[0] for it in items]
            lo, hi = _shard_bounds(len(items),
                                   args.num_processes)[args.process_id]
            t0 = time.monotonic()
            merged, counters, _short = scan_ccs_cohort_step(
                mesh, ctx, items, lo, hi, read_ids, True)
            wall = time.monotonic() - t0
            write_records(args.scan_out, merged, read_ids,
                          list(ctx.genome.names))
            md5 = hashlib.md5(open(args.scan_out, 'rb').read()).hexdigest()
            print('MULTIHOST_SCAN pid={} n_rec={} md5={} n_reads={} '
                  'wall_s={:.3f}'.format(args.process_id, len(merged), md5,
                                         len(items), wall), flush=True)
        launches = launch_counts(CALL_KERNELS + ('tandem_counts',))
        print('MULTIHOST_LAUNCHES pid={} {}'.format(args.process_id, ' '.join(
            '{}={}'.format(k, v) for k, v in launches.items())), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == '__main__':
    main()
