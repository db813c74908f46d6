"""CIRI-long compatible command line of the PyTorch port.

Port of ciri_long_tpu/cli/main.py: the ``call`` subcommand with the same
flags, stage sequencing, tmp/-file resume and run-summary JSON (the
reference counters total/consensus/raw_unmapped/ccs_mapped/bsj/signal/
partial, main.py:96-100, plus ``timing``), and a ``kernels`` section with
the launch count of each hand-written kernel; the ``collapse`` subcommand
with the same flags, tmp/ index, gcodes cache and tmp/{prefix}.corrected.pkl
resume and the same .info, .reads, .expression and .isoforms files, its
kernels' launch counts and poa_align's device time in its log.  ``--device {cuda,cpu}`` (default cuda)
picks where the kernels run; asking for cuda without a GPU raises, and so
does -t > 1 with cuda.
"""

import json
import os
import pickle
import sys
from collections import defaultdict

THREADS_TODO = ('-t > 1 with --device cuda is not yet supported: the CCS '
                'pools fork and CUDA does not survive a fork after '
                'initialisation (ROADMAP.md queue 1, item 1); use -t 1 or '
                '--device cpu')


def _build_context(ref_fasta, gtf_idx, intron_idx, ss_idx, index_cache,
                   build_threads=1):
    """Genome + aligner + annotation indices.  The packed genome and the
    minimizer index are the JAX package's on-disk caches (tmp/gcodes,
    tmp/minidx), read and written in the same format by this package's own
    copies of its modules, so a tmp/ written by either package is reused by
    the other."""
    from ciri_long_tpu_torch.context import Context
    from ciri_long_tpu_torch.io.genome import Genome
    from ciri_long_tpu_torch.models.aligner import GenomeAligner

    gdir = os.path.join(os.path.dirname(index_cache), 'gcodes')
    genome = Genome.from_cache(gdir, ref_fasta)
    if genome is None:
        genome = Genome(ref_fasta)
        try:
            genome.save_cache(gdir)
        except (OSError, ValueError):
            pass
    aligner = GenomeAligner(genome, index_cache=index_cache,
                            build_threads=build_threads)
    return Context(aligner=aligner, genome=genome, gtf_index=gtf_idx,
                   intron_index=intron_idx, ss_index=ss_idx)


def _load_or_build_index(out_dir, gtf_file, circ_file, logger):
    from ciri_long_tpu_torch.annot.gtf import (index_annotation, index_circ,
                                               load_index)

    if gtf_file is None and circ_file is None:
        logger.warning("No annotation provided, entering 'De novo' mode")
        return None, None, None

    idx_file = out_dir + '/tmp/ss.idx'
    if os.path.exists(idx_file):
        logger.info('reusing splice-site index: {}'.format(idx_file))
        gtf_idx, intron_idx, ss_idx = load_index(idx_file)
        return gtf_idx, intron_idx, ss_idx

    if gtf_file is not None:
        gtf_idx, intron_idx, ss_idx = index_annotation(gtf_file)
    else:
        gtf_idx, intron_idx, ss_idx = None, None, None
    if circ_file is not None:
        ss_idx = index_circ(circ_file, ss_idx)

    with open(idx_file, 'wb') as idx:
        pickle.dump([gtf_idx, intron_idx, ss_idx], idx, -1)
    return gtf_idx, intron_idx, ss_idx


def call(args):
    from ciri_long_tpu_torch.utils.logger import StageTimer, get_logger
    from ciri_long_tpu_torch.utils.misc import check_dir, check_file
    from ciri_long_tpu_torch.utils.dispatch import (reset_launches,
                                                    resolve_device)

    device = resolve_device(args.device)
    reset_launches()          # the summary counts this run's launches only
    if device.type == 'cuda' and args.threads > 1:
        raise NotImplementedError(THREADS_TODO)

    if args.input is None or args.output is None:
        sys.exit('Please provide input and output file, run CIRI-long using '
                 '-h or --help for detailed information.')
    if args.reference is None:
        sys.exit('Please specific FASTA of reference genome')

    in_file = check_file(args.input)
    gtf_file = None if args.gtf is None else check_file(args.gtf)
    circ_file = None if args.circ is None else check_file(args.circ)
    out_dir = check_dir(args.output)
    ref_fasta = check_file(args.reference)
    check_dir(out_dir + '/tmp')
    prefix = args.prefix

    # Serial (-t 1) runs hand the idle cores to the native select+stitch
    # batch core and the CCS thread pool; pooled runs keep it
    # single-threaded per worker.  User-set values are respected.
    if 'CIRI_SELECT_THREADS' not in os.environ:
        os.environ['CIRI_SELECT_THREADS'] = str(
            max(1, (os.cpu_count() or 1)) if args.threads <= 1 else 1)

    logger = get_logger('CIRI-long', fname='{}/{}.log'.format(out_dir, prefix),
                        verbosity=args.debug)
    logger.info('=== run configuration ===')
    logger.info('reads: ' + os.path.basename(in_file))
    logger.info('output dir: ' + os.path.basename(out_dir))
    logger.info('device: {}'.format(device))
    logger.info('=== call stage ===')

    timer = StageTimer()
    reads_count = defaultdict(int)
    gtf_idx, intron_idx, ss_idx = _load_or_build_index(
        out_dir, gtf_file, circ_file, logger)
    idx_file = out_dir + '/tmp/ss.idx'
    idx_file = idx_file if os.path.exists(idx_file) else None
    index_cache = out_dir + '/tmp/minidx'
    ctx = _build_context(ref_fasta, gtf_idx, intron_idx, ss_idx, index_cache,
                         build_threads=max(1, args.threads))

    _call_stages(args, logger, timer, reads_count, in_file, out_dir, prefix,
                 ref_fasta, idx_file, ctx, index_cache, device)
    return _finish_call(logger, timer, reads_count, out_dir, prefix)


def _call_stages(args, logger, timer, reads_count, in_file, out_dir, prefix,
                 ref_fasta, idx_file, ctx, index_cache, device):
    from ciri_long_tpu_torch.context import Context
    from ciri_long_tpu_torch.models.aligner import GenomeAligner
    from ciri_long_tpu_torch.pipeline.find_bsj import (recover_ccs_reads,
                                                       scan_ccs_reads,
                                                       scan_raw_reads)
    from ciri_long_tpu_torch.pipeline.find_ccs import (find_ccs_reads,
                                                       load_ccs_reads)

    is_canonical = True
    ccs_fa = '{}/tmp/{}.ccs.fa'.format(out_dir, prefix)
    raw_fa = '{}/tmp/{}.raw.fa'.format(out_dir, prefix)
    if not args.debug and os.path.exists(ccs_fa) and os.path.exists(raw_fa):
        logger.info('[1/4] consensus: resuming from tmp/ ccs artifacts')
        ccs_seq = load_ccs_reads(out_dir, prefix)
        reads_count['consensus'] = len(ccs_seq)
    else:
        with timer.stage('ccs'):
            total_reads, ro_reads, ccs_seq = find_ccs_reads(
                in_file, out_dir, prefix, args.threads)
        reads_count['total'] = total_reads
        reads_count['consensus'] = ro_reads

    if 'total' in reads_count:
        logger.info('reads in: {}'.format(reads_count['total']))
    logger.info('reads with cyclic consensus: {}'.format(
        reads_count['consensus']))

    logger.info('[2/4] scanning consensus reads for BSJs')
    with timer.stage('scan_ccs', items=len(ccs_seq)):
        tmp_cnt, short_seq = scan_ccs_reads(
            ctx, ccs_seq, is_canonical, out_dir, prefix,
            threads=args.threads, ref_fasta=ref_fasta, idx_file=idx_file,
            index_cache=index_cache, device=device)
    for key, value in tmp_cnt.items():
        reads_count[key] += value

    logger.info('[3/4] recovering short consensus reads')
    with timer.stage('recover_ccs', items=len(short_seq)):
        if short_seq:
            # reuse the packed genome; only the denser short-read index is
            # built, and only when there is anything to recover
            short_ctx = Context(
                aligner=GenomeAligner(ctx.genome, short_mode=True,
                                      index_cache=index_cache + '_s'),
                genome=ctx.genome, gtf_index=ctx.gtf_index,
                intron_index=ctx.intron_index, ss_index=ctx.ss_index)
            tmp_cnt = recover_ccs_reads(
                short_ctx, short_seq, is_canonical, out_dir, prefix,
                threads=args.threads, ref_fasta=ref_fasta,
                idx_file=idx_file, index_cache=index_cache + '_s',
                device=device)
        else:
            # the reference still truncates/creates nothing here; keep the
            # append semantics by ensuring the file exists
            open('{}/{}.cand_circ.fa'.format(out_dir, prefix), 'a').close()
            tmp_cnt = {}
    for key, value in tmp_cnt.items():
        reads_count[key] += value

    logger.info('[4/4] scanning raw reads for partial BSJs')
    with timer.stage('scan_raw'):
        tmp_cnt, _short = scan_raw_reads(
            ctx, in_file, is_canonical, out_dir, prefix,
            threads=args.threads, ref_fasta=ref_fasta, idx_file=idx_file,
            index_cache=index_cache, device=device)
    for key, value in tmp_cnt.items():
        reads_count[key] += value
    if device.type == 'cuda':
        import torch
        torch.cuda.synchronize(device)


def _finish_call(logger, timer, reads_count, out_dir, prefix):
    from ciri_long_tpu_torch.utils.dispatch import CALL_KERNELS, launch_counts

    logger.info('non-linear raw reads: {}'.format(reads_count['raw_unmapped']))
    logger.info('mapped consensus reads: {}'.format(reads_count['ccs_mapped']))
    logger.info('BSJ calls: {}'.format(reads_count['bsj']))
    logger.info('calls with splice signal: {}'.format(reads_count['signal']))
    logger.info('partial calls from raw reads: {}'.format(
        reads_count['partial']))

    summary = dict(reads_count)
    summary['timing'] = timer.as_dict()
    summary['kernels'] = launch_counts(CALL_KERNELS)
    with open('{}/{}.json'.format(out_dir, prefix), 'w') as f:
        json.dump(summary, f)

    logger.info('call stage done')
    return reads_count


def collapse(args):
    from ciri_long_tpu_torch.annot.gtf import _PortUnpickler
    from ciri_long_tpu_torch.context import Context
    from ciri_long_tpu_torch.io.genome import Genome
    from ciri_long_tpu_torch.pipeline import collapse as collapse_mod
    from ciri_long_tpu_torch.utils.dispatch import (COLLAPSE_KERNELS,
                                                    DEVICE_MS, launch_counts,
                                                    reset_launches,
                                                    resolve_device)
    from ciri_long_tpu_torch.utils.logger import StageTimer, get_logger
    from ciri_long_tpu_torch.utils.misc import check_dir, check_file

    device = resolve_device(args.device)
    reset_launches()          # the log counts this run's launches only
    if device.type == 'cuda' and args.threads > 1:
        raise NotImplementedError(THREADS_TODO)

    if args.input is None or args.output is None:
        sys.exit('Please provide input and output file, run CIRI-long using '
                 '-h or --help for detailed information.')

    in_file = check_file(args.input)
    out_dir = check_dir(args.output)
    check_dir(out_dir + '/tmp')
    prefix = args.prefix

    gtf_file = None if args.gtf is None else check_file(args.gtf)
    circ_file = None if args.circ is None else check_file(args.circ)
    ref_fasta = check_file(args.reference)
    debugging = args.debug

    logger = get_logger('CIRI-long', fname='{}/{}.log'.format(out_dir, prefix),
                        verbosity=debugging)
    logger.info('=== run configuration ===')
    logger.info('reads: ' + os.path.basename(in_file))
    logger.info('output dir: ' + os.path.basename(out_dir))
    logger.info('device: {}'.format(device))
    logger.info('=== collapse stage ===')

    timer = StageTimer()
    gtf_idx, intron_idx, ss_idx = _load_or_build_index(
        out_dir, gtf_file, circ_file, logger)

    cand_reads = collapse_mod.load_cand_circ(in_file)

    genome = Genome.from_cache(out_dir + '/tmp/gcodes', ref_fasta)
    if genome is None:
        genome = Genome(ref_fasta)
    ctx = Context(aligner=None, genome=genome, gtf_index=gtf_idx,
                  intron_index=intron_idx, ss_index=ss_idx)

    corrected_file = '{}/tmp/{}.corrected.pkl'.format(out_dir, prefix)
    if not debugging and os.path.exists(corrected_file):
        logger.info('[1/2] resuming corrected clusters from tmp/')
        with open(corrected_file, 'rb') as pkl:
            circ_num, corrected_reads = _PortUnpickler(pkl).load()
    else:
        logger.info('[1/2] clustering + correcting candidate reads')
        with timer.stage('cluster', items=len(cand_reads)):
            reads_cluster = collapse_mod.cluster_reads(cand_reads)
            logger.info('BSJ clusters: {}'.format(len(reads_cluster)))
            idx_file = out_dir + '/tmp/ss.idx'
            # refresh the packed-genome cache whenever the current run
            # could not load it (absent OR stale)
            import numpy as np
            gcache = out_dir + '/tmp/gcodes'
            backing = (ctx.genome.codes if ctx.genome.codes is not None
                       else ctx.genome.packed)
            if not isinstance(backing, np.memmap):
                try:
                    ctx.genome.save_cache(gcache)
                except (OSError, ValueError):
                    gcache = None
            circ_num, corrected_reads = collapse_mod.correct_reads(
                ctx, reads_cluster, threads=args.threads,
                ref_fasta=ref_fasta,
                idx_file=idx_file if os.path.exists(idx_file) else None,
                gcache=gcache, device=device)
        with open(corrected_file, 'wb') as pkl:
            pickle.dump([circ_num, corrected_reads], pkl, -1)
        logger.info('Corrected clusters: {}, {}/{}/{}/{} annotated/denovo/'
                    'lariat/unknown'.format(
                        len(corrected_reads), circ_num['Annotated'],
                        circ_num['Denovo signal'],
                        circ_num['High confidence lariat'],
                        circ_num['Unknown signal']))

    logger.info('[2/2] writing expression / isoform matrices')
    with timer.stage('exp_mtx'):
        circ_cnt, iso_cnt = collapse_mod.cal_exp_mtx(
            ctx, cand_reads, corrected_reads, out_dir, prefix)
    if device.type == 'cuda':
        import torch
        torch.cuda.synchronize(device)
    logger.info('circRNAs: {}  isoforms: {}'.format(circ_cnt, iso_cnt))
    logger.info('kernels: {}'.format(json.dumps(
        launch_counts(COLLAPSE_KERNELS))))
    # the device time of the launches a host loop times itself
    logger.info('device ms: {}'.format(json.dumps(DEVICE_MS)))
    logger.info('collapse stage done')
    return circ_cnt, iso_cnt


def main(argv=None):
    import argparse
    from ciri_long_tpu_torch.version import __version__

    parser = argparse.ArgumentParser('CIRI-long-torch')
    parser.add_argument('-v', '--version', action='version',
                        version='%(prog)s v{}'.format(__version__))
    subparsers = parser.add_subparsers(help='commands')

    call_parser = subparsers.add_parser('call')
    call_parser.add_argument('-i', '--in', dest='input', metavar='READS',
                             default=None, help='Input reads.fq.gz')
    call_parser.add_argument('-o', '--out', dest='output', metavar='DIR',
                             default=None, help='Output directory, default: ./')
    call_parser.add_argument('-r', '--ref', dest='reference', metavar='REF',
                             default=None, help='Reference genome FASTA file')
    call_parser.add_argument('-p', '--prefix', dest='prefix', metavar='PREFIX',
                             default='CIRI-long',
                             help='Output sample prefix, (default: %(default)s)')
    call_parser.add_argument('-a', '--anno', dest='gtf', metavar='GTF',
                             default=None, help='Genome reference gtf, (optional)')
    call_parser.add_argument('-c', '--circ', dest='circ', metavar='CIRC',
                             default=None,
                             help='Additional circRNA annotation in bed/gtf format, (optional)')
    call_parser.add_argument('-t', '--threads', dest='threads', metavar='INT',
                             type=int, default=1,
                             help='Host worker processes (--device cpu only '
                                  'above 1), (default: %(default)s)')
    call_parser.add_argument('--device', dest='device', default='cuda',
                             choices=['cuda', 'cpu'],
                             help='Where the SW scorer runs, (default: '
                                  '%(default)s)')
    call_parser.add_argument('--debug', dest='debug', default=False,
                             action='store_true',
                             help='Run in debugging mode, (default: %(default)s)')
    call_parser.set_defaults(func=call)

    collapse_parser = subparsers.add_parser('collapse')
    collapse_parser.add_argument('-i', '--in', dest='input', metavar='LIST',
                                 default=None,
                                 help='Input list of CIRI-long results')
    collapse_parser.add_argument('-o', '--out', dest='output', metavar='DIR',
                                 default=None, help='Output directory, default: ./')
    collapse_parser.add_argument('-p', '--prefix', dest='prefix',
                                 metavar='PREFIX', default='CIRI-long',
                                 help='Output sample prefix, (default: %(default)s)')
    collapse_parser.add_argument('-r', '--ref', dest='reference', metavar='REF',
                                 default=None, help='Reference genome FASTA file')
    collapse_parser.add_argument('-a', '--anno', dest='gtf', metavar='GTF',
                                 default=None, help='Genome reference gtf, (optional)')
    collapse_parser.add_argument('-c', '--circ', dest='circ', metavar='CIRC',
                                 default=None,
                                 help='Additional circRNA annotation in bed/gtf format, (optional)')
    collapse_parser.add_argument('-t', '--threads', dest='threads',
                                 metavar='INT', type=int, default=1,
                                 help='Host worker processes (--device cpu '
                                      'only above 1), (default: %(default)s)')
    collapse_parser.add_argument('--device', dest='device', default='cuda',
                                 choices=['cuda', 'cpu'],
                                 help='Where the SW, edit-distance and '
                                      'traceback kernels run, (default: '
                                      '%(default)s)')
    collapse_parser.add_argument('--debug', dest='debug', default=False,
                                 action='store_true',
                                 help='Run in debugging mode, (default: %(default)s)')
    collapse_parser.set_defaults(func=collapse)

    args = parser.parse_args(argv)
    try:
        func = args.func
    except AttributeError:
        parser.error('too few arguments')
    func(args)


if __name__ == '__main__':
    main()
