"""Standalone pairwise-alignment CLI.

Port of ciri_long_tpu/tools/ssw_cli.py, the role of the vendored SSW
library's standalone programs (reference libs/striped_smith_waterman/main.c
and pyssw.py): align every query in one FASTA against every target in
another and print score / coordinates / cigar.  The scores and coordinates
come from ops/sw.py::sw_align_batch on ``--device`` (csrc/sw_score_ends.cu
on the card, the default; the host on cpu), the cigar from the host
traceback (ops/traceback.py::sw_traceback), as in the JAX package.

  python -m ciri_long_tpu_torch.tools.ssw_cli target.fa query.fa \\
      [--match 2 --mismatch 2 --gap-open 3 --gap-extend 1] [--cigar] \\
      [--device cuda|cpu]
"""

import argparse

from ciri_long_tpu_torch.io.fastx import read_fastx
from ciri_long_tpu_torch.ops.sw import SWParams, sw_align_batch
from ciri_long_tpu_torch.ops.traceback import cigar_to_string, sw_traceback
from ciri_long_tpu_torch.utils.dispatch import resolve_device
from ciri_long_tpu_torch.utils.seq import encode_seq, pad_encoded


def main(argv=None):
    ap = argparse.ArgumentParser('ciri-long-torch-ssw')
    ap.add_argument('target')
    ap.add_argument('query')
    ap.add_argument('--match', type=int, default=2)
    ap.add_argument('--mismatch', type=int, default=2)
    ap.add_argument('--gap-open', type=int, default=3)
    ap.add_argument('--gap-extend', type=int, default=1)
    ap.add_argument('--cigar', action='store_true',
                    help='also print the alignment cigar')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                    help='where the SW scorer runs, (default: %(default)s)')
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    params = SWParams(args.match, args.mismatch, args.gap_open,
                      args.gap_extend)
    targets = list(read_fastx(args.target))
    queries = list(read_fastx(args.query))

    pairs = [(qn, qs, tn, ts) for qn, qs in queries for tn, ts in targets]
    q_codes = [encode_seq(qs) for _, qs, _, _ in pairs]
    t_codes = [encode_seq(ts) for _, _, _, ts in pairs]
    qb, _ = pad_encoded(q_codes)
    tb, _ = pad_encoded(t_codes)
    res = sw_align_batch(qb, tb, params, device)

    print('\t'.join(['query', 'target', 'score', 'q_begin', 'q_end',
                     't_begin', 't_end'] + (['cigar'] if args.cigar else [])))
    for i, (qn, qs, tn, ts) in enumerate(pairs):
        row = [qn, tn, int(res.score[i]), int(res.query_begin[i]),
               int(res.query_end[i]), int(res.ref_begin[i]),
               int(res.ref_end[i])]
        if args.cigar:
            tb_ = sw_traceback(q_codes[i], t_codes[i], args.match,
                               args.mismatch, args.gap_open, args.gap_extend)
            row.append(cigar_to_string(tb_[5]) if tb_ else '*')
        print('\t'.join(str(x) for x in row))


if __name__ == '__main__':
    main()
