#!/usr/bin/env python3
"""A cell's checks over several seeds, read for the program and for each
check's control in one process: the two readings a limit is set from.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 30

Each seed is one run of the cell (``run.run_cell``: its world, set-up and
window at the cell's own load), then its checks judge the window's output
as the program made it and with the control in the program's place.  One
JSON line a seed: ``correct``, the program's readings (``checks``) and the
control's (``control_checks``).  The benchmark's own runs never run the
control.
"""

import argparse
import json

import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True,
                    help='comma-separated seeds, one run each')
    ap.add_argument('--seconds', type=float, required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(',')):
        out = run.run_cell(args.workload, seed, args.seconds, False,
                           controls=True)
        print(json.dumps({'seed': seed, 'correct': out['correct'],
                          'checks': out['checks'],
                          'control_checks': out['control_checks'],
                          'metrics': out['metrics']}), flush=True)


if __name__ == '__main__':
    main()
