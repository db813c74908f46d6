"""``collapse`` of a cohort, again and again, each time afresh.

Set-up calls each sample's read file once with the port's ``call``, with
the world's annotation (``-a``) as upstream's CI passes it, writes the list
file ``collapse -i`` takes (``sample<TAB>cand_circ.fa`` a line) and runs
one warm-up ``collapse`` of the cohort.  Each unit of the window is one
``collapse`` of the cohort into a fresh output directory, so nothing
resumes from an earlier ``tmp/``.  A unit's record names its output
directory and its arguments, which the checks read.
"""

import os

from worlds import sample_list

SPANS = {
    'collapse.cluster_reads': ('ciri_long_tpu_torch.pipeline.collapse',
                               'cluster_reads'),
    'collapse.correct_reads': ('ciri_long_tpu_torch.pipeline.collapse',
                               'correct_reads'),
    'collapse.cal_exp_mtx': ('ciri_long_tpu_torch.pipeline.collapse',
                             'cal_exp_mtx'),
    'collapse.poa_consensus_many': ('ciri_long_tpu_torch.ops.poa',
                                    'poa_consensus_many'),
}
PREFIX = 'cohort'


def setup(world, work, device, mix):
    from ciri_long_tpu_torch.cli.main import main
    from ciri_long_tpu_torch.utils import dispatch

    ref, gtf = world['ref'], world['gtf']
    listed = []
    for name, sample in world['samples'].items():
        out = os.path.join(work, 'calls', name)
        main(['call', '-i', sample['file'], '-o', out, '-r', ref, '-a', gtf,
              '-p', name, '-t', '1', '--device', device])
        listed.append((name, os.path.join(out, name + '.cand_circ.fa')))
    lst = sample_list(os.path.join(work, 'samples.lst'), listed)
    reads = world['reads'] * len(listed)

    def argv(lst_path, out):
        return ['collapse', '-i', lst_path, '-o', out, '-r', ref, '-a', gtf,
                '-p', PREFIX, '-t', '1', '--device', device]

    main(argv(lst, os.path.join(work, 'warm')))

    def unit(i):
        out = os.path.join(work, 'out', str(i))
        main(argv(lst, out))
        return {'reads': reads, 'out': out, 'prefix': PREFIX,
                'argv': argv(lst, out), 'listed': listed,
                'launches': dispatch.launch_counts(dispatch.COLLAPSE_KERNELS),
                'device_ms': dict(dispatch.DEVICE_MS)}

    return unit
