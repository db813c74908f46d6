"""Milliseconds of host work between the launches of csrc/poa_align.cu's
round loop, summed over the cluster threads: its pack, plan, upload,
download and fuse phases (the counters ``poa.ns.<phase>``, steady-clock ns
a phase, from each ``collapse`` run's summary JSON, summed over the
window's runs), over the window's thousands of input reads."""

from summaries import per_kread

PHASES = ('pack', 'plan', 'upload', 'download', 'fuse')


def read(rec):
    return per_kread(rec, lambda s: sum(
        s['counters'].get('poa.ns.' + p, 0.0) for p in PHASES) / 1e6)
