"""Milliseconds of collapse's fused SW and edit-distance rounds, summed
over the rounds: each native round's Python pack and unpack and its
native upload, device wait and download (the counters ``fuser.ns.<phase>``,
steady-clock ns, from each ``collapse`` run's summary JSON, summed over
the window's runs), over the window's thousands of input reads.  Nothing
where no run counted a native round (a program without them)."""

from summaries import per_kread

PHASES = ('pack', 'upload', 'device_wait', 'download', 'unpack')


def read(rec):
    seen = []

    def ms(summary):
        counted = summary['counters']
        seen.append(any('fuser.ns.' + p in counted for p in PHASES))
        return sum(counted.get('fuser.ns.' + p, 0.0) for p in PHASES) / 1e6

    value = per_kread(rec, ms)
    return value if any(seen) else None
