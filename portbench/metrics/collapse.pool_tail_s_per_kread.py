"""Thread-seconds the cluster threads of ``correct_chunk``'s pools sat
idle (the counter ``pool.tail_thread_s``: a chunk's wall time times its
pool's width, less its clusters' thread-seconds; from each ``collapse``
run's summary JSON, summed over the window's runs) over the window's
thousands of input reads."""

from summaries import per_kread


def read(rec):
    return per_kread(
        rec, lambda s: s['counters'].get('pool.tail_thread_s', 0.0))
