"""The cohort's input reads times the ``collapse`` runs completed in the
window, over the window's seconds (from the first run's start to the end of
the run in flight at ``--seconds``): benchmarks/collapse_bench.py's reads
over wall, over many runs."""


def read(rec):
    if rec['entry'] == 'collapse' and rec['window_s'] > 0:
        return rec['reads'] / rec['window_s']
