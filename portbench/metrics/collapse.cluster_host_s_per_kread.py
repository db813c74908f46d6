"""Thread-seconds of the cluster threads' own host work: the state
``collapse.cluster_host``, each cluster's time outside the fuser's rounds,
the sub-cluster POA, the junction POA and the rotation tracebacks (from
each ``collapse`` run's summary JSON, summed over the window's runs), over
the window's thousands of input reads."""

from summaries import per_kread, thread_seconds


def read(rec):
    return per_kread(
        rec, lambda s: thread_seconds(s, 'collapse.cluster_host'))
