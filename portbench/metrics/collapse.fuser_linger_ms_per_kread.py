"""Milliseconds the fuser's dispatcher held pending SW and edit jobs back,
free but waiting for its fire rule (the span ``fuser.linger`` of
``parallel/fuser.py``, from each ``collapse`` run's summary JSON, summed
over the window's runs) over the window's thousands of input reads."""

from summaries import per_kread, thread_seconds


def read(rec):
    return per_kread(
        rec, lambda s: 1e3 * thread_seconds(s, 'fuser.linger'))
