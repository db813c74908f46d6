"""Seconds from the start of the run to the start of the window: the
native cores' load (their build in a fresh checkout), the world made from
the seed, the kernels' load (their build in a fresh checkout) and the
warm-up runs."""


def read(rec):
    return rec['setup_s']
