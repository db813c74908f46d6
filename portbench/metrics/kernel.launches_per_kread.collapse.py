"""Launches of the hand-written kernels in ``collapse`` (``LAUNCHES`` of
``utils/dispatch.py``, summed over the window's runs; an exact count)
over the window's thousands of input reads."""


def read(rec):
    n = sum(sum(u.get('launches', {}).values()) for u in rec['units'])
    if rec['entry'] == 'collapse' and rec['reads']:
        return n / (rec['reads'] / 1000)
