"""Per cent of the traced window in which no operation of the process ran
on the card (``torch.profiler``'s device activity, the union of its
intervals), in ``collapse``."""


def read(rec):
    if rec['entry'] == 'collapse' and rec.get('busy_s'):
        return 100.0 * (1.0 - rec['busy_s'] / rec['traced_s'])
