"""Device milliseconds of ``poa_align``'s launches (``utils/dispatch.py``'s
``DEVICE_MS``: CUDA events around each launch of csrc/poa_align.cu's round
loop, summed over the window's runs) over the window's thousands of input
reads."""


def read(rec):
    ms = [u['device_ms']['poa_align'] for u in rec['units']
          if 'poa_align' in u.get('device_ms', {})]
    if rec['entry'] == 'collapse' and ms and rec['reads']:
        return sum(ms) / (rec['reads'] / 1000)
