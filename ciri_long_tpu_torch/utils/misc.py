"""Small host-side helpers (reference: utils.py:15-115)."""

import itertools
import os
import sys
import threading
import _thread as _low_thread
from collections import defaultdict
from operator import itemgetter


def exit_after(s):
    """Watchdog decorator: interrupt the main thread if the wrapped call
    exceeds ``s`` seconds (reference utils.py:15-30; unused by the
    reference pipeline but part of its public surface)."""
    def outer(fn):
        def inner(*args, **kwargs):
            def quit_function():
                sys.stderr.write('{} took too long\n'.format(fn.__name__))
                sys.stderr.flush()
                _low_thread.interrupt_main()

            timer = threading.Timer(s, quit_function)
            timer.start()
            try:
                result = fn(*args, **kwargs)
            finally:
                timer.cancel()
            return result
        return inner
    return outer


def check_file(file_name):
    if os.path.exists(file_name) and os.path.isfile(file_name):
        return os.path.abspath(file_name)
    sys.exit('File: {}, not found'.format(file_name))


def check_dir(dir_name):
    if os.path.exists(dir_name):
        if not os.path.isdir(dir_name):
            sys.exit('Directory: {}, clashed with existed files'.format(dir_name))
    else:
        os.makedirs(dir_name, exist_ok=True)
    return os.path.abspath(dir_name)


def to_str(bytes_or_str):
    if isinstance(bytes_or_str, bytes):
        return bytes_or_str.decode('utf-8')
    return bytes_or_str


def to_bytes(bytes_or_str):
    if isinstance(bytes_or_str, str):
        return bytes_or_str.encode('utf-8')
    return bytes_or_str


def grouper(iterable, n):
    """Chunk into fixed-length groups, last group None-padded
    (utils.py:78-86)."""
    args = [iter(iterable)] * n
    return itertools.zip_longest(*args, fillvalue=None)


def pairwise(iterable):
    a, b = itertools.tee(iterable)
    next(b, None)
    return zip(a, b)


def tree():
    return defaultdict(tree)


def flatten(x):
    return list(itertools.chain(*x))


def min_sorted_items(iters, key, reverse=False):
    x = sorted(iters, key=itemgetter(key), reverse=reverse)
    return [i for i in x if i[key] == x[0][key]]
