"""Logging + progress reporting (reference: logger.py:10-63), extended with
per-stage wall-clock / throughput counters (SURVEY.md §5 'add: per-stage
wall-clock + reads/s and DP-cells/s counters')."""

import logging
import sys
import time
from contextlib import contextmanager


class ProgressBar(object):
    def __init__(self, width=50):
        self.last_x = -1
        self.width = width

    def update(self, x):
        x = max(0, min(100, x))
        if self.last_x == int(x):
            return
        self.last_x = int(x)
        p = int(self.width * (x / 100.0))
        time_stamp = time.strftime("[%a %Y-%m-%d %H:%M:%S]", time.localtime())
        sys.stderr.write('\r%s [%-5s] [%s]' % (
            time_stamp, str(int(x)) + '%', '#' * p + '.' * (self.width - p)))
        sys.stderr.flush()
        if x == 100:
            sys.stderr.write('\n')


def get_logger(logger_name='CIRI-long', fname=None, verbosity=False):
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.DEBUG)
    level = logging.DEBUG if verbosity else logging.INFO

    fmt = "%(asctime)-15s [%(levelname)-5s] %(message)s"
    datefmt = "[%a %Y-%m-%d %H:%M:%S]"
    formatter = logging.Formatter(fmt, datefmt)

    logger.handlers = []
    if fname is not None:
        file_handler = logging.FileHandler(fname, mode='w')
        file_handler.setLevel(level)
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)

    console_handler = logging.StreamHandler(sys.stderr)
    console_handler.setLevel(level)
    console_handler.setFormatter(formatter)
    logger.addHandler(console_handler)

    return logger


class StageTimer:
    """Collects per-stage wall clock and throughput counters; dumped into the
    run-summary JSON next to the reference's read counters.  Each stage is
    the span ``stage.<name>`` of utils/dispatch.py, whose time it reports."""

    def __init__(self):
        self.stages = {}

    @contextmanager
    def stage(self, name, items=None):
        from ciri_long_tpu_torch.utils.dispatch import span

        rec = {"seconds": None}
        self.stages[name] = rec
        timed = span('stage.' + name)
        try:
            with timed:
                yield rec
        finally:
            dt = timed.ns / 1e9
            rec["seconds"] = round(dt, 3)
            if items is not None and dt > 0:
                rec["items"] = items
                rec["items_per_s"] = round(items / dt, 2)

    def as_dict(self):
        return dict(self.stages)
