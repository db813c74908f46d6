"""Wrapping a function of the program from outside it, and undoing that."""

import functools
import importlib
import sys


class Patches:
    def __init__(self):
        self._undo = []

    def wrap(self, module, attr, fn):
        """Put ``lambda *a, **kw: fn(orig, *a, **kw)`` in place of
        ``module.attr`` (``attr`` a function's name, or ``Class.method``).
        A function is replaced in every loaded module of the program that
        bound it by an import as well."""
        mod = importlib.import_module(module)
        owner, name = mod, attr
        if '.' in attr:
            cls, name = attr.split('.')
            owner = getattr(mod, cls)
            orig = owner.__dict__[name]
        else:
            orig = getattr(mod, name)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            return fn(orig, *args, **kwargs)

        sites = [(owner, name)]
        if owner is mod:
            for other in list(sys.modules.values()):
                if (other is mod or other is None or not getattr(
                        other, '__name__', '').startswith(
                            'ciri_long_tpu_torch')):
                    continue
                for key, value in list(vars(other).items()):
                    if value is orig:
                        sites.append((other, key))
        for site, key in sites:
            setattr(site, key, wrapper)
            self._undo.append((site, key, orig))

    def undo(self):
        for site, key, orig in reversed(self._undo):
            setattr(site, key, orig)
        self._undo.clear()
