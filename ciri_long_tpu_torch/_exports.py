"""The public names of the port's packages, imported at first use.

``ops``, ``models``, ``utils`` and ``parallel`` export the names the JAX
package's ``__init__.py`` files export, under the same ``__all__``, through a
module-level ``__getattr__`` (PEP 562): importing a package loads none of
its modules (no torch, no kernel build), so a spawned worker starts no
slower; a name's module is imported when the name is first read.
"""

import importlib
import sys


def lazy_getattr(package, sources):
    """The ``__getattr__`` of ``package``, whose names map to the submodule
    that defines each (``sources``).  A name read once stays bound in the
    package; a name that is also its submodule's (``ops.poa``) is whatever
    the import binds there, the submodule."""
    def __getattr__(name):
        if name not in sources:
            raise AttributeError('module {!r} has no attribute {!r}'.format(
                package, name))
        module = importlib.import_module(
            '{}.{}'.format(package, sources[name]))
        names = sys.modules[package].__dict__
        if name not in names:
            names[name] = getattr(module, name)
        return names[name]
    return __getattr__
