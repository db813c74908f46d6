"""The aligner and its hits; the JAX package's ``models`` names (same
``__all__``), each imported at first use (``ciri_long_tpu_torch._exports``)."""

from ciri_long_tpu_torch._exports import lazy_getattr

_SOURCES = {'GenomeAligner': 'aligner', 'Hit': 'hits', 'SubHit': 'hits',
            'get_primary_alignment': 'hits', 'remove_long_insert': 'hits'}

__all__ = ["GenomeAligner", "Hit", "SubHit", "get_primary_alignment",
           "remove_long_insert"]

__getattr__ = lazy_getattr(__name__, _SOURCES)
