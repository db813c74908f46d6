"""Sequence codes, small helpers, logging, device resolution and launch
counters; the JAX package's ``utils`` names (same ``__all__``), each
imported at first use (``ciri_long_tpu_torch._exports``)."""

from ciri_long_tpu_torch._exports import lazy_getattr

__all__ = [
    "encode_seq", "decode_seq", "revcomp", "revcomp_encoded", "transform_seq",
    "get_junc_seq", "compress_seq", "pad_encoded",
    "check_file", "check_dir", "grouper", "pairwise", "flatten",
    "min_sorted_items", "tree", "to_str", "to_bytes",
    "get_logger", "ProgressBar",
]

_SOURCES = dict(
    {name: 'seq' for name in __all__[:8]},
    **{name: 'misc' for name in __all__[8:17]},
    **{name: 'logger' for name in __all__[17:]})

__getattr__ = lazy_getattr(__name__, _SOURCES)
