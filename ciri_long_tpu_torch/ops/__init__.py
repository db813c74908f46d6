"""Device ops of the port: the SW scorers and their batches, edit distance,
tracebacks, POA, CCS consensus, the tandem screen and lag profile, and
chaining.  The names of the JAX package's ``ops`` (same ``__all__``), each
imported at first use (``ciri_long_tpu_torch._exports``).  ``ops.poa`` is
its submodule, which is also callable as JAX's ``ops.poa`` function."""

from ciri_long_tpu_torch._exports import lazy_getattr

_SOURCES = {
    'SWParams': 'sw', 'sw_align_batch': 'sw', 'sw_score_ends': 'sw',
    'sw_score_ends_auto': 'sw', 'sw_window_align': 'sw',
    'edit_distance': 'edit', 'edit_distance_batch': 'edit',
    'banded_global_cigar': 'traceback', 'splice_junction_align': 'traceback',
    'sw_traceback': 'traceback',
    'poa': 'poa', 'center_star_consensus': 'ccs', 'find_consensus': 'ccs',
    'lag_profile': 'period',
    'backtrack_chains': 'chain', 'chain_scores_batch': 'chain',
}

__all__ = [
    "SWParams", "sw_align_batch", "sw_score_ends", "sw_score_ends_auto",
    "sw_window_align",
    "edit_distance", "edit_distance_batch",
    "banded_global_cigar", "splice_junction_align", "sw_traceback",
    "poa", "center_star_consensus", "find_consensus", "lag_profile",
    "backtrack_chains", "chain_scores_batch",
]

__getattr__ = lazy_getattr(__name__, _SOURCES)
