"""Parallel layers of the port: collapse's dispatch fuser, the drain
between a host pool and the card, and the mesh scan (records, mesh,
cohort, multihost_worker, dryrun).  The JAX package's ``parallel`` names
(same ``__all__``), each imported at first use
(``ciri_long_tpu_torch._exports``)."""

from ciri_long_tpu_torch._exports import lazy_getattr

__all__ = ["READS_AXIS", "LAG_AXIS", "make_mesh", "sharded_sw",
           "sharded_pipeline_step"]

_SOURCES = {name: 'mesh' for name in __all__}

__getattr__ = lazy_getattr(__name__, _SOURCES)
