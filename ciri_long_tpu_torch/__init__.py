"""CIRI-long on PyTorch and CUDA: the port of ``ciri_long_tpu`` to one
NVIDIA Hopper GPU.

The JAX package stays the reference; each module here keeps its path and
names (``ops/sw.py`` <-> ``ops/sw.py``).  Plain tensor code is PyTorch, and
every Pallas kernel of the JAX package has a hand-written CUDA counterpart in
``csrc/`` (built at first use by ``ops/_build.py``).  The package imports
nothing of ``ciri_long_tpu`` and nothing of ``jax``: it keeps its own copies
of the JAX-free leaf modules (config, context, io, annot, utils.{seq,misc,
logger,diskcache}, tools.simulate, version) and loads the native C++ cores
of ``native/`` built under its own name (``ciri_long_tpu_torch._alncore``,
``_nwcore``, ``_chaincore``, ``_ccscore``, ``_poacore``, ``_fastxcodec``).

Layout:
  csrc/      CUDA sources of the kernels
  ops/       SW scorers and batches (device), host alignment cores
  models/    minimizer index, hits, seed-chain-extend aligner (host)
  pipeline/  call stages: find_ccs, find_bsj
  cli/       ``call`` command line with ``--device {cuda,cpu}``
  io/, annot/, config, context   copies of the JAX package's leaf modules
  misc/      kernel probes: the SW variant harness (kexp) and int16_probe
  tools/     seeded worlds and read simulation
  utils/     device resolution, launch counters, sequence codes, logging
"""

from ciri_long_tpu_torch.version import __version__

__all__ = ["__version__"]
