"""CIRI-long on PyTorch and CUDA: the port of ``ciri_long_tpu`` to one
NVIDIA Hopper GPU.

The JAX package stays the reference; each module here keeps its path and
names (``ops/sw.py`` <-> ``ops/sw.py``).  Plain tensor code is PyTorch, the
Smith-Waterman scorer on the card is a hand-written CUDA kernel
(``csrc/sw_score_ends.cu``, built at first use by ``ops/_build.py``), and the
host-side logic reuses the JAX-free leaf modules and native C++ cores of
``ciri_long_tpu`` (config, context, io, annot, utils.{seq,misc,logger,
diskcache}, tools.simulate, version, ``_alncore``/``_nwcore``/``_chaincore``/
``_ccscore``/``_poacore``/``_fastxcodec``).  Nothing here imports ``jax``.

Layout:
  csrc/      CUDA sources of the kernels
  ops/       SW scorer and batches (device), host alignment cores
  models/    minimizer index, hits, seed-chain-extend aligner (host)
  pipeline/  call stages: find_ccs, find_bsj
  cli/       ``call`` command line with ``--device {cuda,cpu}``
  utils/     device resolution and kernel launch counters
"""

from ciri_long_tpu.version import __version__

__all__ = ["__version__"]
