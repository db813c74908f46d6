"""Centralised pipeline constants.

The reference scatters magic numbers through the code (chunk sizes at
find_ccs.py:49 / find_bsj.py:338,666; filter ratios at find_bsj.py:244-246,
272,280; SSW window at find_bsj.py:196-197; cluster tolerances at
collapse.py:104,118,484,489; max_cluster at collapse.py:218).  Here they
live in one frozen dataclass so the CLI, the pipeline and the tests agree.
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ScoreParams:
    """Affine-gap alignment scoring (positive penalties).

    Gap of length L costs ``gap_open + (L - 1) * gap_extend`` -- the same
    convention as the reference's vendored SSW (ssw.c:229-239, where
    ``e = max(e - gapE, h - gapO)``).
    """

    match: int = 1
    mismatch: int = 1
    gap_open: int = 1
    gap_extend: int = 1


# SSW scoring used for clip re-alignment (find_bsj.py:204,214)
CLIP_SCORE = ScoreParams(match=1, mismatch=1, gap_open=1, gap_extend=1)
# SSW scoring used throughout collapse junction curation (collapse.py:170,213,251,259,373,711)
JUNC_SCORE = ScoreParams(match=10, mismatch=4, gap_open=8, gap_extend=2)


@dataclass(frozen=True)
class PoaParams:
    """spoa parameterisation: poa(seqs, 2, False, 10, -4, -8, -2, -24, -1)
    (collapse.py:267,504): semi-global, match 10, mismatch -4, first gap
    open -8 extend -2, second gap open -24 extend -1 (convex)."""

    match: int = 10
    mismatch: int = -4
    gap_open: int = -8
    gap_extend: int = -2
    gap_open2: int = -24
    gap_extend2: int = -1


@dataclass(frozen=True)
class CallConfig:
    """Stage-1 (`call`) thresholds. file:line cites are to the reference."""

    ccs_chunk_size: int = 250          # find_ccs.py:49
    raw_chunk_size: int = 1000         # find_bsj.py:666
    # Filter 1: linear-mapped raws (find_bsj.py:244-246)
    linear_frac: float = 0.8
    linear_margin: int = 200
    linear_vs_ccs: float = 1.5
    # short CCS recovery threshold (find_bsj.py:260-261)
    short_ccs_len: int = 150
    # circ alignment acceptance (find_bsj.py:272)
    circ_mlen_frac: float = 0.75
    # clip-base acceptance (find_bsj.py:280)
    clip_frac: float = 0.15
    clip_max: int = 20
    # SSW clip re-alignment window (find_bsj.py:196-197)
    clip_window: int = 200_000
    # N-content rejection of the window (find_bsj.py:200)
    max_n_frac: float = 0.3
    # partial-read scan (find_bsj.py:510,520-539)
    min_raw_len: int = 300
    # splice-signal search (find_bsj.py:287-290)
    ss_search_length: int = 10
    ss_shift_threshold: int = 3


@dataclass(frozen=True)
class CollapseConfig:
    """Stage-2 (`collapse`) thresholds."""

    bsj_tolerance: int = 20            # collapse.py:104,118
    bin_size: int = 500                # collapse.py:110,123
    max_circ_len: int = 200_000        # collapse.py:87
    max_cluster: int = 200             # collapse.py:218,235
    junc_width: int = 25               # collapse.py:152,260
    curate_width: int = 10             # collapse.py:169
    cluster_dist_threshold: float = 0.3  # collapse.py:484,489
    subcluster_batch: int = 50         # collapse.py:441-444
    exon_cluster_dist: int = 10        # collapse.py:583-584
    min_circ_len: int = 30             # collapse.py:921
    cluster_chunk_size: int = 250      # collapse.py:850


@dataclass(frozen=True)
class AlignerConfig:
    """Seed-chain-extend aligner parameters (replaces minimap2 splice
    preset, find_bsj.py:336, and BWA ont2d, find_bsj.py:457)."""

    k: int = 15                  # minimizer k-mer size (minimap2 splice: k=15)
    w: int = 5                   # minimizer window (minimap2 splice: w=5)
    max_occ: int = 200           # drop seeds more repetitive than this
    max_gap_ref: int = 200_000   # max intron length / chain gap on reference
    max_gap_query: int = 500     # max chain gap on query
    min_chain_score: int = 30    # minimum anchors bp in a chain
    min_chain_anchors: int = 3
    bw: int = 500                # extension band width
    short_k: int = 11            # recovery pass (BWA ont2d analog) k-mer
    short_w: int = 3
    short_min_chain_score: int = 19   # '-T 19' (find_bsj.py:457)
    short_min_chain_anchors: int = 2


@dataclass(frozen=True)
class Config:
    call: CallConfig = field(default_factory=CallConfig)
    collapse: CollapseConfig = field(default_factory=CollapseConfig)
    aligner: AlignerConfig = field(default_factory=AlignerConfig)


DEFAULT = Config()
