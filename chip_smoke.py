#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Drives ``ciri_long_tpu_torch`` on the card in phases, one JSON line each,
and exits non-zero if any phase fails (none is caught and skipped):

1. device and build: the card, the CUDA kernels built from csrc/, and the
   native host cores built from native/ (``setup.py build_ext --inplace``);
2. every SW kernel (sw_score_ends routed, and each of its two routes
   forced where it takes the shape; sw_rowscan, sw_chain C = 2 and 4)
   against one plain PyTorch output per case on the card, exact, at one
   shape per TPU route sw_score_ends replaces (K1 bench 512x1024x4096, K2
   8x256x512, K4 64x2048x512, K3 4x8192x16384) plus N codes, mid-row PAD,
   all-PAD rows and SWParams(1,1,1,1): (score, q_end, r_end), and for
   sw_score_ends the five sw_align_batch fields; then sw_score_ends's
   routes on tools/sw_cases.py's tile cases at the main path's
   64x28x16384 and 128x54x16384 and at 37x33x5000, its tile edge cases
   (the R boundaries of the tiles' schedule, references cut inside, at
   the end of, at the start of and before a tile's window, twins in two
   tiles and in neighbouring query rows) and a fused round of mixed real
   lengths under one padded 96x54x16384 shape, and on its wavefront
   cases (every real query length at an edge of the wavefront's schedule
   against references of 1, 63, 64, 65 and 130 columns, N, mid-row PAD,
   all-PAD rows, equal-score twins across warps), under three SWParams;
   then a reference too wide for the handoff row in shared memory and a
   fused round of mixed real lengths under one padded shape; then the
   harness's chain and row scan on tools/sw_cases.py's chain jobs (best
   cell in a job's first and last column, all-PAD jobs, twins, N rows,
   queries longer than the references) and wavefront rows at the edges of
   the row scan's runs and warps: the chain at C = 1, 2, 4 and B, the row
   scan by its rule and at every width W of ROWSCAN_WIDTHS;
3. kernel and plain GCUPS at the bench shape and the 1024x1024 square
   (the kernel's launches replayed from a CUDA graph, the plain version's
   wall, each launch fed by the previous one's scores);
4. ``call`` end to end on a seeded 2 Mb world (16 loci, depth 60, 240
   linear reads), ``--device cuda`` then ``--device cpu``: the launch
   counts of its five kernels (sw_score_ends, X2's chain_dp and
   chain_extract, X3's screen_keep, X4's nw_traceback: all > 0 on cuda,
   all 0 in the cpu summary), the route of each SW launch (every launch
   whose shape ops/sw.py::_tile_plan accepts must take the tiled route),
   the center-star pairs aligned on the host (ROUTES['nw_host']: 0 on
   cuda, > 0 on cpu), byte-identical cand_circ.fa, tmp/*.ccs.fa and
   tmp/*.raw.fa, equal counters, reads/s, per-stage seconds, each route's
   wall split (``call_split``, from a third and fourth run with those parts
   timed: the screen, CCS detection and within it the tandem detection, the
   center-star polish (on cpu 0: the native center star aligns inside the
   vote) and the column vote, anchors, chaining, selection and stitching,
   the clips' SW, and map_batch / map around the middle three) and BSJ
   recall/precision
   against the simulated truth; then both SW routes against the plain
   version on the inputs the cuda run gave the kernel, and both timed on
   them, the launches split by route (``call_sw_route``: the tiled route's
   summed device time and its largest launch's ms, plain ms and bound;
   its inputs saved to build/chip_smoke/call_tiled_inputs.pt); then (4b)
   every X4 launch of the cuda run held pair by pair to the port's
   native NW core at its bands (scores and cigar), the first three and the
   largest also to nw_traceback_plain (out, runs and planes), every batch's
   (score, cigar) to the native banded_global_cigar, then
   tools/nw_cases.py's cases along their band ladders (all in one batch,
   under the plan and forced into each width class: C = 1, 2, 4, 8 with the
   rows in registers, a block of warps a pass, the wide class with its rows
   in global scratch; and each alone: every launch against the plain version,
   the results against the native core), and the cases at bands narrow
   enough for each register class, forced there, against the plain version
   and the native core; every star read of the cuda run voted again by the
   plain vote (``star_vote``: csrc/star_vote.cpp against
   center_star_consensus on the same run entries); and the largest launch
   timed (``call_kernel_time``, kernel nw_traceback: a CUDA graph's replay,
   the plain version's wall, the bound from csrc/op_rate.cu's NW cell rate
   or the bytes, its classes, its ``split`` by %globaltimer stamps a task:
   the launch's span, the traceback passes' rows and walk and the check
   passes' rows, each class's span and the resident warps an SM it allows;
   the launches of the run summed, and call's launches by class,
   ``call_routes``); every X2 launch held to the port's
   native chain core (f and pre bit for bit, row by row) and to the host
   backtrack_chains (chains row by row), the first three and the largest
   also to chain_dp_plain and chain_extract_plain, every screen_keep launch
   to screen_keep_plain (one ``kernel_vs_plain`` line each), then the
   case list of tools/chain_cases.py (``extract_cases`` through the
   extraction kernel against chain_extract_plain: tied f, short paths,
   max_chains reached, no candidate, rows over SMEM_ROW, a chain 8 192
   deep, brooms; ``dp_cases`` rows, all in one launch
   and each alone, against chain_dp_plain and the native chain core;
   ``screen_launches`` against screen_keep_plain, each read on the route
   screen_routes_plain gives it), the card's rates for a chaining
   candidate and a screen compare and the DP's serial step
   (csrc/op_rate.cu), and each kernel's largest launch timed
   (``call_kernel_time``: a CUDA graph's replay, the plain version's wall,
   the bound, the DP's ``serial_bound_ms``, the screen's reads on its lag
   route) beside its launches of the run summed and its slowest, from CUDA
   events around each launch in the run (``call_device_ms``,
   ``slowest_ms``) and from a graph's replay of each recorded launch; the
   largest launches' inputs and every extraction launch's go to
   build/chip_smoke/call_x_inputs.pt (what ``python3 -m
   ciri_long_tpu_torch.tools.call_x_ab`` times in two checkouts);
5. the kernel-probe path: the SW variant harness
   (``python -m ciri_long_tpu_torch.misc.kexp``) for the row, wave and
   chain (C = 2, 4) families at the bench shape and the int16 probes
   (``...misc.int16_probe``), through their entry points, with the launch
   counts read around them; then each int16 probe exact against its plain
   version on the TPU probe's input, on negative lanes and on lanes that
   wrap; the card's peak rate for one SW cell update (csrc/op_rate.cu, the
   SW bound); and the times of every family beside the plain version and
   the bound at 512x1024x4096, 512x1024x1024, the main path's 64x28x16384
   and 128x54x16384, and 4096x32x128 (sw_score_ends routed and by each
   route that takes the shape; at the main path's shapes also the tiled
   route at tiles of one, two and eight halos beside the rule's; at the
   wavefront's shapes also the wavefront at 1, 2 and 4 query rows a lane,
   ``wave_rows``; at every shape the chain at C = 2 and 4 by each R of
   1, 2 and 4, ``chain_rows``, and the row scan at each width W,
   ``rowscan_widths``), and of each probe; then the six probes in one
   launch (``int16_probe_all``) beside the six launches and the six
   PyTorch calls;
6. collapse's three kernels, csrc/edit_distance.cu, csrc/sw_traceback.cu
   and csrc/poa_align.cu, against their plain versions on
   tools/collapse_cases.py's and tools/poa_cases.py's cases (random codes
   with N and PAD, empty and one-base rows, equal-score ties, jobs that
   score 0, references and pairs longer than one strip, lengths at the
   edges of a word, of a warp's words and of a strip, a fused round of
   one-word and multi-word pairs, jobs over a block's shared memory; for
   the POA graphs of fused mutated reads, one-node graphs, empty
   sequences, identical copies, indel-heavy reads, in-degree 12 and 130,
   long back edges, mixed sizes, a long insertion and sequences at the
   edges of its run widths, each under the plan and under forced ring
   depths 0-3, which spill, and forced blocks of one and four warps),
   exact, every route of each kernel launched (ROUTES);
7. ``collapse`` end to end on phase 4's cand_circ.fa, ``--device cuda``
   then ``--device cpu``: the launches of sw_score_ends (by route),
   edit_distance, sw_traceback and poa_align (all > 0 on cuda, all 0 on
   cpu), byte-identical .info, .reads, .expression and .isoforms, equal
   corrected clusters and counters (tmp/*.corrected.pkl), the wall of each
   run, the launches of each kernel's routes, and the seconds spent in its
   SW, edit-distance, traceback and POA calls (summed over its threads; the
   POA split into the junction consensus, ``poa``, and the sub-cluster
   consensus, ``poa_consensus_many``), the traceback calls split into their
   stages (pack, upload, plan, launch, download and wait, tb_results: wall
   and thread CPU seconds);
   then every edit and traceback launch and the four largest SW launches
   of the cuda run against the plain versions on their inputs; every
   sub-cluster job of the cuda run replayed through the native ``poa``,
   byte-identical; poa_align's device time summed over the run (CUDA
   events around each launch, in the run) and its largest launch, its
   inputs kept by replaying its call (ops/poa.py::poa_launch_inputs),
   checked against the plain version and timed beside it and the bound
   (operations or the direction words' bytes), split into its rows and its
   walk, with its ring depth; then its SW
   launches split by route (wave, tiled): launches, summed device time (a
   CUDA graph's replay of each recorded input) and, at each route's
   largest launch, its shapes, ms, plain ms and bound;
8. ``collapse`` at full size, the cohort of benchmarks/collapse_bench.py's
   defaults (4000 reads of 16 loci on a 2 Mb genome, seed 0; its ``call``
   first, on cuda and on cpu: byte-identical tmp/*.ccs.fa, tmp/*.raw.fa and
   cand_circ.fa, equal counters, X4's launches and escalated pairs, no
   pair on the host), the checks of phase 7 and the walls; the card's rate for each
   kernel's update (csrc/op_rate.cu: the SW cell, the traceback cell, the
   edit distance's 32-row word and, for comparison, its DP cell); each
   kernel's device time summed over the launches the cuda run made (a CUDA
   graph's replay of each recorded input, with its route plan made
   beforehand) and, at its largest launch, its time, the plain version's
   and the bound, after that launch's check against the plain version;
   the SW launches split by route as in phase 7, the largest wavefront
   launch also at 1, 2 and 4 query rows a lane, and the wavefront and
   tiled launches' inputs saved to build/chip_smoke/cohort_wave_inputs.pt
   and cohort_tiled_inputs.pt (what ``python3 -m
   ciri_long_tpu_torch.tools.wave_ab`` times in two checkouts).
9. ``threads``: ``call`` and ``collapse`` at -t > 1, the host pool beside
   the card (parallel/hybrid.py's drain): on the cohort ``call`` then
   ``collapse`` at ``-t 4 --device cuda`` and ``-t 4 --device cpu``; on
   the ``call`` world ``call`` at ``-t 2 --device cuda``, ``-t 4 --device
   cuda`` and ``-t 4 --device cpu``, then ``collapse`` at -t 4 on both
   devices.  Each run as a fresh process would start (the select core's
   thread budget unset), its launch counts set to 0 before and read after.
   Raises unless tmp/*.ccs.fa, tmp/*.raw.fa, cand_circ.fa and the
   counters, and .info, .reads, .expression, .isoforms and the corrected
   clusters and counters (tmp/*.corrected.pkl) equal the -t 1 cuda run's
   of phases 4, 7 and 8; unless on cuda every kernel of ``call``
   (sw_score_ends where the -t 1 run launched it) and of ``collapse``
   launched, with no center-star pair on the host; and unless the card
   took a chunk of every drained stage of 2 or more chunks (the runs'
   ``hybrid <stage>: device stole X/Y chunks`` log lines; ``scan_ccs``
   and ``collapse`` must have drained).  One ``threads`` line a world:
   each run's wall, reads/s, launches, ``call``'s stage seconds, and each
   drained stage's split of chunks (the log's line, and from the drain's
   recorded deliveries the chunks whose result came first from the card
   and from the pool, and when each side's last one came), then the
   seconds THREADS scan workers take to start (``pool_start_s``), with the
   card.
10. ``dist``: the multi-device scan and the last entry points.  The
   lag-range tandem counts (csrc/tandem_counts.cu, the 'lag' axis's step
   of parallel/mesh.py) against tandem_counts_plain on the card, exact
   (``kernel_vs_plain`` lines, each with the reads that took each route,
   ``routes``): at the dry run's shapes, at phase 4's screened reads
   (1 104 x 4 096) and at tools/call_x_ab.py's six screen cases (1 104 x
   4 096: poly-A, di- and trinucleotide repeats, a period of 50, random,
   all N) over 2 048 lags cut into 1, 2 and 4 ranges, on edge reads
   (all PAD, N, under k, lags past the width), on
   tools/chain_cases.py's wide_cases (4 097 and 16 384 codes, in 1, 2
   and 4 ranges and past the reads; 4 097 also at k = 2 and 5, the
   k-run's other doubling levels), its lag_edge_cases
   (csrc/lag_planes.h's word, chunk and segment edges at 120, 4 097 and
   4 127 codes), full_reads (256 x 8 192) and odd_cases (codes outside
   0..5 at 8 and 4 097 codes); it fails unless some read took each route
   (the bit planes, the value route) and ROUTES['tandem_value'] counted
   each value-route read of each launch.
   Then timed at call's, the dry run's, the two wide shapes and 256 x
   8 192 (``tandem_counts_time``: a CUDA graph's replay, the plain
   version's wall, the bound from the equal k-mer pairs in the range at
   csrc/op_rate.cu's screen-compare rate or the bytes, the reads once and
   the counts once; the (window, lag) pairs of a brute-force design give
   ``window_bound_ms`` beside it).  The lag profile
   (csrc/lag_profile.cu) the same way against lag_profile_plain, bit for
   bit, on the same cases and shapes, its value route's reads counted in
   ROUTES['lag_value'] (``lag_profile_time``: its bound the valid
   (position, lag) pairs at csrc/op_rate.cu's packed lag rate, 32 pairs a
   word of bit planes, or the bytes, and ``one_popc_bound_ms`` at the rate
   of a word with one popcount; ``library_ms`` float32 FFT
   autocorrelations and ``conv1d_ms`` two grouped float32 F.conv1d calls,
   each checked equal to the plain counts first, yardsticks the port
   never calls).
   The public ops'
   run: ops.lag_profile, tandem_counts past 4 096 codes,
   ops.chain_scores_batch and edit_distance_batch_padded through their
   numpy entry points on the card, the counts set to 0 just before,
   each equal to its CPU route and each kernel launched.  Then
   ``dryrun_multichip`` at every visible card (its tandem_counts and SW
   launches: the kernels line's launches); ``call --dist mesh --device
   cuda`` on the ``call`` world, whose files and counters must equal phase
   4's -t 1 cuda run's, with all five kernels of ``call`` launched;
   parallel/multihost_worker.py at one rank and at two ranks sharing
   cuda:0 over gloo, each rank's psum and gather checks holding, its file's
   md5 that of a serial scan_ccs_reads of the same demo world on the card
   and its sw_score_ends launches > 0; ``tools/ssw_cli.py --cigar`` on
   cuda printing what it prints on cpu; and ``call --profile`` on the
   ``call`` world, its files equal to phase 4's and its Chrome trace
   holding CUDA kernel events (counted by kernel function beside the
   ``LAUNCHES`` of the traced stages, [2/4]..[4/4]; equal counts are
   reported, not required).  One ``dist`` line, with ``public_ops``.
11. ``recover``: ``call``'s short-consensus recovery ([3/4]) on the card:
   tools/world.py::short_world (the ``call`` world and 16 one-exon loci of
   30-59 bp) through the CLI at -t 1 and -t 4, on cuda and on cpu; every
   run writes the -t 1 cuda run's tmp/*.ccs.fa, tmp/*.raw.fa, cand_circ.fa
   and counters, sends reads to the recovery (its items > 0), and the
   stage's own launches (counted around find_bsj.recover_ccs_reads) of
   chain_dp and chain_extract are > 0 on cuda, all 0 on cpu; at -t 4 on
   cuda the card takes a chunk of the recovery's drain.  One ``recover``
   line: each run's wall, the stage's items, seconds, launches and SW
   routes, the drains' splits, the BSJ recall and precision on the short
   loci and on the rest.

The thirteen CUDA sources and the host vote (csrc/star_vote.cpp) build in
parallel (one nvcc or c++ each) beside the native host cores (one
extension at a time).  Then the card's ``nvidia-smi`` name
and power limit, the kernels line (sw_score_ends's entry also has
``main_ms`` and ``main_bound_ms`` at 128x54x16384, its collapse launches
and device time, ``tiled``: the tiled route's launches, summed device time
and largest launch (ms, plain ms, bound) on call and on both collapse
worlds, and, for the cohort's wavefront launches, ``wave_device_ms`` summed
over them, ``wave_ms`` and ``wave_bound_ms`` at the largest, and the
wavefront's plans and times by rows a lane there and at the bench shape;
sw_rowscan's and sw_chain's entries also have their ms at every phase-5
shape, ``shapes_ms``, and their plan variants' ms, ``plans_ms``;
int16_probe_all's the one launch of phase 5; edit_distance's,
sw_traceback's and poa_align's numbers are those of their largest launch in
phase 8, with their route counts, edit_distance's ``cell_bound_ms`` the
bound of one DP cell an update, the measure of a cell-by-cell design, and
poa_align's device time summed over the cohort's launches and its phase-7
numbers, ``rows_ms``, ``walk_ms`` and ``depth`` among them; chain_dp's,
chain_extract's, screen_keep's and nw_traceback's those of their largest
launch in phase 4b, with its size (nw_traceback's also its escalated
pairs, its classes, its split into passes and walk, call's launches by
class and its launches on the cohort's call), their summed and slowest
launches of call's run (``call_device_ms``, ``slowest_ms``,
``replay_device_ms``, ``replay_slowest_ms``), chain_dp's
``serial_bound_ms``, screen_keep's bound its equal k-mer pairs, its
``window_bound_ms`` the brute-force (window, lag) measure and
``lag_route_reads``); tandem_counts's those of phase 10 at call's screened
reads (its bound the equal pairs, ``window_bound_ms``, ``seg``), with its
numbers at the dry run's shape (``dryrun``) and the wide shapes'
(``wide``), the reads on each route (``routes``) and the value route's
reads; lag_profile's at call's screened reads, launched by the public
ops' run, its FFT yardstick as ``library_ms`` (conv1d's if the FFT's
counts differ), ``conv1d_ms`` and ``one_popc_bound_ms`` beside, its other
shapes beside (``shapes``); and last
``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits 2 and prints no result.  Its files go under
build/chip_smoke/.
"""

import importlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, 'build', 'chip_smoke')
WAVE_INPUTS = os.path.join(WORK, 'cohort_wave_inputs.pt')
# the tiled route's launches of call and of the cohort's collapse
TILED_INPUTS = {'call': os.path.join(WORK, 'call_tiled_inputs.pt'),
                'cohort': os.path.join(WORK, 'cohort_tiled_inputs.pt')}
X_INPUTS = os.path.join(WORK, 'call_x_inputs.pt')
NW_INPUTS = os.path.join(WORK, 'call_nw_inputs.pt')
# a spin before each recorded X2/X3 launch of call's run (~0.5 ms), longer
# than a wrapper's host work
X_SPIN_CYCLES = 1_000_000
# the keys of a run-summary JSON that time the run (and so differ between
# two runs of the same input): left out where runs are compared
RUN_ONLY = ('timing', 'kernels', 'spans', 'counters', 'threads')
CSRC = 'ciri_long_tpu_torch/csrc/'
SOURCES = ('sw_score_ends.cu', 'sw_rowscan.cu', 'sw_chain.cu',
           'int16_probe.cu', 'op_rate.cu', 'edit_distance.cu',
           'sw_traceback.cu', 'poa_align.cu', 'chain_dp.cu',
           'screen_keep.cu', 'nw_traceback.cu', 'star_vote.cpp',
           'tandem_counts.cu', 'lag_profile.cu')
TILE_CASES = ((64, 28, 16384), (128, 54, 16384), (37, 33, 5000))
TILE_PARAMS = ((1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1))
# the tiles' schedule edges: (padded Lq, the rows' real query lengths) at
# Lr 16 384, each R of the rule (1 to 32 rows, 2 to 64, then 4) and two
# strips at R = 4, beside tools/sw_cases.py's TILE_SPECIAL rows
TILE_EDGES = ((32, (1, 31, 32)), (33, (1, 32, 33)), (64, (33, 63, 64)),
              (65, (1, 64, 65)), (129, (65, 127, 128, 129)))
TILE_RULES = (1, 2, 8)     # tile widths in halos timed beside the rule's
# query rows a lane of the wavefront timed at the bench shape and at
# collapse's largest wavefront launch
WAVE_R_TIMED = (1, 2, 4)
# a reference whose (H, F) handoff row, 8 bytes a column, passes a block's
# shared memory (232 448 bytes): the wavefront keeps it in global memory
WAVE_GLOBAL_LR = 30000
# rows enough that the wavefront gives each one warp (ops/sw.py::WAVE_FILL)
# while its query spans two strips: eight rows a block, a handoff row each
WAVE_MANY_ROWS = 4400
REPLACES = {
    'sw_score_ends': ('ciri_long_tpu/ops/sw_pallas.py:355 _sw_chain_kernel '
                      '(K1); also :240 K2, :141 K3, :58 K4; misc/kexp.py:1534 '
                      'wave family (K6)'),
    'sw_rowscan': ('misc/kexp.py:1586 make_call row family, build_kernel:1065 '
                   'and build_kernel_r3:31 (K5)'),
    'sw_chain': ('misc/kexp.py:1462 make_call chain family, '
                 'build_kernel_chain:534, _chain7:694, _chain9:875, '
                 '_chain10:1222 (K7)'),
    'int16_probe': 'misc/int16_probe.py:41 run, kernel bodies :20-37 (K8)',
    'int16_probe_all': ('misc/int16_probe.py:41 run, kernel bodies :20-37 '
                        '(K8), all six probes in one launch'),
    'edit_distance': ('ciri_long_tpu/ops/edit.py:28 '
                      'edit_distance_batch_padded, an XLA program (X7)'),
    'sw_traceback': ('ciri_long_tpu/ops/sw_tb_batch.py:44 _align_one, :237 '
                     'sw_traceback_batch, an XLA program (X5)'),
    'poa_align': ('ciri_long_tpu/ops/poa_batch.py:39 _align_one, :194 '
                  '_align_one_win, :391 poa_align_batch, an XLA program '
                  '(X6)'),
    'chain_dp': ('ciri_long_tpu/ops/chain.py:26 _chain_dp, the DP of :219 '
                 'chain_extract_batch, an XLA program (X2)'),
    'chain_extract': ('ciri_long_tpu/ops/chain.py:219 chain_extract_batch, '
                      'its greedy extraction :251-307, an XLA program (X2)'),
    'screen_keep': ('ciri_long_tpu/ops/period.py:138 screen_keep, with :90 '
                    '_tandem_counts_impl and :32 _chunked_lag_sum, an XLA '
                    'program (X3)'),
    'nw_traceback': ('ciri_long_tpu/ops/nw_tb_batch.py:53 _build_kernel '
                     '(forward :67, walk :177), :305 nw_traceback_submit, '
                     ':400 nw_traceback_collect, an XLA program (X4)'),
    'tandem_counts': ('ciri_long_tpu/ops/period.py:85 tandem_counts (X3 '
                      'counts, lag ranges), an XLA program'),
    'lag_profile': ('ciri_long_tpu/ops/period.py:55 lag_profile (its lag '
                    'loop :32 _chunked_lag_sum), an XLA program'),
}
# call's kernels of X2, X3 and X4: (module, wrapper) recorded in phase 4
CALL_X = {'chain_dp': ('chain', 'chain_dp_cuda'),
          'chain_extract': ('chain', 'chain_extract_cuda'),
          'screen_keep': ('period', 'screen_keep_cuda'),
          'nw_traceback': ('nw_tb_batch', 'nw_traceback_cuda')}
# the parts of call's wall (phase 4, both routes): the screen; the CCS
# detection's tandem detection, center-star polish (on cuda the staging,
# launches and waits of ops/nw_tb_batch.py; on cpu none: the native center
# star aligns inside the vote) and column vote (on cuda the host C++ vote,
# ops/star_vote.py; on cpu center_star_consensus, its alignments
# included); the anchors, the chaining (the card's batch,
# the host core's rows, or map()'s chain), the selection and stitching, the
# SW of the clips, and map_batch / map around the three middle ones (s
# summed over calls and threads)
CALL_PARTS = (('find_ccs', {'screen': ('device_screen',),
                            'tandem_detection': ('detect_units',),
                            'polish': ('nw_traceback_submit',
                                       'nw_traceback_collect_runs'),
                            'vote': ('star_vote',)}),
              ('ccs', {'vote': ('center_star_consensus',)}),
              ('aligner', {'anchors': ('_anchors',),
                           'chain': ('_device_chains', '_host_chains',
                                     '_chain'),
                           'select_stitch': ('_select_and_stitch_batch',
                                             '_select_and_stitch'),
                           'map': ('map_batch', 'map')}),
              ('find_bsj', {'sw': ('align_clip_segments_batch',)}))
# X2's plain DP loops in Python over anchor slots: held on every recorded
# launch through the native core, on these many first launches and the
# largest through the plain versions
X_PLAIN_FIRST = 3
# benchmarks/collapse_bench.py's defaults
COHORT = dict(reads=4000, genome_kb=2000, loci=16, seed=0)
# phase 9's host workers: -t of each world's runs beside -t 1, and its
# cuda runs' -t on the call world
THREADS = 4
CALL_WORLD_THREADS = (2, 4)
COLLAPSE_FILES = ('info', 'reads', 'expression', 'isoforms')
# the routes of collapse's two kernels (utils/dispatch.py::ROUTES)
COLLAPSE_ROUTES = ('edit_thread', 'edit_warp', 'tb_smem', 'tb_global')
# the (ring depth, block shape) phase 6 forces on every POA case beside
# the plan's: depths 0-3 (0: every predecessor but the source from the
# spill copy), and one warp and four warps of one column a lane
POA_VARIANTS = ((None, None), (0, None), (1, None), (2, None), (3, None),
                (None, (1, 32)), (2, (1, 128)))
SW_CHECKED = 4             # the largest SW launches of a collapse run checked
PROBE_KERNELS = ('sw_score_ends', 'sw_rowscan', 'sw_chain', 'int16_probe',
                 'int16_probe_all')
BENCH = (512, 1024, 4096)
TIMED = (('bench', BENCH), ('square', (512, 1024, 1024)),
         ('main64', (64, 28, 16384)), ('main128', (128, 54, 16384)),
         ('short', (4096, 32, 128)))
# the harness's chain: C jobs a stream timed, and query rows a lane timed
# beside the rule's
CHAIN_C_TIMED = (2, 4)
CHAIN_R_TIMED = (1, 2, 4)
# phase 2's chain jobs (B, Lq, Lr): one strip and several, Lq far above
# Lr, a reference of one chunk and of several; every B divisible by 4
CHAIN_SHAPES = ((28, 40, 7), (64, 150, 33), (32, 1100, 300),
                (8, 70, 2000))
# phase 2's row-scan references: the edges of a warp's runs at each width
# and the widest reference the kernel takes
ROWSCAN_LRS = (1, 127, 129, 513, 1025, 4097, 16384)


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def codes(rng, B, L, pad_suffix=False):
    """Random codes A/C/G/T/N with a random PAD suffix per row."""
    import numpy as np
    x = rng.integers(0, 5, (B, L)).astype(np.int8)
    if pad_suffix:
        for b in range(B):
            x[b, int(rng.integers(max(1, L // 2), L + 1)):] = 5
    return x


def phase_build(torch):
    from ciri_long_tpu_torch.misc.kexp import nvidia_smi
    from ciri_long_tpu_torch.ops import _build
    from ciri_long_tpu_torch.utils.dispatch import resolve_device

    dev = resolve_device('cuda')
    smi = nvidia_smi()
    t0 = time.perf_counter()
    # one extension at a time: the two packages' twins of a core compile
    # to the same object file, and a parallel build_ext can link one
    # while the other rewrites it (a core without its PyInit)
    native = subprocess.Popen(
        [sys.executable, 'setup.py', 'build_ext', '--inplace'], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        _build.build_all(SOURCES)
        kernel_s = time.perf_counter() - t0
    finally:
        native_log = native.communicate()[0]
    ptxas = {src: [ln.strip() for ln in
                   _build.BUILD_LOGS.get(src, '').splitlines()
                   if 'registers' in ln or 'spill' in ln or 'smem' in ln]
             for src in SOURCES}
    if native.returncode != 0:
        raise RuntimeError('native build failed:\n' + native_log[-6000:])
    native_s = time.perf_counter() - t0
    importlib.invalidate_caches()
    from ciri_long_tpu_torch.ops.sw import _alncore
    if _alncore() is None:
        raise RuntimeError('native host cores did not load after the build')
    emit('build', device=torch.cuda.get_device_name(dev), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         kernels_build_s=round(kernel_s, 3), ptxas=ptxas,
         native_build_s=round(native_s, 3))
    return dev, smi


def _max_err(got, want):
    return max(int((a.long() - b.long()).abs().max().item()) if a.numel()
               else 0 for a, b in zip(got, want))


def compare(torch, dev, q, r, params, label, kernels):
    """Each SW kernel of ``kernels`` ((name, fn) of sw_kernels) against
    one plain output of the case on the card, exact: (score, q_end, r_end),
    and for the first kernel also the five sw_align_batch fields.  Returns
    {name: max abs difference}."""
    from ciri_long_tpu_torch.ops.sw import _sw_align_fused, sw_score_ends
    qt = torch.as_tensor(q).to(dev).contiguous()
    rt = torch.as_tensor(r).to(dev).contiguous()
    want = sw_score_ends(qt, rt, params)
    errs = {name: _max_err(fn(qt, rt, params), want) for name, fn in kernels}
    name, fn = kernels[0]
    errs[name] = max(errs[name], _max_err(
        _sw_align_fused(qt, rt, params, score_fn=fn),
        _sw_align_fused(qt, rt, params, score_fn=sw_score_ends)))
    torch.cuda.synchronize(dev)
    emit('kernel_vs_plain', case=label, B=int(q.shape[0]),
         Lq=int(q.shape[1]), Lr=int(r.shape[1]), params=list(params),
         max_abs_err=errs, positive=int((want[0] > 0).sum().item()))
    if any(errs.values()):
        raise AssertionError('a kernel disagrees with plain on ' + label)
    return errs


def kernel_cases():
    """(label, q, r, params) of phase 2: one shape per TPU route K1-K4
    with PAD suffixes, a mid-row PAD and an all-PAD row, then N codes.
    Every B is a multiple of 4, so the chain takes each case with C = 2
    and 4."""
    import numpy as np
    from ciri_long_tpu_torch.ops.sw import SWParams

    rng = np.random.default_rng(20261016)
    big = SWParams(10, 4, 8, 2)
    clip = SWParams(1, 1, 1, 1)
    cases = []
    for label, B, Lq, Lr, params in [
            ('K1 chained wavefront (bench shape)', *BENCH, big),
            ('K2 wave5 small batch', 8, 256, 512, clip),
            ('K4 query-dominated scan', 64, 2048, 512, clip),
            ('K3 wave5 overflow', 4, 8192, 16384, big)]:
        q = codes(rng, B, Lq, pad_suffix=True)
        r = codes(rng, B, Lr, pad_suffix=True)
        q[0, Lq // 3] = 5          # mid-row PAD
        r[0, Lr // 2] = 5
        r[1] = 5                   # all-PAD row
        cases.append((label, q, r, params))
    q = codes(rng, 16, 70)
    r = codes(rng, 16, 333)
    q[:, 10] = 5
    r[:, 100:103] = 5
    r[3] = 5
    q[4] = 5
    cases.append(('N, mid-row PAD, all-PAD', q, r, clip))
    return cases


def wave_cases():
    """(label, q, r, params) of phase 2's wavefront cases: tools/sw_cases.py's
    rows at every edge of the schedule (a lane's rows, a strip, a group of
    strips) against each WAVE_LR width under three SWParams; a reference
    whose handoff row (Lr * 8 bytes) does not fit a block's shared memory;
    rows enough for one warp a row with queries of two strips; a fused round
    of mixed real lengths under one padded shape."""
    import numpy as np
    from ciri_long_tpu_torch.ops.sw import SWParams
    from ciri_long_tpu_torch.tools.sw_cases import WAVE_LR
    from ciri_long_tpu_torch.tools.sw_cases import wave_cases as make

    rng = np.random.default_rng(20261018)
    cases = []
    for params in (SWParams(*p) for p in TILE_PARAMS):
        for Lr in WAVE_LR:
            q, r = make(rng, Lr)
            cases.append(('wave edges Lr {}'.format(Lr), q, r, params))
    q = codes(rng, 2, 1100)
    r = codes(rng, 2, WAVE_GLOBAL_LR)
    r[1, 17000:18100] = q[1]
    cases.append(('wave handoff row in global memory', q, r,
                  SWParams(10, 4, 8, 2)))
    q = codes(rng, WAVE_MANY_ROWS, 200, pad_suffix=True)
    r = codes(rng, WAVE_MANY_ROWS, 70, pad_suffix=True)
    cases.append(('wave one warp a row, rows of two strips', q, r,
                  SWParams(1, 1, 1, 1)))
    q = np.full((96, 1500), 5, np.int8)
    r = np.full((96, 1500), 5, np.int8)
    for b in range(96):
        lq, lr = rng.integers(1, 1501, 2)
        q[b, :lq] = rng.integers(0, 5, lq)
        r[b, :lr] = rng.integers(0, 5, lr)
    cases.append(('wave fused round of mixed lengths', q, r,
                  SWParams(10, 4, 8, 2)))
    return cases


def tile_cases():
    """(label, q, r, params) of phase 2's tile cases: tools/sw_cases.py's
    rows planted around the tile edges _tile_plan gives each shape; its
    tile_edge_cases at TILE_EDGES (the R boundaries, references cut inside,
    at the end of, at the start of and before a tile's window, twins in two
    tiles and in neighbouring query rows); a fused round of mixed real
    lengths under one padded shape; each under three SWParams."""
    import numpy as np
    from ciri_long_tpu_torch.ops.sw import SWParams, _tile_plan
    from ciri_long_tpu_torch.tools.sw_cases import tile_cases as make
    from ciri_long_tpu_torch.tools.sw_cases import tile_edge_cases

    rng = np.random.default_rng(4)
    cases = []
    for params in (SWParams(*p) for p in TILE_PARAMS):
        for B, Lq, Lr in TILE_CASES:
            q, r = make(rng, B, Lq, Lr, _tile_plan(Lq, Lr, params)[0],
                        params)
            cases.append(('tile cases', q, r, params))
        for Lq, lqs in TILE_EDGES:
            q, r = tile_edge_cases(rng, lqs, Lq, 16384,
                                   *_tile_plan(Lq, 16384, params))
            cases.append(('tile edges Lq {}'.format(Lq), q, r, params))
        q = np.full((96, 54), 5, np.int8)
        r = np.full((96, 16384), 5, np.int8)
        for b in range(96):
            lq, lr = rng.integers(1, 55), rng.integers(1, 16385)
            q[b, :lq] = rng.integers(0, 5, lq)
            r[b, :lr] = rng.integers(0, 5, lr)
            at = int(rng.integers(0, max(1, lr - lq)))
            n = min(lq, lr - at)          # a copy of the query inside lr
            r[b, at:at + n] = q[b, :n]
        cases.append(('tile fused round of mixed lengths', q, r, params))
    return cases


def probe_cases():
    """((label, q, r, params), kernels) of phase 2's cases for the
    harness's chain and row scan: tools/sw_cases.py's chain jobs at
    CHAIN_SHAPES through the chain, and its wavefront rows against
    ROWSCAN_LRS references through the row scan, under three SWParams."""
    import numpy as np
    from ciri_long_tpu_torch.ops.sw import SWParams
    from ciri_long_tpu_torch.tools.sw_cases import chain_cases
    from ciri_long_tpu_torch.tools.sw_cases import wave_cases as make

    rng = np.random.default_rng(20261017)
    cases = []
    for params in (SWParams(*p) for p in TILE_PARAMS):
        for B, Lq, Lr in CHAIN_SHAPES:
            q, r = chain_cases(rng, B, Lq, Lr)
            cases.append((('chain jobs', q, r, params), chain_kernels))
        for Lr in ROWSCAN_LRS:
            q, r = make(rng, Lr, (1, 31, 33, 65, 129, 300))
            cases.append((('row scan runs Lr {}'.format(Lr), q, r, params),
                          rowscan_kernels))
    return cases


def chain_kernels(Lq, Lr, params):
    """(name, kernel) of the harness's chain at C = 2, 4, 1 and B."""
    from ciri_long_tpu_torch.misc.kexp import sw_chain_cuda

    kernels = [('sw_chain C={}'.format(C),
                lambda q, r, p, C=C: sw_chain_cuda(q, r, p, C))
               for C in (2, 4, 1)]
    return kernels + [('sw_chain C=B', lambda q, r, p: sw_chain_cuda(
        q, r, p, q.shape[0]))]


def rowscan_kernels(Lq, Lr, params):
    """(name, kernel) of the harness's row scan by its rule and at every
    width."""
    from ciri_long_tpu_torch.misc.kexp import (ROWSCAN_WIDTHS, rowscan_plan,
                                               sw_rowscan_cuda)

    return [('sw_rowscan', sw_rowscan_cuda)] + [
        ('sw_rowscan W={}'.format(W),
         lambda q, r, p, W=W: sw_rowscan_cuda(
             q, r, p, rowscan_plan(q.shape[0], r.shape[1], W)))
        for W in ROWSCAN_WIDTHS]


def phase_kernel(torch, dev):
    """Every SW kernel against one plain output per case, then
    sw_score_ends's routes on the tile and wavefront cases, then the
    harness's chain and row scan on their cases; {name: max err}."""
    errs = {}
    runs = [(case, sw_kernels) for case in kernel_cases()]
    runs += [(case, sw_routes) for case in tile_cases() + wave_cases()]
    runs += probe_cases()
    for (label, q, r, params), kernels in runs:
        for name, err in compare(torch, dev, q, r, params, label,
                                 kernels(q.shape[1], r.shape[1],
                                         params)).items():
            errs[name] = max(errs.get(name, 0), err)
    return errs


def phase_time(torch, dev, smi):
    import numpy as np
    from ciri_long_tpu_torch.misc.kexp import gcups
    from ciri_long_tpu_torch.ops.sw import (SWParams, sw_score_ends,
                                            sw_score_ends_cuda)

    rng = np.random.default_rng(0)
    params = SWParams(10, 4, 8, 2)
    for name, (B, Lq, Lr) in [('bench', BENCH), ('square', (512, 1024, 1024))]:
        q = torch.from_numpy(rng.integers(0, 4, (B, Lq)).astype(np.int8))
        r = torch.from_numpy(rng.integers(0, 4, (B, Lr)).astype(np.int8))
        q, r = q.to(dev), r.to(dev)
        k_gcups, k_ms = gcups(sw_score_ends_cuda, q, r, params, 20,
                              graph=True)
        p_gcups, p_ms = gcups(sw_score_ends, q, r, params, 3)
        emit('kernel_time', shape=name, B=B, Lq=Lq, Lr=Lr,
             kernel_gcups=k_gcups, kernel_ms=k_ms, plain_gcups=p_gcups,
             plain_ms=p_ms, card=smi)


def run_call(device, world, out_dir):
    from ciri_long_tpu_torch.cli.main import main
    main(['call', '-i', world['reads'], '-o', out_dir, '-r', world['ref'],
          '-p', 'smoke', '-t', '1', '--device', device])
    with open(os.path.join(out_dir, 'smoke.json')) as f:
        return json.load(f)


def _modules():
    from ciri_long_tpu_torch.models.aligner import GenomeAligner
    from ciri_long_tpu_torch.ops import ccs, chain, nw_tb_batch, period
    from ciri_long_tpu_torch.pipeline import find_bsj, find_ccs
    return dict(chain=chain, period=period, find_ccs=find_ccs,
                find_bsj=find_bsj, aligner=GenomeAligner, ccs=ccs,
                nw_tb_batch=nw_tb_batch)


def _warm_x_kernels(torch, dev):
    """One launch of each X2/X3 wrapper on a tiny input before call's run,
    so that the run's events hold neither a kernel's first load (CUDA loads
    kernels lazily, at their first launch) nor a library's load or a
    table's upload (call's chaining takes the default gaps)."""
    import numpy as np
    from ciri_long_tpu_torch.ops import chain, nw_tb_batch, period
    offs = torch.tensor([0, 2], dtype=torch.int64, device=dev)
    col = torch.tensor([0, 20], dtype=torch.int32, device=dev)
    f, pre = chain.chain_dp_cuda(offs, col, col, torch.zeros_like(col), 15)
    chain.chain_extract_cuda(offs, f, pre, 30.0, 3, 10,
                             chain.extract_plan([2], dev))
    one = torch.tensor([64], dtype=torch.int32, device=dev)
    period.screen_keep_cuda(torch.zeros((1, 64), dtype=torch.int8,
                                        device=dev), one, one // 2)
    nw_tb_batch.nw_traceback_batch([np.zeros(8, np.int8)],
                                   [np.ones(9, np.int8)], device=dev)
    torch.cuda.synchronize(dev)


def _recording_x(torch, seen, events):
    """Wrap X2's and X3's wrappers (CALL_X) so that each launch keeps CPU
    copies of its inputs and outputs in ``seen`` (lists by kernel name; the
    extraction's plan is left out, extract_plan remakes it) and the CUDA
    events recorded on the launch's stream just before and after it in
    ``events`` (the stream held by a spin of X_SPIN_CYCLES first, so that
    the host has queued the launch when the first event is reached and the
    pair holds the card's time alone); returns the undo."""
    mods = _modules()
    originals = []
    for name, (mod, attr) in CALL_X.items():
        module = mods[mod]
        kernel = getattr(module, attr)
        originals.append((module, attr, kernel))

        def recorder(*args, _kernel=kernel, _name=name):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(X_SPIN_CYCLES)
            pair[0].record()
            out = _kernel(*args)
            pair[1].record()
            events[_name].append(pair)
            keep = args[:6] if _name == 'chain_extract' else args
            seen[_name].append((
                tuple(_on(a, 'cpu', torch) for a in keep),
                tuple(o.cpu() for o in out) if isinstance(out, tuple)
                else out.cpu()))
            return out

        setattr(module, attr, recorder)

    def undo():
        for module, attr, kernel in originals:
            setattr(module, attr, kernel)
    return undo


def _on(a, dev, torch):
    """A recorded argument on ``dev``: a tensor, an NW launch plan (its
    tensors), or anything else as it is."""
    if torch.is_tensor(a):
        return a.to(dev)
    if hasattr(a, 'geom'):
        return a._replace(geom=a.geom.to(dev), offs=a.offs.to(dev),
                          tasks=a.tasks.to(dev))
    return a


def _recording_nw(batches, votes):
    """Wrap find_ccs's nw_traceback_submit, nw_traceback_collect_runs and
    star_vote so that each batch of the run appends (qs, rs, (score, cigar)
    results) to ``batches`` and each vote (its StarBatch, copied, and the
    consensus of each read) to ``votes``; returns the undo."""
    from ciri_long_tpu_torch.pipeline import find_ccs
    submit = find_ccs.nw_traceback_submit
    collect = find_ccs.nw_traceback_collect_runs
    vote = find_ccs.star_vote

    def submitted(qs, rs, *args, **kw):
        h = submit(qs, rs, *args, **kw)
        h.recorded = (list(qs), list(rs))
        return h

    def collected(h):
        out = collect(h)
        batches.append((*h.recorded, [(int(out.score[t]), out.cigar(t))
                                      for t in range(len(out.score))]))
        return out

    def voted(batch, *args, **kw):
        out = vote(batch, *args, **kw)
        votes.append((batch.copy(), [x.copy() for x in out]))
        return out

    find_ccs.nw_traceback_submit = submitted
    find_ccs.nw_traceback_collect_runs = collected
    find_ccs.star_vote = voted

    def undo():
        find_ccs.nw_traceback_submit = submit
        find_ccs.nw_traceback_collect_runs = collect
        find_ccs.star_vote = vote
    return undo


def _same_ccs(root, a, b, prefix):
    """Whether two runs of call under ``root`` wrote the same tmp/*.ccs.fa
    and tmp/*.raw.fa."""
    return all(Path(root, a, 'tmp', prefix + ext).read_bytes()
               == Path(root, b, 'tmp', prefix + ext).read_bytes()
               for ext in ('.ccs.fa', '.raw.fa'))


def _timed_call(device, world, out_dir):
    """run_call with the parts of CALL_PARTS timed; returns (summary,
    wall s, {part: s}), detection = the ccs stage less the screen.  The
    hooks take a clock and a lock around every call they time, so the walls
    phase 4 reports come from runs without them."""
    mods = _modules()
    seconds = {}
    undos = [_timing(mods[mod], calls, seconds) for mod, calls in CALL_PARTS]
    try:
        t0 = time.perf_counter()
        summary = run_call(device, world, out_dir)
        wall = time.perf_counter() - t0
    finally:
        for undo in undos:
            undo()
    parts = {k: seconds.get(k, 0.0) for calls in CALL_PARTS
             for k in calls[1]}
    parts['ccs_detection'] = (summary['timing']['ccs']['seconds']
                              - parts['screen'])
    return summary, wall, parts


def phase_call(torch, dev, smi):
    from ciri_long_tpu_torch.ops import sw
    from ciri_long_tpu_torch.tools.world import bsj_accuracy, make_world
    from ciri_long_tpu_torch.utils.dispatch import (CALL_KERNELS, ROUTES,
                                                    launch_counts,
                                                    reset_launches)

    shutil.rmtree(WORK, ignore_errors=True)
    ref, reads, truth = make_world(os.path.join(WORK, 'world'),
                                   genome_kb=2000, loci=16, depth=60,
                                   linear=240, seed=0)
    world = dict(ref=ref, reads=reads)
    with open(reads) as f:
        n_reads = sum(1 for ln in f if ln.startswith('>'))

    # record the inputs the main path hands the kernels (launch and route
    # counts are kept by the wrappers themselves; the recorders only copy
    # their arguments, and X2's and X3's outputs)
    seen = []
    x_seen = {name: [] for name in CALL_X}
    x_events = {name: [] for name in CALL_X}
    kernel = sw.sw_score_ends_cuda

    def recorder(query, ref_, params):
        seen.append((query.clone(), ref_.clone(), params))
        return kernel(query, ref_, params)

    sw.sw_score_ends_cuda = recorder
    _warm_x_kernels(torch, dev)
    undo_x = _recording_x(torch, x_seen, x_events)
    batches, votes = [], []
    undo_nw = _recording_nw(batches, votes)
    try:
        reset_launches()
        t0 = time.perf_counter()
        gpu = run_call('cuda', world, os.path.join(WORK, 'out_cuda'))
        gpu_s = time.perf_counter() - t0
        launches = launch_counts(CALL_KERNELS)
        routes = dict(ROUTES)
    finally:
        sw.sw_score_ends_cuda = kernel
        undo_x()
        undo_nw()
    t0 = time.perf_counter()
    cpu = run_call('cpu', world, os.path.join(WORK, 'out_cpu'))
    cpu_s = time.perf_counter() - t0
    cpu_routes = dict(ROUTES)
    # the wall split, each route from a run of its own
    _, gpu_split_s, gpu_parts = _timed_call('cuda', world,
                                            os.path.join(WORK, 'split_cuda'))
    _, cpu_split_s, cpu_parts = _timed_call('cpu', world,
                                            os.path.join(WORK, 'split_cpu'))

    cand = [Path(WORK, d, 'smoke.cand_circ.fa').read_bytes()
            for d in ('out_cuda', 'out_cpu')]
    ccs_same = _same_ccs(WORK, 'out_cuda', 'out_cpu', 'smoke')
    counters = [{k: v for k, v in s.items() if k not in RUN_ONLY}
                for s in (gpu, cpu)]
    recall, precision, n_called = bsj_accuracy(
        os.path.join(WORK, 'out_cuda', 'smoke.cand_circ.fa'), truth)
    shapes = [[int(q.shape[0]), int(q.shape[1]), int(r.shape[1]),
               list(p), sw._tile_plan(q.shape[1], r.shape[1], p) is not None]
              for q, r, p in seen]
    emit('call', reads=n_reads, genome_kb=2000, loci=16, depth=60,
         profile='nanopore', launches=launches, routes=routes,
         launch_shapes=shapes,
         summary_kernels=gpu['kernels'],
         cpu_summary_kernels=cpu['kernels'], cand_identical=cand[0] == cand[1],
         cand_bytes=len(cand[0]), ccs_identical=ccs_same,
         nw_pairs=sum(len(qs) for qs, _, _ in batches),
         cpu_nw_host=cpu_routes['nw_host'],
         counters_equal=counters[0] == counters[1],
         counters=counters[0], cuda_wall_s=gpu_s,
         cuda_reads_per_s=n_reads / gpu_s, cpu_wall_s=cpu_s,
         cpu_reads_per_s=n_reads / cpu_s, cuda_timing=gpu['timing'],
         cpu_timing=cpu['timing'], bsj_recall=recall,
         bsj_precision=precision, called_loci=n_called, tolerance_bp=5,
         card=smi)
    emit('call_split', cuda_s=gpu_parts, cpu_s=cpu_parts,
         cuda_wall_s=gpu_split_s, cpu_wall_s=cpu_split_s, card=smi)
    if any(launches[k] <= 0 for k in CALL_KERNELS) \
            or gpu['kernels'] != launches:
        raise AssertionError('call did not go through its kernels: '
                             '{}'.format(launches))
    # an X4 call launches one kernel a width class of its plan
    recorded = {k: len(x_seen[k]) for k in CALL_X}
    recorded['nw_traceback'] = sum(len(args[2].classes)
                                   for args, _ in x_seen['nw_traceback'])
    if any(recorded[k] != launches[k] for k in CALL_X):
        raise AssertionError('X2/X3/X4 launches and recorded inputs differ: '
                             '{} {}'.format(recorded, launches))
    if routes['nw_host'] != 0 or cpu_routes['nw_host'] <= 0 \
            or not batches:
        raise AssertionError('the center-star pairs did not all go to the '
                             'card: cuda {} cpu {} host pairs, {} batches'
                             .format(routes['nw_host'],
                                     cpu_routes['nw_host'], len(batches)))
    planned = sum(tiled for *_, tiled in shapes)
    sw_routes_ = {k: routes[k] for k in ('tiled', 'wave')}
    if (len(seen) != launches['sw_score_ends'] or planned == 0
            or sw_routes_ != {'tiled': planned, 'wave': len(seen) - planned}):
        raise AssertionError('call did not take the tiled route where its '
                             'plan applies: {} {}'.format(routes, shapes))
    if cpu['kernels'] != {k: 0 for k in CALL_KERNELS}:
        raise AssertionError('the --device cpu summary counts launches: '
                             '{}'.format(cpu['kernels']))
    if cand[0] != cand[1] or counters[0] != counters[1] or not ccs_same:
        raise AssertionError('call differs between --device cuda and cpu')
    if not cand[0] or recall <= 0:
        raise AssertionError('call found no BSJ of the simulated truth')

    err = 0
    for t, (q, r, params) in enumerate(seen):
        routes_ = sw_routes(q.shape[1], r.shape[1], params)
        err = max([err] + list(compare(
            torch, dev, q.cpu().numpy(), r.cpu().numpy(), params,
            'main path launch {}'.format(t), routes_).values()))
    torch.cuda.synchronize(dev)
    x_ms = {name: [a.elapsed_time(b) for a, b in pairs]
            for name, pairs in x_events.items()}
    return (launches, err, seen, x_seen, x_ms, batches, votes,
            {k: v for k, v in routes.items() if k.startswith('nw_')})


def phase_call_time(torch, dev, smi, seen):
    """Both routes of sw_score_ends on each input the main path gave it
    (a CUDA graph's replay of 10 launches each), summed over the launches;
    then the launches split by route as collapse's are (sw_route_split,
    ``call_sw_route`` lines: the tiled route's summed device time and its
    largest launch's ms, plain ms and bound), and the tiled launches'
    inputs saved to TILED_INPUTS['call'].  Returns ({route name: ms},
    {route: fields})."""
    from ciri_long_tpu_torch.misc.kexp import gcups, peak_cell_rate

    total = {}
    routed = []
    for t, (q, r, params) in enumerate(seen):
        times = {name: gcups(fn, q, r, params, 10, graph=True)[1]
                 for name, fn in sw_routes(q.shape[1], r.shape[1], params)}
        emit('call_sw_time', launch=t, B=int(q.shape[0]), Lq=int(q.shape[1]),
             Lr=int(r.shape[1]), params=list(params), ms=times, card=smi)
        for name, ms in times.items():
            total[name] = total.get(name, 0.0) + ms
        routed.append(times['sw_score_ends'])
    emit('call_sw_time', launches=len(seen), total_ms=total, card=smi)
    split = sw_route_split(torch, dev, smi, 'call', seen, routed,
                           peak_cell_rate(dev), line='call_sw_route')
    save_route_inputs(torch, seen, 'tiled', TILED_INPUTS['call'])
    return total, split


def _dp_candidates(offs, window=64):
    """The candidates the chaining DP scores over rows of these offsets:
    min(i, window) for anchor i of each row."""
    import numpy as np
    A = np.diff(np.asarray(offs, np.int64))
    m = np.minimum(A, window + 1)
    return int((m * (m - 1) // 2 + window * (A - m)).sum())


def _screen_pairs(reads, lags, k=11):
    """The (window, lag) pairs csrc/screen_keep.cu compares for these reads
    and lag ranges: for each valid window i, min(M, nwin - 1 - i), nwin the
    last valid window + 1."""
    import numpy as np
    x = np.asarray(reads) < 4
    W = x.shape[1]
    total = 0
    for row, M in zip(x, np.asarray(lags)):
        run = np.concatenate([[0], np.cumsum(row)])
        i = np.arange(max(0, W - k + 1))
        valid = i[run[i + k] - run[i] == k]
        if len(valid):
            nwin = valid[-1] + 1
            total += int(np.minimum(int(M), nwin - 1 - valid).sum())
    return total


def _equal_pairs(reads, lo, hi, k=11):
    """The pairs of valid windows i < j of each read with equal k-mer ids
    and lo <= j - i <= hi (ints, or [B] ints a read), what grouping the
    windows by k-mer id (a sort) finds in O(L log L + pairs)."""
    import numpy as np
    x = np.asarray(reads).astype(np.int64)
    B, W = x.shape
    if W < k:
        return 0
    n = W - k + 1
    ok = x < 4
    code = np.where(ok, x, 0)
    kid = np.zeros((B, n), np.int64)
    valid = np.ones((B, n), bool)
    for j in range(k):
        kid = kid * 4 + code[:, j:j + n]
        valid &= ok[:, j:j + n]
    # lags past W - 1 pair nothing; cut there, a lag keeps within one id
    los = np.minimum(np.broadcast_to(np.asarray(lo, np.int64), (B,)), W)
    his = np.minimum(np.broadcast_to(np.asarray(hi, np.int64), (B,)), W - 1)
    total = 0
    for kr, vr, a, b in zip(kid, valid, los, his):
        if a > b:
            continue
        pos = np.nonzero(vr)[0]
        key = np.sort(kr[pos] * (2 * W) + pos)    # by k-mer id, then position
        total += int((np.searchsorted(key, key + b, 'right')
                      - np.searchsorted(key, key + a, 'left')).sum())
    return total


def _screen_equal_pairs(reads, lags, k=11):
    """The work the screen's function needs: the pairs of valid windows i <
    j of one read with equal k-mer ids and j - i <= its lag range M.  About
    L M / p for a tandem read of period p, near 0 for a random one."""
    return _equal_pairs(reads, 1, lags, k)


def _wall_ms(torch, dev, fn):
    """One call's wall in ms, the card synchronised on both sides; (ms,
    result)."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3, out


def _bits_differ(a, b):
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float64:
        return int((a.view(np.int64) != b.view(np.int64)).sum())
    return int((a != b).sum())


def check_chain(torch, dev, x_seen):
    """Every recorded X2 launch of phase 4: f and pre bit-equal to the
    port's native chain core (native/chaincore.cpp) row by row, chains
    equal to the host backtrack_chains (its native core) row by row; the
    plain versions on the first X_PLAIN_FIRST launches and the largest.
    Returns ({name: max err}, plain ms of the largest launch by kernel)."""
    import numpy as np
    from ciri_long_tpu_torch import _chaincore
    from ciri_long_tpu_torch.ops import chain

    dp = x_seen['chain_dp']
    ext = x_seen['chain_extract']
    work = [_dp_candidates(args[0]) for args, _ in dp]
    big = max(range(len(dp)), key=work.__getitem__)
    plain_at = sorted(set(range(min(X_PLAIN_FIRST, len(dp)))) | {big})
    errs = {'chain_dp': 0, 'chain_extract': 0}
    plain_ms = {}
    for t, ((offs, r, q, c, k, window, gr, gq), (f, pre)) in enumerate(dp):
        o = offs.numpy()
        cols = [x.numpy().astype(np.int64) for x in (r, q, c)]
        fn, pn = [], []
        for b in range(len(o) - 1):
            fb, pb = _chaincore.chain(*(x[o[b]:o[b + 1]] for x in cols), k,
                                      window, gr, gq)
            fn.append(np.frombuffer(fb, np.float64))
            pn.append(np.frombuffer(pb, np.int64))
        fn = np.concatenate(fn) if fn else np.zeros(0)
        pn = np.concatenate(pn) if pn else np.zeros(0, np.int64)
        differ = {'native': _bits_differ(f.numpy(), fn)
                  + _bits_differ(pre.numpy(), pn)}
        if t in plain_at:
            table = chain.card_log2_table(chain.table_size(gr, gq), dev)
            ms, (fp, pp) = _wall_ms(torch, dev, lambda: chain.chain_dp_plain(
                *(x.to(dev) for x in (offs, r, q, c)), table, k, window, gr,
                gq))
            differ['plain'] = (_bits_differ(f.numpy(), fp.cpu().numpy())
                               + _bits_differ(pre.numpy(), pp.cpu().numpy()))
            if t == big:
                plain_ms['chain_dp'] = ms
        max_err = max(float((f - torch.from_numpy(fn)).abs().max())
                      if len(fn) else 0.0,
                      int((pre.long() - torch.from_numpy(pn)).abs().max())
                      if len(pn) else 0)
        emit('kernel_vs_plain', case='call launch {}'.format(t),
             kernel='chain_dp', rows=len(o) - 1, anchors=int(o[-1]),
             candidates=work[t], differ=differ, max_abs_err=max_err)
        errs['chain_dp'] = max(errs['chain_dp'], max_err, *differ.values())

    for t, ((offs, f, pre, ms_, ma, mc), out) in enumerate(ext):
        o = offs.numpy()
        got = chain.decode_chain_ids(o, *(x.numpy() for x in out))
        fc, pc = f.numpy(), pre.numpy()
        rows_differ = 0
        for b in range(len(o) - 1):
            lo, hi = o[b], o[b + 1]
            host = chain.backtrack_chains(fc[None, lo:hi], pc[None, lo:hi],
                                          np.ones((1, hi - lo), bool), ms_,
                                          ma, mc)[0]
            same = len(host) == len(got[b]) and all(
                np.array_equal(hi_, gi) and hs == gs
                for (hi_, hs), (gi, gs) in zip(host, got[b]))
            rows_differ += not same
        differ = {'host_rows': rows_differ}
        if t in plain_at:
            ms, want = _wall_ms(torch, dev, lambda: chain.chain_extract_plain(
                offs, f, pre, ms_, ma, mc))
            differ['plain'] = sum(_bits_differ(a.numpy(), b.numpy())
                                  for a, b in zip(out, want))
            if t == big:
                plain_ms['chain_extract'] = ms
        emit('kernel_vs_plain', case='call launch {}'.format(t),
             kernel='chain_extract', rows=len(o) - 1, anchors=int(o[-1]),
             chains=int(out[2].sum()), differ=differ,
             max_abs_err=max(differ.values()))
        errs['chain_extract'] = max(errs['chain_extract'], *differ.values())
    if any(errs.values()):
        raise AssertionError('X2 disagrees with its references: '
                             '{}'.format(errs))
    return errs, plain_ms, big


def check_edge_cases(torch, dev):
    """Phase 4b's case list: tools/chain_cases.py's extract_cases (tied f,
    short paths, max_chains reached, no candidate, rows over SMEM_ROW, a
    chain 8 192 deep, brooms) through the extraction kernel against
    chain_extract_plain, its dp_cases rows (all in one launch, then each
    alone) through the DP kernel against chain_dp_plain and the native
    chain core, and its screen_launches
    through csrc/screen_keep.cu against screen_keep_plain, each read on the
    route screen_routes_plain gives it; one kernel_vs_plain line a case.
    Returns {kernel: max err}."""
    import numpy as np
    from ciri_long_tpu_torch import _chaincore
    from ciri_long_tpu_torch.ops import chain, period
    from ciri_long_tpu_torch.tools import chain_cases

    gaps = (200_000, chain.MAX_GAP_Q)
    table = chain.card_log2_table(chain.table_size(*gaps), dev)
    named = chain_cases.dp_cases(np.random.default_rng(41), *gaps)
    errs = {'chain_dp': 0, 'chain_extract': 0, 'screen_keep': 0}
    for case, (rows, ms_, ma, mc) in chain_cases.extract_cases(
            np.random.default_rng(42)).items():
        offs, f, pre = chain_cases.extract_csr(rows)
        d = [torch.from_numpy(x).to(dev) for x in (offs, f, pre)]
        got = chain.chain_extract_cuda(*d, ms_, ma, mc,
                                       chain.extract_plan(np.diff(offs), dev))
        want = chain.chain_extract_plain(*(torch.from_numpy(x)
                                           for x in (offs, f, pre)),
                                         ms_, ma, mc)
        differ = {'plain': sum(_bits_differ(a.cpu().numpy(), b.numpy())
                               for a, b in zip(got, want))}
        emit('kernel_vs_plain', case='extract_cases ' + case,
             kernel='chain_extract', rows=len(rows), anchors=int(offs[-1]),
             chains=int(want[2].sum()), differ=differ,
             max_abs_err=max(differ.values()))
        errs['chain_extract'] = max(errs['chain_extract'], *differ.values())
    for case in ['all'] + list(named):
        rows = chain_cases.local(list(named.values()) if case == 'all'
                                 else [named[case]])
        offs, r, q, c = chain_cases.csr(rows)
        d = [torch.from_numpy(offs).to(dev)] + [
            torch.from_numpy(x.astype(np.int32)).to(dev) for x in (r, q, c)]
        f, pre = chain.chain_dp_cuda(*d, 15, 64, *gaps)
        fp, pp = chain.chain_dp_plain(*d, table, 15, 64, *gaps)
        f, pre = f.cpu().numpy(), pre.cpu().numpy()
        native = 0
        for b, (rb, qb, cb) in enumerate(rows):
            fb, pb = _chaincore.chain(rb, qb, cb, 15, 64, *gaps)
            lo, hi = offs[b], offs[b + 1]
            native += (_bits_differ(f[lo:hi], np.frombuffer(fb, np.float64))
                       + _bits_differ(pre[lo:hi],
                                      np.frombuffer(pb, np.int64)))
        differ = {'plain': _bits_differ(f, fp.cpu().numpy())
                  + _bits_differ(pre, pp.cpu().numpy()), 'native': native}
        emit('kernel_vs_plain', case='dp_cases ' + case, kernel='chain_dp',
             rows=len(rows), anchors=int(offs[-1]), differ=differ,
             max_abs_err=max(differ.values()))
        errs['chain_dp'] = max(errs['chain_dp'], *differ.values())
    for case, (mat, lens, lags) in chain_cases.screen_launches(
            np.random.default_rng(43)).items():
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (mat, lens, lags)]
        routes = torch.zeros(len(mat), dtype=torch.uint8, device=dev)
        keep = period.screen_keep_cuda(*args, routes=routes).cpu()
        want = period.screen_keep_plain(*args).cpu()
        routes = routes.cpu().numpy().astype(bool)
        differ = {'plain': int((keep != want).sum()),
                  'routes': int((routes != period.screen_routes_plain(
                      mat, lags)).sum())}
        emit('kernel_vs_plain', case='screen_launches ' + case,
             kernel='screen_keep', reads=len(mat), width=int(mat.shape[1]),
             lag_route=int(routes.sum()), kept=int(keep.sum()),
             differ=differ, max_abs_err=max(differ.values()))
        errs['screen_keep'] = max(errs['screen_keep'], *differ.values())
    if any(errs.values()):
        raise AssertionError('edge cases disagree: {}'.format(errs))
    return errs


def _screen_lag_reads(torch, dev, args):
    """How many reads of a recorded screen launch take csrc/screen_keep.cu's
    lag route (the launch made again with ``routes``)."""
    from ciri_long_tpu_torch.ops import period
    d = [a.to(dev) if torch.is_tensor(a) else a for a in args]
    routes = torch.zeros(len(args[0]), dtype=torch.uint8, device=dev)
    period.screen_keep_cuda(*d, routes=routes)
    return int(routes.sum())


def _replay_ms(torch, dev, name, args):
    """Device ms of one recorded X2/X3 launch: a CUDA graph's replay of 3
    launches (the extraction's plan made first)."""
    from ciri_long_tpu_torch.misc.kexp import time_launches
    from ciri_long_tpu_torch.ops import chain, period
    d = [a.to(dev) if torch.is_tensor(a) else a for a in args]
    if name == 'chain_dp':
        fn = lambda: chain.chain_dp_cuda(*d)                    # noqa: E731
    elif name == 'chain_extract':
        plan = chain.extract_plan((args[0][1:] - args[0][:-1]).numpy(), dev)
        fn = lambda: chain.chain_extract_cuda(*d, plan)          # noqa: E731
    else:
        fn = lambda: period.screen_keep_cuda(*d)                 # noqa: E731
    return time_launches(fn, 3, dev, graph=True)


def phase_call_kernels(torch, dev, smi, x_seen, x_ms):
    """Phase 4b: phase 4's X2 and X3 launches against their references
    (check_chain; screen_keep against the plain version on every launch),
    then each kernel at its largest launch: a CUDA graph's replay of 10
    launches beside the plain version's wall (one call) and the bound (X2's
    DP: its candidates at csrc/op_rate.cu's float64 candidate rate, or its
    bytes; the extraction: its bytes; the screen: its equal k-mer pairs
    within each read's lag range at the screen's compare rate, or its
    bytes; bytes at 3.35 TB/s).  The screen's (window, lag) pairs, the work
    of the kernel's brute-force design, give ``window_bound_ms`` beside it
    as a design measure; the DP's ``serial_bound_ms``, its longest row's
    steps at csrc/op_rate.cu's serial step, is another.  Each kernel's
    launches of phase 4 summed and their slowest: from the CUDA events
    around each launch in the run (``call_device_ms``, ``slowest_ms``) and
    from a CUDA graph's replay of each recorded launch
    (``replay_device_ms``, ``replay_slowest_ms``).  The screen's launch is
    made again with ``routes`` to count its reads on the lag route; then
    check_edge_cases.  The largest launches' inputs go to
    X_INPUTS (what tools/call_x_ab.py times in two checkouts).  Returns
    {kernel: numbers for the kernels line}."""
    from ciri_long_tpu_torch.misc.kexp import (HBM_BYTES_PER_S,
                                               recurrence_rate, serial_step_s,
                                               time_launches)
    from ciri_long_tpu_torch.ops import chain, period

    errs, plain_ms, big = check_chain(torch, dev, x_seen)
    scr = x_seen['screen_keep']
    pairs = [_screen_pairs(args[0], args[2], args[3]) for args, _ in scr]
    sbig = max(range(len(scr)), key=pairs.__getitem__)
    equal = _screen_equal_pairs(scr[sbig][0][0], scr[sbig][0][2],
                                scr[sbig][0][3])
    errs['screen_keep'] = 0
    for t, (args, keep) in enumerate(scr):
        ms, want = _wall_ms(torch, dev, lambda: period.screen_keep_plain(
            *(a.to(dev) if torch.is_tensor(a) else a for a in args)))
        err = int((keep != want.cpu()).sum())
        if t == sbig:
            plain_ms['screen_keep'] = ms
        emit('kernel_vs_plain', case='call launch {}'.format(t),
             kernel='screen_keep', reads=int(args[0].shape[0]),
             width=int(args[0].shape[1]), pairs=pairs[t], kept=int(keep.sum()),
             max_abs_err=err)
        errs['screen_keep'] = max(errs['screen_keep'], err)
    if errs['screen_keep']:
        raise AssertionError('screen_keep disagrees with the plain version')
    for name, err in check_edge_cases(torch, dev).items():
        errs[name] = max(errs[name], err)

    rates = {k: recurrence_rate(dev, k) for k in ('chain_dp', 'screen_keep')}
    step_s = serial_step_s(dev)
    emit('cell_rate', call_updates_per_s=rates, serial_step_s=step_s,
         card=smi)
    numbers = {}
    (offs, r, q, c, k, window, gr, gq), (f, pre) = x_seen['chain_dp'][big]
    d = [x.to(dev) for x in (offs, r, q, c)]
    R, N = len(offs) - 1, len(r)
    cands = _dp_candidates(offs)
    numbers['chain_dp'] = dict(
        ms=time_launches(lambda: chain.chain_dp_cuda(*d, k, window, gr, gq),
                         10, dev, graph=True),
        bound=max((cands / rates['chain_dp'], 'operations'),
                  ((24 * N + 8 * (R + 1)) / HBM_BYTES_PER_S, 'bytes')),
        serial_bound_ms=int((offs[1:] - offs[:-1]).max()) * step_s * 1e3,
        rows=R, anchors=N, candidates=cands,
        longest=int((offs[1:] - offs[:-1]).max()))
    (offs, f, pre, ms_, ma, mc), _out = x_seen['chain_extract'][big]
    d = [x.to(dev) for x in (offs, f, pre)]
    plan = chain.extract_plan((offs[1:] - offs[:-1]).numpy(), dev)
    numbers['chain_extract'] = dict(
        ms=time_launches(lambda: chain.chain_extract_cuda(
            *d, ms_, ma, mc, plan), 10, dev, graph=True),
        bound=((13 * N + 8 * (R + 1) + (8 * mc + 4) * R) / HBM_BYTES_PER_S,
               'bytes'),
        rows=R, anchors=N, cap=plan[0], global_slots=plan[2])
    args, _keep = scr[sbig]
    d = [a.to(dev) if torch.is_tensor(a) else a for a in args]
    B, W = args[0].shape
    numbers['screen_keep'] = dict(
        ms=time_launches(lambda: period.screen_keep_cuda(*d), 10, dev,
                         graph=True),
        bound=max((equal / rates['screen_keep'], 'operations'),
                  ((B * W + 9 * B + 8 * int(args[2].max()))
                   / HBM_BYTES_PER_S, 'bytes')),
        window_bound_ms=pairs[sbig] / rates['screen_keep'] * 1e3,
        reads=int(B), width=int(W), pairs=pairs[sbig], equal_pairs=equal,
        lag_route_reads=_screen_lag_reads(torch, dev, args))
    os.makedirs(WORK, exist_ok=True)
    torch.save({'chain_dp': x_seen['chain_dp'][big][0],
                'chain_extract': x_seen['chain_extract'][big][0],
                'chain_extract_all': [a for a, _ in x_seen['chain_extract']],
                'screen_keep': scr[sbig][0]}, X_INPUTS)
    for name, n in numbers.items():
        bound_s, by = n.pop('bound')
        replay = [_replay_ms(torch, dev, name, args)
                  for args, _ in x_seen[name]]
        n.update(max_abs_err=errs[name], plain_ms=plain_ms[name],
                 bound_ms=bound_s * 1e3, bound_by=by,
                 launches_recorded=len(x_seen[name]),
                 call_device_ms=sum(x_ms[name]), slowest_ms=max(x_ms[name]),
                 replay_device_ms=sum(replay), replay_slowest_ms=max(replay))
        emit('call_kernel_time', kernel=name, card=smi, **n)
    return numbers


def sw_routes(Lq, Lr, params):
    """(name, kernel) of sw_score_ends: routed, then the wavefront forced,
    then the tiled route forced where _tile_plan takes the shape."""
    from ciri_long_tpu_torch.ops.sw import (_tile_plan, sw_score_ends_cuda,
                                            sw_score_ends_tiled_cuda,
                                            sw_score_ends_wave_cuda)

    routes = [('sw_score_ends', sw_score_ends_cuda),
              ('sw_score_ends wave', sw_score_ends_wave_cuda)]
    if _tile_plan(Lq, Lr, params) is not None:
        routes.append(('sw_score_ends tiled', sw_score_ends_tiled_cuda))
    return routes


def sw_kernels(Lq, Lr, params):
    """(name, kernel) of every SW design family on the card."""
    from ciri_long_tpu_torch.misc.kexp import sw_chain_cuda, sw_rowscan_cuda

    return sw_routes(Lq, Lr, params) + [
        ('sw_rowscan', sw_rowscan_cuda),
        ('sw_chain C=2', lambda q, r, p: sw_chain_cuda(q, r, p, 2)),
        ('sw_chain C=4', lambda q, r, p: sw_chain_cuda(q, r, p, 4))]


def _nw_cells(launch):
    """Cells of both passes of an X4 launch: (n + 1) x (W + W2) a pair."""
    g = launch.geom.cpu().numpy().astype('int64')
    return int(((g[:, 0] + 1) * (g[:, 3] - g[:, 2] + g[:, 5] - g[:, 4] + 2))
               .sum())


def _nw_native_differ(q, r, launch, out, runs, scores):
    """The pairs of a recorded X4 launch whose traceback band's score and
    cigar or check band's score differ from the port's native core at the
    same bands (native/nwcore.cpp::nw_banded; None there where the band
    holds no path)."""
    import numpy as np
    from ciri_long_tpu_torch import _nwcore
    from ciri_long_tpu_torch.ops.nw_tb_batch import HALF_NEG
    from ciri_long_tpu_torch.ops.traceback import _decode_cigar_u32

    g = launch.geom.numpy().astype(np.int64)
    o = launch.offs.numpy()
    out, runs = out.numpy(), runs.numpy().view(np.uint32)
    qn, rn = q.numpy().view(np.uint8), r.numpy().view(np.uint8)
    differ = 0
    for k, (n, m, lo, hi, lo2, hi2) in enumerate(g):
        qb = qn[o[k, 0]:o[k, 0] + n].tobytes()
        rb = rn[o[k, 1]:o[k, 1] + m].tobytes()
        shift = max(0, m - n)
        x = _nwcore.nw_banded(qb, rb, int(hi - shift), *scores)
        y = _nwcore.nw_banded(qb, rb, int(hi2 - shift), *scores)
        s1, s2, cnt = (int(v) for v in out[k])
        end = o[k, 3] + n + m
        cigar = [(int(e) >> 4, int(e) & 15) for e in runs[end - cnt:end]] \
            if cnt >= 0 else None
        same = (x is not None and (int(x[0]), _decode_cigar_u32(x[1]))
                == (s1, cigar)) and \
            (int(y[0]) == s2 if y is not None else s2 <= HALF_NEG)
        differ += not same
    return differ


def check_nw(torch, dev, x_seen, batches):
    """Every recorded X4 launch of phase 4 held to the port's native core at
    its bands, pair by pair (_nw_native_differ), the first X_PLAIN_FIRST and
    the largest (by cells) also to nw_launch_plain on the card (out, runs
    and planes, element by element); every batch's (score, cigar) to the
    port's native banded_global_cigar.  Returns (max err, the plain
    version's wall on the largest launch, its index)."""
    from ciri_long_tpu_torch.ops import nw_tb_batch as ntb
    from ciri_long_tpu_torch.ops.traceback import banded_global_cigar

    rec = x_seen['nw_traceback']
    cells = [_nw_cells(args[2]) for args, _ in rec]
    big = max(range(len(rec)), key=cells.__getitem__)
    plain_at = sorted(set(range(min(X_PLAIN_FIRST, len(rec)))) | {big})
    err, plain_ms = 0, None
    for t, ((q, r, launch, *scores), out) in enumerate(rec):
        differ = {'native': _nw_native_differ(q, r, launch, *out[:2],
                                              scores)}
        if t in plain_at:
            d = [_on(a, dev, torch) for a in (q, r, launch)]
            ms, want = _wall_ms(torch, dev, lambda: ntb.nw_launch_plain(
                *d, *scores))
            differ['plain'] = sum(int((a != b.cpu()).sum())
                                  for a, b in zip(out, want))
            if t == big:
                plain_ms = ms
        emit('kernel_vs_plain', case='call launch {}'.format(t),
             kernel='nw_traceback', pairs=len(launch.pairs), cells=cells[t],
             classes=[[c.route, c.C, c.count, c.warps]
                      for c in launch.classes], differ=differ,
             max_abs_err=max(differ.values()))
        err = max(err, *differ.values())
    final = sum(res != banded_global_cigar(q, r)
                for qs, rs, results in batches
                for q, r, res in zip(qs, rs, results))
    emit('nw_batches', batches=len(batches),
         pairs=sum(len(qs) for qs, _, _ in batches),
         differ={'native_final': final})
    err = max(err, final)
    if err:
        raise AssertionError('X4 disagrees with its references')
    return err, plain_ms, big


def check_nw_cases(torch, dev):
    """tools/nw_cases.py's cases through nw_traceback_batch on the card,
    all in one batch under the plan and forced into each class
    (ops/nw_tb_batch.py::FORCES: each register class, the block class, the
    wide class with its rows in global scratch), and each alone: every
    launch of the band ladder against nw_launch_plain (out, runs and
    planes), the batch's (score, cigar) against the port's native
    banded_global_cigar; then the cases at bands narrow enough for each
    register class (C = 1 holds no first band), each class forced, against
    nw_launch_plain and the native core at their bands.  One
    kernel_vs_plain line a case.  Returns the max err."""
    import functools
    import numpy as np
    from ciri_long_tpu_torch.ops import nw_tb_batch as ntb
    from ciri_long_tpu_torch.ops.traceback import banded_global_cigar
    from ciri_long_tpu_torch.tools.nw_cases import nw_cases
    from ciri_long_tpu_torch.utils.dispatch import ROUTES

    named = nw_cases(np.random.default_rng(44))
    every = [p for ps in named.values() for p in ps]
    kernel, plan = ntb.nw_traceback_cuda, ntb.nw_plan
    err = 0
    for case, force in ([('all', f) for f in ntb.FORCES]
                        + [(name, None) for name in named]):
        pairs = every if case == 'all' else named[case]
        differ = {'plain': 0}
        routes = {}

        def checked(q, r, launch, *scores):
            got = kernel(q, r, launch, *scores)
            want = ntb.nw_launch_plain(q, r, launch, *scores)
            differ['plain'] += sum(int((a != b).sum())
                                   for a, b in zip(got, want))
            for c in launch.classes:
                routes[c.route] = routes.get(c.route, 0) + c.count
            return got

        escalated = ROUTES['nw_escalate']
        ntb.nw_traceback_cuda = checked
        ntb.nw_plan = functools.partial(plan, force=force)
        try:
            res = ntb.nw_traceback_batch([q for q, _ in pairs],
                                         [r for _, r in pairs], device=dev)
        finally:
            ntb.nw_traceback_cuda, ntb.nw_plan = kernel, plan
        differ['native'] = sum(res[t] != banded_global_cigar(q, r)
                               for t, (q, r) in enumerate(pairs))
        if force in ('block', 'global'):
            differ['classes'] = int(set(routes) != {'nw_' + force})
        elif force is not None:
            differ['classes'] = int('nw_c{}'.format(force) not in routes
                                    and force != 1)
        emit('kernel_vs_plain', case='nw_cases {}{}'.format(
            case, '' if force is None else ' force {}'.format(force)),
            kernel='nw_traceback', pairs=len(pairs),
            passes_by_route=routes,
            escalated=ROUTES['nw_escalate'] - escalated, differ=differ,
            max_abs_err=max(differ.values()))
        err = max(err, *differ.values())
    pairs = [p for p in every if len(p[0]) < 1000]
    n = np.array([len(q) for q, _ in pairs])
    m = np.array([len(r) for _, r in pairs])
    q = torch.from_numpy(np.concatenate([x for x, _ in pairs])).to(dev)
    r = torch.from_numpy(np.concatenate([y for _, y in pairs])).to(dev)
    for C in ntb.REG_CLASSES:
        band = np.maximum(0, (32 * C - 1 - np.abs(n - m)) // 4)
        (launch,) = plan(n, m, band, np.cumsum(n) - n, np.cumsum(m) - m,
                         dev, budget=1 << 40, force=C)
        got = kernel(q, r, launch)
        want = ntb.nw_launch_plain(q, r, launch)
        differ = {'plain': sum(int((a != b).sum())
                               for a, b in zip(got, want)),
                  'native': _nw_native_differ(
                      q.cpu(), r.cpu(), _on(launch, 'cpu', torch),
                      got[0].cpu(), got[1].cpu(), (2, 4, 4, 2))}
        routes = {c.route: c.count for c in launch.classes}
        differ['classes'] = int('nw_c{}'.format(C) not in routes)
        emit('kernel_vs_plain', case='nw_cases narrow C={}'.format(C),
             kernel='nw_traceback', pairs=len(pairs),
             passes_by_route=routes, differ=differ,
             max_abs_err=max(differ.values()))
        err = max(err, *differ.values())
    if err:
        raise AssertionError('X4 disagrees on tools/nw_cases.py')
    return err


def _nw_pairs(args):
    """The pairs of one recorded X4 launch, free of its plan: the codes
    (flat, each pair's at its offsets), lengths, traceback bands and
    offsets, and the scores."""
    import numpy as np
    q, r, launch, *scores = args
    g = launch.geom.numpy().astype(np.int64)
    o = launch.offs.numpy()
    return dict(q=q, r=r, n=g[:, 0], m=g[:, 1],
                band=g[:, 3] - np.maximum(0, g[:, 1] - g[:, 0]),
                q_off=o[:, 0], r_off=o[:, 1], scores=list(scores))


def _nw_pairs_all(rec):
    """The pairs of every first-band X4 launch of the run (each pair's band
    |n - m| + FIRST_BAND) as one batch, as the parent's single megabatch
    launched them."""
    import numpy as np
    import torch
    from ciri_long_tpu_torch.ops.nw_tb_batch import FIRST_BAND

    parts = [_nw_pairs(args) for args, _ in rec]
    parts = [p for p in parts
             if (p['band'] == np.abs(p['n'] - p['m']) + FIRST_BAND).all()]
    qs, rs, q_off, r_off = [], [], [], []
    at_q = at_r = 0
    for p in parts:
        qs.append(p['q'])
        rs.append(p['r'])
        q_off.append(p['q_off'] + at_q)
        r_off.append(p['r_off'] + at_r)
        at_q += len(p['q'])
        at_r += len(p['r'])
    cat = np.concatenate
    return dict(q=torch.cat(qs), r=torch.cat(rs),
                n=cat([p['n'] for p in parts]),
                m=cat([p['m'] for p in parts]),
                band=cat([p['band'] for p in parts]), q_off=cat(q_off),
                r_off=cat(r_off), scores=parts[0]['scores'])


def check_votes(votes):
    """Every star read of the cuda run voted again by the plain version
    (ops/star_vote.py::star_vote_plain, the port's center_star_consensus on
    the same run entries): the reads whose consensus differs."""
    import numpy as np
    from ciri_long_tpu_torch.ops.star_vote import star_vote_plain

    reads = differ = 0
    t0 = time.perf_counter()
    for batch, out in votes:
        want = star_vote_plain(batch)
        reads += len(want)
        differ += sum(not np.array_equal(a, b) for a, b in zip(out, want))
    emit('star_vote', votes=len(votes), reads=reads, differ=differ,
         plain_s=time.perf_counter() - t0)
    if differ or not reads:
        raise AssertionError('the host vote disagrees with its plain version '
                             'on {} of {} reads'.format(differ, reads))


def phase_call_nw(torch, dev, smi, x_seen, x_ms, batches, votes,
                  routes):
    """Phase 4b's X4: check_nw, check_nw_cases and the host vote on every
    star read (check_votes), then the largest launch of phase 4 timed (a
    CUDA graph's replay of 10 launches) beside the plain version's wall and
    the bound, the larger of its cells (both passes) at csrc/op_rate.cu's
    NW cell rate and its bytes (the codes read, the plan, the planes, runs
    and scores written) at 3.35 TB/s,
    and split by its stamps (tools/call_x_ab.py::nw_split); its launches of
    phase 4 summed and their slowest, from the CUDA events around each
    launch in the run and from a graph's replay of each recorded launch.
    The pairs of call's first-band launches (codes, lengths, first band)
    go to NW_INPUTS, for tools/call_x_ab.py to plan in each checkout: the
    largest launch's, and all of them as one batch.
    Returns the numbers for the kernels line."""
    import numpy as np
    from ciri_long_tpu_torch.misc.kexp import (HBM_BYTES_PER_S,
                                               recurrence_rate, time_launches)
    from ciri_long_tpu_torch.ops import nw_tb_batch as ntb
    from ciri_long_tpu_torch.tools.call_x_ab import nw_split

    err, plain_ms, big = check_nw(torch, dev, x_seen, batches)
    err = max(err, check_nw_cases(torch, dev))
    check_votes(votes)
    rate = recurrence_rate(dev, 'nw_traceback')
    emit('cell_rate', nw_cells_per_s=rate, card=smi)
    rec = x_seen['nw_traceback']

    def timed(args, n_iter):
        q, r, launch, *scores = args
        d = [_on(a, dev, torch) for a in (q, r, launch)]
        return time_launches(lambda: ntb.nw_traceback_cuda(*d, *scores),
                             n_iter, dev, graph=True)

    args = rec[big][0]
    launch = args[2]
    g = launch.geom.numpy().astype('int64')
    o = launch.offs.numpy()
    cells = _nw_cells(launch)
    nbytes = (int(g[:, 0].sum() + g[:, 1].sum()) + (24 + 32 + 8) * len(g)
              + launch.plane_bytes + 4 * launch.run_entries)
    replay = [timed(a, 3) for a, _ in rec]
    numbers = dict(
        ms=timed(args, 10), plain_ms=plain_ms, max_abs_err=err,
        pairs=len(g), cells=cells, longest=int(g[:, 0].max()),
        widest=int(max((g[:, 3] - g[:, 2]).max(), (g[:, 5] - g[:, 4]).max())
                   + 1),
        classes=[[c.route, c.C, c.count, c.warps] for c in launch.classes],
        plane_bytes=launch.plane_bytes, launches_recorded=len(rec),
        call_routes=routes, escalated_pairs=routes['nw_escalate'],
        call_device_ms=sum(x_ms['nw_traceback']),
        slowest_ms=max(x_ms['nw_traceback']), replay_device_ms=sum(replay),
        replay_slowest_ms=max(replay),
        split=nw_split(torch, dev, *(_on(a, dev, torch) for a in args)))
    numbers['bound_ms'], numbers['bound_by'] = max(
        (cells / rate * 1e3, 'operations'),
        (nbytes / HBM_BYTES_PER_S * 1e3, 'bytes'))
    os.makedirs(WORK, exist_ok=True)
    torch.save(dict(largest=_nw_pairs(args), all=_nw_pairs_all(rec)),
               NW_INPUTS)
    emit('call_kernel_time', kernel='nw_traceback', card=smi, **numbers)
    return numbers


def phase_probe_path():
    """The kernel-probe path through its entry points: the harness for each
    family at the bench shape, then the int16 probes.  Returns the launch
    counts of that run."""
    from ciri_long_tpu_torch.misc import int16_probe, kexp
    from ciri_long_tpu_torch.utils.dispatch import (launch_counts,
                                                    reset_launches)

    B, Lq, Lr = BENCH
    shape = ['--B', str(B), '--Lq', str(Lq), '--Lr', str(Lr), '--iters', '8']
    reset_launches()
    lines = [kexp.main(flags + shape) for flags in
             (['--r3'], ['--wave'], ['--chain', '2'], ['--chain', '4'])]
    int16_probe.main(['--device', 'cuda'])
    launches = launch_counts(PROBE_KERNELS)
    emit('probe_path', launches=launches,
         kexp=[dict(l['variant'], gcups=l['gcups'], ms=l['ms'],
                    bound_ms=l['bound_ms']) for l in lines])
    if min(launches.values()) <= 0:
        raise AssertionError('the probe path missed a kernel: {}'.format(
            launches))
    return launches


def phase_probe_exact(torch, dev):
    """Every int16 probe against its plain version on each of its
    ``probe_cases`` (the TPU probe's input, negative lanes, wrapping lanes),
    launched alone and all six in one launch.  Exact, or it raises; returns
    the max abs difference of each entry point."""
    from ciri_long_tpu_torch.misc.int16_probe import (PROBES,
                                                      int16_probe_all_cuda,
                                                      int16_probe_cuda,
                                                      probe_cases)

    worst = {'int16_probe': 0, 'int16_probe_all': 0}
    cases = [probe_cases(probe, dev) for probe in PROBES]
    for probe, mine in zip(PROBES, cases):
        for label, x in mine:
            err = _max_err([int16_probe_cuda(probe, x)], [probe.plain(x)])
            emit('probe_exact', probe=probe.name, case=label,
                 shape=list(probe.shape), max_abs_err=err)
            worst['int16_probe'] = max(worst['int16_probe'], err)
    for k in range(len(cases[0])):
        xs = [mine[k][1] for mine in cases]
        errs = [_max_err([got], [probe.plain(x)]) for probe, x, got in
                zip(PROBES, xs, int16_probe_all_cuda(xs))]
        emit('probe_exact', probe='all six in one launch',
             case=cases[0][k][0], max_abs_err=errs)
        worst['int16_probe_all'] = max([worst['int16_probe_all']] + errs)
    if any(worst.values()):
        raise AssertionError('an int16 probe disagrees with its plain version')
    return worst


def wave_rows(torch, dev, smi, label, q, r, params, bound_ms, timer):
    """The wavefront at each R of WAVE_R_TIMED (ops/sw.py::_wave_plan with
    that many query rows a lane, K and the handoff row as the rule gives
    them), timed by ``timer`` (ms of one step); one JSON line, and {R: ms}.
    The rule's R (WAVE_ROWS) is the one these lines show fastest."""
    from ciri_long_tpu_torch.ops.sw import (WAVE_ROWS, _wave_plan,
                                            sw_score_ends_wave_cuda)

    B, Lq = q.shape
    Lr = r.shape[1]
    times, plans = {}, {}
    for R in WAVE_R_TIMED:
        plan = _wave_plan(B, Lq, Lr, rows=R)
        plans[R] = list(plan)
        times[R] = timer(lambda: sw_score_ends_wave_cuda(q, r, params, plan))
    emit('wave_rows', shape=label, B=B, Lq=Lq, Lr=Lr, plans=plans, ms=times,
         rule_rows=WAVE_ROWS, bound_ms=bound_ms, card=smi)
    return times


def probe_plans(smi, label, q, r, bound_ms, timer):
    """The harness's chain at each C of CHAIN_C_TIMED and R of
    CHAIN_R_TIMED (misc/kexp.py::chain_plan with that many query rows a
    lane) and its row scan at each width W (rowscan_plan with that W), timed
    by ``timer`` (ms of one step); two JSON lines, and {'chain_rows': {C:
    {R: ms}}, 'rowscan_widths': {W: ms}}.  The rules' R (CHAIN_ROWS) and W
    (ROWSCAN_WIDTH) are the ones these lines show fastest."""
    from ciri_long_tpu_torch.misc.kexp import (CHAIN_MIN_LR, CHAIN_ROWS,
                                               ROWSCAN_WIDTH,
                                               ROWSCAN_WIDTHS, chain_plan,
                                               rowscan_plan,
                                               sw_chain_cuda,
                                               sw_rowscan_cuda)
    from ciri_long_tpu_torch.misc.kexp import PARAMS as params

    B, Lq = q.shape
    Lr = r.shape[1]
    chain, chain_plans = {}, {}
    for C in CHAIN_C_TIMED:
        T = C * (max(Lr, CHAIN_MIN_LR) + 1) + 1   # the stream's slots
        chain[C], chain_plans[C] = {}, {}
        for R in CHAIN_R_TIMED:
            plan = chain_plan(B // C, Lq, T, C, rows=R)
            chain_plans[C][R] = list(plan)
            chain[C][R] = timer(lambda: sw_chain_cuda(q, r, params, C, plan))
    emit('chain_rows', shape=label, B=B, Lq=Lq, Lr=Lr, plans=chain_plans,
         ms=chain, rule_rows=CHAIN_ROWS, bound_ms=bound_ms, card=smi)
    widths, width_plans = {}, {}
    for W in ROWSCAN_WIDTHS:
        plan = rowscan_plan(B, Lr, W)
        width_plans[W] = list(plan)
        widths[W] = timer(lambda: sw_rowscan_cuda(q, r, params, plan))
    emit('rowscan_widths', shape=label, B=B, Lq=Lq, Lr=Lr, plans=width_plans,
         ms=widths, rule_width=ROWSCAN_WIDTH, bound_ms=bound_ms, card=smi)
    return {'chain_rows': chain, 'rowscan_widths': widths}


def phase_probe_time(torch, dev, smi):
    """The card's peak cell rate in both forms (the SW bound), the SW
    families and the plain version at each TIMED shape with the harness's
    dependent launches, and the int16 probes with independent launches,
    each beside its bound.  Kernel and library times are a CUDA graph's
    replay (``kexp.time_launches``: the card's time without the host's
    cost per launch), plain times the wall of the calls."""
    import numpy as np
    from ciri_long_tpu_torch.misc.int16_probe import (PROBES,
                                                      int16_probe_all_cuda,
                                                      int16_probe_cuda,
                                                      probe_input)
    from ciri_long_tpu_torch.misc.kexp import (HBM_BYTES_PER_S, PARAMS,
                                               cell_rate, gcups, sw_bound,
                                               time_launches)
    from ciri_long_tpu_torch.ops.sw import (_tile_plan, sw_score_ends,
                                            sw_score_ends_tiled_cuda)

    rates = {'dpx': cell_rate(dev, True), 'plain': cell_rate(dev, False)}
    rate = max(rates.values())
    emit('cell_rate', cells_per_s=rates,
         sms=torch.cuda.get_device_properties(dev).multi_processor_count,
         card=smi)
    rng = np.random.default_rng(1)
    sw = {}
    for shape, (B, Lq, Lr) in TIMED:
        q = torch.from_numpy(rng.integers(0, 4, (B, Lq)).astype(np.int8))
        r = torch.from_numpy(rng.integers(0, 4, (B, Lr)).astype(np.int8))
        q, r = q.to(dev), r.to(dev)
        plain_gcups, plain_ms = gcups(sw_score_ends, q, r, PARAMS, 2)
        bound_ms, bound_by = sw_bound(B, Lq, Lr, rate)
        sw[shape] = dict(plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        for name, fn in sw_kernels(Lq, Lr, PARAMS):
            k_gcups, k_ms = gcups(fn, q, r, PARAMS, 10, graph=True)
            sw[shape][name] = k_ms
            emit('probe_time', shape=shape, B=B, Lq=Lq, Lr=Lr, kernel=name,
                 ms=k_ms, gcups=k_gcups, plain_ms=plain_ms,
                 plain_gcups=plain_gcups, bound_ms=bound_ms,
                 bound_by=bound_by, bound_share=bound_ms / k_ms, card=smi)
        for halos in TILE_RULES if shape.startswith('main') else ():
            plan = _tile_plan(Lq, Lr, PARAMS, halos)
            k_gcups, k_ms = gcups(
                lambda q_, r_, p: sw_score_ends_tiled_cuda(q_, r_, p, plan),
                q, r, PARAMS, 10, graph=True)
            emit('tile_rule', shape=shape, B=B, Lq=Lq, Lr=Lr, halos=halos,
                 T=plan[0], halo=plan[1], ms=k_ms, gcups=k_gcups,
                 bound_ms=bound_ms, card=smi)
        if _tile_plan(Lq, Lr, PARAMS) is None:
            sw[shape]['wave_rows'] = wave_rows(
                torch, dev, smi, shape, q, r, PARAMS, bound_ms,
                lambda step: time_launches(step, 10, dev, graph=True))
        sw[shape].update(probe_plans(smi, shape, q, r, bound_ms,
                                     lambda step: time_launches(
                                         step, 10, dev, graph=True)))
    probes = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for probe in PROBES:
        x = probe_input(probe, dev)
        t = dict(ms=time_launches(lambda: int16_probe_cuda(probe, x), 200,
                                  dev, graph=True),
                 plain_ms=time_launches(lambda: probe.plain(x), 200, dev),
                 library_ms=time_launches(lambda: probe.plain(x), 200, dev,
                                          graph=True),
                 bound_ms=2 * x.numel() * x.element_size()
                 / HBM_BYTES_PER_S * 1e3)
        emit('probe_time', probe=probe.name, shape=list(probe.shape),
             bound_by='bytes', card=smi, **t)
        for key, ms in t.items():
            probes[key] += ms
    # the six in one launch beside the six launches (both a graph's replay)
    # and the six PyTorch calls
    xs = [probe_input(probe, dev) for probe in PROBES]

    def six():
        for probe, x in zip(PROBES, xs):
            int16_probe_cuda(probe, x)

    def six_plain():
        for probe, x in zip(PROBES, xs):
            probe.plain(x)

    probes['all_ms'] = time_launches(lambda: int16_probe_all_cuda(xs), 200,
                                     dev, graph=True)
    probes['six_launches_ms'] = time_launches(six, 200, dev, graph=True)
    probes['six_plain_graph_ms'] = time_launches(six_plain, 200, dev,
                                                 graph=True)
    emit('probe_time', probe='all six in one launch', ms=probes['all_ms'],
         six_launches_ms=probes['six_launches_ms'],
         library_ms=probes['six_plain_graph_ms'],
         bound_ms=probes['bound_ms'], bound_by='bytes',
         bound_share=probes['bound_ms'] / probes['all_ms'], card=smi)
    return sw, probes


def compare_edit(torch, dev, label, a, b):
    """csrc/edit_distance.cu's native round (ops/edit.py::
    edit_distance_rows) against its plain twin (edit_distance_rows_plain,
    the plain version on the card) on the pairs of two ops/rows.py::Rows,
    exact; returns the max abs difference or raises."""
    from ciri_long_tpu_torch.ops.edit import (edit_distance_rows,
                                              edit_distance_rows_plain)
    got = edit_distance_rows(a, b, dev)
    want = edit_distance_rows_plain(a, b, dev)
    err = _max_err([torch.from_numpy(got)], [torch.from_numpy(want)])
    emit('kernel_vs_plain', kernel='edit_distance', case=label,
         B=len(a.lens), La=int(a.lens.max(initial=0)),
         Lb=int(b.lens.max(initial=0)), max_abs_err=err)
    if err:
        raise AssertionError('edit_distance disagrees with plain on ' + label)
    return err


def compare_sw_rows(torch, dev, label, q, r, pid, params):
    """csrc/sw_score_ends.cu's native round (ops/sw.py::sw_align_rows: the
    expand, both scorer passes, the reverse-prefix and result kernels)
    against its plain twin (sw_align_rows_plain, the plain scorer on the
    card) on one recorded round, exact: every score and coordinate.
    Returns the max abs difference or raises."""
    from ciri_long_tpu_torch.ops.rows import row_groups
    from ciri_long_tpu_torch.ops.sw import sw_align_rows, sw_align_rows_plain
    got = sw_align_rows(q, r, pid, params, dev)
    want = sw_align_rows_plain(q, r, pid, params, dev)
    err = _max_err([torch.from_numpy(got)], [torch.from_numpy(want)])
    emit('kernel_vs_plain', kernel='sw_rows', case=label, B=len(q.lens),
         groups=len(row_groups(q.lens, r.lens, pid)[1]),
         Lq=int(q.lens.max(initial=0)), Lr=int(r.lens.max(initial=0)),
         params=[list(p) for p in params], max_abs_err=err,
         hits=int((want[0] > 0).sum()))
    if err:
        raise AssertionError('sw_align_rows disagrees with its plain twin '
                             'on ' + label)
    return err


def compare_tb(torch, dev, label, q, r, n, m, scores):
    """csrc/sw_traceback.cu against the plain version on one batch of jobs,
    on the card, exact: every (score, begins, ends, run count) and every
    path's runs, element for element.  Returns the max abs difference or
    raises."""
    from ciri_long_tpu_torch.ops.sw_tb_batch import (sw_traceback_batch_plain,
                                                     sw_traceback_cuda,
                                                     tb_results)
    args = [torch.as_tensor(x).to(dev).contiguous() for x in (q, r, n, m)]
    got = sw_traceback_cuda(*args, *scores)
    want = sw_traceback_batch_plain(*args, *scores)
    torch.cuda.synchronize(dev)
    err = _max_err(list(got), list(want))     # out, and the runs
    if tb_results(*got) != tb_results(*want):
        err = max(err, 1)
    emit('kernel_vs_plain', kernel='sw_traceback', case=label,
         B=int(args[0].shape[0]), W=int(args[0].shape[1]),
         M=int(args[1].shape[1]), scores=list(scores), max_abs_err=err,
         hits=int((want[0][:, 0] > 0).sum().item()))
    if err:
        raise AssertionError('sw_traceback disagrees with plain on ' + label)
    return err


def compare_poa(torch, dev, label, arrays, variants=((None, None),)):
    """csrc/poa_align.cu against the plain version on one batch (numpy
    batch_arrays), on the card, exact: scores, pair counts and every pair;
    under each (ring depth, block shape) of ``variants``, None for the
    plan's own, one line each.  Returns the max abs difference or
    raises."""
    import numpy as np
    from ciri_long_tpu_torch.ops.poa_batch import (poa_align_batch_cuda,
                                                   poa_align_batch_plain,
                                                   poa_plan)
    args = [torch.as_tensor(x).to(dev).contiguous() for x in arrays]
    want = poa_align_batch_plain(*args)
    bases, offs, preds, seqs, nv, ns = arrays
    for depth, shape in variants:
        plan = poa_plan(offs, preds, nv, ns, bases.shape[1], seqs.shape[1],
                        dev, depth=depth, shape=shape)
        got = poa_align_batch_cuda(*args, plan=plan)
        torch.cuda.synchronize(dev)
        err = _max_err(list(got), list(want))
        emit('kernel_vs_plain', kernel='poa_align', case=label,
             B=int(bases.shape[0]), Vmax=int(bases.shape[1]),
             nmax=int(seqs.shape[1]),
             max_indegree=int(np.diff(offs, axis=1).max(initial=0)),
             cols=plan.cols, warps=plan.warps, depth=plan.depth,
             forced=[depth is not None, shape is not None],
             spill_rows=plan.spill_rows, max_abs_err=err,
             pairs=int(want[2].sum().item()))
        if err:
            raise AssertionError('poa_align disagrees with plain on {} '
                                 'under {}'.format(label, plan[:5]))
    return 0


def phase_collapse_kernels(torch, dev):
    """Phase 6: collapse's kernels on tools/collapse_cases.py's and
    tools/poa_cases.py's cases; {name: max err}."""
    import numpy as np
    from ciri_long_tpu_torch.ops.edit import _padded_rows
    from ciri_long_tpu_torch.ops.sw_tb_batch import pack_jobs
    from ciri_long_tpu_torch.tools.collapse_cases import edit_cases, tb_cases
    from ciri_long_tpu_torch.tools.poa_cases import poa_cases

    from ciri_long_tpu_torch.utils.dispatch import ROUTES

    rng = np.random.default_rng(20261017)
    errs = {'edit_distance': 0, 'sw_traceback': 0, 'poa_align': 0}
    before = dict(ROUTES)
    for label, a, b, alen, blen in edit_cases(rng):
        errs['edit_distance'] = max(errs['edit_distance'], compare_edit(
            torch, dev, label, _padded_rows(a, np.clip(alen, 0, a.shape[1])),
            _padded_rows(b, np.clip(blen, 0, b.shape[1]))))
    for label, qs, rs, scores in tb_cases(rng):
        errs['sw_traceback'] = max(errs['sw_traceback'], compare_tb(
            torch, dev, label, *pack_jobs(qs, rs), scores))
    for label, arrays in poa_cases(np.random.default_rng(20261019),
                                   wide=True):
        errs['poa_align'] = max(errs['poa_align'], compare_poa(
            torch, dev, label, arrays, POA_VARIANTS))
    routes = {k: ROUTES[k] - before[k] for k in COLLAPSE_ROUTES}
    emit('collapse_routes', routes=routes)
    if min(routes.values()) <= 0:
        raise AssertionError('phase 6 missed a route: {}'.format(routes))
    return errs


# what a collapse run's recorder keeps, by name
RECORDED = ('sw_score_ends', 'sw_rows', 'edit_distance', 'sw_traceback')


def _recording(torch, seen):
    """Record a collapse run's kernel inputs into ``seen`` (lists by the
    names of RECORDED); returns the undo.  The launch counts stay the
    wrappers' own.  The rotation's traceback: each sw_traceback_cuda
    call's arguments.  The SW and edit distances are native rounds
    (pipeline/collapse.py's sw_align_rows and edit_distance_rows): each
    round's row views whole ('sw_rows': (q, r, pid, params);
    'edit_distance': (a, b)), and each SW group's two scorer passes as the
    padded launches the round makes ('sw_score_ends': (q, r, params) on
    the card; the reverse pass's rows reversed at the round's ends)."""
    import numpy as np

    from ciri_long_tpu_torch.ops import sw_tb_batch
    from ciri_long_tpu_torch.ops.rows import padded, row_groups
    from ciri_long_tpu_torch.ops.sw import _reverse_rows
    from ciri_long_tpu_torch.pipeline import collapse

    real_tb = sw_tb_batch.sw_traceback_cuda
    real_sw, real_edit = collapse.sw_align_rows, collapse.edit_distance_rows

    def tb(*args, **kw):
        seen['sw_traceback'].append(tuple(
            a.clone() if torch.is_tensor(a) else a for a in args))
        return real_tb(*args, **kw)

    def on(x, device):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def sw_rows(q, r, pid, params, device, *args, **kw):
        out = real_sw(q, r, pid, params, device, *args, **kw)
        seen['sw_rows'].append((q, r, np.asarray(pid), list(params)))
        order, groups = row_groups(q.lens, r.lens, pid)
        for start, n, Lq, Lr, k in groups.tolist():
            rows = order[start:start + n]
            qp = padded((q.codes, q.off[rows], q.lens[rows]), Lq)[0]
            rp = padded((r.codes, r.off[rows], r.lens[rows]), Lr)[0]
            seen['sw_score_ends'] += [
                (on(qp, device), on(rp, device), params[k]),
                (on(_reverse_rows(qp, out[2, rows]), device),
                 on(_reverse_rows(rp, out[4, rows]), device), params[k])]
        return out

    def edit_rows(a, b, device, *args, **kw):
        seen['edit_distance'].append((a, b))
        return real_edit(a, b, device, *args, **kw)

    sw_tb_batch.sw_traceback_cuda = tb
    collapse.sw_align_rows, collapse.edit_distance_rows = sw_rows, edit_rows

    def undo():
        sw_tb_batch.sw_traceback_cuda = real_tb
        collapse.sw_align_rows, collapse.edit_distance_rows = \
            real_sw, real_edit
    return undo


# collapse's calls whose wall the run sums over its threads: the SW and
# the edit distances (native rounds, fused or a direct call's own), the
# rotation's traceback, the junction consensus (a host ``poa`` on both
# routes) and the sub-cluster consensus (``poa_consensus_many``:
# csrc/poa_align.cu's rounds on cuda, host ``poa`` calls on cpu)
TIMED_CALLS = {'sw': ('_fused_sw',),
               'edit': ('_fused_edit',),
               'traceback': ('sw_traceback_batch',),
               'poa_junction': ('poa',),
               'poa_subcluster': ('poa_consensus_many',)}
# the stages of ops/sw_tb_batch.py::sw_traceback_batch on the card: packing
# the jobs, the host-to-device copy, the route plan (its job lists copied
# too), the launches (the host's side; on a recorded run also the
# recorder's copies of the inputs), the device-to-host copy that waits for
# the kernels, and the Python that turns the runs into tuples
TB_STAGES = {'pack': ('pack_jobs',), 'upload': ('upload',),
             'plan': ('tb_plan',), 'launch': ('sw_traceback_cuda',),
             'download_and_wait': ('download',),
             'tb_results': ('tb_results',)}


def _timing(module, calls, seconds, cpu=None):
    """Wrap ``calls`` ({kind: attribute names}) of ``module`` so that each
    call adds its wall to ``seconds[kind]`` and, with ``cpu``, the thread's
    CPU time to ``cpu[kind]`` (both summed over threads; a thread waiting
    for the interpreter lock or the card spends wall without CPU, unless
    CUDA spins while it waits); returns the undo."""
    import threading

    lock = threading.Lock()
    originals = []
    for kind, names in calls.items():
        for attr in names:
            fn = getattr(module, attr)
            originals.append((attr, fn))

            def timed(*args, _fn=fn, _kind=kind, **kw):
                t0, c0 = time.perf_counter(), time.thread_time()
                try:
                    return _fn(*args, **kw)
                finally:
                    wall = time.perf_counter() - t0
                    used = time.thread_time() - c0
                    with lock:
                        seconds[_kind] = seconds.get(_kind, 0.0) + wall
                        if cpu is not None:
                            cpu[_kind] = cpu.get(_kind, 0.0) + used

            setattr(module, attr, timed)

    def undo():
        for attr, fn in originals:
            setattr(module, attr, fn)
    return undo


def _recording_poa(calls):
    """Wrap collapse's ``poa_consensus_many`` so that each call on the card
    appends (jobs, consensus list, the round loop's stats of the call) to
    ``calls``; returns the undo."""
    from ciri_long_tpu_torch.pipeline import collapse

    real = collapse.poa_consensus_many

    def recorder(jobs, *args, **kw):
        stats = {}
        out = real(jobs, *args, stats=stats, **kw)
        calls.append((jobs, out, stats))
        return out

    collapse.poa_consensus_many = recorder

    def undo():
        collapse.poa_consensus_many = real
    return undo


def run_collapse(torch, label, ref, cand_circ, root):
    """``collapse`` through the CLI on one sample, --device cuda (its kernel
    inputs and its sub-cluster POA calls recorded) then --device cpu, with
    the launch counts set to 0 before and read after each run.  Raises
    unless the four files are byte-identical, the corrected clusters and
    counters equal, every kernel launched on cuda and none on cpu.  Returns
    the recorded inputs, the phase's fields and the recorded POA calls."""
    import pickle
    from ciri_long_tpu_torch.cli.main import main
    from ciri_long_tpu_torch.ops import sw_tb_batch
    from ciri_long_tpu_torch.pipeline import collapse
    from ciri_long_tpu_torch.tools.world import sample_list
    from ciri_long_tpu_torch.utils.dispatch import (COLLAPSE_KERNELS,
                                                    DEVICE_MS, ROUTES,
                                                    launch_counts,
                                                    reset_launches)

    lst = sample_list(os.path.join(root, 'samples.lst'), [('s1', cand_circ)])
    seen = {name: [] for name in RECORDED}
    poa_calls = []
    runs = {}
    for device in ('cuda', 'cpu'):
        out = os.path.join(root, 'collapse_' + device)
        shutil.rmtree(out, ignore_errors=True)
        undo = _recording(torch, seen) if device == 'cuda' else (lambda: 0)
        undo_poa = _recording_poa(poa_calls) if device == 'cuda' else \
            (lambda: 0)
        host_s, tb_wall, tb_cpu = {}, {}, {}
        untime = _timing(collapse, TIMED_CALLS, host_s)
        untime_tb = _timing(sw_tb_batch, TB_STAGES, tb_wall, tb_cpu)
        try:
            reset_launches()
            t0 = time.perf_counter()
            main(['collapse', '-i', lst, '-o', out, '-r', ref, '-p', 'smoke',
                  '-t', '1', '--device', device])
            wall = time.perf_counter() - t0
            launches = launch_counts(COLLAPSE_KERNELS)
            routes = dict(ROUTES)
            device_ms = dict(DEVICE_MS)
        finally:
            untime_tb()
            untime()
            undo_poa()
            undo()
        with open(os.path.join(out, 'tmp', 'smoke.corrected.pkl'), 'rb') as f:
            circ_num, corrected = pickle.load(f)
        runs[device] = dict(
            wall_s=wall, launches=launches, routes=routes, host_s=host_s,
            device_ms=device_ms, tb_split=dict(wall_s=tb_wall, cpu_s=tb_cpu),
            files={ext: Path(out, 'smoke.' + ext).read_bytes()
                   for ext in COLLAPSE_FILES},
            counters=dict(circ_num), corrected=corrected)
    gpu, cpu = runs['cuda'], runs['cpu']
    identical = {ext: gpu['files'][ext] == cpu['files'][ext]
                 for ext in COLLAPSE_FILES}
    n_circ = gpu['files']['info'].count(b'\n')
    fields = dict(
        world=label, cand_reads=sum(1 for ln in open(cand_circ)
                                    if ln.startswith('>')),
        circrnas=n_circ, clusters=len(gpu['corrected']),
        counters=gpu['counters'], counters_equal=(
            gpu['counters'] == cpu['counters']),
        corrected_equal=gpu['corrected'] == cpu['corrected'],
        files_identical=identical, launches=gpu['launches'],
        routes=gpu['routes'], cpu_launches=cpu['launches'],
        cuda_wall_s=gpu['wall_s'], cpu_wall_s=cpu['wall_s'],
        cuda_calls_s=gpu['host_s'], cpu_calls_s=cpu['host_s'],
        cuda_traceback_split=gpu['tb_split'],
        poa_device_ms=gpu['device_ms']['poa_align'],
        poa_calls=len(poa_calls),
        poa_jobs=sum(len(c[0]) for c in poa_calls),
        recorded={k: len(v) for k, v in seen.items()})
    emit('collapse', **fields)
    if not all(identical.values()) or not fields['counters_equal'] \
            or not fields['corrected_equal']:
        raise AssertionError('collapse differs between --device cuda and '
                             'cpu on the {} world'.format(label))
    if min(gpu['launches'].values()) <= 0:
        raise AssertionError('collapse --device cuda missed a kernel: '
                             '{}'.format(gpu['launches']))
    if min(gpu['routes'][k] for k in ('wave', 'tb_smem', 'edit_thread')) <= 0:
        raise AssertionError('collapse --device cuda missed the routes its '
                             'jobs take: {}'.format(gpu['routes']))
    if any(cpu['launches'].values()):
        raise AssertionError('collapse --device cpu launched a kernel: '
                             '{}'.format(cpu['launches']))
    if n_circ <= 0:
        raise AssertionError('collapse found no circRNA on the {} '
                             'world'.format(label))
    return seen, fields, poa_calls


def poa_checks(torch, dev, smi, label, calls, rate):
    """A collapse run's sub-cluster POA on the card (``calls``, recorded by
    _recording_poa): every job replayed through the native ``poa``,
    byte-identical; then the call that held the largest launch (by cells)
    replayed to keep that launch's inputs (ops/poa.py::poa_launch_inputs),
    checked against the plain version, timed (a CUDA graph's replay of 10
    launches, its plan made beforehand) beside the plain version and the
    bound: its cell updates, V x (n + 1) a job, at ``rate``, the card's
    rate for this update, or the bytes it must move at the HBM rate,
    whichever is larger (the inputs read once, the pairs, scores and
    counts written once, and the 32-bit direction word of each of the
    (V + 1) x (n + 1) cells, which the walk reads; H, F1 and F2 need not
    leave the chip), and split into its rows and its walk (block 0's
    %globaltimer stamps, the mean of 10 launches), with its plan's ring
    depth and spill rows.  The launch's inputs go to
    build/chip_smoke/<label>_poa_largest.npz (what ``python3 -m
    ciri_long_tpu_torch.tools.poa_split --inputs`` times).  One JSON line;
    returns its fields."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from ciri_long_tpu_torch.misc.kexp import HBM_BYTES_PER_S, time_launches
    from ciri_long_tpu_torch.ops import poa as poa_mod
    from ciri_long_tpu_torch.ops.poa_batch import (DIR_BYTES,
                                                   poa_align_batch_cuda,
                                                   poa_align_batch_plain,
                                                   poa_plan)

    def native(job):
        return poa_mod.poa(job, 2, False, 10, -4, -8, -2, -24, -1)[0]

    jobs = [job for c in calls for job in c[0]]
    got = [ccs for c in calls for ccs in c[1]]
    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        want = list(pool.map(native, jobs))
    differ = sum(not _same(a, b) for a, b in zip(got, want))
    if differ or not calls:
        raise AssertionError('{}: {} of {} sub-cluster consensus differ from '
                             'the native poa ({} calls)'.format(
                                 label, differ, len(jobs), len(calls)))

    big_call = max(calls, key=lambda c: c[2]['largest_cells'])
    again, arrays = poa_mod.poa_launch_inputs(big_call[0], big_call[2],
                                              device=dev)
    if not all(_same(a, b) for a, b in zip(again, big_call[1])):
        raise AssertionError('{}: a replayed POA call differs'.format(label))
    err = compare_poa(torch, dev, label + ' largest poa_align launch',
                      arrays)
    bases, offs, preds, seqs, nv, ns = arrays
    np.savez(os.path.join(WORK, label + '_poa_largest.npz'), bases=bases,
             offs=offs, preds=preds, seqs=seqs, nv=nv, ns=ns)
    args = [torch.as_tensor(x).to(dev).contiguous() for x in arrays]
    plan = poa_plan(offs, preds, nv, ns, bases.shape[1], seqs.shape[1], dev)
    pairs = int(poa_align_batch_cuda(*args, plan=plan)[2].sum().item())
    ms = time_launches(lambda: poa_align_batch_cuda(*args, plan=plan),
                       10, dev, graph=True)
    stamps = torch.zeros((len(nv), 3), dtype=torch.int64, device=dev)
    split = []
    for _ in range(10):
        poa_align_batch_cuda(*args, plan=plan, stamps=stamps)
        split.append(np.diff(stamps[0].cpu().numpy()) * 1e-6)
    rows_ms, walk_ms = np.mean(split, axis=0).tolist()
    plain_ms = time_launches(lambda: poa_align_batch_plain(*args), 1, dev)
    nv64, ns64 = nv.astype(np.int64), ns.astype(np.int64)
    updates = int((nv64 * (ns64 + 1)).sum())
    cells = int(((nv64 + 1) * (ns64 + 1)).sum())
    nbytes = DIR_BYTES * cells + int(nv64.sum() + ns64.sum()) + \
        4 * int((nv64 + 1).sum() + preds.size) + 8 * pairs + 8 * len(nv)
    ops_ms = updates / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, 'operations') if ops_ms >= bytes_ms else \
        (bytes_ms, 'bytes')
    fields = dict(
        world=label, calls=len(calls), jobs=len(jobs), identical_to_native=
        len(jobs) - differ, launches=sum(c[2]['launches'] for c in calls),
        run_device_ms=sum(c[2]['device_ms'] for c in calls),
        largest=dict(B=int(len(nv)), Vmax=int(bases.shape[1]),
                     nmax=int(seqs.shape[1]), cells=cells, updates=updates,
                     pairs=pairs, max_indegree=int(
                         np.diff(offs, axis=1).max(initial=0)),
                     run_ms=big_call[2]['largest_ms']),
        ms=ms, rows_ms=rows_ms, walk_ms=walk_ms, cols=plan.cols,
        warps=plan.warps, depth=plan.depth, spill_rows=plan.spill_rows,
        plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / ms, ops_bound_ms=ops_ms,
        bytes_bound_ms=bytes_ms, max_abs_err=err, card=smi)
    emit('collapse_poa', **fields)
    return fields


def _same(a, b):
    """Two consensus results equal in form and bytes."""
    import numpy as np
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    return np.asarray(a).dtype == np.asarray(b).dtype and \
        np.array_equal(a, b)


def _real(x, torch):
    """Per-row real lengths of PAD-suffixed codes (the first PAD)."""
    pad = x >= 5
    first = torch.where(pad.any(1), pad.int().argmax(1),
                        torch.full_like(pad[:, 0], x.shape[1], dtype=torch.int64))
    return first


def _row_lens(args):
    """int64 lengths of a recorded native round's two sides."""
    return args[0].lens.astype('int64'), args[1].lens.astype('int64')


def launch_cells(name, args, torch):
    """The DP cells one recorded launch's or native round's data needs:
    real query x reference lengths summed over its rows (the forward
    pass's, for a SW round)."""
    if name == 'sw_score_ends':
        q, r = args[0], args[1]
        return int((_real(q, torch) * _real(r, torch)).sum().item())
    if name in ('sw_rows', 'edit_distance'):
        n, m = _row_lens(args)
        return int((n * m).sum())
    a, b, n, m = args[:4]
    n = n.long().clamp(0, a.shape[1])
    m = m.long().clamp(0, b.shape[1])
    return int((n * m).sum().item())


def launch_work(name, args, torch):
    """The updates one recorded launch's data needs at the least: DP cells
    for the SW kernels; for the bit-parallel edit distance, 32-row word
    updates, ceil(pattern / 32) * text a pair with the pattern the side
    that needs fewer."""
    if name != 'edit_distance':
        return launch_cells(name, args, torch)
    n, m = _row_lens(args)
    return int(((n + 31) // 32 * m).clip(max=(m + 31) // 32 * n).sum())


def check_recorded(torch, dev, seen, sw_count=SW_CHECKED, tb_all=True,
                   edit_all=True, label='collapse'):
    """The recorded inputs of a collapse run against the plain versions:
    every native edit round and traceback launch (or the largest one when
    ``*_all`` is False), every native SW round (the ``sw_count`` largest
    when ``edit_all`` is False) and the ``sw_count`` largest SW scorer
    launches.  {name: max err}."""
    errs = {}
    for name, args_list in seen.items():
        order = sorted(range(len(args_list)), reverse=True,
                       key=lambda t: launch_work(name, args_list[t], torch))
        keep = {'sw_score_ends': order[:sw_count],
                'sw_rows': order if edit_all else order[:sw_count],
                'edit_distance': order if edit_all else order[:1],
                'sw_traceback': order if tb_all else order[:1]}[name]
        err = 0
        for t in keep:
            args = args_list[t]
            case = '{} {} launch {}'.format(label, name, t)
            if name == 'sw_score_ends':
                err = max(err, compare(torch, dev, args[0].cpu().numpy(),
                                       args[1].cpu().numpy(), args[2], case,
                                       sw_routes(args[0].shape[1],
                                                 args[1].shape[1],
                                                 args[2]))['sw_score_ends'])
            elif name == 'sw_rows':
                err = max(err, compare_sw_rows(torch, dev, case, *args))
            elif name == 'edit_distance':
                err = max(err, compare_edit(torch, dev, case, *args))
            else:
                err = max(err, compare_tb(torch, dev, case, *args[:4],
                                          args[4:8]))
        errs[name] = err
    return errs


def sw_route_split(torch, dev, smi, label, args_list, times, rate,
                   rows_timed=False, line='collapse_sw_route'):
    """A collapse run's SW launches by route (tiled where ops/sw.py::
    _tile_plan gives a plan, wave elsewhere): per route the launches, their
    summed device time (``times``: each recorded launch's graph replay) and,
    at the route's largest launch (by cells), its shapes, ms, plain ms and
    bound at ``rate`` cells/s, and with ``rows_timed`` the wavefront's
    largest launch at each R (wave_rows).  One JSON line a route, named
    ``line``; returns {route: fields}."""
    from ciri_long_tpu_torch.misc.kexp import time_launches
    from ciri_long_tpu_torch.ops.sw import _tile_plan

    split = {}
    for route in ('wave', 'tiled'):
        mine = [t for t, a in enumerate(args_list)
                if (_tile_plan(a[0].shape[1], a[1].shape[1], a[2]) is None)
                == (route == 'wave')]
        fields = dict(launches=len(mine),
                      device_ms=sum(times[t] for t in mine))
        if mine:
            big = args_list[max(mine, key=lambda t: launch_cells(
                'sw_score_ends', args_list[t], torch))]
            bound_ms, bound_by = launch_bound(
                'sw_score_ends', big, {'sw_score_ends': rate}, torch)
            ms = _time_recorded(torch, dev, 'sw_score_ends', big, 10)
            fields.update(
                shape=[list(big[0].shape), list(big[1].shape)],
                params=list(big[2]),
                cells=launch_cells('sw_score_ends', big, torch), ms=ms,
                plain_ms=_plain_ms(torch, dev, 'sw_score_ends', big),
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms)
        split[route] = fields
        emit(line, world=label, route=route, card=smi, **fields)
        if route == 'wave' and mine and rows_timed:
            fields['wave_rows'] = wave_rows(
                torch, dev, smi, label + ' largest wave launch', big[0],
                big[1], big[2], fields['bound_ms'],
                lambda step: time_launches(step, 10, dev, graph=True))
    return split


def phase_collapse(torch, dev, smi, world_ref):
    """Phase 7: collapse on phase 4's cand_circ.fa, then its sub-cluster POA
    and its SW launches by route; ({name: max err}, the POA's fields,
    {route: fields})."""
    from ciri_long_tpu_torch.misc.kexp import peak_cell_rate, recurrence_rate

    root = os.path.join(WORK, 'collapse_call_world')
    os.makedirs(root, exist_ok=True)
    seen, fields, poa_calls = run_collapse(
        torch, 'call', world_ref,
        os.path.join(WORK, 'out_cuda', 'smoke.cand_circ.fa'), root)
    errs = check_recorded(torch, dev, seen, label='call world collapse')
    poa = poa_checks(torch, dev, smi, 'call', poa_calls,
                     recurrence_rate(dev, 'poa_align'))
    errs['poa_align'] = poa['max_abs_err']
    sw_args = seen['sw_score_ends']
    split = sw_route_split(torch, dev, smi, 'call', sw_args,
                           [_time_recorded(torch, dev, 'sw_score_ends', a, 3)
                            for a in sw_args], peak_cell_rate(dev))
    return errs, dict(poa, launches=fields['launches']['poa_align'],
                      device_ms=fields['poa_device_ms']), split


def _time_recorded(torch, dev, name, args, n_iter):
    """ms of one recorded launch, a CUDA graph's replay of n_iter (the
    route plans made beforehand, as the main path makes them); of a
    recorded native round ('sw_rows', 'edit_distance'), which syncs, the
    mean wall of n_iter rounds after one, staging and copies included."""
    from ciri_long_tpu_torch.misc.kexp import time_launches
    from ciri_long_tpu_torch.ops import edit, sw, sw_tb_batch

    if name in ('sw_rows', 'edit_distance'):
        def step():
            if name == 'sw_rows':
                sw.sw_align_rows(*args, dev)
            else:
                edit.edit_distance_rows(*args, dev)
        step()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            step()
        return (time.perf_counter() - t0) * 1e3 / n_iter
    if name == 'sw_score_ends':
        def step():
            sw.sw_score_ends_cuda(*args)
    else:
        q, r, n, m = args[:4]
        plan = sw_tb_batch.tb_plan(n.cpu().numpy(), m.cpu().numpy(),
                                   q.shape[1], r.shape[1], dev)

        def step():
            sw_tb_batch.sw_traceback_cuda(*args, plan=plan)
    return time_launches(step, n_iter, dev, graph=True)


def _plain_ms(torch, dev, name, args):
    from ciri_long_tpu_torch.misc.kexp import time_launches
    from ciri_long_tpu_torch.ops.edit import edit_distance_rows_plain
    from ciri_long_tpu_torch.ops.sw import (sw_align_rows_plain,
                                            sw_score_ends)
    from ciri_long_tpu_torch.ops.sw_tb_batch import sw_traceback_batch_plain

    fn = {'sw_score_ends': sw_score_ends,
          'sw_rows': lambda *a: sw_align_rows_plain(*a, dev),
          'edit_distance': lambda *a: edit_distance_rows_plain(*a, dev),
          'sw_traceback': sw_traceback_batch_plain}[name]
    return time_launches(lambda: fn(*args), 1, dev)


def launch_bound(name, args, rates, torch):
    """(least ms, 'operations' or 'bytes') of one recorded launch: its
    updates (launch_work) at the card's rate for that kernel's update, or
    its bytes at the HBM rate (codes and lengths read once, outputs written
    once; for the traceback also the direction bytes of its jobs on the
    global route, one a cell, written once)."""
    from ciri_long_tpu_torch.misc.kexp import HBM_BYTES_PER_S
    from ciri_long_tpu_torch.ops.sw_tb_batch import global_bytes

    if name == 'sw_score_ends':
        q, r = args[0], args[1]
        nbytes = int(_real(q, torch).sum() + _real(r, torch).sum()) \
            + 12 * q.shape[0]
    elif name in ('sw_rows', 'edit_distance'):
        # codes read once, 16 bytes of views and 20 (SW) or 4 bytes of
        # answers a row
        n, m = _row_lens(args)
        nbytes = int(n.sum() + m.sum()) + len(n) * (
            36 if name == 'sw_rows' else 20)
    else:
        a, b, n, m = args[:4]
        n = n.long().clamp(0, a.shape[1])
        m = m.long().clamp(0, b.shape[1])
        nbytes = int(n.sum() + m.sum()) + 32 * a.shape[0] + int(
            global_bytes(n.cpu().numpy(), m.cpu().numpy()).sum())
    ops_ms = launch_work(name, args, torch) / rates[name] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else \
        (bytes_ms, 'bytes')


def save_route_inputs(torch, args_list, route, path):
    """The SW launches (query, ref, params) of ``route`` ('wave' or
    'tiled', as ops/sw.py::_tile_plan routes them), on the host, to
    ``path``: the inputs ciri_long_tpu_torch/tools/wave_ab.py times in two
    checkouts."""
    from ciri_long_tpu_torch.ops.sw import _tile_plan

    torch.save([(a[0].cpu(), a[1].cpu(), tuple(a[2])) for a in args_list
                if (_tile_plan(a[0].shape[1], a[1].shape[1], a[2]) is None)
                == (route == 'wave')], path)


def phase_collapse_full(torch, dev, smi):
    """Phase 8: collapse at full size on the cohort of
    benchmarks/collapse_bench.py's defaults, its ``call`` first on both
    routes (byte-identical tmp/*.ccs.fa, tmp/*.raw.fa and cand_circ.fa; X4's
    launches and escalated pairs on cuda, no pair aligned on the host
    there).  Returns ({name: max err}, {name: the largest launch's
    numbers}, the phase's fields, with ``cohort_nw``)."""
    from ciri_long_tpu_torch.cli.main import main
    from ciri_long_tpu_torch.misc.kexp import peak_cell_rate, recurrence_rate
    from ciri_long_tpu_torch.tools.world import cohort_world
    from ciri_long_tpu_torch.utils.dispatch import LAUNCHES, ROUTES

    root = os.path.join(WORK, 'cohort')
    ref, reads, n_reads = cohort_world(os.path.join(root, 'world'), **COHORT)
    walls = {}
    for device, out in (('cuda', 'call'), ('cpu', 'call_cpu')):
        t0 = time.perf_counter()
        main(['call', '-i', reads, '-o', os.path.join(root, out), '-r', ref,
              '-p', 'cohort', '-t', '1', '--device', device])
        walls[device] = time.perf_counter() - t0
        if device == 'cuda':
            cohort_nw = dict(launches=LAUNCHES['nw_traceback'],
                             escalated_pairs=ROUTES['nw_escalate'],
                             host_pairs=ROUTES['nw_host'],
                             routes={k: v for k, v in ROUTES.items()
                                     if k.startswith('nw_')})
    cohort_nw['cpu_host_pairs'] = ROUTES['nw_host']
    counters = [{k: v for k, v in json.loads(
        Path(root, d, 'cohort.json').read_text()).items()
        if k not in RUN_ONLY} for d in ('call', 'call_cpu')]
    same = _same_ccs(root, 'call', 'call_cpu', 'cohort') and (
        Path(root, 'call', 'cohort.cand_circ.fa').read_bytes()
        == Path(root, 'call_cpu', 'cohort.cand_circ.fa').read_bytes()) \
        and counters[0] == counters[1]
    emit('cohort_call', n_reads=n_reads, wall_s=walls['cuda'],
         cpu_wall_s=walls['cpu'], identical=same, counters=counters[0],
         nw=cohort_nw, cohort=COHORT)
    if not same or cohort_nw['launches'] <= 0 or cohort_nw['host_pairs']:
        raise AssertionError('the cohort\'s call differs between cuda and '
                             'cpu, or its polish left the card: '
                             '{}'.format(cohort_nw))
    seen, fields, poa_calls = run_collapse(
        torch, 'cohort', ref, os.path.join(root, 'call',
                                           'cohort.cand_circ.fa'), root)
    errs = check_recorded(torch, dev, seen, sw_count=2, tb_all=False,
                          edit_all=False, label='cohort collapse')
    rates = {'sw_score_ends': peak_cell_rate(dev),
             'sw_rows': peak_cell_rate(dev),
             'edit_distance': recurrence_rate(dev, 'edit_distance'),
             'sw_traceback': recurrence_rate(dev, 'sw_traceback'),
             'edit_cell': recurrence_rate(dev, 'edit_cell'),
             'poa_align': recurrence_rate(dev, 'poa_align')}
    emit('cell_rate', collapse_updates_per_s=rates, card=smi)
    poa = poa_checks(torch, dev, smi, 'cohort', poa_calls,
                     rates['poa_align'])
    errs['poa_align'] = poa['max_abs_err']
    largest = {}
    for name, args_list in seen.items():
        work = [launch_work(name, a, torch) for a in args_list]
        times = [_time_recorded(torch, dev, name, a, 3) for a in args_list]
        total = sum(times)
        if name == 'sw_score_ends':
            routes = sw_route_split(torch, dev, smi, 'cohort', args_list,
                                    times, rates[name], rows_timed=True)
            save_route_inputs(torch, args_list, 'wave', WAVE_INPUTS)
            save_route_inputs(torch, args_list, 'tiled',
                              TILED_INPUTS['cohort'])
        big = args_list[max(range(len(work)), key=work.__getitem__)]
        bound_ms, bound_by = launch_bound(name, big, rates, torch)
        largest[name] = dict(
            launches=len(args_list), device_ms=total,
            cells=sum(launch_cells(name, a, torch) for a in args_list),
            updates=sum(work), ms=_time_recorded(torch, dev, name, big, 10),
            plain_ms=_plain_ms(torch, dev, name, big), bound_ms=bound_ms,
            bound_by=bound_by, shape=(
                [len(big[0].lens), int(big[0].lens.max(initial=0)),
                 int(big[1].lens.max(initial=0))]
                if name in ('sw_rows', 'edit_distance') else
                [list(a.shape) for a in big if torch.is_tensor(a)]),
            largest_cells=launch_cells(name, big, torch),
            largest_updates=max(work))
        if name == 'edit_distance':   # the bound of a DP cell an update
            largest[name]['cell_bound_ms'] = (
                largest[name]['largest_cells'] / rates['edit_cell'] * 1e3)
        emit('collapse_kernel_time', kernel=name, card=smi, **largest[name])
    largest['poa_align'] = dict(
        poa, launches=fields['launches']['poa_align'],
        device_ms=fields['poa_device_ms'],
        shape=[poa['largest'][k] for k in ('B', 'Vmax', 'nmax')])
    emit('collapse_full', reads=n_reads, cuda_wall_s=fields['cuda_wall_s'],
         cpu_wall_s=fields['cpu_wall_s'],
         cuda_reads_per_s=n_reads / fields['cuda_wall_s'],
         cpu_reads_per_s=n_reads / fields['cpu_wall_s'],
         device_ms={k: v['device_ms'] for k, v in largest.items()},
         cuda_calls_s=fields['cuda_calls_s'],
         cpu_calls_s=fields['cpu_calls_s'], card=smi)
    largest['sw_score_ends']['routes'] = routes
    fields['cohort_nw'] = cohort_nw
    fields['n_reads'] = n_reads
    return errs, largest, fields


def _stole(log):
    """[(stage, chunks the card ran, chunks)] from a run's log lines
    ``hybrid <stage>: device stole X/Y chunks``, in order."""
    import re
    out = []
    with open(log) as f:
        for ln in f:
            m = re.search(r'hybrid (\w+): device stole (\d+)/(\d+) chunks',
                          ln)
            if m:
                out.append((m.group(1), int(m.group(2)), int(m.group(3))))
    return out


def _recording_drains(drains):
    """Record every HybridDrain the stages make: each delivery's chunk, its
    seconds since the drain began, whether a stealer (the card) or the pool
    gave it, and whether it came first.  Returns the undo."""
    import threading
    from ciri_long_tpu_torch.parallel.hybrid import HybridDrain
    from ciri_long_tpu_torch.pipeline import collapse, find_bsj

    class Recorded(HybridDrain):
        def __init__(self, *args, **kw):
            self.t0 = time.perf_counter()
            self.arrivals = []
            super().__init__(*args, **kw)
            drains.append(self)

        def _deliver(self, ci, res):
            self.arrivals.append((
                ci, time.perf_counter() - self.t0,
                threading.current_thread().name.startswith('ciri-hybrid'),
                ci not in self._done and ci not in self._taken))
            super()._deliver(ci, res)

    saved = find_bsj.HybridDrain, collapse.HybridDrain
    find_bsj.HybridDrain = collapse.HybridDrain = Recorded

    def undo():
        find_bsj.HybridDrain, collapse.HybridDrain = saved
    return undo


def _drain_fields(drain):
    """A recorded drain's split: the chunks whose first result came from
    the card and from the pool, and when the last of each came (seconds
    since the drain began; the pool's first too)."""
    first = [(t, card) for _, t, card, new in drain.arrivals if new]
    card = [t for t, c in first if c]
    pool = [t for t, c in first if not c]
    return dict(chunks=len(drain._payloads),
                card_chunks=len(card), pool_chunks=len(pool),
                stolen=drain.stolen, raced=drain.raced,
                card_last_s=max(card, default=None),
                pool_first_s=min(pool, default=None),
                pool_last_s=max(pool, default=None))


def _cli_run(argv, out, prefix):
    """One run of the CLI in this process, as a fresh process would start
    (CIRI_SELECT_THREADS unset: the CLI sets it from -t), the launch counts
    set to 0 just before it and read just after: its wall, launches,
    routes, and each drained stage's split of chunks (the log's line and
    the recorded deliveries)."""
    from ciri_long_tpu_torch.cli.main import main
    from ciri_long_tpu_torch.utils.dispatch import (LAUNCHES, ROUTES,
                                                    reset_launches)

    shutil.rmtree(out, ignore_errors=True)
    saved = os.environ.pop('CIRI_SELECT_THREADS', None)
    drains = []
    undo = _recording_drains(drains)
    try:
        reset_launches()
        t0 = time.perf_counter()
        main(argv + ['-o', out, '-p', prefix])
        wall = time.perf_counter() - t0
        launches, routes = dict(LAUNCHES), dict(ROUTES)
    finally:
        undo()
        os.environ.pop('CIRI_SELECT_THREADS', None)
        if saved is not None:
            os.environ['CIRI_SELECT_THREADS'] = saved
    logged = _stole(os.path.join(out, prefix + '.log'))
    if len(logged) != len(drains):
        raise AssertionError('{} drains, {} logged'.format(len(drains),
                                                           len(logged)))
    stole = {stage: dict(_drain_fields(d), logged=[x, y])
             for (stage, x, y), d in zip(logged, drains)}
    return dict(wall_s=wall, launches=launches, routes=routes, stole=stole)


def _pool_start_s(ref, index_cache):
    """Seconds from spawning THREADS scan workers (find_bsj's pool, with
    their genome and index from ``index_cache``) until each has run a task
    (a 0.5 s sleep, taken off)."""
    from ciri_long_tpu_torch.pipeline.find_bsj import _spawn_pool

    t0 = time.perf_counter()
    pool = _spawn_pool(THREADS, ref, None, False, index_cache)
    try:
        for r in [pool.apply_async(time.sleep, (0.5,))
                  for _ in range(THREADS)]:
            r.get(timeout=300)
        return time.perf_counter() - t0 - 0.5
    finally:
        pool.terminate()
        pool.join()


def _call_outputs(out, prefix):
    counters = {k: v for k, v in json.loads(Path(
        out, prefix + '.json').read_text()).items()
        if k not in RUN_ONLY}
    return counters, {name: Path(out, name).read_bytes() for name in (
        'tmp/{}.ccs.fa'.format(prefix), 'tmp/{}.raw.fa'.format(prefix),
        '{}.cand_circ.fa'.format(prefix))}


def _collapse_outputs(out, prefix):
    import pickle
    with open(os.path.join(out, 'tmp', prefix + '.corrected.pkl'),
              'rb') as f:
        circ_num, corrected = pickle.load(f)
    return (dict(circ_num), corrected), {
        ext: Path(out, prefix + '.' + ext).read_bytes()
        for ext in COLLAPSE_FILES}


def _threads_world(smi, label, ref, reads, n_reads, call_t1, collapse_t1,
                   root, prefix, cuda_threads):
    """Phase 9 on one world: ``call`` at each -t of ``cuda_threads`` on
    cuda and at THREADS on cpu, then ``collapse`` at THREADS on both, each
    held to the -t 1 cuda run's outputs (``call_t1``, ``collapse_t1``:
    (out dir, prefix) of phases 4, 7 and 8)."""
    from ciri_long_tpu_torch.tools.world import sample_list
    from ciri_long_tpu_torch.utils.dispatch import (CALL_KERNELS,
                                                    COLLAPSE_KERNELS)

    want_call = _call_outputs(*call_t1)
    want_collapse = _collapse_outputs(*collapse_t1)
    runs, failed = {}, []
    calls = [(t, 'cuda') for t in cuda_threads] + [(THREADS, 'cpu')]
    for t, device in calls:
        name = 'call_t{}_{}'.format(t, device)
        run = _cli_run(['call', '-i', reads, '-r', ref, '-t', str(t),
                        '--device', device], os.path.join(root, name),
                       prefix)
        run['identical'] = _call_outputs(os.path.join(root, name),
                                         prefix) == want_call
        run['reads'] = n_reads
        run['timing'] = json.loads(Path(
            root, name, prefix + '.json').read_text())['timing']
        runs[name] = run
    for device in ('cuda', 'cpu'):
        cand = os.path.join(root, 'call_t{}_{}'.format(THREADS, device),
                            prefix + '.cand_circ.fa')
        lst = sample_list(os.path.join(root, 'threads_{}.lst'.format(
            device)), [('s1', cand)])
        name = 'collapse_t{}_{}'.format(THREADS, device)
        run = _cli_run(['collapse', '-i', lst, '-r', ref, '-t',
                        str(THREADS), '--device', device],
                       os.path.join(root, name), 'smoke')
        run['identical'] = _collapse_outputs(os.path.join(root, name),
                                             'smoke') == want_collapse
        run['reads'] = n_reads
        run['cand_reads'] = sum(1 for ln in open(cand)
                                if ln.startswith('>'))
        runs[name] = run
    sw_t1 = json.loads(Path(call_t1[0], call_t1[1] + '.json').read_text())[
        'kernels']['sw_score_ends']
    for name, run in runs.items():
        run['reads_per_s'] = run['reads'] / run['wall_s']
        kernels = CALL_KERNELS if name.startswith('call') else \
            COLLAPSE_KERNELS
        run['launches'] = {k: run['launches'][k] for k in kernels}
        run['nw_host'] = run.pop('routes')['nw_host']
        if not run['identical']:
            failed.append('{} differs from -t 1 cuda'.format(name))
        if name.endswith('cuda'):
            # the card's SW runs where a stolen chunk holds a clipped read:
            # required where the -t 1 run launched it on this world
            missed = [k for k, n in run['launches'].items() if n <= 0
                      and not (k == 'sw_score_ends' and sw_t1 == 0)]
            if missed or run['nw_host']:
                failed.append('{} missed {} or aligned {} pairs on the '
                              'host'.format(name, missed, run['nw_host']))
            drained = 'scan' if name.startswith('call') else 'collapse'
            if drained not in run['stole']:
                failed.append('{}: no {} drain'.format(name, drained))
            for stage, split in run['stole'].items():
                stolen, chunks = split['logged']
                if chunks >= 2 and stolen < 1:
                    failed.append('{}: the card took no chunk of {}'.format(
                        name, stage))
        elif any(run['launches'].values()) or run['stole']:
            failed.append('{} launched a kernel or drained'.format(name))
    # how long THREADS workers take to start, each with the world's genome
    # and index (the -t 1 cuda run's caches)
    pool_start = _pool_start_s(ref, os.path.join(call_t1[0], 'tmp',
                                                 'minidx'))
    emit('threads', world=label, threads=THREADS, runs=runs,
         pool_start_s=pool_start, card=smi)
    if failed:
        raise AssertionError('-t > 1 on the {} world: {}'.format(
            label, '; '.join(failed)))
    return runs


def phase_threads(torch, smi, full_fields):
    """Phase 9: -t > 1 on both worlds, the host pool beside the card;
    {world: {run: fields}}."""
    cohort = os.path.join(WORK, 'cohort')
    reads = os.path.join(WORK, 'world', 'reads.fa')
    with open(reads) as f:
        n_call = sum(1 for ln in f if ln.startswith('>'))
    return {
        'cohort': _threads_world(
            smi, 'cohort', os.path.join(cohort, 'world', 'genome.fa'),
            os.path.join(cohort, 'world', 'reads.fa'),
            full_fields['n_reads'], (os.path.join(cohort, 'call'), 'cohort'),
            (os.path.join(cohort, 'collapse_cuda'), 'smoke'), cohort,
            'cohort', (THREADS,)),
        'call': _threads_world(
            smi, 'call', os.path.join(WORK, 'world', 'genome.fa'), reads,
            n_call, (os.path.join(WORK, 'out_cuda'), 'smoke'),
            (os.path.join(WORK, 'collapse_call_world', 'collapse_cuda'),
             'smoke'), os.path.join(WORK, 'threads_call_world'), 'smoke',
            CALL_WORLD_THREADS)}


# phase 10: the kernel functions the profiler's trace names for each kernel
# of call (a launch of the tiled SW route also runs sw_tile_merge_kernel,
# not counted); the timeout of each worker process
KERNEL_FUNCS = {'sw_score_ends': ('sw_wave_kernel', 'sw_tile_kernel'),
                'chain_dp': ('chain_dp_kernel',),
                'chain_extract': ('chain_extract_kernel',),
                'screen_keep': ('screen_keep_kernel',),
                'nw_traceback': ('nw_reg_kernel', 'nw_block_kernel',
                                 'nw_wide_kernel'),
                'tandem_counts': ('tandem_counts_kernel',),
                'lag_profile': ('lag_profile_kernel',)}
WORKER_TIMEOUT_S = 300
# call's screened reads cut into these many lag ranges
LAG_SPLITS = (1, 2, 4)


def _tandem_pairs(reads, lag_offset, max_lag, k=11):
    """The (window, lag) pairs a brute-force tandem_counts would compare for
    these reads: for each valid window i, the lags d in lag_offset + 1 ..
    lag_offset + max_lag with i + d at or below the read's last valid
    window (the lag route's work)."""
    import numpy as np
    x = np.asarray(reads) < 4
    W = x.shape[1]
    total = 0
    for row in x:
        run = np.concatenate([[0], np.cumsum(row)])
        i = np.arange(max(0, W - k + 1))
        valid = i[run[i + k] - run[i] == k]
        if len(valid):
            room = valid[-1] - valid - lag_offset
            total += int(np.clip(room, 0, max_lag).sum())
    return total


def _tandem_equal_pairs(reads, lag_offset, max_lag, k=11):
    """The work tandem_counts's function needs: the pairs of valid windows
    i < j of one read with equal k-mer ids and lag_offset < j - i <=
    lag_offset + max_lag (tandem_counts_plain's sum)."""
    return _equal_pairs(reads, lag_offset + 1, lag_offset + max_lag, k)


def _tandem_edge_reads(rng, W):
    """Rows of width W: a tandem read, an N-poisoned one, a random one, a
    read under k and an all-PAD row (PAD = 5 past each read)."""
    import numpy as np
    unit = rng.integers(0, 4, 37)
    mat = np.full((5, W), 5, np.int8)
    mat[0, :W - 3] = np.tile(unit, W // 37 + 1)[:W - 3]
    mat[1, :W // 2] = np.tile(unit, W // 37 + 1)[:W // 2]
    mat[1, 7:W // 2:41] = 4
    mat[2, :W - 9] = rng.integers(0, 4, W - 9)
    mat[3, :9] = rng.integers(0, 4, 9)
    return mat


def _lag_range_cases(rng, screened):
    """(label, reads, [(lag_offset, max_lag)], k) of phase 10's lag-range
    kernels (tandem_counts, lag_profile): the dry run's shapes (its lag
    ranges at 1 and 2 lag shards), call's screened reads (``screened``,
    phase 4's screen launch) and tools/call_x_ab.py's screen cases at
    max_lag 2 048 cut into LAG_SPLITS ranges, edge reads (all PAD, N, a
    read under k, lags past the width) at lag offsets, and
    tools/chain_cases.py's wide_cases (4 097 and 16 384 codes; 4 097
    also at k = 2 and 5, the k-run's other doubling levels),
    lag_edge_cases (csrc/lag_planes.h's word, chunk and segment edges at
    120, 4 097 and 4 127 codes), full_reads (256 x 8 192) and odd_cases
    (codes outside 0..5 at 8 and 4 097 codes: the value route, at their
    own k); k 11 but there."""
    import numpy as np
    from ciri_long_tpu_torch.ops.period import MAX_LAG
    from ciri_long_tpu_torch.tools.call_x_ab import SCREEN_CASES, screen_case
    from ciri_long_tpu_torch.tools.chain_cases import (full_reads,
                                                       lag_edge_cases,
                                                       odd_cases, wide_cases)

    dry = rng.integers(0, 4, (8, 192)).astype(np.int8)
    cases = [('dryrun 1x1', dry[:2], [(0, 32)], 11),
             ('dryrun 4x2', dry, [(0, 32), (32, 32)], 11)]
    for label, reads in ([('call screen', screened)]
                         + [('screen case ' + name, screen_case(name)[0])
                            for name in SCREEN_CASES]):
        for parts in LAG_SPLITS:
            w = MAX_LAG // parts
            cases.append(('{}, {} lag ranges'.format(label, parts), reads,
                          [(t * w, w) for t in range(parts)], 11))
    for W, ranges in ((120, [(0, 32), (32, 40), (96, 32)]),
                      (4096, [(0, 2048), (2048, 2048), (4000, 200)])):
        cases.append(('edge W={}'.format(W), _tandem_edge_reads(rng, W),
                      ranges, 11))
    for label, (reads, ranges) in (list(wide_cases(rng).items())
                                   + list(lag_edge_cases(rng).items())):
        cases.append((label, reads, ranges, 11))
        if label == 'wide W=4097':         # the k-run's other levels
            cases += [('{} k={}'.format(label, k), reads, ranges, k)
                      for k in (2, 5)]
    cases.append(('full 256x8192', full_reads(rng), [(0, 2048)], 11))
    for label, (reads, ranges, k) in odd_cases(rng).items():
        cases.append((label, reads, ranges, k))
    return dry, cases


# phase 10's timed shapes of the lag-range kernels: (label, case label of
# _lag_range_cases, max_lag)
LAG_TIMED = (('call', 'call screen, 1 lag ranges', 2048),
             ('dryrun', 'dryrun 1x1', 32),
             ('wide W=4097', 'wide W=4097', 2048),
             ('wide W=16384', 'wide W=16384', 2048),
             ('full 256x8192', 'full 256x8192', 2048))


def check_tandem_counts(torch, dev, smi, screened):
    """Phase 10's kernel: csrc/tandem_counts.cu against tandem_counts_plain
    on the card, exact, on _lag_range_cases, each launch with the reads
    that took each route (the bit planes, and the value route of reads with
    a code outside 0..5); then the kernel at LAG_TIMED's shapes, timed: a
    CUDA graph's replay of 10 launches, the plain version's wall, and the
    bound, the equal k-mer pairs in the range at csrc/op_rate.cu's
    screen-compare rate or the bytes (the reads once, the counts once) at
    3.35 TB/s.  Returns the numbers of the kernels line."""
    import numpy as np
    from ciri_long_tpu_torch.misc.kexp import (HBM_BYTES_PER_S,
                                               recurrence_rate,
                                               time_launches)
    from ciri_long_tpu_torch.ops.period import (odd_reads, tandem_counts_cuda,
                                                tandem_counts_plain)
    from ciri_long_tpu_torch.utils.dispatch import ROUTES, settle_routes

    _, cases = _lag_range_cases(np.random.default_rng(0), screened)
    err = 0
    took = {'planes': 0, 'value': 0}
    settle_routes()
    value_reads, odd_total = ROUTES['tandem_value'], 0
    for label, reads, ranges, k in cases:
        x = torch.from_numpy(np.ascontiguousarray(reads)).to(dev)
        B = int(x.shape[0])
        n_odd = int(odd_reads(x).sum())
        for offset, M in ranges:
            odd_total += n_odd
            routes = torch.zeros(B, dtype=torch.uint8, device=dev)
            got = tandem_counts_cuda(x, M, k, offset, routes=routes)
            want = tandem_counts_plain(x, M, k, offset)
            e = int((got.long() - want.long()).abs().max())
            r = routes.cpu().numpy()
            split = {name: int((r == code).sum()) for code, name in
                     enumerate(('planes', 'value'))}
            for name, n in split.items():
                took[name] += n
            emit('kernel_vs_plain', kernel='tandem_counts', case=label,
                 reads=B, width=int(x.shape[1]), lag_offset=offset,
                 max_lag=M, k=k, nonzero=int((want > 0).sum()),
                 routes=split, max_abs_err=e)
            err = max(err, e)
    settle_routes()
    value_reads = ROUTES['tandem_value'] - value_reads
    if err:
        raise AssertionError('tandem_counts disagrees with the plain version')
    if not min(took.values()) or value_reads != odd_total:
        raise AssertionError('a tandem_counts route took no read: {} (value '
                             'route reads counted {} of {})'.format(
                                 took, value_reads, odd_total))
    rate = recurrence_rate(dev, 'screen_keep')
    by_label = {c[0]: c[1] for c in cases}
    timed = {}
    for label, case, M in LAG_TIMED:
        reads = by_label[case]
        x = torch.from_numpy(np.ascontiguousarray(reads)).to(dev)
        B, W = x.shape
        equal = _tandem_equal_pairs(reads, 0, M)
        pairs = _tandem_pairs(reads, 0, M)
        bound = max((equal / rate, 'operations'),
                    ((B * W + 4 * B * M) / HBM_BYTES_PER_S, 'bytes'))
        plain_ms, _ = _wall_ms(torch, dev,
                               lambda: tandem_counts_plain(x, M, 11))
        timed[label] = dict(
            ms=time_launches(lambda: tandem_counts_cuda(x, M, 11), 10, dev,
                             graph=True),
            plain_ms=plain_ms, bound_ms=bound[0] * 1e3, bound_by=bound[1],
            window_bound_ms=pairs / rate * 1e3, reads=int(B), width=int(W),
            max_lag=M, equal_pairs=equal, pairs=pairs,
            seg=_lag_seg(torch, dev, B, W, M))
        emit('tandem_counts_time', shape=label, card=smi,
             compare_rate=rate, **timed[label])
    return dict(max_abs_err=err, routes=took, value_reads=value_reads,
                **timed)


def check_lag_profile(torch, dev, smi, screened):
    """Phase 10's lag profile: csrc/lag_profile.cu against
    lag_profile_plain on the card, bit for bit (the float32 fractions'
    bits), on _lag_range_cases but the screen cases, the value route's
    reads counted; then timed at LAG_TIMED's shapes as
    tandem_counts is, its bound the (position, lag) pairs with both codes
    valid (the plain version's den summed) at csrc/op_rate.cu's packed
    lag rate (codes as bit planes, 32 pairs a word: two popcounts), or the
    bytes (the reads once, the fractions once); beside it
    ``one_popc_bound_ms``, the same pairs at the rate of a word with one
    popcount (kind 8: den from the run's length, which a read of one valid
    run allows), and the library yardsticks (``fft_yardstick``,
    ``conv_yardstick``).  Returns the numbers of the kernels line."""
    import numpy as np
    from ciri_long_tpu_torch.misc.kexp import (HBM_BYTES_PER_S,
                                               LAG_WORD_PAIRS,
                                               recurrence_rate,
                                               time_launches)
    from ciri_long_tpu_torch.ops.period import (lag_profile_counts_plain,
                                                lag_profile_cuda,
                                                lag_profile_plain, odd_reads)

    from ciri_long_tpu_torch.utils.dispatch import ROUTES, settle_routes

    _, cases = _lag_range_cases(np.random.default_rng(0), screened)
    # the profile's only route a read's data picks is the value route (a
    # code outside 0..5): the screen cases add nothing that call's screened
    # reads do not cover
    cases = [c for c in cases if not c[0].startswith('screen case')]
    differ, err = 0, 0.0
    settle_routes()
    value_reads, odd_total = ROUTES['lag_value'], 0
    for label, reads, ranges, _ in cases:
        x = torch.from_numpy(np.ascontiguousarray(reads)).to(dev)
        n_odd = int(odd_reads(x).sum())
        for offset, M in ranges:
            odd_total += n_odd
            got = lag_profile_cuda(x, M, offset)
            want = lag_profile_plain(x, M, offset)
            e = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            abs_err = float((got - want).abs().max())
            emit('kernel_vs_plain', kernel='lag_profile', case=label,
                 reads=int(x.shape[0]), width=int(x.shape[1]),
                 lag_offset=offset, max_lag=M,
                 nonzero=int((want > 0).sum()), differ_bits=e,
                 max_abs_err=abs_err)
            differ += e
            err = max(err, abs_err)
    settle_routes()
    value_reads = ROUTES['lag_value'] - value_reads
    if differ:
        raise AssertionError('lag_profile disagrees with the plain version')
    if not odd_total or value_reads != odd_total:
        raise AssertionError('lag_profile counted {} value-route reads of {}'
                             .format(value_reads, odd_total))
    rate = recurrence_rate(dev, 'lag_profile') * LAG_WORD_PAIRS
    rate_one = recurrence_rate(dev, 'lag_matches') * LAG_WORD_PAIRS
    by_label = {c[0]: c[1] for c in cases}
    timed = {}
    for label, case, M in LAG_TIMED:
        x = torch.from_numpy(np.ascontiguousarray(by_label[case])).to(dev)
        B, W = x.shape
        num, den = lag_profile_counts_plain(x, M)
        pairs = int(den.sum())
        bound = max((pairs / rate, 'operations'),
                    ((B * W + 4 * B * M) / HBM_BYTES_PER_S, 'bytes'))
        plain_ms, _ = _wall_ms(torch, dev, lambda: lag_profile_plain(x, M))
        timed[label] = dict(
            ms=time_launches(lambda: lag_profile_cuda(x, M), 10, dev,
                             graph=True),
            plain_ms=plain_ms, bound_ms=bound[0] * 1e3, bound_by=bound[1],
            one_popc_bound_ms=max(pairs / rate_one,
                                  (B * W + 4 * B * M) / HBM_BYTES_PER_S)
            * 1e3,
            reads=int(B), width=int(W), max_lag=M, valid_pairs=pairs,
            seg=_lag_seg(torch, dev, B, W, M),
            **fft_yardstick(torch, dev, x, M, num, den),
            **conv_yardstick(torch, dev, x, M, num, den))
        emit('lag_profile_time', shape=label, card=smi, compare_rate=rate,
             one_popc_rate=rate_one, **timed[label])
    return dict(max_abs_err=err, value_reads=value_reads, **timed)


def _lag_seg(torch, dev, B, W, M):
    """The positions a block ops/period.py::lag_plan gives csrc/lag_planes.h
    for this launch on this card."""
    from ciri_long_tpu_torch.ops.period import lag_plan
    return lag_plan(int(B), int(W), M, torch.cuda.get_device_properties(
        dev).multi_processor_count)


def conv_yardstick(torch, dev, x, M, num, den):
    """The nearest library form of the lag profile's counts, a yardstick the
    port never calls: two grouped F.conv1d calls in float32 (groups = B,
    TF32 off), the one-hot planes of codes 0..3 of each read correlated
    with themselves for num and its valid plane for den, lags 1..M.  Held
    equal to the plain counts (num, den) first; ``conv1d_ms``: the two
    calls, the mean of 3 after one to warm up (CUDA events), or None and
    the error when they disagree or fail."""
    F = torch.nn.functional
    B, W = x.shape
    xi = x.long()
    planes = torch.stack([xi == c for c in range(4)] + [xi < 4],
                         1).float()                       # [B, 5, W]
    # input[i + j] = plane[i + j + 1], zero past W: out[j] = lag j + 1
    inp = torch.zeros((B, 5, W + M - 1), dtype=torch.float32, device=dev)
    inp[:, :, :W - 1] = planes[:, :, 1:]
    hot_in = inp[:, :4].reshape(1, 4 * B, -1)
    hot_w = planes[:, :4].contiguous()
    val_in = inp[:, 4:].reshape(1, B, -1)
    val_w = planes[:, 4:].contiguous()

    def convs():
        return (F.conv1d(hot_in, hot_w, groups=B)[0],
                F.conv1d(val_in, val_w, groups=B)[0])

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        c_num, c_den = convs()
        same = (torch.equal(c_num.round().int(), num)
                and torch.equal(c_den.round().int(), den))
        if not same:
            return dict(conv1d_ms=None, conv1d_error='conv1d counts differ '
                        'from the plain counts')
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            convs()
        stop.record()
        torch.cuda.synchronize(dev)
        return dict(conv1d_ms=start.elapsed_time(stop) / 3)
    except RuntimeError as e:
        return dict(conv1d_ms=None, conv1d_error=str(e)[:200])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def fft_yardstick(torch, dev, x, M, num, den):
    """The lag profile's counts as FFT autocorrelations in float32, a
    yardstick the port never calls: the one-hot planes of codes 0..3 and
    the valid plane of each read, zero-padded to N >= W + M (no wrap at lags
    up to M), rfft, |F|^2, irfft, lags 1..M; num the four code planes'
    sum.  Held equal to the plain counts (num, den) after rounding first;
    ``library_ms``: the mean of 3 after one to warm up (CUDA events), or
    None and the error when they disagree or fail."""
    B, W = x.shape
    n = 1 << (W + M - 1).bit_length()
    xi = x.long()
    planes = torch.stack([xi == c for c in range(4)] + [xi < 4],
                         1).float()                       # [B, 5, W]

    def ffts():
        f = torch.fft.rfft(planes, n=n)
        c = torch.fft.irfft(f.real ** 2 + f.imag ** 2, n=n)[..., 1:M + 1]
        return c[:, :4].sum(1), c[:, 4]

    try:
        f_num, f_den = ffts()
        if not (torch.equal(f_num.round().int(), num)
                and torch.equal(f_den.round().int(), den)):
            return dict(library_ms=None, library_error='FFT counts differ '
                        'from the plain counts')
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            ffts()
        stop.record()
        torch.cuda.synchronize(dev)
        return dict(library_ms=start.elapsed_time(stop) / 3)
    except RuntimeError as e:
        return dict(library_ms=None, library_error=str(e)[:200])


def public_ops(torch, dev):
    """The JAX package's public device ops of the port, each through its
    numpy entry point on the card as a caller would, the launch counts set
    to 0 just before and read just after: ops.lag_profile and
    ops.period.tandem_counts at the dry run's reads and past 4 096 codes,
    ops.chain_scores_batch on rows with holes in their valid masks,
    ops.edit.edit_distance_batch_padded; each held to its CPU route.
    Returns the run's launches."""
    import numpy as np
    from ciri_long_tpu_torch import ops
    from ciri_long_tpu_torch.ops import edit, period
    from ciri_long_tpu_torch.tools.chain_cases import wide_cases
    from ciri_long_tpu_torch.utils.dispatch import (LAUNCHES,
                                                    reset_launches)

    rng = np.random.default_rng(3)
    dry = rng.integers(0, 4, (2, 192)).astype(np.int8)
    wide, _ = wide_cases(rng, (6000,))['wide W=6000']
    B, A = 4, 500
    q = np.sort(rng.integers(0, 5000, (B, A)), axis=1)
    r = q + rng.integers(0, 3, (B, A)) + 2000
    ctg = np.zeros((B, A), np.int32)
    valid = rng.random((B, A)) < 0.9
    a = rng.integers(0, 4, (64, 80)).astype(np.int8)
    b = rng.integers(0, 4, (64, 90)).astype(np.int8)
    alen = rng.integers(0, 81, 64)
    blen = rng.integers(0, 91, 64)
    calls = {
        'lag_profile dryrun': lambda d: ops.lag_profile(dry, 32, device=d),
        'lag_profile wide': lambda d: ops.lag_profile(wide, 512, 100,
                                                      device=d),
        'tandem_counts wide': lambda d: period.tandem_counts(
            wide, 512, 11, 100, device=d),
        'chain_scores_batch': lambda d: ops.chain_scores_batch(
            r, q, ctg, valid, 15, device=d),
        'edit_distance_batch_padded': lambda d: edit.
        edit_distance_batch_padded(a, b, alen, blen, device=d)}
    want = {name: fn('cpu') for name, fn in calls.items()}
    reset_launches()
    got = {name: fn('cuda') for name, fn in calls.items()}
    launches = dict(LAUNCHES)
    same = {}
    for name in calls:
        g, w = got[name], want[name]
        if name == 'chain_scores_batch':
            # the card's libm log2 table; the CPU's is libm too once the
            # native chain core is built (phase 1)
            same[name] = bool(np.array_equal(g[1], w[1])
                              and np.array_equal(g[0], w[0]))
        else:
            same[name] = bool(np.array_equal(np.asarray(g), np.asarray(w)))
    return dict(identical=same,
                launches={k: launches[k] for k in (
                    'lag_profile', 'tandem_counts', 'chain_dp',
                    'edit_distance')})


def _worker_runs(torch, n, out_dir):
    """n ranks of parallel/multihost_worker.py on cuda:0 over gloo, each a
    process with its own timeout; [{fields of its lines, wall_s}]."""
    import socket
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'ciri_long_tpu_torch.parallel.multihost_worker',
         '--coordinator', '127.0.0.1:{}'.format(port), '--num-processes',
         str(n), '--process-id', str(i), '--device', 'cuda:0', '--scan-out',
         os.path.join(out_dir, 'rank_{}.fa'.format(i))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(n)]
    runs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            run = {'wall_s': time.perf_counter() - t0, 'rc': p.returncode}
            for ln in out.splitlines():
                if ln.startswith('MULTIHOST_'):
                    head, *kv = ln.split()
                    run[head] = dict(x.split('=', 1) for x in kv)
            if p.returncode != 0:
                raise AssertionError('worker {} of {} failed:\n{}'.format(
                    len(runs), n, out[-4000:]))
            runs.append(run)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return runs


def _trace_kernels(path):
    """{kernel function of KERNEL_FUNCS, or 'other': events} of the CUDA
    kernel events in a Chrome trace written by torch.profiler (an event's
    name is the demangled signature)."""
    import re
    from collections import Counter
    funcs = [f for fs in KERNEL_FUNCS.values() for f in fs]
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return Counter(next((f for f in funcs
                         if re.search(r'\b{}\b'.format(f), e['name'])),
                        'other')
                   for e in events if e.get('cat') == 'kernel')


def phase_dist(torch, dev, smi, screened):
    """Phase 10: the multi-device scan and the last entry points on the
    card (see the module's docstring).  Returns the tandem_counts entry's
    numbers and its launches in the dry run."""
    import hashlib
    import io
    from contextlib import redirect_stdout
    from ciri_long_tpu_torch.cli import main as cli_main_mod
    from ciri_long_tpu_torch.parallel.dryrun import dryrun_multichip
    from ciri_long_tpu_torch.parallel.multihost_worker import \
        build_demo_world
    from ciri_long_tpu_torch.pipeline.find_bsj import scan_ccs_reads
    from ciri_long_tpu_torch.tools import ssw_cli
    from ciri_long_tpu_torch.utils.dispatch import (CALL_KERNELS, LAUNCHES,
                                                    reset_launches)

    failed = []
    root = os.path.join(WORK, 'dist')
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    tandem = check_tandem_counts(torch, dev, smi, screened)
    profile_numbers = check_lag_profile(torch, dev, smi, screened)
    public = public_ops(torch, dev)
    if not all(public['identical'].values()):
        failed.append('a public op differs from its CPU route: {}'.format(
            public))
    if min(public['launches'].values()) <= 0:
        failed.append('a public op missed its kernel: {}'.format(public))

    # the dry run at every visible card: the pipeline step (tandem_counts
    # over lag ranges, the SW) and the sharded scan against one shard
    n_cards = torch.cuda.device_count()
    reset_launches()
    t0 = time.perf_counter()
    dryrun_multichip(n_cards, device='cuda')
    dry = dict(cards=n_cards, wall_s=time.perf_counter() - t0,
               launches={k: LAUNCHES[k] for k in ('tandem_counts',
                                                  'sw_score_ends')})
    if min(dry['launches'].values()) <= 0:
        failed.append('the dry run missed a kernel: {}'.format(
            dry['launches']))

    # call --dist mesh on the call world, against phase 4's -t 1 cuda run
    ref = os.path.join(WORK, 'world', 'genome.fa')
    reads = os.path.join(WORK, 'world', 'reads.fa')
    want = _call_outputs(os.path.join(WORK, 'out_cuda'), 'smoke')
    t1 = json.loads(Path(WORK, 'out_cuda', 'smoke.json').read_text())
    mesh = _cli_run(['call', '-i', reads, '-r', ref, '-t', '1', '--device',
                     'cuda', '--dist', 'mesh'], os.path.join(root, 'mesh'),
                    'smoke')
    mesh_out = _call_outputs(os.path.join(root, 'mesh'), 'smoke')
    mesh_fields = dict(
        wall_s=mesh['wall_s'], identical=mesh_out == want,
        launches={k: mesh['launches'][k] for k in CALL_KERNELS},
        timing=json.loads(Path(root, 'mesh', 'smoke.json').read_text())[
            'timing'], t1_timing=t1['timing'])
    if not mesh_fields['identical']:
        failed.append('call --dist mesh differs from -t 1 cuda')
    if min(mesh_fields['launches'].values()) <= 0:
        failed.append('call --dist mesh missed a kernel: {}'.format(
            mesh_fields['launches']))

    # the worker at one rank and at two ranks sharing the card, against a
    # serial scan of the same demo world on the card
    ctx, ccs_seq = build_demo_world()
    os.makedirs(os.path.join(root, 'serial', 'tmp'))
    scan_ccs_reads(ctx, ccs_seq, True, os.path.join(root, 'serial'), 'p',
                   device=dev)
    serial_md5 = hashlib.md5(Path(root, 'serial', 'p.cand_circ.fa')
                             .read_bytes()).hexdigest()
    workers = {}
    for n in (1, 2):
        runs = _worker_runs(torch, n, os.path.join(root, 'ranks{}'.format(n)))
        workers[n] = runs
        for t, run in enumerate(runs):
            res, gat = run['MULTIHOST_RESULT'], run['MULTIHOST_GATHER']
            scan = run['MULTIHOST_SCAN']
            sw = int(run['MULTIHOST_LAUNCHES']['sw_score_ends'])
            if (res['got'] != res['expected'] or gat['ids_ok'] != 'True'
                    or scan['md5'] != serial_md5 or sw <= 0):
                failed.append('worker {} of {}: {}'.format(t, n, run))

    # ssw_cli on the card and on the host
    rng = __import__('numpy').random.default_rng(1)
    base = ''.join(rng.choice(list('ACGT'), size=400))
    Path(root, 't.fa').write_text('>t1\n{}\n>t2\nACGTACGTTGCA\n'.format(base))
    Path(root, 'q.fa').write_text('>q1\n{}\n>q2\n{}\n'.format(
        base[50:120] + base[130:200], base[300:380].replace('G', 'N')))
    printed = {}
    reset_launches()
    for device in ('cuda', 'cpu'):
        buf = io.StringIO()
        with redirect_stdout(buf):
            ssw_cli.main([os.path.join(root, 't.fa'),
                          os.path.join(root, 'q.fa'), '--cigar', '--device',
                          device])
        printed[device] = buf.getvalue()
    ssw = dict(identical=printed['cuda'] == printed['cpu'],
               lines=len(printed['cuda'].splitlines()),
               launches=LAUNCHES['sw_score_ends'])
    if not ssw['identical'] or ssw['launches'] <= 0:
        failed.append('ssw_cli: {}'.format(ssw))

    # call --profile on the call world: the trace's kernel events by name
    # beside the launches made inside the traced stages ([2/4]..[4/4]: the
    # CCS stage's screen_keep and nw_traceback launches come before it)
    prof_dir = os.path.join(root, 'profile')
    window = []
    inner = cli_main_mod._scan_stages

    def traced_stages(*args, **kw):
        window.append(dict(LAUNCHES))
        inner(*args, **kw)
        window.append(dict(LAUNCHES))

    cli_main_mod._scan_stages = traced_stages
    try:
        prof = _cli_run(['call', '-i', reads, '-r', ref, '-t', '1',
                         '--device', 'cuda', '--profile', prof_dir],
                        os.path.join(root, 'prof_out'), 'smoke')
    finally:
        cli_main_mod._scan_stages = inner
    trace = os.path.join(prof_dir, 'smoke.trace.json')
    by_name = _trace_kernels(trace)
    profile = dict(
        trace_mb=os.path.getsize(trace) / 2 ** 20, wall_s=prof['wall_s'],
        kernel_events=sum(by_name.values()), by_function=dict(by_name),
        traced={k: sum(by_name.get(f, 0) for f in KERNEL_FUNCS[k])
                for k in CALL_KERNELS},
        window_launches={k: window[1][k] - window[0][k]
                         for k in CALL_KERNELS},
        launches={k: prof['launches'][k] for k in CALL_KERNELS},
        identical=_call_outputs(os.path.join(root, 'prof_out'), 'smoke')
        == want)
    profile['counts_equal'] = profile['traced'] == profile['window_launches']
    if not profile['kernel_events']:
        failed.append('the profiler trace holds no CUDA kernel event')
    if not profile['identical']:
        failed.append('call --profile differs from -t 1 cuda')

    emit('dist', card=smi, dryrun=dry, call_mesh=mesh_fields,
         workers={n: [{k: v for k, v in run.items()} for run in runs]
                  for n, runs in workers.items()},
         serial_md5=serial_md5, ssw_cli=ssw, profile=profile,
         public_ops=public)
    if failed:
        raise AssertionError('phase 10: ' + '; '.join(failed))
    profile_numbers['launches'] = public['launches']['lag_profile']
    return tandem, dry['launches']['tandem_counts'], profile_numbers


def _recording_recovery(stages):
    """Record each call of find_bsj.recover_ccs_reads (``call``'s [3/4]):
    its items, seconds, and the launches and SW routes made inside it (on
    the card from the stealer thread too: the call returns once its chunks
    have drained).  Returns the undo."""
    from ciri_long_tpu_torch.pipeline import find_bsj
    from ciri_long_tpu_torch.utils.dispatch import LAUNCHES, ROUTES

    inner = find_bsj.recover_ccs_reads

    def recorded(ctx, short_reads, *args, **kw):
        launches, routes = dict(LAUNCHES), dict(ROUTES)
        t0 = time.perf_counter()
        out = inner(ctx, short_reads, *args, **kw)
        stages.append(dict(
            items=len(short_reads), seconds=time.perf_counter() - t0,
            launches={k: LAUNCHES[k] - launches[k] for k in (
                'sw_score_ends', 'chain_dp', 'chain_extract')},
            routes={k: ROUTES[k] - routes[k] for k in ('wave', 'tiled')}))
        return out

    find_bsj.recover_ccs_reads = recorded

    def undo():
        find_bsj.recover_ccs_reads = inner
    return undo


def _accuracy_split(cand_circ, truth, n_regular, tol=5):
    """BSJ recall and precision (tools/world.py::bsj_accuracy's rule: both
    ends within ``tol``) on the short loci (truth[n_regular:]) and on the
    rest, each called locus counted with the group of its nearest true
    locus."""
    from ciri_long_tpu_torch.tools.world import called_bsjs
    called = called_bsjs(cand_circ)

    def match(c, t):
        return (c[0] == t[0] and abs(c[1] - t[1]) <= tol
                and abs(c[2] - t[2]) <= tol)

    def nearest(c):
        return min(range(len(truth)), key=lambda i: (
            c[0] != truth[i][0], abs(c[1] - truth[i][1])
            + abs(c[2] - truth[i][2])))

    out = {}
    for name, lo, hi in (('regular', 0, n_regular),
                         ('short', n_regular, len(truth))):
        group = [c for c in called if lo <= nearest(c) < hi]
        out[name] = dict(
            recall=sum(any(match(c, t) for c in called)
                       for t in truth[lo:hi]) / max(1, hi - lo),
            precision=sum(any(match(c, t) for t in truth[lo:hi])
                          for c in group) / max(1, len(group)),
            loci=hi - lo, called=len(group))
    return out


def phase_recover(torch, smi):
    """Phase 11: ``call``'s short-consensus recovery ([3/4]) on the card.
    tools/world.py::short_world (the ``call`` world and 16 one-exon loci
    of 30-59 bp) through the CLI at -t 1 on cuda and cpu, then at -t
    THREADS on both; fails unless every run writes the -t 1 cuda run's
    tmp/*.ccs.fa, tmp/*.raw.fa and cand_circ.fa and its counters, every
    run's recover_ccs items are > 0, the stage's own launches of chain_dp
    and chain_extract are > 0 on cuda and every launch 0 on cpu, and at -t
    THREADS on cuda the card took a chunk of the recovery's drain.  One
    ``recover`` line: each run's wall, the stage's items, seconds,
    launches and SW routes, the drains' splits, and the BSJ recall and
    precision on the short loci and on the rest."""
    from ciri_long_tpu_torch.tools.world import SHORT_LEN, short_world

    root = os.path.join(WORK, 'short')
    shutil.rmtree(root, ignore_errors=True)
    ref, reads, truth = short_world(os.path.join(root, 'world'))
    n_regular = 16
    with open(reads) as f:
        n_reads = sum(1 for ln in f if ln.startswith('>'))
    stages, runs, failed = [], {}, []
    undo = _recording_recovery(stages)
    try:
        for t, device in ((1, 'cuda'), (1, 'cpu'), (THREADS, 'cuda'),
                          (THREADS, 'cpu')):
            name = 'call_t{}_{}'.format(t, device)
            out = os.path.join(root, name)
            n_stages = len(stages)
            run = _cli_run(['call', '-i', reads, '-r', ref, '-t', str(t),
                            '--device', device], out, 'short')
            run['stage'] = (stages[n_stages] if len(stages) > n_stages
                            else None)
            run['timing'] = json.loads(Path(out, 'short.json')
                                       .read_text())['timing']
            run['outputs'] = _call_outputs(out, 'short')
            runs[name] = run
    finally:
        undo()
    want = runs['call_t1_cuda']['outputs']
    for name, run in runs.items():
        run['identical'] = run.pop('outputs') == want
        stage = run['stage']
        if not run['identical']:
            failed.append('{} differs from -t 1 cuda'.format(name))
        if stage is None or run['timing']['recover_ccs']['items'] <= 0:
            failed.append('{}: no read reached the recovery'.format(name))
            continue
        if name.endswith('cuda'):
            if min(stage['launches']['chain_dp'],
                   stage['launches']['chain_extract']) <= 0:
                failed.append('{}: the recovery chained on the host: {}'
                              .format(name, stage))
        elif any(stage['launches'].values()) or any(
                run['launches'].values()):
            failed.append('{} launched a kernel'.format(name))
    split = runs['call_t{}_cuda'.format(THREADS)]['stole'].get('recovery')
    if split is None or split['logged'][0] < 1:
        failed.append('-t {} cuda: the card took no recovery chunk: {}'
                      .format(THREADS, split))
    accuracy = _accuracy_split(
        os.path.join(root, 'call_t1_cuda', 'short.cand_circ.fa'), truth,
        n_regular)
    emit('recover', card=smi, reads=n_reads, loci=n_regular,
         short_loci=len(truth) - n_regular, short_len=list(SHORT_LEN),
         accuracy=accuracy,
         runs={name: {k: run[k] for k in (
             'wall_s', 'identical', 'stage', 'stole', 'launches', 'timing')}
               for name, run in runs.items()})
    if failed:
        raise AssertionError('phase 11: ' + '; '.join(failed))
    return runs


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch {}, CUDA build {})'.format(
            torch.__version__, torch.version.cuda), file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    dev, smi = phase_build(torch)
    errs = phase_kernel(torch, dev)
    phase_time(torch, dev, smi)
    (call_launches, call_err, seen, x_seen, x_ms, nw_batches, nw_votes,
     nw_routes) = phase_call(torch, dev, smi)
    launches = call_launches['sw_score_ends']
    _, call_routes = phase_call_time(torch, dev, smi, seen)
    x_numbers = phase_call_kernels(torch, dev, smi, x_seen, x_ms)
    x_numbers['nw_traceback'] = phase_call_nw(torch, dev, smi, x_seen, x_ms,
                                              nw_batches, nw_votes, nw_routes)
    probe_launches = phase_probe_path()
    probe_err = phase_probe_exact(torch, dev)
    sw, probes = phase_probe_time(torch, dev, smi)
    collapse_errs = phase_collapse_kernels(torch, dev)
    call_errs, call_poa, call_world_routes = phase_collapse(
        torch, dev, smi, os.path.join(WORK, 'world', 'genome.fa'))
    for name, err in call_errs.items():
        collapse_errs[name] = max(collapse_errs.get(name, 0), err)
    full_errs, full, full_fields = phase_collapse_full(torch, dev, smi)
    for name, err in full_errs.items():
        collapse_errs[name] = max(collapse_errs.get(name, 0), err)
    threads = phase_threads(torch, smi, full_fields)
    tandem, tandem_launches, profile = phase_dist(
        torch, dev, smi, x_seen['screen_keep'][0][0][0].numpy())
    phase_recover(torch, smi)

    bench = sw['bench']
    main = sw['main128']

    def entry(name, n, max_err, ms, plain_ms=bench['plain_ms'],
              bound=bench['bound_ms'], by=bench['bound_by'],
              library_ms=None):
        return {'name': name, 'route': 'cuda', 'source': CSRC + name + '.cu',
                'replaces': REPLACES[name], 'launches': n,
                'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
                'bound_ms': bound, 'bound_by': by, 'library_ms': library_ms}

    # SW kernels at the bench shape (phase 5 has every shape); no PyTorch
    # call computes SW, so no library time.  sw_score_ends is launched by
    # call (phase 4), the others by the probe path (phase 5).
    # sw_score_ends also at the main path's 128x54x16384 (its tiled route)
    # collapse's kernels at their largest launch of the full-size collapse
    # (phase 8), launched by it; sw_score_ends's collapse launches and
    # device time beside its call numbers
    def collapse_entry(name):
        big = full[name]
        prefix = 'edit_' if name == 'edit_distance' else 'tb_'
        extra = {k: big[k] for k in ('cell_bound_ms',) if k in big}
        return dict(entry(name, full_fields['launches'][name],
                          collapse_errs[name], big['ms'], big['plain_ms'],
                          big['bound_ms'], big['bound_by']),
                    shape=big['shape'], collapse_device_ms=big['device_ms'],
                    collapse_routes={k: v for k, v in
                                     full_fields['routes'].items()
                                     if k.startswith(prefix)}, **extra)

    def wave_fields(wave):
        """The cohort's wavefront launches: the largest one's time, bound
        and plan, and the summed device time of all of them; the plan and
        R times at the bench shape."""
        from ciri_long_tpu_torch.ops.sw import _wave_plan
        big = wave.get('shape')
        return dict(wave_launches=wave['launches'],
                    wave_device_ms=wave['device_ms'], wave_shape=big,
                    wave_ms=wave.get('ms'),
                    wave_plain_ms=wave.get('plain_ms'),
                    wave_bound_ms=wave.get('bound_ms'),
                    wave_plan=big and list(_wave_plan(big[0][0], big[0][1],
                                                      big[1][1])),
                    wave_rows_ms=wave.get('wave_rows'),
                    bench_plan=list(_wave_plan(*BENCH)),
                    bench_rows_ms=bench['wave_rows'])

    def tiled_fields(tiled):
        """The tiled route on one world: its launches, their summed device
        time and, at the largest, its shapes, ms, plain ms and bound."""
        return {k: tiled.get(k) for k in ('launches', 'device_ms', 'shape',
                                          'params', 'ms', 'plain_ms',
                                          'bound_ms', 'bound_by')}

    def family_err(prefix):
        return max(err for name, err in errs.items()
                   if name.startswith(prefix))

    def shapes_ms(name):
        return {shape: sw[shape][name] for shape in sw}

    kernels = [
        dict(entry('sw_score_ends', launches,
                   max([call_err, collapse_errs['sw_score_ends']]
                       + [err for name, err in errs.items()
                          if name.startswith('sw_score_ends')]),
                   bench['sw_score_ends']),
             main_ms=main['sw_score_ends'], main_bound_ms=main['bound_ms'],
             collapse_launches=full_fields['launches']['sw_score_ends'],
             collapse_routes={k: full_fields['routes'][k]
                              for k in ('wave', 'tiled')},
             collapse_device_ms=full['sw_score_ends']['device_ms'],
             tiled={'call': tiled_fields(call_routes['tiled']),
                    'call_world_collapse': tiled_fields(
                        call_world_routes['tiled']),
                    'cohort_collapse': tiled_fields(
                        full['sw_score_ends']['routes']['tiled'])},
             **wave_fields(full['sw_score_ends']['routes']['wave'])),
        dict(entry('sw_rowscan', probe_launches['sw_rowscan'],
                   family_err('sw_rowscan'), bench['sw_rowscan']),
             shapes_ms=shapes_ms('sw_rowscan'),
             plans_ms={shape: sw[shape]['rowscan_widths'] for shape in sw}),
        dict(entry('sw_chain', probe_launches['sw_chain'],
                   family_err('sw_chain'), bench['sw_chain C=4']),
             c2_ms=bench['sw_chain C=2'],
             shapes_ms={C: shapes_ms('sw_chain C={}'.format(C))
                        for C in CHAIN_C_TIMED},
             plans_ms={shape: sw[shape]['chain_rows'] for shape in sw}),
        # the six probes summed; the library time is the card's own time of
        # the plain versions, each one PyTorch call
        entry('int16_probe', probe_launches['int16_probe'],
              probe_err['int16_probe'], probes['ms'], probes['plain_ms'],
              probes['bound_ms'], 'bytes', probes['library_ms']),
        # the six in one launch, beside the six launches' graph
        dict(entry('int16_probe_all', probe_launches['int16_probe_all'],
                   probe_err['int16_probe_all'], probes['all_ms'],
                   probes['plain_ms'], probes['bound_ms'], 'bytes',
                   probes['six_plain_graph_ms']),
             source=CSRC + 'int16_probe.cu',
             six_launches_ms=probes['six_launches_ms']),
        collapse_entry('edit_distance'),
        collapse_entry('sw_traceback'),
        # the largest launch of the cohort's sub-cluster POA, its launches
        # and their summed device time (CUDA events in the run); phase 7's
        # numbers beside them
        dict(entry('poa_align', full_fields['launches']['poa_align'],
                   collapse_errs['poa_align'], full['poa_align']['ms'],
                   full['poa_align']['plain_ms'],
                   full['poa_align']['bound_ms'],
                   full['poa_align']['bound_by']),
             shape=full['poa_align']['shape'],
             rows_ms=full['poa_align']['rows_ms'],
             walk_ms=full['poa_align']['walk_ms'],
             depth=full['poa_align']['depth'],
             collapse_device_ms=full['poa_align']['device_ms'],
             largest=full['poa_align']['largest'],
             call_world={k: call_poa[k] for k in (
                 'launches', 'device_ms', 'ms', 'rows_ms', 'walk_ms',
                 'depth', 'plain_ms', 'bound_ms', 'bound_by', 'largest')}),
    ]
    # call's X2, X3 and X4 at their largest launch of phase 4, launched by
    # it; X4's launches on the cohort's call beside them
    x_numbers['nw_traceback']['cohort_call'] = full_fields['cohort_nw']
    for name, source in (('chain_dp', 'chain_dp.cu'),
                         ('chain_extract', 'chain_dp.cu'),
                         ('screen_keep', 'screen_keep.cu'),
                         ('nw_traceback', 'nw_traceback.cu')):
        n = dict(x_numbers[name])
        kernels.append(dict(
            entry(name, call_launches[name], n.pop('max_abs_err'),
                  n.pop('ms'), n.pop('plain_ms'), n.pop('bound_ms'),
                  n.pop('bound_by')), source=CSRC + source, **n))
    # the lag-range tandem counts at call's screened reads (2 048 lags)
    # and at the dry run's shape, launched by the dry run (phase 10)
    call_tc, dry_tc = tandem['call'], tandem['dryrun']
    kernels.append(dict(
        entry('tandem_counts', tandem_launches, tandem['max_abs_err'],
              call_tc['ms'], call_tc['plain_ms'], call_tc['bound_ms'],
              call_tc['bound_by']),
        shape=[call_tc['reads'], call_tc['width'], call_tc['max_lag']],
        pairs=call_tc['pairs'], equal_pairs=call_tc['equal_pairs'],
        window_bound_ms=call_tc['window_bound_ms'],
        seg=call_tc['seg'], dryrun=dry_tc,
        routes=tandem['routes'], value_reads=tandem['value_reads'],
        wide={label: tandem[label] for label in ('wide W=4097',
                                                 'wide W=16384',
                                                 'full 256x8192')}))
    # the lag profile at call's screened reads (2 048 lags), launched by
    # the public ops' run (phase 10), its other timed shapes beside
    call_lp = profile['call']
    kernels.append(dict(
        entry('lag_profile', profile['launches'], profile['max_abs_err'],
              call_lp['ms'], call_lp['plain_ms'], call_lp['bound_ms'],
              call_lp['bound_by'],
              call_lp['library_ms'] if call_lp['library_ms'] is not None
              else call_lp['conv1d_ms']),
        shape=[call_lp['reads'], call_lp['width'], call_lp['max_lag']],
        valid_pairs=call_lp['valid_pairs'],
        one_popc_bound_ms=call_lp['one_popc_bound_ms'],
        conv1d_ms=call_lp['conv1d_ms'],
        value_reads=profile['value_reads'],
        shapes={label: profile[label] for label in (
            'dryrun', 'wide W=4097', 'wide W=16384', 'full 256x8192')}))
    # each kernel of call and collapse: its launches in phase 9's -t 4
    # cuda runs, on each world
    for k in kernels:
        k['threads_launches'] = {
            '{} {}'.format(world, run): runs[run]['launches'][k['name']]
            for world, runs in threads.items() for run in (
                'call_t{}_cuda'.format(THREADS),
                'collapse_t{}_cuda'.format(THREADS))
            if k['name'] in runs[run]['launches']} or None
    print(smi)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
