"""Device mesh and sharded batch runners.

Port of ciri_long_tpu/parallel/mesh.py.  The JAX package lays its devices
on a 2-D (reads, lag) ``jax.sharding.Mesh`` and runs ``shard_map`` steps
over it: 'reads' shards the batch (data parallelism, the analog of the
reference's chunked pools), 'lag' shards the tandem counts' lag axis
(ops/period.py), counters reduce with ``psum`` and candidate records merge
with one tiled ``all_gather``.  Here a ``Mesh`` names one explicit
``torch.device`` per shard:

* one process (``call --dist mesh``, ``scan_ccs_sharded``, the dry run):
  on cuda a shard a visible card (cuda:0 .. n-1; more shards than cards
  raises), on cpu n shards that all sit on the CPU, as the JAX tests' 8
  virtual CPU devices.  Shards run in turn; a tiled all_gather over them
  is their blocks in shard order and a psum their sum, both taken on the
  host.
* several processes (``init_distributed``, the worker, the cohort step):
  a shard a rank, each on the rank's own device.  Records, valid masks and
  counters are host data in both packages, so they meet as CPU tensors
  over a gloo process group (``dist.all_gather`` into a list and
  ``dist.all_reduce``).  Gloo, not NCCL: it takes two ranks that share a
  card as well as a card a rank, and it carries only those host rows;
  every kernel still runs on the rank's own card.
"""

import datetime
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ciri_long_tpu_torch.ops.period import tandem_counts
from ciri_long_tpu_torch.ops.sw import SWParams, sw_score_ends_auto
from ciri_long_tpu_torch.utils.dispatch import resolve_device

READS_AXIS = 'reads'
LAG_AXIS = 'lag'
# seconds a rank waits in a collective before it fails (a peer that died)
TIMEOUT_S = 300


class Mesh(NamedTuple):
    """``shape`` {'reads': dp, 'lag': lp}; ``devices`` the devices this
    process drives, row-major over (reads, lag) in one process (dp * lp of
    them), the rank's own one in a process group (``group`` not None, a
    shard a rank, lp 1)."""
    shape: dict
    devices: List[torch.device]
    group: Optional[object] = None

    def shard_device(self, s, lag=0):
        """The device of shard (s, lag) in one process."""
        return self.devices[s * self.shape[LAG_AXIS] + lag]


def make_mesh(n_devices=None, lag_parallel=None, device='cuda'):
    """Build a (reads, lag) mesh.  In one process: over ``n_devices``
    shards (default every visible card on cuda, 1 on cpu), ``lag_parallel``
    by default 2 when n is even and >= 4, as JAX's.  Under an initialised
    process group: a shard a rank on this rank's ``device`` (lag_parallel
    1).  Raises for cuda without a card, or more shards than cards."""
    dev = resolve_device(device)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        n = torch.distributed.get_world_size()
        if n_devices not in (None, n) or lag_parallel not in (None, 1):
            raise ValueError('a process-group mesh has a shard a rank ({}) '
                             'and no lag axis'.format(n))
        return Mesh({READS_AXIS: n, LAG_AXIS: 1}, [dev],
                    torch.distributed.group.WORLD)
    if dev.type == 'cuda':
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if n > have:
            raise ValueError('{} shards asked for, {} cards visible'.format(
                n, have))
        devs = [torch.device('cuda', i) for i in range(n)]
    else:
        n = 1 if n_devices is None else n_devices
        devs = [dev] * n
    if n < 1:
        raise ValueError('a mesh needs a shard')
    if lag_parallel is None:
        lag_parallel = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // lag_parallel
    return Mesh({READS_AXIS: dp, LAG_AXIS: lag_parallel},
                devs[:dp * lag_parallel])


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Multi-process bring-up over gloo (no-op when single-process):
    ``coordinator`` is host:port of rank 0; every collective fails after
    TIMEOUT_S instead of waiting for a rank that died."""
    if num_processes is None or num_processes <= 1:
        return
    torch.distributed.init_process_group(
        'gloo', init_method='tcp://' + coordinator, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def pad_to_multiple(x, m, axis=0, fill=5):
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill)


def _all_sum(mesh, value):
    """psum of a host integer over the process group (itself in one
    process)."""
    if mesh.group is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    torch.distributed.all_reduce(t, group=mesh.group)
    return int(t[0])


def _sw_shard(device, q, r, params):
    score, q_end, r_end = sw_score_ends_auto(
        torch.from_numpy(np.ascontiguousarray(q, np.int8)).to(device),
        torch.from_numpy(np.ascontiguousarray(r, np.int8)).to(device), params)
    return score.cpu().numpy(), q_end.cpu().numpy(), r_end.cpu().numpy()


def sharded_sw(mesh, query, ref, params: SWParams):
    """Batched SW sharded over the 'reads' axis; n_positive psum-reduced.

    Returns (score, q_end, r_end, n_positive), n_positive the global count
    of positive-scoring pairs (the reference accumulates such counters
    in its main process, main.py:81-94).  In one process the batch is padded to the
    reads axis (fill 5, which scores 0) and shard s runs on its device; in
    a process group ``query`` and ``ref`` are this rank's rows (JAX's
    process-local data), the outputs this rank's and n_positive the
    group's."""
    if mesh.group is not None:
        score, q_end, r_end = _sw_shard(mesh.devices[0], query, ref, params)
        return score, q_end, r_end, _all_sum(mesh, (score > 0).sum())
    n_dp = mesh.shape[READS_AXIS]
    q = pad_to_multiple(np.asarray(query), n_dp)
    r = pad_to_multiple(np.asarray(ref), n_dp)
    outs = [_sw_shard(mesh.shard_device(s), qs, rs, params)
            for s, (qs, rs) in enumerate(zip(np.split(q, n_dp),
                                             np.split(r, n_dp)))]
    score, q_end, r_end = (np.concatenate(x) for x in zip(*outs))
    B = np.asarray(query).shape[0]
    return (score[:B], q_end[:B], r_end[:B], int((score > 0).sum()))


def make_pipeline_step(mesh, params: SWParams, max_lag: int):
    """The multi-device step of the dry run: reads sharded over 'reads',
    the tandem counts' lags over 'lag', the positive SW count psum-reduced
    over the whole mesh.

    Returns a function (reads [B, L], query [B, Lq], ref [B, Lr], numpy) ->
    (tandem counts [B, max_lag], sw scores [B], n_pos), B a multiple of the
    reads axis.  Lag shard l of reads shard s counts lags l * max_lag / lp
    + 1 .. (l + 1) * max_lag / lp on its device (ops/period.py::
    tandem_counts with a lag offset, csrc/tandem_counts.cu on the card).
    The SW of a reads shard runs once, on its lag-0 device: JAX runs it on
    every lag shard, each with the same count, and its psum over both axes
    is lp times the reads' count, which n_pos keeps."""
    if mesh.group is not None:
        raise ValueError('make_pipeline_step runs in one process')
    dp, lp = mesh.shape[READS_AXIS], mesh.shape[LAG_AXIS]
    if max_lag % lp:
        raise ValueError('max_lag {} does not divide over {} lag shards'
                         .format(max_lag, lp))
    width = max_lag // lp

    def step(reads, query, ref):
        reads, query, ref = (np.asarray(x) for x in (reads, query, ref))
        if reads.shape[0] % dp:
            raise ValueError('a batch of {} does not divide over {} reads '
                             'shards'.format(reads.shape[0], dp))
        prof, scores = [], []
        for s, (rd, qs, rs) in enumerate(zip(np.split(reads, dp),
                                             np.split(query, dp),
                                             np.split(ref, dp))):
            prof.append(np.concatenate(
                [tandem_counts(rd, width, lag_offset=lag * width,
                               pad_lags=max_lag,
                               device=mesh.shard_device(s, lag))
                 for lag in range(lp)], axis=1))
            scores.append(_sw_shard(mesh.shard_device(s), qs, rs, params)[0])
        score = np.concatenate(scores)
        return (np.concatenate(prof), score, lp * int((score > 0).sum()))

    return step


def sharded_pipeline_step(mesh, reads, query, ref, params=SWParams(),
                          max_lag=128):
    step = make_pipeline_step(mesh, params, max_lag)
    return step(reads, query, ref)


# ----------------------------------------------------------------------
# Candidate-record merge.  The reference appends per-chunk candidate
# circRNAs to a shared file from pool workers (find_bsj.py:473) and its
# main process accumulates counters (main.py:81-94); the JAX package keeps
# fixed-shape candidate records and merges them with one all_gather over
# the reads axis, after which every host holds the whole table.

CAND_FIELDS = 6  # read_id, ctg_id, start, end, strand, score


def _gather_blocks(mesh, block):
    """Every rank's ``block`` (numpy, rows of one width and dtype, any
    count) in rank order: dist.all_gather of the row counts, then of the
    blocks padded to the longest."""
    rows = torch.tensor([len(block)], dtype=torch.int64)
    counts = [torch.zeros_like(rows) for _ in range(mesh.shape[READS_AXIS])]
    torch.distributed.all_gather(counts, rows, group=mesh.group)
    counts = [int(c[0]) for c in counts]
    top = max(1, max(counts))
    mine = torch.zeros((top,) + block.shape[1:],
                       dtype=torch.from_numpy(block[:0]).dtype)
    mine[:len(block)] = torch.from_numpy(np.ascontiguousarray(block))
    got = [torch.empty_like(mine) for _ in counts]
    torch.distributed.all_gather(got, mine, group=mesh.group)
    return np.concatenate([g[:c].numpy() for g, c in zip(got, counts)])


def make_candidate_gather(mesh):
    """(records [B, W] int32, valid [B] bool) -> (all_records, all_valid,
    n_valid): the reads axis's blocks in shard order (a tiled all_gather),
    n_valid their psum.  In one process the records are the whole batch;
    in a process group they are this rank's block."""

    def gather(records, valid):
        records = np.asarray(records, np.int32)
        valid = np.asarray(valid, bool)
        if mesh.group is None:
            return records, valid, int(valid.sum())
        return (_gather_blocks(mesh, records),
                _gather_blocks(mesh, valid.astype(np.uint8)).astype(bool),
                _all_sum(mesh, valid.sum()))

    return gather


def gather_candidates(mesh, records, valid):
    """Merge per-shard candidate records into one table and return its
    valid rows on the host, lexsorted over every column (read id first),
    with their count.  Batches that do not divide the reads axis are padded
    with invalid rows, as sharded_sw pads."""
    dp = mesh.shape[READS_AXIS] if mesh.group is None else 1
    records = np.asarray(records, np.int32)
    valid = np.asarray(valid, bool)
    pad = (-len(records)) % dp
    if pad:
        records = np.pad(records, ((0, pad), (0, 0)))
        valid = np.pad(valid, (0, pad))
    all_rec, all_valid, n = make_candidate_gather(mesh)(records, valid)
    rec_h = all_rec[all_valid]
    order = np.lexsort(tuple(rec_h[:, c] for c in
                             range(rec_h.shape[1] - 1, -1, -1)))
    return rec_h[order], int(n)
