"""The host graph code of collapse's POA rounds (csrc/poa_graph.h) on the
CPU, against the JAX package.

The header is compiled with the host's C++ compiler, behind the small C
shim below, into a temporary directory, and driven from Python the way
csrc/poa_align.cu's round loop drives it: each round ``Rounds::pack``
flattens every pending job into the kernel's batch, the plain aligner
(ops/poa_batch.py::poa_align_batch_plain) stands in for the kernel, and
``Rounds::fuse_all`` fuses its pairs; then the consensus.  The consensus
equals the JAX package's ``poa_consensus_many(jobs, use_device=True)``
byte for byte on seeded fuzz jobs, and every round's batch equals the one
that the port's Python rounds (ops/poa.py::poa_consensus_many_plain) make
of the same graphs.  Skips when no C++ compiler is
found.  The round loop's CUDA side is held on the card (chip_smoke.py
phases 7 and 8, and tests/test_torch_cuda.py).
"""

import ctypes
import importlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ciri_long_tpu_torch.ops.poa_batch import (poa_align_batch_plain,
                                               split_inputs)
from tests.test_poa import mutate

jpoa = importlib.import_module('ciri_long_tpu.ops.poa')
tpoa = importlib.import_module('ciri_long_tpu_torch.ops.poa')
CSRC = Path(__file__).resolve().parent.parent / 'ciri_long_tpu_torch' / 'csrc'

SHIM = r'''
#include "poa_graph.h"
#include <cstring>

extern "C" {
void* rounds_new(const uint8_t* codes, const int32_t* lens,
                 const int32_t* counts, int njobs) {
    return new poa_graph::Rounds(codes, lens, counts, njobs);
}
void rounds_free(void* r) { delete static_cast<poa_graph::Rounds*>(r); }
// B, then Vmax, nmax and the predecessor entries of the batch
int rounds_pack(void* h, int64_t* sizes) {
    auto* r = static_cast<poa_graph::Rounds*>(h);
    const int B = r->pack();
    sizes[0] = B;
    sizes[1] = r->vmax;
    sizes[2] = r->nmax;
    sizes[3] = r->preds.size();
    return B;
}
void rounds_copy(void* h, int32_t* out) {
    static_cast<poa_graph::Rounds*>(h)->copy_inputs(out);
}
void rounds_fuse(void* h, const int32_t* aln, const int32_t* acnt) {
    static_cast<poa_graph::Rounds*>(h)->fuse_all(aln, acnt);
}
int rounds_consensus(void* h, int t, uint8_t* out) {
    std::vector<uint8_t> cons;
    poa_graph::consensus(static_cast<poa_graph::Rounds*>(h)->jobs[t].g,
                         cons);
    std::memcpy(out, cons.data(), cons.size());
    return static_cast<int>(cons.size());
}
}
'''


@pytest.fixture(scope='module')
def shim(tmp_path_factory):
    cxx = shutil.which('g++') or shutil.which('c++')
    if cxx is None:
        pytest.skip('no C++ compiler to build csrc/poa_graph.h')
    root = tmp_path_factory.mktemp('poa_graph')
    (root / 'shim.cpp').write_text(SHIM)
    lib = root / 'libpoa_graph.so'
    subprocess.run([cxx, '-std=c++17', '-O1', '-shared', '-fPIC',
                    '-I', str(CSRC), '-o', str(lib), str(root / 'shim.cpp')],
                   check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    vp, i64p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)
    so.rounds_new.argtypes = [vp, vp, vp, ctypes.c_int]
    so.rounds_new.restype = vp
    so.rounds_free.argtypes = [vp]
    so.rounds_pack.argtypes = [vp, i64p]
    so.rounds_copy.argtypes = [vp] * 2
    so.rounds_fuse.argtypes = [vp] * 3
    so.rounds_consensus.argtypes = [vp, ctypes.c_int, vp]
    return so


def _codes(jobs):
    from ciri_long_tpu_torch.utils.seq import encode_seq
    return [[encode_seq(s) for s in job] for job in jobs]


def _run(so, jobs, launches):
    """The rounds of ``jobs`` through the header, the plain aligner in place
    of the kernel; each round's batch is appended to ``launches``.
    Returns the consensus strings."""
    from ciri_long_tpu_torch.utils.seq import decode_seq

    codes = _codes(jobs)
    lens = np.array([len(c) for job in codes for c in job], np.int32)
    counts = np.array([len(job) for job in codes], np.int32)
    concat = np.concatenate([c.astype(np.uint8) for job in codes
                             for c in job] + [np.zeros(1, np.uint8)])
    h = so.rounds_new(concat.ctypes.data, lens.ctypes.data,
                      counts.ctypes.data, len(jobs))
    try:
        sizes = np.zeros(4, np.int64)
        while so.rounds_pack(h, sizes.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64))):
            B, V, n, E = (int(v) for v in sizes)
            buf = np.zeros(B * V + B * (V + 1) + E + B * n + 2 * B, np.int32)
            so.rounds_copy(h, buf.ctypes.data)
            arrays = split_inputs(buf, B, V, n, E)
            launches.append(arrays)
            _, aln, acnt = poa_align_batch_plain(
                *(torch.from_numpy(a) for a in arrays))
            aln = np.ascontiguousarray(aln.numpy(), np.int32)
            acnt = np.ascontiguousarray(acnt.numpy(), np.int32)
            so.rounds_fuse(h, aln.ctypes.data, acnt.ctypes.data)
        out = []
        buf = np.zeros(max(1, len(concat)), np.uint8)
        for t in range(len(jobs)):
            k = so.rounds_consensus(h, t, buf.ctypes.data)
            out.append(decode_seq(buf[:k].astype(np.int8)))
        return out
    finally:
        so.rounds_free(h)


def _fuzz(rng, n_jobs):
    jobs = []
    for _ in range(n_jobs):
        template = "".join(rng.choice(list("ACGTN"),
                                      size=int(rng.integers(20, 220))))
        k = int(rng.integers(2, 9))
        sub = float(rng.uniform(0.0, 0.12))
        jobs.append([mutate(rng, template, sub=sub, ins=sub / 2,
                            dele=sub / 2) for _ in range(k)])
    return jobs


def test_header_rounds_match_jax(shim, rng):
    jobs = _fuzz(rng, 8) + [["ACGTACGTTGCAGGGCATCGATCG"] * 4,
                            ["", "GGGT", "GGAT"], [""], ["ACGT"]]
    launches = []
    got = _run(shim, jobs, launches)
    assert got == jpoa.poa_consensus_many(jobs, use_device=True)
    assert got == [tpoa.poa(job)[0] for job in jobs]
    assert len(launches) == max(len([s for s in job if s]) for job in jobs) - 1


def test_header_packs_the_python_graphs(shim, rng, monkeypatch):
    """Each round's batch equals the one the port's Python round loop
    (ops/poa.py::poa_consensus_many_plain) hands the plain aligner."""
    from ciri_long_tpu_torch.ops import poa_batch

    jobs = _fuzz(rng, 5)
    launches, seen = [], []
    _run(shim, jobs, launches)
    real = poa_batch.batch_arrays

    def spy(graphs, seqs):
        seen.append(real(graphs, seqs))
        return seen[-1]

    monkeypatch.setattr(poa_batch, 'batch_arrays', spy)
    tpoa.poa_consensus_many_plain(jobs)
    assert len(seen) == len(launches) > 0
    for got, want in zip(launches, seen):
        for x, y in zip(got, want):
            assert np.array_equal(x, y)
