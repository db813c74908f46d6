"""The hand-written CUDA SW kernel against its plain PyTorch version, on the
card.  Marked ``cuda``; each test skips when no GPU is visible.  Imports
only torch, numpy and the port (the card's machine has no JAX), so it runs
there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ciri_long_tpu_torch.ops import sw
from ciri_long_tpu_torch.utils.dispatch import LAUNCHES

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the SW kernel has no CPU mode)')
    return torch.device('cuda')


def _codes(rng, B, L):
    x = rng.integers(0, 5, (B, L)).astype(np.int8)
    for b in range(B):
        x[b, int(rng.integers(1, L + 1)):] = 5
    return x


@pytest.mark.parametrize("params", [(1, 1, 1, 1), (10, 4, 8, 2), (2, 3, 5, 1)])
@pytest.mark.parametrize("shape", [(7, 1, 1), (9, 33, 65), (5, 100, 31),
                                   (64, 64, 700)])
def test_kernel_matches_plain(dev, params, shape):
    rng = np.random.default_rng(1000 * sum(params) + sum(shape))
    B, Lq, Lr = shape
    q = _codes(rng, B, Lq)
    r = _codes(rng, B, Lr)
    q[0, Lq // 2] = 5
    r[min(1, B - 1)] = 5
    qt = torch.from_numpy(q).to(dev)
    rt = torch.from_numpy(r).to(dev)
    p = sw.SWParams(*params)
    got = sw.sw_score_ends_cuda(qt, rt, p)
    want = sw.sw_score_ends(qt, rt, p)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_auto_launches_kernel_for_cuda_tensors(dev):
    q = torch.randint(0, 4, (3, 20), dtype=torch.int8, device=dev)
    before = LAUNCHES['sw_score_ends']
    res = sw.sw_align_batch(q.cpu().numpy(), q.cpu().numpy(), sw.SWParams(),
                            dev)
    assert LAUNCHES['sw_score_ends'] == before + 2   # ends + begins
    assert (res.score == 20).all() and (res.query_begin == 0).all()


def test_kernel_rejects_bad_inputs(dev):
    q = torch.zeros((2, 8), dtype=torch.int8, device=dev)
    p = sw.SWParams()
    with pytest.raises(TypeError):
        sw.sw_score_ends_cuda(q.int(), q, p)
    with pytest.raises(ValueError):
        sw.sw_score_ends_cuda(q.t(), q.t(), p)
    with pytest.raises(ValueError):
        sw.sw_score_ends_cuda(q, q.cpu(), p)
    with pytest.raises(ValueError):
        sw.sw_score_ends_cuda(q, q[:1], p)
