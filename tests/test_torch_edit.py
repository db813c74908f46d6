"""The port's batched edit distance (ops/edit.py) against the JAX package's on
the CPU, exact: the plain PyTorch version and the CPU wrapper (the native
Myers core) against JAX ``edit_distance_batch_padded`` (XLA on the CPU) and
JAX ``edit_distance_batch``, on tools/collapse_cases.py's batches (N and
PAD codes, alen or blen 0, lengths 1-300, an odd batch, one-base rows, long
near-equal pairs, junction-curation pairs, N against N) and on a seeded
random batch; the scalar ``edit_distance`` against its twin."""

import numpy as np
import pytest
import torch

from ciri_long_tpu.ops import edit as jedit
from ciri_long_tpu_torch.ops import edit
from ciri_long_tpu_torch.tools.collapse_cases import edit_cases

CASES = edit_cases(np.random.default_rng(7))


@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_plain_and_cpu_wrapper_match_jax(case):
    _, a, b, alen, blen = case
    want = np.asarray(jedit.edit_distance_batch_padded(a, b, alen, blen))
    plain = edit.edit_distance_batch_plain(
        *(torch.from_numpy(x) for x in (a, b, alen, blen)))
    assert plain.dtype == torch.int32
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(edit.edit_distance_batch(a, b, alen, blen, 'cpu'),
                          want)
    assert np.array_equal(jedit.edit_distance_batch(a, b, alen, blen), want)


def test_empty_rows_give_the_other_length(rng):
    a = rng.integers(0, 4, (5, 12)).astype(np.int8)
    b = rng.integers(0, 4, (5, 9)).astype(np.int8)
    alen = np.array([0, 12, 0, 3, 7], np.int32)
    blen = np.array([9, 0, 0, 2, 9], np.int32)
    got = edit.edit_distance_batch_plain(
        *(torch.from_numpy(x) for x in (a, b, alen, blen))).numpy()
    assert list(got[:3]) == [9, 12, 0]
    assert np.array_equal(got, edit.edit_distance_batch(a, b, alen, blen,
                                                        'cpu'))


def test_default_lengths_are_the_full_widths(rng):
    a = rng.integers(0, 5, (7, 40)).astype(np.int8)
    b = rng.integers(0, 5, (7, 33)).astype(np.int8)
    want = np.asarray(jedit.edit_distance_batch_padded(
        a, b, np.full(7, 40, np.int32), np.full(7, 33, np.int32)))
    assert np.array_equal(edit.edit_distance_batch(a, b, device='cpu'), want)


def test_lengths_outside_the_widths_raise():
    a = np.zeros((2, 4), np.int8)
    with pytest.raises(ValueError, match='alen'):
        edit.edit_distance_batch(a, a, np.array([5, 1], np.int32), None,
                                 'cpu')
    with pytest.raises(ValueError, match='blen'):
        edit.edit_distance_batch(a, a, None, np.array([-1, 1], np.int32),
                                 'cpu')


def test_auto_takes_the_plain_version_for_cpu_tensors(rng):
    a = torch.from_numpy(rng.integers(0, 5, (3, 10)).astype(np.int8))
    n = torch.full((3,), 10, dtype=torch.int32)
    assert torch.equal(edit.edit_distance_auto(a, a.flip(1), n, n),
                       edit.edit_distance_batch_plain(a, a.flip(1), n, n))


@pytest.mark.parametrize('pair', [('', ''), ('ACGT', ''), ('', 'NN'),
                                  ('ACGTTGCA', 'ACGTGCAA'),
                                  ('NNNN', 'NANA')])
def test_scalar_edit_distance_matches_jax(pair):
    assert edit.edit_distance(*pair) == jedit.edit_distance(*pair)
