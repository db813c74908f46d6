"""Packed 16-bit and 8-bit vector probes on one CUDA GPU: the port of
misc/int16_probe.py.

    python -m ciri_long_tpu_torch.misc.int16_probe [--device cuda]

Runs the six probes of misc/int16_probe.py on the TPU probe's input
(``arange % 7`` of the probe's type and shape), each a kernel of
csrc/int16_probe.cu on packed lanes, and holds each exactly to its plain
PyTorch version.  Prints ``PROBE <name>: OK <first four values>`` per probe,
as the TPU probe did, then runs all six again in one launch
(``int16_probe_all``) and prints ``PROBES in one launch: OK``; raises on any
mismatch or launch error (the TPU probe caught them and printed FAIL).
``--device cpu`` runs the plain versions; ``--device cuda`` without a card
raises.
"""

import argparse
import ctypes
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from ciri_long_tpu_torch.utils.dispatch import count_launch, resolve_device


class Probe(NamedTuple):
    name: str
    index: int                 # the probe's number in csrc/int16_probe.cu
    dtype: torch.dtype
    shape: Tuple[int, ...]
    plain: Callable


def _bitcast(x):
    """int16 [..., 2] -> int32 [...], little-endian pairs."""
    return x.view(torch.int32).reshape(x.shape[:-1])


PROBES = (
    Probe('int16 add', 0, torch.int16, (256, 512), lambda x: x + 1),
    Probe('int16 max', 1, torch.int16, (256, 512),
          lambda x: torch.clamp_min(x, 3)),
    Probe('int16 where', 2, torch.int16, (256, 512),
          lambda x: torch.where(x > 0, x, torch.full_like(x, -1))),
    Probe('int16 roll', 3, torch.int16, (256, 512),
          lambda x: torch.roll(x, 1, dims=1)),
    Probe('int8 add', 4, torch.int8, (256, 512), lambda x: x + 1),
    Probe('bitcast16->32', 5, torch.int16, (256, 512, 2), _bitcast),
)


def probe_input(probe: Probe, device='cpu'):
    """The TPU probe's input: arange over the shape in the probe's type
    (wrapping as the type does), % 7."""
    n = int(np.prod(probe.shape))
    x = torch.arange(n, dtype=torch.int64, device=device).to(probe.dtype)
    return x.reshape(probe.shape) % 7


def probe_cases(probe: Probe, device='cpu'):
    """(label, input) pairs a kernel is held on: the TPU probe's input, the
    same less 3 (negative lanes), and the same raised to the top of the
    type (lanes that wrap on the add)."""
    x = probe_input(probe, device)
    top = torch.iinfo(probe.dtype).max - 6
    return [('arange % 7', x), ('arange % 7 - 3', x - 3),
            ('arange % 7 + {}'.format(top), x + top)]


_SYMBOLS = {
    'int16_probe_launch': ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                           ctypes.c_int),
    'int16_probe_all_launch': ([ctypes.c_void_p] * 3
                               + [ctypes.c_int, ctypes.c_void_p],
                               ctypes.c_int),
}


def _check(probe: Probe, x: torch.Tensor, max_row=2048):
    """The words of ``x`` (and for the roll its row's words), or raises:
    a contiguous CUDA tensor of the probe's type whose bytes fill whole
    32-bit words; the roll takes 2-D [R, W], W a multiple of 64 up to
    ``max_row``."""
    if not x.is_cuda:
        raise ValueError('int16_probe_cuda needs a CUDA tensor (got {})'
                         .format(x.device))
    if x.dtype != probe.dtype or not x.is_contiguous():
        raise TypeError('probe {} needs a contiguous {} tensor (got {})'
                        .format(probe.name, probe.dtype, x.dtype))
    nbytes = x.numel() * x.element_size()
    if nbytes % 4:
        raise ValueError('probe {} needs whole 32-bit words (got {} bytes)'
                         .format(probe.name, nbytes))
    row_words = 0
    if probe.index == 3:
        if x.dim() != 2 or x.shape[1] % 64 or x.shape[1] > max_row:
            raise ValueError('the roll probe needs [R, W] with W a multiple '
                             'of 64 up to {} (got {})'.format(
                                 max_row, tuple(x.shape)))
        row_words = x.shape[1] // 2
    return nbytes // 4, row_words


def int16_probe_cuda(probe: Probe, x: torch.Tensor):
    """The probe's kernel (csrc/int16_probe.cu) on a contiguous CUDA tensor
    of the probe's type whose bytes fill whole 32-bit words.  The roll takes
    2-D [R, W] with W/2 words a row, a multiple of 32 and at most 1024.
    Raises on anything else, and when the launch is refused."""
    from ciri_long_tpu_torch.ops import _build

    n_words, row_words = _check(probe, x)
    out = torch.empty_like(x)
    lib = _build.load('int16_probe.cu', _SYMBOLS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.int16_probe_launch(probe.index, x.data_ptr(), out.data_ptr(),
                                    n_words, row_words, stream)
    if rc != 0:
        raise RuntimeError('int16 probe {} launch failed: cudaError {}'.format(
            probe.name, rc))
    count_launch('int16_probe')
    return _bitcast(out) if probe.index == 5 else out


# the one launch's roll row: one block of csrc/int16_probe.cu's THREADS
ALL_MAX_ROW = 512


def int16_probe_all_cuda(xs):
    """All six probes in one launch of csrc/int16_probe.cu: ``xs`` one
    input a probe, in PROBES order, each as int16_probe_cuda takes it (the
    roll's rows at most ALL_MAX_ROW int16), on one device, 16-byte
    aligned.  Returns the six outputs; raises as int16_probe_cuda does."""
    from ciri_long_tpu_torch.ops import _build

    if len(xs) != len(PROBES):
        raise ValueError('int16_probe_all_cuda needs {} inputs (got {})'
                         .format(len(PROBES), len(xs)))
    sizes = [_check(probe, x, ALL_MAX_ROW) for probe, x in zip(PROBES, xs)]
    if any(x.device != xs[0].device or x.data_ptr() % 16 for x in xs):
        raise ValueError('int16_probe_all_cuda needs its inputs on one '
                         'device, 16-byte aligned')
    outs = [torch.empty_like(x) for x in xs]
    ptrs = (ctypes.c_void_p * len(xs))(*(x.data_ptr() for x in xs))
    out_ptrs = (ctypes.c_void_p * len(xs))(*(o.data_ptr() for o in outs))
    words = (ctypes.c_int * len(xs))(*(n for n, _ in sizes))
    lib = _build.load('int16_probe.cu', _SYMBOLS)
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream(xs[0].device).cuda_stream
        rc = lib.int16_probe_all_launch(ptrs, out_ptrs, words, sizes[3][1],
                                        stream)
    if rc != 0:
        raise RuntimeError('int16 probes in one launch failed: cudaError {}'
                           .format(rc))
    count_launch('int16_probe_all')
    return [_bitcast(o) if p.index == 5 else o for p, o in zip(PROBES, outs)]


def int16_probe_all(xs):
    """The one launch for CUDA tensors, the six plain versions for CPU
    tensors."""
    if all(x.is_cuda for x in xs):
        return int16_probe_all_cuda(xs)
    if all(x.device.type == 'cpu' for x in xs):
        return [p.plain(x) for p, x in zip(PROBES, xs)]
    raise ValueError('int16_probe_all: unsupported devices {}'.format(
        [str(x.device) for x in xs]))


def int16_probe(probe: Probe, x: torch.Tensor):
    """The probe's kernel for a CUDA tensor, its plain version for a CPU
    tensor."""
    if x.is_cuda:
        return int16_probe_cuda(probe, x)
    if x.device.type == 'cpu':
        return probe.plain(x)
    raise ValueError('int16_probe: unsupported device {}'.format(x.device))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m ciri_long_tpu_torch.misc.int16_probe',
        description='Packed 16/8-bit vector probes on the card.')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                    help='cpu runs the plain versions, (default: '
                         '%(default)s)')
    dev = resolve_device(ap.parse_args(argv).device)
    print('device:', torch.cuda.get_device_name(dev) if dev.type == 'cuda'
          else 'cpu', flush=True)
    outs = {}
    for probe in PROBES:
        x = probe_input(probe, dev)
        got = int16_probe(probe, x)
        want = probe.plain(x)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError('PROBE {}: MISMATCH got {} want {}'.format(
                probe.name, got.flatten()[:4].tolist(),
                want.flatten()[:4].tolist()))
        print('PROBE {}: OK {}'.format(
            probe.name, np.asarray(got.cpu()).ravel()[:4]), flush=True)
        outs[probe.name] = got
    xs = [probe_input(probe, dev) for probe in PROBES]
    for probe, got in zip(PROBES, int16_probe_all(xs)):
        if not torch.equal(got, outs[probe.name]):
            raise AssertionError('PROBES in one launch: {} MISMATCH'.format(
                probe.name))
    print('PROBES in one launch: OK', flush=True)
    return outs


if __name__ == '__main__':
    main()
