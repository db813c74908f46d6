"""Import boundary and device handling of the PyTorch port.

``ciri_long_tpu_torch`` never imports ``jax``; outside itself it imports
only the JAX-free leaf modules and native cores of ``ciri_long_tpu``; and
``chip_smoke.py`` imports nothing of either.  Asking for ``--device cuda``
without a GPU raises, and -t > 1 with cuda raises NotImplementedError.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / 'ciri_long_tpu_torch'

# the JAX-free parts of ciri_long_tpu the port may import by name
ALLOWED = {
    'ciri_long_tpu', 'ciri_long_tpu.version', 'ciri_long_tpu.config',
    'ciri_long_tpu.context', 'ciri_long_tpu.io', 'ciri_long_tpu.io.fastx',
    'ciri_long_tpu.io.genome', 'ciri_long_tpu.annot',
    'ciri_long_tpu.annot.gtf', 'ciri_long_tpu.annot.signal',
    'ciri_long_tpu.utils.seq', 'ciri_long_tpu.utils.misc',
    'ciri_long_tpu.utils.logger', 'ciri_long_tpu.utils.diskcache',
    'ciri_long_tpu.tools.simulate',
}
NATIVE = {'_alncore', '_nwcore', '_chaincore', '_ccscore', '_poacore',
          '_fastxcodec'}


def _imports(path):
    """(module, names) for every import statement in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, []
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, [a.name for a in node.names]


def _port_files():
    files = sorted(PORT.rglob('*.py'))
    assert len(files) >= 15
    return files


@pytest.mark.parametrize('rel', [str(p.relative_to(REPO))
                                 for p in sorted(PORT.rglob('*.py'))])
def test_port_module_imports_stay_inside_the_boundary(rel):
    for module, names in _imports(REPO / rel):
        root = module.split('.')[0]
        assert root != 'jax', (rel, module)
        if root != 'ciri_long_tpu':
            continue
        if module == 'ciri_long_tpu' and names:
            assert set(names) <= NATIVE | {'version'}, (rel, names)
        else:
            assert module in ALLOWED, (rel, module)


def test_chip_smoke_imports_no_jax_package():
    for module, _names in _imports(REPO / 'chip_smoke.py'):
        assert module.split('.')[0] not in ('jax', 'ciri_long_tpu'), module


def test_port_runs_with_jax_blocked(tmp_path):
    """Every port module imports, and the CPU scorer runs, in a process
    where ``import jax`` fails."""
    mods = ['.'.join(p.relative_to(REPO).with_suffix('').parts)
            for p in _port_files()]
    mods = [m[:-len('.__init__')] if m.endswith('.__init__') else m
            for m in mods]
    code = '\n'.join([
        'import sys',
        "sys.modules['jax'] = None",
        'import importlib, numpy as np',
        'for m in {!r}: importlib.import_module(m)'.format(mods),
        'from ciri_long_tpu_torch.ops.sw import SWParams, sw_align_batch',
        'q = np.array([[0, 1, 2, 3]], np.int8)',
        "res = sw_align_batch(q, q, SWParams(), 'cpu')",
        'assert int(res.score[0]) == 4, res',
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items()"
        " if v is not None}",
        'from ciri_long_tpu_torch.ops import _build',
        'assert _build._LIBS == {}, _build._LIBS   # nothing built or loaded',
    ])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_without_gpu_raises(monkeypatch):
    from ciri_long_tpu_torch.cli.main import main
    from ciri_long_tpu_torch.utils.dispatch import resolve_device

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError, match='is_available'):
        main(['call', '-i', 'r.fa', '-o', 'out', '-r', 'g.fa'])
    assert resolve_device('cpu') == torch.device('cpu')
    with pytest.raises(ValueError):
        resolve_device('meta')


def test_threads_with_cuda_not_implemented(monkeypatch):
    from ciri_long_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        main(['call', '-i', 'r.fa', '-o', 'out', '-r', 'g.fa', '-t', '4',
              '--device', 'cuda'])


def test_kernel_sources_ship_with_package():
    from ciri_long_tpu_torch.ops import _build

    assert (_build.CSRC / 'sw_score_ends.cu').exists()
    setup = (REPO / 'setup.py').read_text()
    assert "'ciri_long_tpu_torch': ['csrc/*.cu']" in setup
    assert 'CIRI-long-torch=ciri_long_tpu_torch.cli.main:main' in setup
