"""Import boundary and device handling of the PyTorch port.

Neither ``ciri_long_tpu_torch`` nor ``chip_smoke.py`` imports ``jax`` or
``ciri_long_tpu`` in any form (the port keeps its own copies of the JAX-free
leaf modules and loads the native cores built under its own name), and the
port's ``call`` runs in a process where both are blocked.  Asking for
``--device cuda`` without a GPU raises.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / 'ciri_long_tpu_torch'
BLOCKED = ('jax', 'ciri_long_tpu')


def _imported(path):
    """Every module name ``path`` imports: import statements, and constant
    arguments of importlib.import_module / __import__."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, 'id', None)
            if name in ('import_module', '__import__'):
                yield node.args[0].value


def _port_files():
    files = sorted(PORT.rglob('*.py'))
    assert len(files) >= 30
    return files


@pytest.mark.parametrize('rel', [str(p.relative_to(REPO))
                                 for p in sorted(PORT.rglob('*.py'))])
def test_port_module_imports_stay_inside_the_boundary(rel):
    for module in _imported(REPO / rel):
        assert module.split('.')[0] not in BLOCKED, (rel, module)


def test_chip_smoke_imports_no_jax_package():
    for module in _imported(REPO / 'chip_smoke.py'):
        assert module.split('.')[0] not in BLOCKED, module


def test_port_runs_with_jax_blocked(tmp_path):
    """Every port module imports, the CPU scorer runs, ``call --device
    cpu`` on the verification world calls its 10 BSJ reads at
    chr1:20001-20520, and ``collapse --device cpu`` on them writes its one
    circRNA there, in a process where ``import jax`` and ``import
    ciri_long_tpu`` fail; the cand_circ.fa and the four collapse files are
    byte-identical to the JAX package's ``--backend cpu`` runs on the same
    files."""
    mods = ['.'.join(p.relative_to(REPO).with_suffix('').parts)
            for p in _port_files()]
    mods = [m[:-len('.__init__')] if m.endswith('.__init__') else m
            for m in mods]
    code = '\n'.join([
        'import sys',
        # a finder that refuses the two packages, so that neither enters
        # sys.modules (scipy looks jax up there, and a None entry breaks it)
        'class Block:',
        '    def find_spec(self, name, path=None, target=None):',
        "        if name.split('.')[0] in {!r}:".format(BLOCKED),
        "            raise ImportError('blocked: ' + name)",
        'sys.meta_path.insert(0, Block())',
        'import importlib, numpy as np',
        'for m in {!r}: importlib.import_module(m)'.format(mods),
        'from ciri_long_tpu_torch.ops.sw import SWParams, sw_align_batch',
        'q = np.array([[0, 1, 2, 3]], np.int8)',
        "res = sw_align_batch(q, q, SWParams(), 'cpu')",
        'assert int(res.score[0]) == 4, res',
        'from ciri_long_tpu_torch.tools.world import skill_world',
        'from ciri_long_tpu_torch.cli.main import main',
        "ref, reads = skill_world('w')",
        "main(['call', '-i', reads, '-o', 'out', '-r', ref, '-p', 'vtest',",
        "      '-t', '1', '--device', 'cpu'])",
        "heads = [ln.split('\\t')[1] for ln in open('out/vtest.cand_circ.fa')",
        "         if ln.startswith('>')]",
        "assert heads == ['chr1:20001-20520'] * 10, heads",
        "import os",
        "open('s.lst', 'w').write('vtest\\t{}\\n'.format(",
        "    os.path.abspath('out/vtest.cand_circ.fa')))",
        "main(['collapse', '-i', 's.lst', '-o', 'col', '-r', ref, '-p',",
        "      'vtest', '--device', 'cpu'])",
        "info = open('col/vtest.info').read().split('\\t')",
        "assert info[3:5] == ['20001', '20520'], info",
        'loaded = {k.split(".")[0] for k, v in sys.modules.items() if v}',
        'assert not loaded & {!r}, loaded'.format(set(BLOCKED)),
        'from ciri_long_tpu_torch.ops import _build',
        'assert _build._LIBS == {}, _build._LIBS   # nothing built or loaded',
    ])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]

    from ciri_long_tpu.cli.main import call
    world = tmp_path / 'w'
    call(SimpleNamespace(input=str(world / 'reads.fa'),
                         output=str(tmp_path / 'out_jax'),
                         reference=str(world / 'genome.fa'), prefix='vtest',
                         gtf=None, circ=None, threads=1, debug=False,
                         backend='cpu'))
    assert (tmp_path / 'out' / 'vtest.cand_circ.fa').read_bytes() == \
        (tmp_path / 'out_jax' / 'vtest.cand_circ.fa').read_bytes()

    from ciri_long_tpu.cli.main import collapse
    collapse(SimpleNamespace(input=str(tmp_path / 's.lst'),
                             output=str(tmp_path / 'col_jax'),
                             reference=str(world / 'genome.fa'),
                             prefix='vtest', gtf=None, circ=None, threads=1,
                             debug=False, backend='cpu'))
    for ext in ('info', 'reads', 'expression', 'isoforms'):
        name = 'vtest.' + ext
        assert (tmp_path / 'col' / name).read_bytes() == \
            (tmp_path / 'col_jax' / name).read_bytes(), name


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


def _setup_kwargs():
    """The keyword arguments setup.py hands to setuptools.setup."""
    import setuptools

    seen = {}
    orig = setuptools.setup
    setuptools.setup = lambda **kw: seen.update(kw)
    try:
        code = compile((REPO / 'setup.py').read_text(), 'setup.py', 'exec')
        exec(code, {'__name__': '__main__', '__file__': str(REPO / 'setup.py')})
    finally:
        setuptools.setup = orig
    return seen


def test_kernel_sources_ship_with_package():
    from ciri_long_tpu_torch.ops import _build

    for src in ('sw_score_ends.cu', 'sw_rowscan.cu', 'sw_chain.cu',
                'int16_probe.cu', 'op_rate.cu', 'edit_distance.cu',
                'sw_traceback.cu', 'tandem_counts.cu', 'star_vote.cpp',
                'poa_graph.h', 'kmer_pairs.h'):
        assert (_build.CSRC / src).exists(), src
    seen = _setup_kwargs()
    assert 'csrc/*.cu' in seen['package_data']['ciri_long_tpu_torch']
    assert 'CIRI-long-torch=ciri_long_tpu_torch.cli.main:main' in \
        seen['entry_points']['console_scripts']


def test_package_data_covers_every_csrc_file():
    """An installed port builds its kernels, its host C++ vote and their
    headers from csrc/: every file there must match a package_data glob
    (csrc/star_vote.cpp and csrc/poa_graph.h once did not)."""
    import fnmatch

    globs = _setup_kwargs()['package_data']['ciri_long_tpu_torch']
    files = sorted(str(p.relative_to(PORT)) for p in (PORT / 'csrc').iterdir()
                   if p.is_file())
    assert len(files) >= 14
    missed = [f for f in files if not any(fnmatch.fnmatch(f, g)
                                          for g in globs)]
    assert not missed, missed


def test_setup_names_the_ports_native_cores():
    """setup.py builds each native core twice: as ciri_long_tpu._X for the
    JAX package and as ciri_long_tpu_torch._X for the port."""
    seen = _setup_kwargs()
    names = {ext.name: ext.sources for ext in seen['ext_modules']}
    for core in ('_fastxcodec', '_chaincore', '_nwcore', '_alncore',
                 '_poacore', '_ccscore'):
        assert names['ciri_long_tpu_torch.' + core] == \
            names['ciri_long_tpu.' + core] == ['native/{}.cpp'.format(core[1:])]
