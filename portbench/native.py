"""The program's native host cores (``native/*.cpp``), built for the run.

The port loads ``ciri_long_tpu_torch._alncore``, ``_nwcore``, ``_chaincore``,
``_ccscore``, ``_poacore`` and ``_fastxcodec`` when they are built, and falls
back to slow Python without them.  ``setup.py build_ext --inplace`` would
build them, but it imports the JAX package, which nothing of the benchmark
may load.  So each core is compiled here with the flags of ``setup.py``
(``-O3 -march=native -std=c++17``, zlib for the codec) into
``build/portbench/native/<hash>/`` at the root of the checkout, a fixed
path named by a hash of the sources and flags, and that directory joins
the package's ``__path__``.  Only the first run in a checkout compiles.
"""

import hashlib
import os
import subprocess
import sys
import sysconfig
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CORES = {'alncore': [], 'nwcore': [], 'chaincore': [], 'ccscore': [],
         'poacore': [], 'fastxcodec': ['-lz']}
FLAGS = ['-O3', '-march=native', '-std=c++17', '-shared', '-fPIC']


def _tag():
    h = hashlib.sha1(' '.join(FLAGS + [sys.version]).encode())
    for src in sorted((ROOT / 'native').glob('*')):
        h.update(src.name.encode() + src.read_bytes())
    return h.hexdigest()[:12]


def _compile(out_dir, name, libs):
    target = out_dir / ('_' + name + sysconfig.get_config_var('EXT_SUFFIX'))
    if target.exists():
        return
    tmp = target.with_name(target.name + '.tmp{}'.format(os.getpid()))
    cmd = ['c++', *FLAGS, '-I' + sysconfig.get_paths()['include'],
           str(ROOT / 'native' / (name + '.cpp')), '-o', str(tmp), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('building native/{}.cpp failed:\n{}'.format(
            name, proc.stderr[-4000:]))
    os.replace(tmp, target)


def load_cores():
    """Build the cores if this checkout has not, and put them on the port
    package's path.  Raises when a build fails."""
    out_dir = ROOT / 'build' / 'portbench' / 'native' / _tag()
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(CORES)) as pool:
        list(pool.map(lambda kv: _compile(out_dir, *kv), CORES.items()))
    import ciri_long_tpu_torch
    if str(out_dir) not in ciri_long_tpu_torch.__path__:
        ciri_long_tpu_torch.__path__.append(str(out_dir))
    from ciri_long_tpu_torch import _alncore, _chaincore  # noqa: F401
    return out_dir
