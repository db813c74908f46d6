import os

from setuptools import Extension, find_packages, setup

from ciri_long_tpu.version import __version__

# -march=native maximises the split-row DP cores' auto-vectorisation on
# the build host but makes the artifacts CPU-specific; set
# CIRI_NATIVE_ARCH=0 (or =<arch>) when building wheels for other machines.
_arch = os.environ.get('CIRI_NATIVE_ARCH', 'native')
_cxx_args = ['-O3', '-std=c++17']
if _arch not in ('', '0', 'none'):
    _cxx_args.insert(1, '-march=' + _arch)

fastxcodec = Extension(
    'ciri_long_tpu._fastxcodec',
    sources=['native/fastxcodec.cpp'],
    libraries=['z'],
    extra_compile_args=_cxx_args,
)

chaincore = Extension(
    'ciri_long_tpu._chaincore',
    sources=['native/chaincore.cpp'],
    extra_compile_args=_cxx_args,
)

nwcore = Extension(
    'ciri_long_tpu._nwcore',
    sources=['native/nwcore.cpp'],
    extra_compile_args=_cxx_args,
)

alncore = Extension(
    'ciri_long_tpu._alncore',
    sources=['native/alncore.cpp'],
    extra_compile_args=_cxx_args,
)

poacore = Extension(
    'ciri_long_tpu._poacore',
    sources=['native/poacore.cpp'],
    extra_compile_args=_cxx_args,
)

ccscore = Extension(
    'ciri_long_tpu._ccscore',
    sources=['native/ccscore.cpp'],
    extra_compile_args=_cxx_args,
)

setup(
    name='ciri-long-tpu',
    version=__version__,
    description='TPU-native circular RNA identification from Nanopore long reads',
    packages=find_packages(include=['ciri_long_tpu', 'ciri_long_tpu.*',
                                    'ciri_long_tpu_torch',
                                    'ciri_long_tpu_torch.*']),
    # the PyTorch/CUDA port builds its kernels from these at first use
    package_data={'ciri_long_tpu_torch': ['csrc/*.cu']},
    ext_modules=[fastxcodec, chaincore, nwcore, poacore, alncore, ccscore],
    python_requires='>=3.10',
    install_requires=[
        'jax',
        'numpy',
    ],
    entry_points={
        'console_scripts': [
            'CIRI-long-tpu=ciri_long_tpu.cli.main:main',
            'CIRI-long-torch=ciri_long_tpu_torch.cli.main:main',
        ],
    },
)
