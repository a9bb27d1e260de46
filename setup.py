"""Build for pb_chime5_tpu.

Two packages: ``pb_chime5_tpu`` (JAX, the reference) and
``pb_chime5_tpu_torch`` (its PyTorch / CUDA port, whose CUDA and C++
sources under ``pb_chime5_tpu_torch/csrc/`` ship as package data and are
compiled at first use, with nvcc and the host compiler; it carries its own
copy of the corpus tables).

Native pieces (optional — everything has a pure-Python fallback):
  * pb_chime5_tpu.utils._interval_ops  — interval algebra (C++)
  * pb_chime5_tpu.io._wav_ops          — segmented WAV reader/writer (C++)

Build in place with:  python setup.py build_ext --inplace
"""

from setuptools import setup, Extension, find_packages

extensions = [
    Extension(
        'pb_chime5_tpu.utils._interval_ops',
        sources=['cpp/interval_ops.cpp'],
        extra_compile_args=['-O3', '-std=c++17'],
        optional=True,
    ),
    Extension(
        'pb_chime5_tpu.io._wav_ops',
        sources=['cpp/wav_ops.cpp'],
        extra_compile_args=['-O3', '-std=c++17'],
        optional=True,
    ),
]

setup(
    name='pb_chime5_tpu',
    version='0.1.0',
    description='TPU-native guided source separation front-end '
                '(CHiME-5/6 GSS)',
    packages=find_packages(include=['pb_chime5_tpu*']),
    package_data={'pb_chime5_tpu': ['data/*.json'],
                  'pb_chime5_tpu_torch': ['csrc/*.cu', 'csrc/*.cpp',
                                          'data/*.json']},
    ext_modules=extensions,
    python_requires='>=3.10',
)
