"""pb_chime5_tpu_torch — the PyTorch / CUDA port of ``pb_chime5_tpu``.

The JAX package beside it is the reference.  This package mirrors its
module paths and public function names (``ops/stft.py``, ``ops/wpe.py``,
``ops/cacgmm.py``, ``models/gss.py``, ...) and keeps its tensor layouts at
the public functions: ``(F, D, T)`` through WPE and the beamformer,
``(F, T, D)`` into the EM, masks ``(K, T, F)`` out.

It imports ``torch``, never ``jax``, and nothing of the JAX package: its
host layer (``mapping``, ``io``, ``utils``, ``math``, ``activity``,
``database``, ``visualization``, ``testing``) is its own copy of the JAX
package's, so the port runs where only it is installed.  The TPU kernels'
counterparts are hand-written CUDA kernels (``csrc/*.cu``) built with
``nvcc`` at first use; every other stage is plain PyTorch.
"""

from pathlib import Path

from pb_chime5_tpu_torch import _device  # noqa: F401  (pins precision)

__version__ = '0.1.0'

package_root = Path(__file__).parent
repo_root = package_root.parent
