"""The build directory of the port's compiled code.

Counterpart of `utils/cache.py` in the JAX package, which points XLA's
persistent compilation cache at a directory so that repeated app runs
reuse compiled executables. The port's compiled code is its CUDA kernels
(`ops/_build.py`, nvcc at first use, named by a hash of their sources) and
the native preview renderer (`native/`); this points their build directory
at ``path``. Called by every CLI app at startup, as in the JAX package,
whose default directory the environment's ``AQE_TPU_CACHE`` names: here
``AQE_TORCH_BUILD_DIR`` does, and without it the build directory stays
``build/`` inside the package.
"""

from __future__ import annotations

import os

from ..ops import _build

DEFAULT_DIR = os.environ.get("AQE_TORCH_BUILD_DIR", _build.BUILD_DIR)


def enable_compilation_cache(path: str = DEFAULT_DIR) -> None:
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = path
