"""ctypes bindings for the native host-side preview renderer.

Counterpart of `native/` in the JAX package: ``preview.cpp`` (g++, no
external dependencies) is built at first use into the port's build
directory (`ops/_build.BUILD_DIR`, which `utils.cache.enable_compilation_cache`
sets), named by a hash of the source and flags. `preview_available()` gates
callers so that no training path depends on it: it exists for humans
(manual flight, replays), the role Panda3D played in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..ops import _build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "preview.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
_lib = None

_D = ctypes.POINTER(ctypes.c_double)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read()).hexdigest()[:16]
    return os.path.join(_build.BUILD_DIR, f"libpreview-{digest}.so")


def _build_lib(path: str) -> bool:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)  # atomic: a concurrent builder sees all or nothing
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = _lib_path()
    if not os.path.exists(path) and not _build_lib(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.render_preview.argtypes = [_D, _D, _D, ctypes.c_int, ctypes.c_int, _U8]
    lib.render_trajectory.argtypes = [_D, ctypes.c_int, _D, _D, ctypes.c_int, ctypes.c_int,
                                      _U8]
    _lib = lib
    return lib


def preview_available() -> bool:
    return _load() is not None


def _f64(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float64)


def render_preview(
    quad_state: np.ndarray,
    marker_xy=(0.0, 0.0),
    cam_offset=(3.0, 3.0, 2.0),
    width: int = 640,
    height: int = 480,
) -> np.ndarray:
    """One chase-cam frame, (H, W, 3) uint8."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the preview library is unavailable (g++ failed?)")
    state, marker, off = _f64(quad_state), _f64(marker_xy), _f64(cam_offset)
    img = np.zeros((height, width, 3), np.uint8)
    lib.render_preview(state.ctypes.data_as(_D), marker.ctypes.data_as(_D),
                       off.ctypes.data_as(_D), width, height, img.ctypes.data_as(_U8))
    return img


def render_trajectory(
    states: np.ndarray,
    marker_xy=(0.0, 0.0),
    cam_offset=(3.0, 3.0, 2.0),
    width: int = 640,
    height: int = 480,
) -> np.ndarray:
    """(T, 13) states -> (T, H, W, 3) uint8 frames, one ctypes crossing."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the preview library is unavailable (g++ failed?)")
    states, marker, off = _f64(states), _f64(marker_xy), _f64(cam_offset)
    imgs = np.zeros((states.shape[0], height, width, 3), np.uint8)
    lib.render_trajectory(states.ctypes.data_as(_D), states.shape[0],
                          marker.ctypes.data_as(_D), off.ctypes.data_as(_D), width, height,
                          imgs.ctypes.data_as(_U8))
    return imgs


def save_ppm(path: str, img: np.ndarray) -> None:
    """Dependency-free frame dump."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6 {w} {h} 255\n".encode())
        f.write(img.tobytes())
