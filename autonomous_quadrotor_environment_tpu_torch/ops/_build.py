"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header (only the shared ``csrc/*.cuh``), so nvcc builds it in seconds. A
source is built once per instantiation: ``defines``, pairs such as
``(("H", 256), ("OBS", 75))``, become ``-DAQE_H=256 -DAQE_OBS=75`` (the
hidden width, obs width and precision the kernels are compiled for). The
shared library goes into ``build/`` inside the package, named by the
instantiation and a hash of the source, the headers and the defines, at
first use; nvcc's ``-Xptxas -v`` report (registers, shared memory, spills)
is kept beside it. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# ctypes signatures of each library's C entry points: every pointer and the
# stream as c_void_p, ints as c_int, floats as c_float; each returns the
# cudaError_t of its launches.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# obs, aux, perm, pack, work, out; n, tile, n_blocks, G; the 5 loss
# constants; the model's hidden width
_ROWS = [_P] * 6 + [_I] * 4 + [_F] * 5 + [_I]
SIGNATURES = {
    # s0, noise, pool, pack; obs, misc, s_final; B, T, P; consts, std,
    # logprob constant, device, stream
    "rollout_fused": {
        "rollout_fused": [_P] * 4 + [_P] * 3 + [_I] * 3 + [_P, _F, _F, _I, _P],
    },
    # the same, and the model's hidden width, the scratch and the card's SMs
    # before the device
    "rollout_wide": {
        "rollout_wide": [_P] * 4 + [_P] * 3 + [_I] * 3 + [_P, _F, _F, _I, _P, _I, _I, _P],
        "rollout_wide_scratch_floats": [_I] * 4,
    },
    "ppo_fused_t": {"ppo_fused_t": [_P] * 6 + [_I] * 5 + [_F] * 5 + [_I] + [_I, _P]},
    "ppo_fused": {
        "ppo_fused": _ROWS + [_I, _P],
        "ppo_fused_adam": _ROWS + [_P] + [_F] * 6 + [_I, _P],  # + the 36 leaves, Adam consts
    },
    # quad, marker, brightness, out; B, H, W; fx, fy, cx, cy, square,
    # half_w, half_h, ground_z
    "render_nadir": {"render_nadir": [_P] * 4 + [_I] * 3 + [_F] * 8 + [_I, _P],
                     "render_nadir_smem_bytes": [_I]},
}
# The wide gradient libraries take the narrow ones' arguments.
SIGNATURES["ppo_wide_t"] = {"ppo_fused_t": SIGNATURES["ppo_fused_t"]["ppo_fused_t"]}
SIGNATURES["ppo_wide"] = SIGNATURES["ppo_fused"]
# Size queries that do not return an int.
RESTYPES = {"ppo_grad_work_floats": ctypes.c_longlong,
            "rollout_wide_scratch_floats": ctypes.c_longlong}


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default: the toolkit's default
    install prefix)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")


def build(name: str, defines: tuple = ()) -> dict:
    """Compile ``csrc/<name>.cu`` with ``defines`` (pairs (key, value), each
    passed as ``-DAQE_<key>=<value>``) unless a library built from the same
    source and defines is already in ``build/``. Returns the library path,
    nvcc's wall seconds (0 when reused) and its output."""
    src = os.path.join(CSRC, f"{name}.cu")
    flags = [f"-DAQE_{k}={int(v)}" for k, v in defines]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + flags).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = "".join(f"-{k.lower()}{int(v)}" for k, v in defines)
    lib = os.path.join(BUILD_DIR, f"{name}{tag}-{digest}.so")
    log = lib[:-3] + ".log"
    if os.path.exists(lib) and os.path.exists(log):
        with open(log) as f:
            return {"path": lib, "seconds": 0.0, "cached": True, "log": f.read()}
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{out}")
    with open(log, "w") as f:
        f.write(out)
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return {"path": lib, "seconds": seconds, "cached": False, "log": out}


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load kernel library ``name`` at the
    instantiation ``defines`` (see `build`), with the argtypes of its entry
    points and of its ``cuda_error_string`` set."""
    lib = ctypes.CDLL(build(name, defines)["path"])
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for entry, restype in RESTYPES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).restype = restype
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib

