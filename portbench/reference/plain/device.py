"""Device selection for the port's entry points, and cached device
constants."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a missing card is an error, never a
    silent fall back to the CPU. Pass ``"cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


@functools.lru_cache(maxsize=None)
def _const(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` for a Python
    number or a (nested) tuple of them, made once per (values, dtype,
    device) and shared by every caller, who must not write to it. A
    per-call `torch.tensor` on the card is a blocking host-to-device copy,
    which a CUDA graph's capture refuses."""
    return _const(values, dtype, torch.device("cpu" if device is None else device))
