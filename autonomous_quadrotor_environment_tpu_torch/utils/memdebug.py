"""Device-memory introspection.

Counterpart of `utils/memdebug.py` in the JAX package (the reference's
GPU-leak helper, visual_landing/memory_leak.py:4-13, which counts live
torch tensors via gc): the CUDA caching allocator's stats and a census of
the live tensors.
"""

from __future__ import annotations

import gc

import torch


def device_memory_stats(device=None) -> dict:
    """Allocator stats for one CUDA device (bytes in use, peak, reserved, and
    the rest of `torch.cuda.memory_stats`); an empty dict without a card or
    for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(dev))


def live_array_summary() -> dict:
    """Count and total size of the live tensors that the garbage collector
    tracks: the reference's torch-tensor census (memory_leak.py:8-13)."""
    count = total = 0
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which some
        # module proxies answer with a deprecation warning
        if issubclass(type(obj), torch.Tensor):
            count += 1
            total += obj.numel() * obj.element_size()
    return {"count": count, "bytes": int(total)}
