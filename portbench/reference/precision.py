"""How a reference multiplies: in the precision the configuration states,
or, for the control, in the nearest precision below it."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuBLAS and cuDNN float32 products in TF32 while ``enabled``; plain
    float32 otherwise."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _Fp8Round(torch.autograd.Function):
    """x rounded to float8 e4m3 under a per-tensor scale (amax to the format's
    largest value), back in x's dtype; the gradient passes straight through,
    as it does through a quantized product's operands."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
        q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
        return q.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Round.apply(x)
