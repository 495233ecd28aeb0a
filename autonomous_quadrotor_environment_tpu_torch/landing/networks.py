"""Landing CNN actor-critic.

Counterpart of `landing/networks.py` in the JAX package (the reference's
`rl_nn_model_v2`, visual_landing/rl_nn_model_v2.py:62-246):

  conv trunk: 3->64 k8 s4, 64->128 k4 s2, 128->128 k3 s1 (all VALID, tanh),
              flatten 128*7*7 -> fc 768 tanh
  actor:  concat(conv(image), sens 75) -> fc 768 tanh -> fc 3 tanh
  critic: concat(conv(image), sens, action 3) -> fc 768 tanh -> fc 1
  one learned scalar log_std (kept float32), separate actor and critic
  trunks.

Layouts. Images here are NCHW (B, 3, 84, 84), the render kernel's output;
the convolutions are `torch.nn.functional.conv2d` (cuDNN on the card).
The JAX package works in NHWC with flax HWIO kernels and flattens the
7x7x128 map in (h, w, c) order, so `from_flax` moves conv kernels to OIHW
and permutes the 6272 input rows of each trunk's Dense from (h, w, c) to
the (c, h, w) order of an NCHW flatten. The space-to-depth first conv
folds each 4x4 pixel block into 48 channels in (p1 p2 c) order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..utils.checkpoint import read_msgpack

TRUNK_OUT = 768
SENS = 75
ACT = 3


def space_to_depth(img: torch.Tensor, block: int = 4) -> torch.Tensor:
    """(B, C, H, W) -> (B, block*block*C, H/block, W/block), channels in
    (p1 p2 c) order: the einops pattern
    ``(h p1) (w p2) c -> h w (p1 p2 c)`` of the JAX package, in NCHW."""
    b, c, h, w = img.shape
    x = img.reshape(b, c, h // block, block, w // block, block)  # b c h p1 w p2
    x = x.permute(0, 3, 5, 1, 2, 4)                               # b p1 p2 c h w
    return x.reshape(b, block * block * c, h // block, w // block)


class ConvTrunk(nn.Module):
    """(B, 3, 84, 84) -> (B, 768). ``space_to_depth`` folds 4x4 pixel blocks
    into channels first, so the 8x8/stride-4 conv becomes a 2x2/stride-1
    conv on 48 channels (the same function under a fixed permutation of
    the kernel)."""

    def __init__(self, space_to_depth: bool = False):
        super().__init__()
        self.space_to_depth = space_to_depth
        if space_to_depth:
            self.conv0 = nn.Conv2d(48, 64, 2, stride=1)
        else:
            self.conv0 = nn.Conv2d(3, 64, 8, stride=4)
        self.conv1 = nn.Conv2d(64, 128, 4, stride=2)
        self.conv2 = nn.Conv2d(128, 128, 3, stride=1)
        self.dense = nn.Linear(128 * 7 * 7, TRUNK_OUT)
        for m in (self.conv0, self.conv1, self.conv2, self.dense):
            _orthogonal(m, math.sqrt(2.0))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = space_to_depth(img) if self.space_to_depth else img
        x = torch.tanh(self.conv0(x))
        x = torch.tanh(self.conv1(x))
        x = torch.tanh(self.conv2(x))
        return torch.tanh(self.dense(x.flatten(1)))  # (c, h, w) flatten

    def load_flax(self, p: dict) -> None:
        """Copy a flax ConvTrunk subtree (numpy leaves) into this trunk."""
        with torch.no_grad():
            for conv, name in ((self.conv0, "Conv_0"), (self.conv1, "Conv_1"), (self.conv2, "Conv_2")):
                w = np.asarray(p[name]["kernel"], np.float32).transpose(3, 2, 0, 1)  # HWIO -> OIHW
                if w.shape != tuple(conv.weight.shape):
                    raise ValueError(f"{name}: kernel {w.shape} (OIHW) does not fit {tuple(conv.weight.shape)}")
                conv.weight.copy_(torch.from_numpy(np.array(w)))
                conv.bias.copy_(torch.from_numpy(np.asarray(p[name]["bias"], np.float32).copy()))
            k = np.asarray(p["Dense_0"]["kernel"], np.float32)  # (7*7*128, 768), rows (h, w, c)
            c = self.conv2.out_channels
            hw = int(round(math.sqrt(k.shape[0] // c)))
            k = k.reshape(hw, hw, c, -1).transpose(2, 0, 1, 3).reshape(k.shape[0], -1)
            self.dense.weight.copy_(torch.from_numpy(np.array(k.T)))
            self.dense.bias.copy_(torch.from_numpy(np.asarray(p["Dense_0"]["bias"], np.float32).copy()))


def _orthogonal(m: nn.Module, gain: float) -> None:
    """flax's `orthogonal(gain)` kernel init (on the flattened fan-in) and
    zero bias."""
    nn.init.orthogonal_(m.weight, gain)
    nn.init.zeros_(m.bias)


class LandingActorCritic(nn.Module):
    """(image (B, 3, 84, 84), sens (B, 75)) -> (action mean (B, 3), value
    (B,), log_std). ``log_std`` is a float32 parameter that dtype changes
    of the module leave float32 (the JAX package's round-5 frozen-std
    fault: a bf16 log(0.1) swallows every small Adam step)."""

    def __init__(self, action_std: float = 0.1, conv_s2d: bool = False):
        super().__init__()
        self.conv_s2d = conv_s2d
        self.conv_ac = ConvTrunk(space_to_depth=conv_s2d)
        self.conv_ct = ConvTrunk(space_to_depth=conv_s2d)
        self.actor_fc1 = nn.Linear(TRUNK_OUT + SENS, TRUNK_OUT)
        self.actor_out = nn.Linear(TRUNK_OUT, ACT)
        self.critic_fc1 = nn.Linear(TRUNK_OUT + SENS + ACT, TRUNK_OUT)
        self.critic_out = nn.Linear(TRUNK_OUT, 1)
        for m, gain in ((self.actor_fc1, math.sqrt(2.0)), (self.actor_out, 0.01),
                        (self.critic_fc1, math.sqrt(2.0)), (self.critic_out, 1.0)):
            _orthogonal(m, gain)
        self.log_std = nn.Parameter(torch.tensor(math.log(action_std), dtype=torch.float32))

    def _apply(self, fn, recurse=True):
        """Device moves reach ``log_std``; dtype changes do not."""
        log_std = self._parameters.pop("log_std")
        try:
            super()._apply(fn, recurse)
        finally:
            self._parameters["log_std"] = log_std
        log_std.data = log_std.data.to(self.actor_out.weight.device)
        return self

    def actor(self, image: torch.Tensor, sens: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.conv_ac(image), sens.to(image.dtype)], dim=-1)
        x = torch.tanh(self.actor_fc1(x))
        return torch.tanh(self.actor_out(x))

    def critic(self, image: torch.Tensor, sens: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([self.conv_ct(image), sens.to(image.dtype), action.to(image.dtype)], dim=-1)
        x = torch.tanh(self.critic_fc1(x))
        return self.critic_out(x).squeeze(-1)

    def forward(self, image, sens, action=None):
        mean = self.actor(image, sens)
        value = self.critic(image, sens, mean if action is None else action)
        return mean, value, self.log_std

    @classmethod
    def from_flax(cls, params: dict, action_std: float = 0.1) -> "LandingActorCritic":
        """Build from a flax param tree of numpy arrays (`load_params`
        output), on the CPU; the first-conv layout (plain or space-to-depth)
        is read from the stored kernel's shape."""
        p = params["params"]
        s2d = np.asarray(p["conv_ac"]["Conv_0"]["kernel"]).shape[:2] == (2, 2)
        model = cls(action_std=action_std, conv_s2d=s2d)
        model.conv_ac.load_flax(p["conv_ac"])
        model.conv_ct.load_flax(p["conv_ct"])
        with torch.no_grad():
            for name in ("actor_fc1", "actor_out", "critic_fc1", "critic_out"):
                layer = getattr(model, name)
                kernel = np.asarray(p[name]["kernel"], np.float32)
                if kernel.T.shape != tuple(layer.weight.shape):
                    raise ValueError(f"{name}: kernel {kernel.shape} does not fit {tuple(layer.weight.shape)}")
                layer.weight.copy_(torch.from_numpy(np.array(kernel.T)))
                layer.bias.copy_(torch.from_numpy(np.asarray(p[name]["bias"], np.float32).copy()))
            model.log_std.fill_(float(np.asarray(p["log_std"], np.float32)))
        return model


def detect_s2d(path: str) -> bool:
    """Does a saved LandingActorCritic checkpoint use the space-to-depth
    first-conv layout? Read from the stored first-conv kernel's shape,
    (2, 2, 48, 64) against (8, 8, 3, 64), through the port's own msgpack
    reader."""
    with open(path, "rb") as f:
        tree = read_msgpack(f.read())
    return np.asarray(tree["params"]["conv_ac"]["Conv_0"]["kernel"]).shape[:2] == (2, 2)


def _copy(d):
    """Dict deep copy that keeps array leaves by reference."""
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in d.items()}


def params_to_s2d(params: dict) -> dict:
    """Plain-ConvTrunk flax params -> the space-to-depth layout: each (8, 8,
    3, 64) first-conv kernel becomes (2, 2, 48, 64) under the fixed block
    permutation ``(di p1) (dj p2) c o -> di dj (p1 p2 c) o``."""
    out = _copy(params)
    for trunk in ("conv_ac", "conv_ct"):
        k = np.asarray(out["params"][trunk]["Conv_0"]["kernel"])
        kh, kw, c, o = k.shape
        k = k.reshape(kh // 4, 4, kw // 4, 4, c, o).transpose(0, 2, 1, 3, 4, 5)
        out["params"][trunk]["Conv_0"]["kernel"] = np.ascontiguousarray(
            k.reshape(kh // 4, kw // 4, 16 * c, o)
        )
    return out


def params_from_s2d(params: dict) -> dict:
    """Inverse of `params_to_s2d`: (2, 2, 48, 64) -> (8, 8, 3, 64)."""
    out = _copy(params)
    for trunk in ("conv_ac", "conv_ct"):
        k = np.asarray(out["params"][trunk]["Conv_0"]["kernel"])
        dh, dw, pc, o = k.shape
        k = k.reshape(dh, dw, 4, 4, pc // 16, o).transpose(0, 2, 1, 3, 4, 5)
        out["params"][trunk]["Conv_0"]["kernel"] = np.ascontiguousarray(
            k.reshape(dh * 4, dw * 4, pc // 16, o)
        )
    return out
