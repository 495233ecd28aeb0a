"""Landing CNN actor-critic.

Counterpart of `landing/networks.py` in the JAX package (the reference's
`rl_nn_model_v2`, visual_landing/rl_nn_model_v2.py:62-246):

  conv trunk: 3->64 k8 s4, 64->128 k4 s2, 128->128 k3 s1 (all VALID, tanh),
              flatten 128*7*7 -> fc 768 tanh
  actor:  concat(conv(image), sens 75) -> fc 768 tanh -> fc 3 tanh
  critic: concat(conv(image), sens, action 3) -> fc 768 tanh -> fc 1
  one learned scalar log_std (kept float32), separate actor and critic
  trunks; or, with ``conv_3d``, the stacked-frame 3D-conv trunk.

Layouts. Images here are NCHW (B, 3, 84, 84), the render kernel's output;
the convolutions are `torch.nn.functional.conv2d` (cuDNN on the card).
The JAX package works in NHWC with flax HWIO kernels and flattens the
7x7x128 map in (h, w, c) order, so `from_flax` moves conv kernels to OIHW
and permutes the 6272 input rows of each trunk's Dense from (h, w, c) to
the (c, h, w) order of an NCHW flatten; `to_flax` undoes both. The
space-to-depth first conv folds each 4x4 pixel block into 48 channels in
(p1 p2 c) order.

Compute dtype. ``conv_dtype=torch.bfloat16`` runs both trunks and the
heads in bf16, as flax's ``dtype`` does: the parameters stay float32 and
are cast at each layer, so Adam updates the float32 masters; the callers
take the outputs to float32 for the loss math. ``log_std`` stays a float32
parameter (JAX landing/networks.py:199-209: a bf16 log(0.1) swallowed every
lr=2e-5 Adam step, the round-5 frozen std).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
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


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _conv(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    op = F.conv3d if isinstance(conv, nn.Conv3d) else F.conv2d
    return op(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype), conv.stride,
              conv.padding)


def _load_dense(dense: nn.Linear, p: dict, lead: tuple) -> None:
    """A flax Dense whose input rows are a channels-last flatten of a map of
    spatial shape ``lead``, into ``dense`` with the channels-first rows."""
    k = np.asarray(p["kernel"], np.float32)
    c = k.shape[0] // math.prod(lead)
    k = k.reshape(lead + (c, -1))
    k = k.transpose((len(lead),) + tuple(range(len(lead))) + (len(lead) + 1,))
    dense.weight.copy_(torch.from_numpy(np.ascontiguousarray(k.reshape(-1, k.shape[-1]).T)))
    dense.bias.copy_(torch.from_numpy(np.asarray(p["bias"], np.float32).copy()))


def _dense_flax(dense: nn.Linear, lead: tuple) -> dict:
    """Inverse of `_load_dense`."""
    w = dense.weight.detach().cpu().numpy()            # (out, c * prod(lead))
    c = w.shape[1] // math.prod(lead)
    k = w.T.reshape((c,) + lead + (-1,))
    k = k.transpose(tuple(range(1, len(lead) + 1)) + (0, len(lead) + 1))
    return {"kernel": np.ascontiguousarray(k.reshape(-1, k.shape[-1])),
            "bias": dense.bias.detach().cpu().numpy().copy()}


def _load_conv(conv: nn.Module, p: dict, name: str) -> None:
    """A flax Conv kernel (spatial..., I, O) into ``conv`` (O, I, spatial...)."""
    k = np.asarray(p["kernel"], np.float32)
    w = k.transpose((k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2)))
    if w.shape != tuple(conv.weight.shape):
        raise ValueError(f"{name}: kernel {k.shape} does not fit {tuple(conv.weight.shape)}")
    conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
    conv.bias.copy_(torch.from_numpy(np.asarray(p["bias"], np.float32).copy()))


def _conv_flax(conv: nn.Module) -> dict:
    """Inverse of `_load_conv`."""
    w = conv.weight.detach().cpu().numpy()
    k = w.transpose(tuple(range(2, w.ndim)) + (1, 0))
    return {"kernel": np.ascontiguousarray(k), "bias": conv.bias.detach().cpu().numpy().copy()}


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

    def forward(self, img: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = space_to_depth(img) if self.space_to_depth else img
        for conv in (self.conv0, self.conv1, self.conv2):
            x = torch.tanh(_conv(conv, x, dtype))
        return torch.tanh(_linear(self.dense, x.flatten(1), dtype))  # (c, h, w) flatten

    def load_flax(self, p: dict) -> None:
        """Copy a flax ConvTrunk subtree (numpy leaves) into this trunk."""
        with torch.no_grad():
            for conv, name in ((self.conv0, "Conv_0"), (self.conv1, "Conv_1"),
                               (self.conv2, "Conv_2")):
                _load_conv(conv, p[name], name)
            _load_dense(self.dense, p["Dense_0"], (7, 7))

    def to_flax(self) -> dict:
        p = {name: _conv_flax(conv) for conv, name in (
            (self.conv0, "Conv_0"), (self.conv1, "Conv_1"), (self.conv2, "Conv_2"))}
        p["Dense_0"] = _dense_flax(self.dense, (7, 7))
        return p


class ConvTrunk3D(nn.Module):
    """Stacked-frame 3D-conv trunk (JAX landing/networks.py:69-96; the
    reference's conv3D_forward, rl_nn_model_v2.py:98-127, off by default
    there): (B, T, 3, H, W) frames -> (B, 768) through Conv3D(60, k=(2,3,3),
    spatial padding 1) -> tanh -> avgpool (1,3,3) -> Conv3D(120, k=(2,3,3))
    -> tanh -> avgpool (2,3,3) -> fc 768 tanh. The fc width follows from
    ``frames``, ``height`` and ``width``, as flax infers it from the
    flatten (the reference hardcodes a width its own trace contradicts)."""

    def __init__(self, frames: int = 5, height: int = 84, width: int = 84, channels: int = 3):
        super().__init__()
        self.conv0 = nn.Conv3d(channels, 60, (2, 3, 3), padding=(0, 1, 1))
        self.conv1 = nn.Conv3d(60, 120, (2, 3, 3), padding=(0, 1, 1))
        pool = lambda n, k: (n - k) // k + 1
        t, h, w = frames - 1, pool(height, 3), pool(width, 3)
        self.map_shape = (pool(t - 1, 2), pool(h, 3), pool(w, 3))  # (T', H', W')
        self.dense = nn.Linear(120 * math.prod(self.map_shape), TRUNK_OUT)
        for m in (self.conv0, self.conv1, self.dense):
            _orthogonal(m, math.sqrt(2.0))

    def forward(self, frames: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = frames.transpose(1, 2)  # (B, C, T, H, W)
        x = F.avg_pool3d(torch.tanh(_conv(self.conv0, x, dtype)), (1, 3, 3))
        x = F.avg_pool3d(torch.tanh(_conv(self.conv1, x, dtype)), (2, 3, 3))
        return torch.tanh(_linear(self.dense, x.flatten(1), dtype))  # (c, t, h, w) flatten

    def load_flax(self, p: dict) -> None:
        with torch.no_grad():
            _load_conv(self.conv0, p["Conv_0"], "Conv_0")
            _load_conv(self.conv1, p["Conv_1"], "Conv_1")
            _load_dense(self.dense, p["Dense_0"], self.map_shape)

    def to_flax(self) -> dict:
        return {"Conv_0": _conv_flax(self.conv0), "Conv_1": _conv_flax(self.conv1),
                "Dense_0": _dense_flax(self.dense, self.map_shape)}


class ImageHistory:
    """Fixed-depth image ring buffer of the stacked-frame variant (JAX
    landing/networks.py:99-116, reference image_roll rl_worker.py:190-205),
    batched: (B, depth, 3, H, W), newest frame at index 0."""

    @staticmethod
    def init(n: int, depth: int, h: int = 84, w: int = 84, c: int = 3,
             dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros(n, depth, c, h, w, dtype=dtype, device=device)

    @staticmethod
    def push(buf: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
        return torch.cat([frame[:, None], buf[:, :-1]], dim=1)

    @staticmethod
    def select(buf: torch.Tensor, times=(6, 5, 2, 1, 0)) -> torch.Tensor:
        """The reference's T_visual_time frame selection (rl_worker.py:29)."""
        return buf[:, list(times)]


def _orthogonal(m: nn.Module, gain: float) -> None:
    """flax's `orthogonal(gain)` kernel init (on the flattened fan-in) and
    zero bias."""
    nn.init.orthogonal_(m.weight, gain)
    nn.init.zeros_(m.bias)


HEADS = ("actor_fc1", "actor_out", "critic_fc1", "critic_out")


class LandingActorCritic(nn.Module):
    """(image (B, 3, 84, 84), or frames (B, T, 3, 84, 84) with ``conv_3d``;
    sens (B, 75)) -> (action mean (B, 3), value (B,), log_std), the first
    two in ``conv_dtype``. ``log_std`` is a float32 parameter that dtype
    changes of the module leave float32 (the JAX package's round-5
    frozen-std fault: a bf16 log(0.1) swallows every small Adam step)."""

    def __init__(self, action_std: float = 0.1, conv_s2d: bool = False,
                 conv_dtype: torch.dtype = torch.float32, conv_3d: bool = False,
                 frames: int = 5):
        super().__init__()
        self.conv_s2d, self.conv_3d, self.conv_dtype = conv_s2d, conv_3d, conv_dtype
        trunk = (lambda: ConvTrunk3D(frames)) if conv_3d else (lambda: ConvTrunk(conv_s2d))
        self.conv_ac = trunk()
        self.conv_ct = trunk()
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
        dt = self.conv_dtype
        x = torch.cat([self.conv_ac(image, dt), sens.to(dt)], dim=-1)
        x = torch.tanh(_linear(self.actor_fc1, x, dt))
        return torch.tanh(_linear(self.actor_out, x, dt))

    def critic(self, image: torch.Tensor, sens: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        dt = self.conv_dtype
        x = torch.cat([self.conv_ct(image, dt), sens.to(dt), action.to(dt)], dim=-1)
        x = torch.tanh(_linear(self.critic_fc1, x, dt))
        return _linear(self.critic_out, x, dt).squeeze(-1)

    def forward(self, image, sens, action=None):
        mean = self.actor(image, sens)
        value = self.critic(image, sens, mean if action is None else action)
        return mean, value, self.log_std

    @classmethod
    def from_flax(cls, params: dict, action_std: float = 0.1,
                  conv_dtype: torch.dtype = torch.float32) -> "LandingActorCritic":
        """Build from a flax param tree of numpy arrays (`load_params`
        output), on the CPU; the trunk (plain, space-to-depth, or 3D
        over 5 frames) is read from the stored first kernel's shape."""
        p = params["params"]
        k0 = np.asarray(p["conv_ac"]["Conv_0"]["kernel"])
        model = cls(action_std=action_std, conv_s2d=k0.shape[:2] == (2, 2) and k0.ndim == 4,
                    conv_dtype=conv_dtype, conv_3d=k0.ndim == 5)
        model.conv_ac.load_flax(p["conv_ac"])
        model.conv_ct.load_flax(p["conv_ct"])
        with torch.no_grad():
            for name in HEADS:
                layer = getattr(model, name)
                kernel = np.asarray(p[name]["kernel"], np.float32)
                if kernel.T.shape != tuple(layer.weight.shape):
                    raise ValueError(f"{name}: kernel {kernel.shape} does not fit {tuple(layer.weight.shape)}")
                layer.weight.copy_(torch.from_numpy(np.array(kernel.T)))
                layer.bias.copy_(torch.from_numpy(np.asarray(p[name]["bias"], np.float32).copy()))
            model.log_std.fill_(float(np.asarray(p["log_std"], np.float32)))
        return model


def to_flax(model: LandingActorCritic) -> dict:
    """The inverse of `LandingActorCritic.from_flax`: the flax param tree of
    float32 numpy arrays (conv kernels HWIO, each trunk's Dense rows in
    the channels-last flatten order, head kernels (in, out), a 0-d
    ``log_std``), in the layout the model has (plain or space-to-depth),
    for `utils.checkpoint.save_params`."""
    p = {"conv_ac": model.conv_ac.to_flax(), "conv_ct": model.conv_ct.to_flax()}
    for name in HEADS:
        layer = getattr(model, name)
        p[name] = {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
                   "bias": layer.bias.detach().cpu().numpy().copy()}
    p["log_std"] = model.log_std.detach().cpu().numpy().copy()
    return {"params": p}


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
