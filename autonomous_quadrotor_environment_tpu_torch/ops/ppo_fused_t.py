"""PPO minibatch loss and weight gradients on the transposed batch.

Counterpart of `ops/ppo_fused_t.py:fused_ppo_grad_t` in the JAX package.
`fused_ppo_grad_t` computes, over the minibatch's row blocks of the rollout
kernel's (T, features, B) output, the clipped-surrogate + value loss of
`agents.ppo.ppo_loss` and the gradients of all 12 ActorCritic leaves:

* on CUDA tensors, as one launch of the hand-written kernel in
  `csrc/ppo_fused_t.cu` (plus its fixed-order reduction pass), built per
  instantiation (`library`: a hidden width of 32, 64 or 128 that a
  narrower model runs zero-padded on, the obs width, f32 or bf16
  products; the rest of the layout the header derives); a model wider than
  128, of any width, on `csrc/ppo_wide_t.cu` (`csrc/ppo_grad_wide.cuh`:
  tiled products over super-chunks of rows, its width read at run time),
  built per obs width and precision;
* on CPU tensors, as `ppo_grad_t_plain`: the rows gathered by block id and
  `torch.autograd` of `ppo_loss` on them, which is also the reference the
  kernel is held against on the card.

A block is ``tile`` consecutive envs at one timestep (any tile that divides
B); block id p is timestep ``p // (B // tile)`` and envs ``(p % (B //
tile)) * tile`` onward.
aux rows are [action(4), old logprob sum, return, advantage, 0].

Gradients come back in `nn.Linear`'s own layout, kernels (out, in) and
biases (out,), so they go straight into ``.grad``; the JAX wrapper's
transpose back to flax's (in, out) has no counterpart here. Entropy is
constant under the fixed std: it adds to the loss and the metrics outside
the kernel, as in the JAX wrapper.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .rollout_fused import (
    ACT,
    OBS,
    WIDE_STEP,
    _check,
    check_offsets,
    device_buffer,
    kernel_width,
    pack_offsets,
    transpose_leaves,
    weight_pack,
)

CHUNK = 64      # rows per chunk in the gradient kernels
COMPUTE = ("f32", "bf16")
# Widths from WIDE_FROM up run on the wide design (`csrc/ppo_grad_wide.cuh`),
# narrower ones on the per-width instantiations (`csrc/ppo_grad.cuh`): at
# 256 the wide design took B2 13.90 ms at bench.py's minibatch against the
# 256 instantiation's 37.26 ms (`chip_smoke.py` kernel_options on an NVIDIA
# H100 80GB HBM3 at 700 W; PERF.md, kernel table).
WIDE_FROM = 129
# The library's `ppo_grad_config` entries, in order.
CONFIG = ("H", "OBS", "BF16", "K1", "NS", "resident", "smem_bytes", "wide")
_LOG_2PI = math.log(2.0 * math.pi)


def is_wide(hidden: int) -> bool:
    """Whether a model of ``hidden`` units runs on the wide gradient
    kernels."""
    return hidden >= WIDE_FROM


def kernel_depth(hidden: int, obs: int) -> int:
    """The input depth K1 of the weight pack's W1: ``obs`` padded to 16, or
    to 32 at the 32-wide instantiation (`csrc/ppo_grad.cuh`) and on the
    wide kernels (`csrc/ppo_grad_wide.cuh`)."""
    if is_wide(hidden):
        return -(-obs // 32) * 32
    quantum = 32 if kernel_width(hidden) == 32 else 16
    return -(-obs // quantum) * quantum


def entropy_const(action_std: float) -> float:
    """Summed per-dimension entropy of the fixed-std Gaussian head."""
    return ACT * (0.5 + 0.5 * _LOG_2PI + math.log(action_std))


def supports(obs_t: torch.Tensor, leaves: list, tile: int) -> bool:
    """What the kernel takes: any hidden width, any obs width, 4 actions,
    and env tiles that divide B. It computes under the fixed std it is
    given (the JAX gate sends a learned std to autograd), in f32 or bf16
    products."""
    _, obs_dim, b = obs_t.shape
    return (
        len(leaves) == 12
        and tuple(leaves[0].shape)[1] == obs_dim
        and tuple(leaves[4].shape)[0] == ACT
        and tile > 0
        and b % tile == 0
    )


def _leaves(model_or_leaves) -> list[torch.Tensor]:
    """12 leaves in flax leaf order: kernels (out, in), biases (out, 1)."""
    if isinstance(model_or_leaves, (list, tuple)):
        return list(model_or_leaves)
    return transpose_leaves(model_or_leaves)


def _gather_rows(x_t: torch.Tensor, perm: torch.Tensor, tile: int) -> torch.Tensor:
    """(T, F, B) and block ids -> the blocks' rows, (n_blocks * tile, F)."""
    blocks_per_t = x_t.shape[2] // tile
    perm = perm.long()
    t_ids = (perm // blocks_per_t)[:, None]
    cols = (perm % blocks_per_t)[:, None] * tile + torch.arange(tile, device=x_t.device)[None]
    return x_t[t_ids, :, cols].reshape(-1, x_t.shape[1])


def ppo_grad_t_plain(model_or_leaves, obs_t, aux_t, perm, *, tile: int,
                     action_std: float, clip_eps: float, entropy_coef: float,
                     compute_dtype: str = "f32"):
    """The plain PyTorch version: gather the minibatch's rows by block id and
    take `torch.autograd` of the port's `ppo_loss` on them (with bf16
    products under ``compute_dtype="bf16"``, see `grads_on_rows`). The mean
    over the rows scales the gradients by 1/mb, as the kernel does.

    It is an independent check of the kernel's hand-derived backward, and
    agrees with it everywhere except at ratio == 1 +- clip_eps exactly:
    there `torch.clamp`'s gradient is inclusive of the bounds while the
    kernel's (and `lax.clamp`'s) is strict.

    Returns ``(loss, metrics, grads)`` like `fused_ppo_grad_t`."""
    return grads_on_rows(model_or_leaves, _gather_rows(obs_t, perm, tile),
                         _gather_rows(aux_t, perm, tile), action_std=action_std,
                         clip_eps=clip_eps, entropy_coef=entropy_coef,
                         compute_dtype=compute_dtype)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 to nearest even, in x's own dtype (JAX's
    astype(bfloat16) for f32; a float64 copy of the plain version keeps its
    products and sums in float64)."""
    return x.to(torch.bfloat16).to(x.dtype)


class _Bf16Linear(torch.autograd.Function):
    """x W^T + b with every product on operands rounded to bf16 and summed in
    f32, the backward's too, as the JAX kernels form them (`_make_dots`):
    the output bf16(x) bf16(W)^T, the data gradient bf16(g) bf16(W), the
    weight gradient bf16(g)^T bf16(x); the bias and its gradient in f32. The
    rounded operands are multiplied as f32 tensors, so no product's result
    is rounded (a product of two bf16 values is exact in f32)."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = _bf16(x), _bf16(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.T + b

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = _bf16(g)
        return gr @ wr, gr.T @ xr, g.sum(0)


class _Bf16Forward:
    """``model``'s forward with bf16 products (`_Bf16Linear`), the tanh in
    f32: what `ppo_loss` calls as its model under ``compute_dtype="bf16"``."""

    def __init__(self, model):
        self.model = model

    def __call__(self, obs):
        a1, a2, a3, c1, c2, c3 = self.model.linears()

        def lin(layer, x):
            return _Bf16Linear.apply(x, layer.weight, layer.bias)

        mean = torch.tanh(lin(a3, torch.tanh(lin(a2, torch.tanh(lin(a1, obs))))))
        value = lin(c3, torch.tanh(lin(c2, torch.tanh(lin(c1, obs))))).squeeze(-1)
        if self.model.learn_std:
            return mean, value, self.model.log_std
        return mean, value, torch.tensor(math.log(self.model.action_std), dtype=torch.float32,
                                         device=obs.device)


def grads_on_rows(model_or_leaves, obs, aux, *, action_std: float, clip_eps: float,
                  entropy_coef: float, compute_dtype: str = "f32"):
    """`torch.autograd` of the port's `ppo_loss` on gathered rows, obs
    (mb, obs_dim) and aux (mb, 8): the plain versions' arithmetic. Under
    ``compute_dtype="bf16"`` every product of the forward and the backward
    takes operands rounded to bf16 and sums in f32 (`_Bf16Linear`); the
    tanh, the loss and the bias gradients stay f32. Returns ``(loss,
    metrics, grads)``, detached, the gradients in leaf order."""
    from ..agents.networks import ActorCritic
    from ..agents.ppo import ppo_loss
    from ..config import PPOConfig

    if compute_dtype not in COMPUTE:
        raise ValueError(f"compute_dtype must be one of {COMPUTE}, not {compute_dtype!r}")
    if isinstance(model_or_leaves, (list, tuple)):
        model = ActorCritic.from_leaves(model_or_leaves, action_std)
    else:
        model = model_or_leaves
    cfg = PPOConfig(clip_eps=clip_eps, entropy_coef=entropy_coef, action_std=action_std)
    params = [p for layer in model.linears() for p in (layer.weight, layer.bias)]
    forward = _Bf16Forward(model) if compute_dtype == "bf16" else model
    with torch.enable_grad():
        loss, metrics = ppo_loss(
            forward, obs, aux[:, 0:4], aux[:, 4:5], aux[:, 5], aux[:, 6], cfg
        )
        grads = torch.autograd.grad(loss, params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, list(grads)


def _leaf_shapes(hidden: int, n_act: int = ACT, obs: int = OBS) -> list[tuple]:
    return [
        (hidden, obs), (hidden,), (hidden, hidden), (hidden,), (n_act, hidden), (n_act,),
        (hidden, obs), (hidden,), (hidden, hidden), (hidden,), (1, hidden), (1,),
    ]


def _pack(leaves: list[torch.Tensor]) -> torch.Tensor:
    """The kernels' (2, PACK) weights for these leaves at their
    instantiation: per head W1 zero-padded to (H, K1), W2 to (H, H), W3 to
    (ACT, H), b1, b2, b3 padded (`rollout_fused.weight_pack`)."""
    hidden, obs = leaves[0].shape
    return weight_pack(leaves, kernel_width(hidden), kernel_depth(hidden, obs))


def check_fits(hidden: int, obs: int) -> None:
    """Raise, naming the bytes, where a model of ``hidden`` units with
    ``obs`` inputs has an array that the gradient kernels' 32-bit offsets
    cannot address: a head's weight pack, a head's partial of the workspace
    (`csrc/ppo_common.cuh:Layout`) or the flat output (both heads' 12
    leaves and 3 metrics; at about 2 hidden^2 floats the first to pass the
    limit, near 32,700 units)."""
    width, obs_p = kernel_width(hidden), -(-obs // 4) * 4
    check_offsets("weight pack a head", pack_offsets(width, kernel_depth(hidden, obs))["PACK"],
                  hidden)
    check_offsets("gradient partial a head",
                  width * obs_p + width * width + (ACT + 2) * width + ACT + 4, hidden)
    check_offsets("gradient output",
                  2 * (obs * hidden + 2 * hidden + hidden * hidden) + (ACT + 1) * hidden + ACT + 4,
                  hidden)


def check_leaves(leaves: list, device: torch.device, obs: int) -> None:
    """Raise unless ``leaves`` are 12 float32 leaves on ``device`` of one
    width with ``obs`` inputs whose arrays the gradient kernels address
    (`check_fits`)."""
    if len(leaves) != 12:
        raise ValueError("want the 12 ActorCritic leaves in flax leaf order")
    hidden = leaves[0].shape[0]
    check_fits(hidden, obs)
    for i, (w, shape) in enumerate(zip(leaves, _leaf_shapes(hidden, obs=obs))):
        if w.device != device or w.dtype != torch.float32 or w.numel() != math.prod(shape):
            raise ValueError(
                f"leaf {i}: want float32 {shape} on {device}, "
                f"got {w.dtype} {tuple(w.shape)} on {w.device}"
            )


def source(name: str, hidden: int) -> str:
    """The source of gradient kernel ``name`` ("ppo_fused_t" or
    "ppo_fused") that a model of ``hidden`` units runs on: itself, or from
    `WIDE_FROM` units its wide counterpart ("ppo_wide_t", "ppo_wide")."""
    return name.replace("ppo_fused", "ppo_wide") if is_wide(hidden) else name


def library(hidden: int, obs: int, compute_dtype: str) -> tuple:
    """The build's defines (`_build.build`) of the gradient libraries that a
    model of ``hidden`` units with ``obs`` inputs runs on in
    ``compute_dtype``: precision, width and obs width; the wide libraries
    take their width as an argument."""
    if compute_dtype not in COMPUTE:
        raise ValueError(f"compute_dtype must be one of {COMPUTE}, not {compute_dtype!r}")
    bf16 = ("BF16", int(compute_dtype == "bf16"))
    if is_wide(hidden):
        return bf16, ("OBS", obs)
    return bf16, ("H", kernel_width(hidden)), ("OBS", obs)


def load_lib(name: str, hidden: int, obs: int, compute_dtype: str):
    """The library of gradient kernel ``name`` (its `source` for this
    width) at the instantiation for this width, obs width and precision,
    its width and depth checked against the weight pack's (a wide library
    reports the multiple every width runs padded to, `WIDE_STEP`)."""
    defines = library(hidden, obs, compute_dtype)
    lib = _build.load(source(name, hidden), defines)
    got = [lib.ppo_grad_config(i) for i in range(4)]
    width = WIDE_STEP if is_wide(hidden) else kernel_width(hidden)
    want = [width, obs, defines[0][1], kernel_depth(hidden, obs)]
    if got != want:
        raise RuntimeError(f"the {name} library's instantiation {got} is not the wrapper's {want}")
    return lib


def instantiation(lib) -> dict:
    """A gradient library's instantiation as its header derived it
    (`ppo_grad_config`): width (on a wide library the multiple every width
    runs padded to), obs, bf16, depth K1, weight-gradient slices
    NS, whether W1 and W2 sit in shared memory, its shared memory in bytes,
    and whether the obs are too wide to stage (``wide``)."""
    return {k: lib.ppo_grad_config(i) for i, k in enumerate(CONFIG)}


def check_perm(perm: torch.Tensor, device: torch.device) -> None:
    if perm.dim() != 1 or perm.numel() < 1:
        raise ValueError("perm must be a non-empty 1-D tensor of block ids")
    _check("perm", perm, (perm.shape[0],), device, torch.int32)


def launch_buffers(lib, leaves: list, device: torch.device, mb: int):
    """What a gradient launch over ``mb`` rows needs beside its inputs: the
    (2, PACK) weight pack, the chunk walkers per head G and the workspace,
    both as the library sizes them (`ppo_grad_walkers`,
    `ppo_grad_work_floats`; on the wide design under 8 GB to about 31,600
    units, `csrc/ppo_grad_wide.cuh:walkers`). Where the card lacks the
    memory, an error names the bytes."""
    hidden = leaves[0].shape[0]
    pack = _pack(leaves)
    if pack.shape[1] != lib.ppo_grad_pack_floats(hidden):
        raise RuntimeError("weight pack size disagrees with the kernel's")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ctas = lib.ppo_grad_walkers(hidden, sms, mb)
    work = device_buffer(lib.ppo_grad_work_floats(hidden, mb, ctas), device,
                         "gradient workspace", hidden)
    return pack, ctas, work


def loss_consts(action_std: float, clip_eps: float, mb: int) -> tuple:
    """The kernels' loss constants: 1/std, the logprob's constant, the clip
    band's bounds and 1/mb."""
    log_std = math.log(action_std)
    return (1.0 / action_std, ACT * (log_std + 0.5 * _LOG_2PI),
            1.0 - clip_eps, 1.0 + clip_eps, 1.0 / mb)


def raise_on_error(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: error {err} ({msg})")


def split_out(out: torch.Tensor, hidden: int = 128, obs: int = OBS):
    """The kernels' flat output at the model's width -> the 12 gradients
    (views, leaf order, kernels (out, in), biases (out,)) and the actor sum,
    critic sum and ratio max."""
    grads, off = [], 0
    for shape in _leaf_shapes(hidden, obs=obs):
        size = math.prod(shape)
        grads.append(out[off:off + size].view(shape))
        off += size
    return grads, out[off], out[off + 1], out[off + 2]


def loss_and_metrics(actor_sum, critic_sum, rmax, mb: int, action_std: float,
                     entropy_coef: float):
    """The loss and metrics from the kernels' sums; entropy is the fixed
    std's constant, added here as the JAX wrappers add it."""
    entropy = entropy_const(action_std)
    loss = (actor_sum + critic_sum) / mb - entropy_coef * entropy
    metrics = {
        "actor_loss": actor_sum / mb,
        "critic_loss": critic_sum / mb,
        "entropy": torch.full((), entropy, dtype=torch.float32, device=actor_sum.device),
        "ratio_max": rmax,
    }
    return loss, metrics


def _launch(leaves, obs_t, aux_t, perm, tile, action_std, clip_eps, compute_dtype):
    device = obs_t.device
    steps, obs_dim, b = obs_t.shape
    _check("obs_t", obs_t, (steps, obs_dim, b), device)
    _check("aux_t", aux_t, (steps, 8, b), device)
    check_perm(perm, device)
    check_leaves(leaves, device, obs_dim)
    hidden = leaves[0].shape[0]
    n_blocks = perm.shape[0]
    mb = n_blocks * tile
    lib = load_lib("ppo_fused_t", hidden, obs_dim, compute_dtype)
    pack, ctas, work = launch_buffers(lib, leaves, device, mb)
    out = torch.empty(lib.ppo_grad_out_floats(hidden), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ppo_fused_t(
            obs_t.data_ptr(), aux_t.data_ptr(), perm.data_ptr(), pack.data_ptr(),
            work.data_ptr(), out.data_ptr(),
            steps, b, tile, n_blocks, ctas, *loss_consts(action_std, clip_eps, mb), hidden,
            device.index, stream,
        )
    raise_on_error(lib, err, "ppo_fused_t")
    fused_ppo_grad_t.launches += 1
    grads, actor_sum, critic_sum, rmax = split_out(out, hidden, obs_dim)
    return actor_sum, critic_sum, rmax, mb, grads


def fused_ppo_grad_t(model_or_leaves, obs_t: torch.Tensor, aux_t: torch.Tensor,
                     perm: torch.Tensor, *, tile: int, action_std: float,
                     clip_eps: float, entropy_coef: float, compute_dtype: str = "f32"):
    """Loss, metrics and the 12 gradients of one minibatch given as block
    ids: one kernel launch for CUDA tensors, the plain version for CPU
    tensors. ``compute_dtype`` is the products' precision,
    `PPOConfig.fused_compute`: "f32" (3xTF32 on the card) or "bf16".

    ``model_or_leaves`` is an `ActorCritic` or its 12 leaves in flax leaf
    order (kernels (out, in), biases (out, 1) or (out,)). Returns ``(loss,
    metrics, grads)``: 0-dim tensors, metrics ``actor_loss``,
    ``critic_loss``, ``entropy`` and ``ratio_max``, and the gradients in
    leaf order, kernels (out, in), biases (out,).
    `fused_ppo_grad_t.launches` counts the kernel launches."""
    if obs_t.device.type == "cpu":
        return ppo_grad_t_plain(
            model_or_leaves, obs_t, aux_t, perm, tile=tile, action_std=action_std,
            clip_eps=clip_eps, entropy_coef=entropy_coef, compute_dtype=compute_dtype,
        )
    if obs_t.device.type != "cuda":
        raise ValueError(f"fused_ppo_grad_t runs on CUDA or CPU tensors, not {obs_t.device}")
    leaves = _leaves(model_or_leaves)
    if not supports(obs_t, leaves, tile):
        raise ValueError(
            "the ppo_fused_t kernel takes 4 actions and a tile dividing B; got leaves "
            f"{[tuple(l.shape) for l in leaves[:1]]}, obs {tuple(obs_t.shape)}, tile {tile}"
        )
    actor_sum, critic_sum, rmax, mb, grads = _launch(
        leaves, obs_t, aux_t, perm, tile, action_std, clip_eps, compute_dtype
    )
    loss, metrics = loss_and_metrics(actor_sum, critic_sum, rmax, mb, action_std, entropy_coef)
    return loss, metrics, grads


fused_ppo_grad_t.launches = 0
