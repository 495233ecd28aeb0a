"""PPO minibatch loss and weight gradients on the transposed batch.

Counterpart of `ops/ppo_fused_t.py:fused_ppo_grad_t` in the JAX package.
`fused_ppo_grad_t` computes, over the minibatch's row blocks of the rollout
kernel's (T, features, B) output, the clipped-surrogate + value loss of
`agents.ppo.ppo_loss` and the gradients of all 12 ActorCritic leaves:

* on CUDA tensors, as one launch of the hand-written kernel in
  `csrc/ppo_fused_t.cu` (plus its fixed-order reduction pass);
* on CPU tensors, as `ppo_grad_t_plain`: the rows gathered by block id and
  `torch.autograd` of `ppo_loss` on them, which is also the reference the
  kernel is held against on the card.

A block is ``tile`` consecutive envs at one timestep; block id p is
timestep ``p // (B // tile)`` and envs ``(p % (B // tile)) * tile`` onward.
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
from .rollout_fused import _check, transpose_leaves

OBS = 75
HIDDEN = 128  # the one hidden width the kernel is built for
ACT = 4
TILE_STEP = 32  # a tile must be a multiple: the kernel loads 32-env halves of a chunk
CHUNK = 64      # rows per chunk in the gradient kernels
_LOG_2PI = math.log(2.0 * math.pi)

# One head's weight pack (floats), as `csrc/ppo_grad.cuh` declares it (P_*):
# W1 (out, in) with its inputs padded to K1 = 80, W2 (out, in), W3 padded
# to ACT rows, b1, b2, b3 padded to ACT.
K1 = 80
P_W1 = 0
P_W2 = P_W1 + HIDDEN * K1
P_W3 = P_W2 + HIDDEN * HIDDEN
P_B1 = P_W3 + ACT * HIDDEN
P_B2 = P_B1 + HIDDEN
P_B3 = P_B2 + HIDDEN
PACK = P_B3 + ACT


def entropy_const(action_std: float) -> float:
    """Summed per-dimension entropy of the fixed-std Gaussian head."""
    return ACT * (0.5 + 0.5 * _LOG_2PI + math.log(action_std))


def supports(obs_t: torch.Tensor, leaves: list, tile: int) -> bool:
    """What the kernel takes: hidden 128, 75-dim obs, 4 actions, and env
    tiles that divide B and are a multiple of 32. It computes in f32 under
    the fixed std it is given (`agents.ppo.make_train_step` refuses a
    learned std and bf16 products)."""
    _, obs_dim, b = obs_t.shape
    return (
        obs_dim == OBS
        and len(leaves) == 12
        and tuple(leaves[0].shape) == (HIDDEN, OBS)
        and tuple(leaves[4].shape)[0] == ACT
        and tile > 0
        and tile % TILE_STEP == 0
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
                     action_std: float, clip_eps: float, entropy_coef: float):
    """The plain PyTorch version: gather the minibatch's rows by block id and
    take `torch.autograd` of the port's `ppo_loss` on them. The mean over
    the rows scales the gradients by 1/mb, as the kernel does.

    It is an independent check of the kernel's hand-derived backward, and
    agrees with it everywhere except at ratio == 1 +- clip_eps exactly:
    there `torch.clamp`'s gradient is inclusive of the bounds while the
    kernel's (and `lax.clamp`'s) is strict.

    Returns ``(loss, metrics, grads)`` like `fused_ppo_grad_t`."""
    return grads_on_rows(model_or_leaves, _gather_rows(obs_t, perm, tile),
                         _gather_rows(aux_t, perm, tile), action_std=action_std,
                         clip_eps=clip_eps, entropy_coef=entropy_coef)


def grads_on_rows(model_or_leaves, obs, aux, *, action_std: float, clip_eps: float,
                  entropy_coef: float):
    """`torch.autograd` of the port's `ppo_loss` on gathered rows, obs
    (mb, 75) and aux (mb, 8): the plain versions' arithmetic. Returns
    ``(loss, metrics, grads)``, detached, the gradients in leaf order."""
    from ..agents.networks import ActorCritic
    from ..agents.ppo import ppo_loss
    from ..config import PPOConfig

    if isinstance(model_or_leaves, (list, tuple)):
        model = ActorCritic.from_leaves(model_or_leaves, action_std)
    else:
        model = model_or_leaves
    cfg = PPOConfig(clip_eps=clip_eps, entropy_coef=entropy_coef, action_std=action_std)
    params = [p for layer in model.linears() for p in (layer.weight, layer.bias)]
    with torch.enable_grad():
        loss, metrics = ppo_loss(
            model, obs, aux[:, 0:4], aux[:, 4:5], aux[:, 5], aux[:, 6], cfg
        )
        grads = torch.autograd.grad(loss, params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, list(grads)


def _leaf_shapes(hidden: int, n_act: int = ACT) -> list[tuple]:
    return [
        (hidden, OBS), (hidden,), (hidden, hidden), (hidden,), (n_act, hidden), (n_act,),
        (hidden, OBS), (hidden,), (hidden, hidden), (hidden,), (1, hidden), (1,),
    ]


def _pack(leaves: list[torch.Tensor]) -> torch.Tensor:
    """The kernels' (2, PACK) weights at the offsets P_*: per head W1 with
    its inputs padded to K1, W2, W3 padded to ACT rows, b1, b2, b3 padded."""
    pack = torch.zeros(2, PACK, dtype=torch.float32, device=leaves[0].device)
    for head, (w1, b1, w2, b2, w3, b3) in enumerate((leaves[:6], leaves[6:])):
        p = pack[head]
        p[P_W1:P_W2].view(HIDDEN, K1)[:, :OBS] = w1
        p[P_W2:P_W3] = w2.reshape(-1)
        p[P_W3:P_W3 + w3.numel()] = w3.reshape(-1)
        p[P_B1:P_B2] = b1.reshape(-1)
        p[P_B2:P_B3] = b2.reshape(-1)
        p[P_B3:P_B3 + b3.numel()] = b3.reshape(-1)
    return pack


def check_leaves(leaves: list, device: torch.device) -> None:
    """Raise unless ``leaves`` are the 12 float32 hidden-128 leaves on
    ``device`` that the gradient kernels take."""
    if len(leaves) != 12:
        raise ValueError("want the 12 ActorCritic leaves in flax leaf order")
    for i, (w, shape) in enumerate(zip(leaves, _leaf_shapes(HIDDEN))):
        if w.device != device or w.dtype != torch.float32 or w.numel() != math.prod(shape):
            raise ValueError(
                f"leaf {i}: the kernel takes hidden width {HIDDEN}: want float32 "
                f"{shape} on {device}, got {w.dtype} {tuple(w.shape)} on {w.device}"
            )


def check_perm(perm: torch.Tensor, device: torch.device) -> None:
    if perm.dim() != 1 or perm.numel() < 1:
        raise ValueError("perm must be a non-empty 1-D tensor of block ids")
    _check("perm", perm, (perm.shape[0],), device, torch.int32)


def launch_buffers(lib, leaves: list, device: torch.device, n_chunks: int):
    """What a gradient launch needs beside its inputs: the (2, PACK) weight
    pack, the CTAs per head (about half the SMs, at most one per chunk) and
    their (2, G, partial) workspace."""
    pack = _pack(leaves)
    if pack.shape[1] != lib.ppo_grad_pack_floats():
        raise RuntimeError("weight pack size disagrees with the kernel's")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ctas = max(1, min(sms // 2, n_chunks))
    work = torch.empty(2 * ctas * lib.ppo_grad_partial_floats(), dtype=torch.float32,
                       device=device)
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


def split_out(out: torch.Tensor):
    """The kernels' flat output -> the 12 gradients (views, leaf order,
    kernels (out, in), biases (out,)) and the actor sum, critic sum and
    ratio max."""
    grads, off = [], 0
    for shape in _leaf_shapes(HIDDEN):
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


def _launch(leaves, obs_t, aux_t, perm, tile, action_std, clip_eps):
    device = obs_t.device
    steps, _, b = obs_t.shape
    _check("obs_t", obs_t, (steps, OBS, b), device)
    _check("aux_t", aux_t, (steps, 8, b), device)
    check_perm(perm, device)
    check_leaves(leaves, device)
    n_blocks = perm.shape[0]
    mb = n_blocks * tile
    lib = _build.load("ppo_fused_t")
    pack, ctas, work = launch_buffers(lib, leaves, device, -(-mb // CHUNK))
    out = torch.empty(lib.ppo_grad_out_floats(), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.ppo_fused_t(
            obs_t.data_ptr(), aux_t.data_ptr(), perm.data_ptr(), pack.data_ptr(),
            work.data_ptr(), out.data_ptr(),
            steps, b, tile, n_blocks, ctas, *loss_consts(action_std, clip_eps, mb),
            device.index, stream,
        )
    raise_on_error(lib, err, "ppo_fused_t")
    fused_ppo_grad_t.launches += 1
    grads, actor_sum, critic_sum, rmax = split_out(out)
    return actor_sum, critic_sum, rmax, mb, grads


def fused_ppo_grad_t(model_or_leaves, obs_t: torch.Tensor, aux_t: torch.Tensor,
                     perm: torch.Tensor, *, tile: int, action_std: float,
                     clip_eps: float, entropy_coef: float):
    """Loss, metrics and the 12 gradients of one minibatch given as block
    ids: one kernel launch for CUDA tensors, the plain version for CPU
    tensors.

    ``model_or_leaves`` is an `ActorCritic` or its 12 leaves in flax leaf
    order (kernels (out, in), biases (out, 1) or (out,)). Returns ``(loss,
    metrics, grads)``: 0-dim tensors, metrics ``actor_loss``,
    ``critic_loss``, ``entropy`` and ``ratio_max``, and the gradients in
    leaf order, kernels (out, in), biases (out,).
    `fused_ppo_grad_t.launches` counts the kernel launches."""
    if obs_t.device.type == "cpu":
        return ppo_grad_t_plain(
            model_or_leaves, obs_t, aux_t, perm, tile=tile, action_std=action_std,
            clip_eps=clip_eps, entropy_coef=entropy_coef,
        )
    if obs_t.device.type != "cuda":
        raise ValueError(f"fused_ppo_grad_t runs on CUDA or CPU tensors, not {obs_t.device}")
    leaves = _leaves(model_or_leaves)
    if not supports(obs_t, leaves, tile):
        raise ValueError(
            "the ppo_fused_t kernel takes hidden width 128, 75-dim obs, 4 actions "
            f"and a tile that is a multiple of {TILE_STEP} dividing B; got leaves "
            f"{[tuple(l.shape) for l in leaves[:1]]}, obs {tuple(obs_t.shape)}, tile {tile}"
        )
    actor_sum, critic_sum, rmax, mb, grads = _launch(
        leaves, obs_t, aux_t, perm, tile, action_std, clip_eps
    )
    loss, metrics = loss_and_metrics(actor_sum, critic_sum, rmax, mb, action_std, entropy_coef)
    return loss, metrics, grads


fused_ppo_grad_t.launches = 0
