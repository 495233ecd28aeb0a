"""PPO minibatch loss and weight gradients on the row-major batch, alone or
followed by the Adam step.

Counterpart of `ops/ppo_fused.py` in the JAX package, whose two kernels
serve `agents.ppo.ppo_update` when ``fused_update`` is on and the fully
fused branch is not taken. Over the minibatch formed by the row blocks
``perm`` (``tile`` rows each) of the row-major ``obs`` (n, 75) and ``aux``
(n, 8) = [action(4), old logprob sum, return, advantage, 0]:

* `fused_ppo_grad` computes the clipped-surrogate + value loss of
  `agents.ppo.ppo_loss`, its metrics and the gradients of all 12
  ActorCritic leaves;
* `fused_ppo_grad_adam` computes the same and then takes one Adam step on
  the model's parameters with the state of its `torch.optim.Adam`, in
  place, and returns no gradients.

On CUDA tensors each is one launch of a hand-written kernel in
`csrc/ppo_fused.cu` (plus its fixed-order reduction pass, which carries the
Adam step), built per instantiation (`ppo_fused_t.library`: hidden
width, obs width, f32 or bf16 products), or above 128 units in
`csrc/ppo_wide.cu`; on CPU tensors each is its plain version:
`ppo_grad_plain`, the rows gathered by block id and `torch.autograd` of
`ppo_loss` on them, then
for the Adam wrapper ``opt.step()``. `ppo_grad_adam_plain` is the Adam
formula on copies of the state, the reference the card's kernel is held
to. The minibatch is never gathered on the card.

Gradients come back in `nn.Linear`'s (out, in) layout, as B2's do
(`ops.ppo_fused_t`), whose host-side helpers these wrappers share. The
Adam step is `torch.optim.Adam`'s: moments lerped and scaled in place,
p -= lr / c1 * m / (sqrt(v) / sqrt(c2) + eps) with the bias corrections of
the incremented step; it equals optax's ``adam`` (which the JAX kernel runs)
up to rounding. It works on the optimizer's own ``exp_avg``, ``exp_avg_sq``
and ``step``, created as torch creates them when empty, so ``opt.step()``
carries on from it.
"""

from __future__ import annotations

import ctypes

import torch

from .ppo_fused_t import (
    ACT,
    _leaves,
    check_leaves,
    check_perm,
    grads_on_rows,
    launch_buffers,
    load_lib,
    loss_and_metrics,
    loss_consts,
    raise_on_error,
    split_out,
)
from .rollout_fused import _check


def pack_aux(actions: torch.Tensor, old_logprobs: torch.Tensor, returns: torch.Tensor,
             advantages: torch.Tensor) -> torch.Tensor:
    """(n, 8) float32 rows [action(4), sum of old logprobs, return,
    advantage, 0] (JAX `pack_aux`)."""
    return torch.cat([
        actions.float(),
        old_logprobs.float().sum(-1, keepdim=True),
        returns[:, None].float(),
        advantages[:, None].float(),
        torch.zeros_like(returns[:, None], dtype=torch.float32),
    ], dim=1).contiguous()


def supports(obs: torch.Tensor, leaves: list, tile: int) -> bool:
    """What the kernels take: any hidden width, any obs width (any
    EnvConfig.hist_t * 15), 4 actions, and any tile that divides the rows.
    They compute under the fixed std they are given (the JAX gate sends a
    learned std to autograd), in f32 or bf16 products."""
    n, obs_dim = obs.shape
    return (
        len(leaves) == 12
        and tuple(leaves[0].shape)[1] == obs_dim
        and tuple(leaves[4].shape)[0] == ACT
        and tile > 0
        and n % tile == 0
    )


def gather_rows(x: torch.Tensor, perm: torch.Tensor, tile: int) -> torch.Tensor:
    """Rows of the blocks ``perm`` of ``tile`` rows each, in that order."""
    rows = perm.long()[:, None] * tile + torch.arange(tile, device=x.device)[None]
    return x[rows.reshape(-1)]


def ppo_grad_plain(model_or_leaves, obs, aux, perm, *, tile: int, action_std: float,
                   clip_eps: float, entropy_coef: float, compute_dtype: str = "f32"):
    """The plain PyTorch version of `fused_ppo_grad`: gather the minibatch's
    rows and take `torch.autograd` of the port's `ppo_loss` on them, with
    bf16 products under ``compute_dtype="bf16"`` (`grads_on_rows`). As for
    B2's plain version, it agrees with the kernel everywhere except at ratio
    == 1 +- clip_eps exactly (`torch.clamp`'s gradient is inclusive there).
    Returns ``(loss, metrics, grads)``."""
    return grads_on_rows(model_or_leaves, gather_rows(obs, perm, tile),
                         gather_rows(aux, perm, tile), action_std=action_std,
                         clip_eps=clip_eps, entropy_coef=entropy_coef,
                         compute_dtype=compute_dtype)


def adam_plain(params, grads, exp_avg, exp_avg_sq, step: int, *, lr: float, b1: float,
               b2: float, eps: float):
    """torch.optim.Adam's step number ``step`` (already incremented) on
    copies: returns the new params, exp_avg and exp_avg_sq."""
    c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, exp_avg, exp_avg_sq):
        m = m.lerp(g, 1.0 - b1)
        v = v.mul(b2).addcmul_(g, g, value=1.0 - b2)
        new_p.append(p.detach().addcdiv(m, v.sqrt() / c2 ** 0.5 + eps, value=-lr / c1))
        new_m.append(m)
        new_v.append(v)
    return new_p, new_m, new_v


def ppo_grad_adam_plain(model_or_leaves, exp_avg, exp_avg_sq, step: int, obs, aux, perm, *,
                        tile: int, action_std: float, clip_eps: float, entropy_coef: float,
                        lr: float, b1: float, b2: float, eps: float = 1e-8,
                        compute_dtype: str = "f32"):
    """The plain PyTorch version of `fused_ppo_grad_adam`, on copies of the
    state: `ppo_grad_plain` (in ``compute_dtype``), then `adam_plain` (f32)
    at step ``step + 1``. Returns ``(loss, metrics, new_params,
    new_exp_avg, new_exp_avg_sq, step + 1)``, the lists in leaf order."""
    leaves = _leaves(model_or_leaves)
    loss, metrics, grads = ppo_grad_plain(
        model_or_leaves, obs, aux, perm, tile=tile, action_std=action_std,
        clip_eps=clip_eps, entropy_coef=entropy_coef, compute_dtype=compute_dtype,
    )
    params = [w.reshape(g.shape) for w, g in zip(leaves, grads)]
    new_p, new_m, new_v = adam_plain(params, grads, exp_avg, exp_avg_sq, step + 1,
                                     lr=lr, b1=b1, b2=b2, eps=eps)
    return loss, metrics, new_p, new_m, new_v, step + 1


def _model_params(model) -> list[torch.Tensor]:
    return [p for layer in model.linears() for p in (layer.weight, layer.bias)]


def adam_takes(opt: torch.optim.Optimizer, model) -> bool:
    """Whether ``opt`` is the plain Adam that `fused_ppo_grad_adam` steps
    (the JAX gate's "standard optax adam state"): one param group holding
    the model's 12 leaves and nothing else, a float lr, no weight decay, amsgrad,
    maximize, or capturable or fused state."""
    if type(opt) is not torch.optim.Adam or len(opt.param_groups) != 1:
        return False
    g = opt.param_groups[0]
    return (
        {id(p) for p in g["params"]} == {id(p) for p in _model_params(model)}
        and isinstance(g["lr"], float)
        and g["weight_decay"] == 0
        and not any(g.get(k) for k in ("amsgrad", "maximize", "capturable", "fused"))
    )


def adam_state(opt: torch.optim.Adam, params: list[torch.Tensor]):
    """``opt``'s exp_avg and exp_avg_sq of each param, created as torch
    creates them when empty, and the shared step count as an int."""
    steps = set()
    for p in params:
        st = opt.state[p]
        if not st:
            st["step"] = torch.tensor(0.0, dtype=torch.float32)
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        steps.add(int(st["step"]))
    if len(steps) != 1:
        raise ValueError(f"the Adam state's step counts differ: {sorted(steps)}")
    return ([opt.state[p]["exp_avg"] for p in params],
            [opt.state[p]["exp_avg_sq"] for p in params], steps.pop())


def _check_rows(obs, aux, perm, tile, leaves):
    device = obs.device
    if obs.dim() != 2:
        raise ValueError(f"obs must be (n, obs_dim) rows, not {tuple(obs.shape)}")
    n, obs_dim = obs.shape
    _check("obs", obs, (n, obs_dim), device)
    _check("aux", aux, (n, 8), device)
    check_perm(perm, device)
    check_leaves(leaves, device, obs_dim)
    if not supports(obs, leaves, tile):
        raise ValueError(
            "the ppo_fused kernels take 4 actions and a tile dividing the rows; got obs "
            f"{tuple(obs.shape)}, tile {tile}"
        )


def _launch(entry: str, leaves, obs, aux, perm, tile, action_std, clip_eps, compute_dtype,
            extra=()):
    """Launch ``entry`` (the gradient kernel and its reduction pass); its
    output is the flat gradients and metrics, or for the Adam entry, whose
    extra arguments are the 36 leaf pointers and the Adam constants, the
    three metrics alone."""
    device = obs.device
    n, obs_dim = obs.shape
    hidden = leaves[0].shape[0]
    n_blocks = perm.shape[0]
    mb = n_blocks * tile
    lib = load_lib("ppo_fused", hidden, obs_dim, compute_dtype)
    pack, ctas, work = launch_buffers(lib, leaves, device, mb)
    size = 3 if extra else lib.ppo_grad_out_floats(hidden)
    out = torch.empty(size, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(
            obs.data_ptr(), aux.data_ptr(), perm.data_ptr(), pack.data_ptr(),
            work.data_ptr(), out.data_ptr(), n, tile, n_blocks, ctas,
            *loss_consts(action_std, clip_eps, mb), hidden, *extra, device.index, stream,
        )
    raise_on_error(lib, err, entry)
    return out, mb


def fused_ppo_grad(model_or_leaves, obs: torch.Tensor, aux: torch.Tensor, perm: torch.Tensor,
                   *, tile: int, action_std: float, clip_eps: float, entropy_coef: float,
                   compute_dtype: str = "f32"):
    """Loss, metrics and the 12 gradients of the minibatch of row blocks
    ``perm``: one kernel launch for CUDA tensors, the plain version for CPU
    tensors; products in ``compute_dtype`` (`PPOConfig.fused_compute`).

    ``model_or_leaves`` is an `ActorCritic` or its 12 leaves in flax leaf
    order. Returns ``(loss, metrics, grads)``: 0-dim tensors, metrics
    ``actor_loss``, ``critic_loss``, ``entropy`` and ``ratio_max``, and the
    gradients in leaf order, kernels (out, in), biases (out,).
    `fused_ppo_grad.launches` counts the kernel launches."""
    if obs.device.type == "cpu":
        return ppo_grad_plain(model_or_leaves, obs, aux, perm, tile=tile,
                              action_std=action_std, clip_eps=clip_eps,
                              entropy_coef=entropy_coef, compute_dtype=compute_dtype)
    if obs.device.type != "cuda":
        raise ValueError(f"fused_ppo_grad runs on CUDA or CPU tensors, not {obs.device}")
    leaves = _leaves(model_or_leaves)
    _check_rows(obs, aux, perm, tile, leaves)
    out, mb = _launch("ppo_fused", leaves, obs, aux, perm, tile, action_std, clip_eps,
                      compute_dtype)
    fused_ppo_grad.launches += 1
    grads, actor_sum, critic_sum, rmax = split_out(out, leaves[0].shape[0], obs.shape[1])
    loss, metrics = loss_and_metrics(actor_sum, critic_sum, rmax, mb, action_std, entropy_coef)
    return loss, metrics, grads


def fused_ppo_grad_adam(model, opt: torch.optim.Adam, obs: torch.Tensor, aux: torch.Tensor,
                        perm: torch.Tensor, *, tile: int, action_std: float, clip_eps: float,
                        entropy_coef: float, compute_dtype: str = "f32"):
    """One whole minibatch step: the loss, metrics and gradients of
    `fused_ppo_grad` (products in ``compute_dtype``), then ``opt``'s Adam
    step (f32) on ``model``'s 12 leaves, in place on the parameters and the
    optimizer's state. One kernel launch for CUDA tensors, whatever the
    model's width: the kernel runs on the zero-padded pack and its
    reduction steps the model's own leaves, so nothing is copied in or out;
    for CPU tensors `ppo_grad_plain` and ``opt.step()``, which leaves no
    ``.grad`` behind. ``opt`` must pass `adam_takes`. Returns ``(loss,
    metrics)``.
    `fused_ppo_grad_adam.launches` counts the kernel launches."""
    if not adam_takes(opt, model):
        raise ValueError("fused_ppo_grad_adam steps a plain torch.optim.Adam over the "
                         "model's 12 leaves (see adam_takes)")
    if obs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ppo_grad_adam runs on CUDA or CPU tensors, not {obs.device}")
    params = _model_params(model)
    if obs.device.type == "cpu":
        loss, metrics, grads = ppo_grad_plain(
            model, obs, aux, perm, tile=tile, action_std=action_std, clip_eps=clip_eps,
            entropy_coef=entropy_coef, compute_dtype=compute_dtype,
        )
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        for p in params:
            p.grad = None
        return loss, metrics
    group = opt.param_groups[0]
    lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
    exp_avg, exp_avg_sq, step = adam_state(opt, params)
    leaves = _leaves(model)
    _check_rows(obs, aux, perm, tile, leaves)
    for name, tensors in (("param", params), ("exp_avg", exp_avg), ("exp_avg_sq", exp_avg_sq)):
        for p, x in zip(params, tensors):
            _check(name, x, tuple(p.shape), obs.device)
    t = step + 1
    ptrs = (ctypes.c_void_p * 36)(*[x.data_ptr() for x in params + exp_avg + exp_avg_sq])
    out, mb = _launch(
        "ppo_fused_adam", leaves, obs, aux, perm, tile, action_std, clip_eps, compute_dtype,
        extra=(ptrs, 1.0 - b1, b2, 1.0 - b2, -lr / (1.0 - b1 ** t),
               (1.0 - b2 ** t) ** 0.5, eps),
    )
    fused_ppo_grad_adam.launches += 1
    for p in params:
        opt.state[p]["step"] += 1
    return loss_and_metrics(out[0], out[1], out[2], mb, action_std, entropy_coef)


fused_ppo_grad.launches = 0
fused_ppo_grad_adam.launches = 0
