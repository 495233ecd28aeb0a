"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

Run from the repository root, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

It imports nothing of JAX. Each phase prints one flushed JSON line:

1. build: nvcc builds both kernels, `ops/csrc/rollout_fused.cu` and
   `ops/csrc/ppo_fused_t.cu`, in parallel; ptxas's registers and spills,
   and each kernel's shared memory.
2. kernel_vs_plain: the rollout kernel against its plain PyTorch version on
   the same CUDA tensors (B=1024, T=32, P=4, seeded weights and noise), at
   the default bounding box and at bb_scale=0.15, where resets and pool
   wrap-around happen.
3. grad_t_vs_plain: the PPO gradient kernel against its plain version
   (autograd of `ppo_loss`) on the same CUDA tensors: a seeded small shape
   (T=8, B=1024, tile 128, a shuffled subset of blocks) and one
   quarter-batch minibatch at the bench shape of the solved controller's
   rollout after GAE; the kernel's time, the plain version's and the bound.
4. slice: the shipped solved controller through `rollout_batch_fused` at
   the bench shape (B=8192 envs, T=256 steps, P=4) with the launch counter
   set to 0 just before and read just after; then the kernel against the
   plain version at that shape, and the times of both.
5. fly: 256 deterministic episodes of the solved controller (zero noise,
   T=1000 steps); each env's first episode must be solved in >= 90% of envs.
6. train: the fully fused PPO train step at bench.py's configuration
   (8192 x 256, K=10, quarter-batch minibatches, tile 1024) through
   `ppo_init` and `make_train_step`, 3 steps, each with both launch counters
   set to 0 just before and read just after (1 rollout and 40 gradient
   launches per step); where the step's time goes.
7. learn: training from scratch at the trainer's defaults (1024 x 128,
   K=10, full batch, lr 5e-4) with a deterministic 256-episode eval every
   100 updates, until eval_solved >= 0.8; it fails if no eval reaches it by
   update 600.

Then the kernels line, the card's name and power limit from nvidia-smi, and
as the last line {"ok": true, "device": {...}}. Any failure raises, exits
non-zero and prints no ok line; so does a machine without a CUDA card.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from autonomous_quadrotor_environment_tpu_torch.agents import ppo
from autonomous_quadrotor_environment_tpu_torch.agents.gae import gae_advantages
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic
from autonomous_quadrotor_environment_tpu_torch.agents.ppo import (
    fused_inputs,
    rollout_batch_fused,
)
from autonomous_quadrotor_environment_tpu_torch.config import EnvConfig, PPOConfig, TrainConfig
from autonomous_quadrotor_environment_tpu_torch.envs import hover
from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
from autonomous_quadrotor_environment_tpu_torch.ops import _build
from autonomous_quadrotor_environment_tpu_torch.ops import ppo_fused_t as pf
from autonomous_quadrotor_environment_tpu_torch.ops import rollout_fused as rf

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_F32_FLOPS = 67e12    # f32 on the CUDA cores
PEAK_HBM_BYTES = 3.35e12  # device memory

DEVICE = "cuda"
ACTION_STD = 0.1
BENCH_B, BENCH_T, BENCH_P = 8192, 256, 4  # bench.py's controller shape
BENCH_K, BENCH_TILE = 10, 1024            # bench.py's epochs and shuffle block
# The trainer's defaults (apps/train_control.py): envs, steps, eval cadence,
# and the update by which an eval must reach LEARN_SOLVED.
LEARN_B, LEARN_T, LEARN_LR = 1024, 128, 5e-4
LEARN_EVAL_EVERY, LEARN_MAX_UPDATES, LEARN_EPISODES, LEARN_SOLVED = 100, 600, 256, 0.8
LEARN_SEED = 0  # fixed before the first run on the card
KERNELS = {
    "rollout_fused": ("autonomous_quadrotor_environment_tpu_torch/ops/csrc/rollout_fused.cu",
                      "autonomous_quadrotor_environment_tpu/ops/rollout_fused.py:624"),
    "ppo_fused_t": ("autonomous_quadrotor_environment_tpu_torch/ops/csrc/ppo_fused_t.cu",
                    "autonomous_quadrotor_environment_tpu/ops/ppo_fused_t.py:211"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Comparison of the kernel with its plain version
# ---------------------------------------------------------------------------


def compare(kernel_out, plain_out, atol: float, rtol: float) -> dict:
    """Hold the kernel's (s_final, obs, misc) against the plain version's,
    entry by entry within ``atol + rtol * |plain|``.

    Three decisions inside a step are discrete, and a last-bit difference
    near their thresholds flips them:
    - the done bit: the env then starts another episode and the two
      trajectories are unrelated. So the done bits must agree on >= 99.9%
      of (step, env) entries, and the values are compared on the envs whose
      done history agrees at every step (>= 99% of the envs);
    - the solved bit, which in training mode is a done bit too;
    - the cascade bonus of the reward (r_norm < 2 tr_i): a flip changes one
      step's reward by the bonus and the next step's by minus it, and the
      shaping carry (state row 99) by the bonus, without touching the
      dynamics. So the reward and that row may differ beyond the tolerance
      in at most 1e-4 of their entries; every other output in none.
    ``max_abs_err`` is over the entries within tolerance; the flips are
    counted apart."""
    ks, ko, km = kernel_out
    ps, po, pm = plain_out
    for name, t in (("s_final", ks), ("obs", ko), ("misc", km)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"kernel {name} has non-finite values")
    if km[:, 12:16].abs().max().item() != 0.0:
        raise AssertionError("misc rows 12-15 must be zeros")
    done_k, done_p = km[:, 10] > 0.5, pm[:, 10] > 0.5
    done_agree = (done_k == done_p).float().mean().item()
    same = (done_k == done_p).all(dim=0)
    env_agree = same.float().mean().item()
    if done_agree < 0.999:
        raise AssertionError(f"done bits agree on {done_agree:.5f} < 0.999")
    if env_agree < 0.99:
        raise AssertionError(f"done histories agree on {env_agree:.4f} of envs < 0.99")
    rows = torch.ones(rf.ROWS, dtype=torch.bool, device=ks.device)
    rows[rf._PREV_SHAPING] = False
    errs, flips = {}, {}
    for name, k, p, max_flips in (
        ("obs", ko, po, 0.0),
        ("action", km[:, 0:4], pm[:, 0:4], 0.0),
        ("logprob", km[:, 4:8], pm[:, 4:8], 0.0),
        ("value", km[:, 8], pm[:, 8], 0.0),
        ("solved", km[:, 11], pm[:, 11], 0.0),
        ("s_final", ks[rows], ps[rows], 0.0),
        ("reward", km[:, 9], pm[:, 9], 1e-4),
        ("shaping_carry", ks[rf._PREV_SHAPING], ps[rf._PREV_SHAPING], 1e-4),
    ):
        k, p = k[..., same], p[..., same]
        diff = (k - p).abs()
        bad = diff > atol + rtol * p.abs()
        n_bad = int(bad.sum())
        errs[name] = diff[~bad].max().item()
        if n_bad:
            flips[name] = n_bad
        if n_bad > max_flips * bad.numel():
            raise AssertionError(
                f"{name}: {n_bad} of {bad.numel()} entries beyond atol={atol} "
                f"rtol={rtol}, max abs err {diff.max().item():.3e}"
            )
    return {
        "done_agree": done_agree,
        "envs_compared": int(same.sum()),
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_output": errs,
        "bonus_flips": flips,
        "atol": atol,
        "rtol": rtol,
    }


def kernel_and_plain(cfg, model, states, gen, steps, pool_size):
    s0, noise, pool, wT = fused_inputs(model, states, gen, cfg, steps, pool_size)
    out_k = rf.fused_rollout(s0, noise, pool, wT, cfg, ACTION_STD)
    sync()
    out_p = rf.rollout_plain(s0, noise, pool, wT, rf._scalars(cfg), ACTION_STD)
    sync()
    return (s0, noise, pool, wT), out_k, out_p


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def _ptxas(name: str, info: dict) -> dict:
    lib = _build.load(name)
    log = info["log"]
    return {
        "nvcc_seconds": info["seconds"],
        "cached": info["cached"],
        "registers": [int(x) for x in re.findall(r"Used (\d+) registers", log)],
        "spill_store_load_bytes": [(int(a), int(b)) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)],
        "dynamic_smem_bytes": getattr(lib, f"{name}_smem_bytes")(),
        "ptxas": [l.strip() for l in log.splitlines() if "ptxas" in l or "spill" in l],
    }


def phase_build() -> dict:
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        infos = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "kernels": {name: _ptxas(name, info) for name, info in infos.items()}}
    emit(out)
    return out


def phase_kernel_vs_plain() -> dict:
    """B=1024, T=32, P=4 at two bounding boxes.

    Tolerance atol = rtol = 1e-4: the JAX package holds its kernel to its
    XLA twin at 1e-5 over 32 steps with resets; here the kernel sums the
    75- and 128-long dot products in another order than cuBLAS does for
    the plain version and contracts multiply-adds into FMAs, so each step
    differs in the last bits and 32 closed-loop steps amplify that."""
    t0 = time.perf_counter()
    results = []
    for bb_scale in (1.0, 0.15):
        cfg = EnvConfig(bb_scale=bb_scale)
        torch.manual_seed(11)
        model = ActorCritic(hidden=128, action_std=ACTION_STD).to(DEVICE)
        gen = torch.Generator(device=DEVICE).manual_seed(12)
        states = hover.reset(gen, cfg, n=1024)
        _, out_k, out_p = kernel_and_plain(cfg, model, states, gen, steps=32, pool_size=4)
        res = compare(out_k, out_p, atol=1e-4, rtol=1e-4)
        dones = float(out_p[2][:, 10].sum())
        res.update(bb_scale=bb_scale, dones=dones, max_slot=float(out_p[0][rf._SLOT].max()))
        if bb_scale < 1.0:
            if dones <= 2 * 1024:
                raise AssertionError(f"reset path not exercised: {dones} dones")
            if res["max_slot"] <= 4:
                raise AssertionError("pool wrap-around not exercised")
        results.append(res)
    out = {"phase": "kernel_vs_plain", "seconds": time.perf_counter() - t0, "runs": results}
    emit(out)
    return out


def time_cuda(fn, warmup: int, runs: int) -> float:
    """Mean milliseconds of ``fn`` over ``runs`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / runs


def host_ms(fn, runs: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the host clock over ``runs`` calls
    closed by a synchronize, after one warm-up call."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / runs


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def bound(b: int, t: int, p: int, hidden: int) -> tuple[float, str, float, float]:
    """The least time the card could take for one rollout: the larger of
    the forward passes' f32 FLOP over the f32 peak and the bytes that must
    move (each input read once, each output written once) over the memory
    rate. The physics (~10^3 operations per env-step, under 1% of the
    forward passes) is left out of the count, which keeps the bound a lower
    bound."""
    per_step = 2 * (2 * (rf.OBS * hidden + hidden * hidden) + hidden * 4 + hidden * 1)
    flops = float(b) * t * per_step
    weights = 2 * (rf.OBS * hidden + hidden + hidden * hidden + hidden) + (hidden * 4 + 4) + (hidden + 1)
    floats = rf.ROWS * b + t * 4 * b + p * rf.ROWS * b + weights \
        + t * rf.OBS * b + t * rf.MISC * b + rf.ROWS * b
    bytes_ = 4.0 * floats
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, bytes_ / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, bytes_


GRAD_SMALL = (8, 1024, 128, 24)  # T, B, tile, blocks of the small shape
CLIP_EPS, ENTROPY_COEF = 0.2, 0.006  # PPOConfig defaults


def grad_flops_per_row(hidden: int) -> int:
    """The f32 FLOP per row of the products the gradient function needs, per
    head (actor with ACT outputs, critic with 1): the forward x.W1, h1.W2,
    h2.W3; the three weight gradients, as many again; the data gradients
    through W3 and W2. The inputs take no gradient, so none goes through W1.
    277,248 at hidden 128; the JAX cost model's 315,648
    (ops/ppo_fused_t.py:210) is 3x the forward and so counts the W1 data
    gradient that neither kernel computes."""
    total = 0
    for out in (pf.ACT, 1):
        forward = 2 * (pf.OBS * hidden + hidden * hidden + hidden * out)
        data_grad = 2 * (hidden * out + hidden * hidden)
        total += 2 * forward + data_grad
    return total


def grad_bound(rows: int, n_blocks: int, hidden: int, n_params: int) -> tuple[float, str, float, float]:
    """The least time the card could take for one gradient call: the larger
    of the products' f32 FLOP (`grad_flops_per_row`) over the f32 peak, and
    the bytes that must move (the rows' obs and aux read once, the block ids
    and weights read once, the gradients written once) over the memory
    rate."""
    flops = float(rows) * grad_flops_per_row(hidden)
    bytes_ = 4.0 * (rows * (pf.OBS + 8) + n_blocks + 2 * n_params)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, bytes_ / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, bytes_


def grad_compare(model, obs_t, aux_t, blocks, tile: int) -> dict:
    """The gradient kernel against its plain version on the same tensors:
    loss and metrics within rtol 1e-4, each gradient leaf within a relative
    Frobenius error of 1e-4 (sums over up to 5e5 rows cancel, so an
    elementwise rtol is the wrong yardstick at that size). A second launch
    must give the same bits: the reduction runs in a fixed order."""
    kw = dict(tile=tile, action_std=ACTION_STD, clip_eps=CLIP_EPS, entropy_coef=ENTROPY_COEF)
    loss, met, grads = pf.fused_ppo_grad_t(model, obs_t, aux_t, blocks, **kw)
    loss2, _, grads2 = pf.fused_ppo_grad_t(model, obs_t, aux_t, blocks, **kw)
    sync()
    lp, mp, gp = pf.ppo_grad_t_plain(model, obs_t, aux_t, blocks, **kw)
    sync()
    deterministic = bool(torch.equal(loss, loss2)) and all(
        torch.equal(a, b) for a, b in zip(grads, grads2))
    rel = {"loss": abs(loss.item() - lp.item()) / max(abs(lp.item()), 1e-30)}
    for k in mp:
        rel[k] = abs(met[k].item() - mp[k].item()) / max(abs(mp[k].item()), 1e-30)
    leaf_fro, leaf_abs = [], []
    for g, want in zip(grads, gp):
        if not torch.isfinite(g).all():
            raise AssertionError("kernel gradient has non-finite values")
        leaf_fro.append((torch.linalg.vector_norm(g - want) / torch.linalg.vector_norm(want)).item())
        leaf_abs.append((g - want).abs().max().item())
    out = {
        "rows": int(blocks.numel()) * tile, "tile": tile, "blocks": int(blocks.numel()),
        "loss": loss.item(), "plain_loss": lp.item(),
        "rel_err": rel, "leaf_rel_fro": leaf_fro, "leaf_max_abs_err": leaf_abs,
        "max_abs_err": max(leaf_abs), "deterministic": deterministic,
        "ratio_max": met["ratio_max"].item(),
    }
    bad = {k: v for k, v in rel.items() if not v <= 1e-4}
    if bad or not max(leaf_fro) <= 1e-4 or not deterministic:
        emit({"phase": "grad_t_vs_plain", "failed": out})
        raise AssertionError(f"gradient kernel disagrees: {bad}, max leaf rel fro "
                             f"{max(leaf_fro):.3e}, deterministic={deterministic}")
    return out


def phase_grad_t_vs_plain() -> dict:
    """(a) seeded data at a small shape, ratios on both sides of the clip
    band; (b) one quarter-batch minibatch (512 blocks of 1024 rows) of the
    solved controller's rollout at the bench shape after GAE. Then the times
    of the kernel and the plain version at (b)."""
    t0 = time.perf_counter()
    steps, b, tile, n_blocks = GRAD_SMALL
    g = torch.Generator(device=DEVICE).manual_seed(21)
    obs = torch.randn(steps, pf.OBS, b, generator=g, device=DEVICE) * 0.3
    aux = torch.zeros(steps, 8, b, device=DEVICE)
    aux[:, 0:4] = torch.randn(steps, 4, b, generator=g, device=DEVICE) * 0.2
    aux[:, 4] = torch.randn(steps, b, generator=g, device=DEVICE) * 0.4 - 4.0
    aux[:, 5:7] = torch.randn(steps, 2, b, generator=g, device=DEVICE)
    torch.manual_seed(22)
    model = ActorCritic(hidden=128, action_std=ACTION_STD).to(DEVICE)
    blocks = torch.randperm(steps * b // tile, generator=g, device=DEVICE)[:n_blocks].to(torch.int32)
    small = grad_compare(model, obs, aux, blocks, tile)

    cfg, pcfg = EnvConfig(), PPOConfig()
    model = load_solved_controller(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    states = hover.reset(gen, cfg, n=BENCH_B)
    _, obs_t, misc, boot = ppo.rollout_batch_fused_raw(model, states, gen, cfg, BENCH_T, BENCH_P)
    returns, advs = gae_advantages(misc[:, 9], misc[:, 8], misc[:, 10] > 0.5, boot,
                                   pcfg.gamma, pcfg.gae_lambda)
    aux_t = ppo.pack_aux_t(misc, returns, advs)
    n_all = BENCH_T * BENCH_B // BENCH_TILE
    blocks = torch.randperm(n_all, generator=gen, device=DEVICE)[: n_all // 4].to(torch.int32)
    bench = grad_compare(model, obs_t, aux_t, blocks, BENCH_TILE)

    kw = dict(tile=BENCH_TILE, action_std=ACTION_STD, clip_eps=CLIP_EPS,
              entropy_coef=ENTROPY_COEF)
    ms = time_cuda(lambda: pf.fused_ppo_grad_t(model, obs_t, aux_t, blocks, **kw), 2, 10)
    plain_ms = time_cuda(lambda: pf.ppo_grad_t_plain(model, obs_t, aux_t, blocks, **kw), 1, 3)
    n_params = sum(p.numel() for p in model.parameters())
    bound_ms, bound_by, flops, bytes_ = grad_bound(bench["rows"], bench["blocks"], model.hidden,
                                                   n_params)
    out = {
        "phase": "grad_t_vs_plain", "seconds": time.perf_counter() - t0, "card": card(),
        "small": small, "bench": bench,
        "kernel_ms": ms, "plain_ms": plain_ms, "kernel_slower_than_plain": ms > plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": bytes_,
        "achieved_f32_tflops": flops / (ms / 1e3) / 1e12,
        "max_abs_err": max(small["max_abs_err"], bench["max_abs_err"]),
    }
    emit(out)
    return out


def phase_slice() -> dict:
    """The main path at full width, then the kernel against the plain
    version at that shape, and the times.

    Tolerance atol = rtol = 1e-3: the same last-bit differences as in the
    kernel_vs_plain phase, carried through 256 closed-loop steps (8x the
    steps) of the solved controller."""
    t0 = time.perf_counter()
    cfg = EnvConfig()
    model = load_solved_controller(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    states = hover.reset(gen, cfg, n=BENCH_B)
    sync()

    torch.cuda.reset_peak_memory_stats()
    rf.fused_rollout.launches = 0
    t_main = time.perf_counter()
    new_states, roll, bootstrap = rollout_batch_fused(
        model, states, gen, cfg, BENCH_T, pool_size=BENCH_P
    )
    sync()
    main_seconds = time.perf_counter() - t_main
    launches = rf.fused_rollout.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    if launches < 1:
        raise AssertionError("the main path did not launch the rollout kernel")
    if roll.obs.shape != (BENCH_T, BENCH_B, rf.OBS) or bootstrap.shape != (BENCH_B,):
        raise AssertionError(f"bad shapes {tuple(roll.obs.shape)} {tuple(bootstrap.shape)}")
    for name, t in (("obs", roll.obs), ("rewards", roll.rewards), ("values", roll.values),
                    ("bootstrap", bootstrap), ("x", new_states.x)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"main path {name} has non-finite values")

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    (s0, noise, pool, wT), out_k, out_p = kernel_and_plain(
        cfg, model, states, gen, BENCH_T, BENCH_P
    )
    res = compare(out_k, out_p, atol=1e-3, rtol=1e-3)
    del out_k, out_p

    ms = time_cuda(lambda: rf.fused_rollout(s0, noise, pool, wT, cfg, ACTION_STD), 2, 5)
    C = rf._scalars(cfg)
    plain_ms = time_cuda(lambda: rf.rollout_plain(s0, noise, pool, wT, C, ACTION_STD), 1, 2)
    # Where the main path's time goes, warm: the whole call, and the part
    # that builds the kernel's inputs (noise, the reset pool with its
    # warmup steps, packing); the rest is the kernel plus unpack/bootstrap.
    main_ms = host_ms(
        lambda: rollout_batch_fused(model, states, gen, cfg, BENCH_T, pool_size=BENCH_P)
    )
    inputs_ms = host_ms(lambda: fused_inputs(model, states, gen, cfg, BENCH_T, BENCH_P))
    bound_ms, bound_by, flops, bytes_ = bound(BENCH_B, BENCH_T, BENCH_P, model.hidden)
    out = {
        "phase": "slice",
        "seconds": time.perf_counter() - t0,
        "card": card(),
        "B": BENCH_B, "T": BENCH_T, "P": BENCH_P, "hidden": model.hidden,
        "main_path_seconds": main_seconds,
        "main_path_warm_ms": main_ms,
        "inputs_ms": inputs_ms,
        "kernel_share_of_main_path": ms / main_ms,
        "launches": launches,
        "peak_memory_bytes": peak_bytes,
        "reward_per_step": roll.rewards.mean().item(),
        "dones": int(roll.dones.sum()),
        "compare": res,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "env_steps_per_s": BENCH_B * BENCH_T / (ms / 1e3),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "flops": flops,
        "bytes": bytes_,
        "achieved_f32_tflops": flops / (ms / 1e3) / 1e12,
    }
    emit(out)
    return out


def phase_fly(episodes: int = 256, steps: int = 1000) -> dict:
    """Deterministic episodes of the solved controller: zero noise, so the
    action is the actor mean. Every env's first episode ends within the
    1000 steps (the env times out at max_steps - warmup = 1000 steps)."""
    t0 = time.perf_counter()
    cfg = EnvConfig()
    model = load_solved_controller(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    states = hover.reset(gen, cfg, n=episodes)
    s0, noise, pool, wT = fused_inputs(model, states, gen, cfg, steps, pool_size=1)
    _, _, misc = rf.fused_rollout(s0, torch.zeros_like(noise), pool, wT, cfg, ACTION_STD)
    sync()
    done = misc[:, 10] > 0.5                    # (T, B)
    if not done.any(dim=0).all():
        raise AssertionError("an episode did not end within the step budget")
    first = done.float().argmax(dim=0)          # first done step of each env
    cols = torch.arange(episodes, device=misc.device)
    solved = misc[first, 11, cols] > 0.5
    upto = torch.arange(steps, device=misc.device)[:, None] <= first[None, :]
    reward = (misc[:, 9] * upto).sum(dim=0)
    out = {
        "phase": "fly",
        "seconds": time.perf_counter() - t0,
        "episodes": episodes,
        "solved_frac": solved.float().mean().item(),
        "mean_reward": reward.mean().item(),
        "mean_length": (first + 1).float().mean().item(),
    }
    emit(out)
    if out["solved_frac"] < 0.9:
        raise AssertionError(f"solved fraction {out['solved_frac']} < 0.9")
    return out


def bench_configs():
    """bench.py's controller configuration at BENCH_B x BENCH_T."""
    env_cfg = EnvConfig(n_steps=1000)
    pcfg = PPOConfig(k_epochs=BENCH_K, minibatch_size=BENCH_B * BENCH_T // 4,
                     fused_update=True, shuffle_block=BENCH_TILE)
    tcfg = TrainConfig(num_envs=BENCH_B, rollout_steps=BENCH_T, network_size=128,
                       fused_rollout=True, fused_pool=BENCH_P)
    return env_cfg, pcfg, tcfg


def profile_step(step, state) -> tuple[object, dict]:
    """Device time by kernel over one warm train step from torch.profiler
    (kernel rows only). Only the profiler may degrade to "not measured", with
    the reason: an error of the step itself fails the run. The profiler slows
    the host, so its wall time is longer than an unprofiled step's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as err:
        state, _ = step(state)
        sync()
        return state, {"device_time": f"not measured: {err}"}
    t0 = time.perf_counter()
    try:
        state, _ = step(state)
        sync()
    except BaseException:
        prof.stop()
        raise
    wall_ms = (time.perf_counter() - t0) * 1e3
    try:
        prof.stop()
        averages = prof.key_averages()
    except RuntimeError as err:
        return state, {"device_time": f"not measured: {err}"}
    rows = []
    for e in averages:
        if e.device_type != DeviceType.CUDA:  # operator rows repeat their kernels' time
            continue
        if getattr(e, "is_user_annotation", False):  # e.g. Adam.step's span over its kernels
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        return state, {"device_time": "not measured: the profiler showed no device time"}
    return state, {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top_kernels_ms_count": rows[:12],
    }


def optimizer_in_step(step, state) -> tuple[object, float, int]:
    """The optimizer's share of one warm train step: CUDA events around each
    of the step's own `opt.step` calls, summed. Each call is queued behind
    its minibatch's gradient kernel, so its events bracket its device work
    (and any wait for the host's launches inside the call)."""
    opt = state.optimizer
    inner = opt.step
    events = []

    def timed(*args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(*args, **kwargs)
        e1.record()
        events.append((e0, e1))
        return out

    opt.step = timed
    try:
        state, _ = step(state)
        sync()
    finally:
        del opt.step  # the class's own step again
    return state, sum(a.elapsed_time(b) for a, b in events), len(events)


def phase_train() -> dict:
    """The main path: 3 fully fused train steps at the bench configuration,
    each with both launch counters set to 0 just before and read just after.
    Then, warm, where a step's time goes."""
    t0 = time.perf_counter()
    env_cfg, pcfg, tcfg = bench_configs()
    model, opt, state = ppo.ppo_init(1, env_cfg, pcfg, tcfg, device=DEVICE)
    step = ppo.make_train_step(model, opt, env_cfg, pcfg, tcfg)
    before = [p.detach().clone() for p in model.parameters()]
    n_mb = 4
    torch.cuda.reset_peak_memory_stats()
    step_ms, launches, metrics = [], [], {}
    for _ in range(3):
        sync()
        rf.fused_rollout.launches = 0
        pf.fused_ppo_grad_t.launches = 0
        t_step = time.perf_counter()
        state, metrics = step(state)
        sync()
        step_ms.append((time.perf_counter() - t_step) * 1e3)
        launches.append((rf.fused_rollout.launches, pf.fused_ppo_grad_t.launches))
        if launches[-1] != (1, BENCH_K * n_mb):
            raise AssertionError(f"a train step launched {launches[-1]}, want (1, {BENCH_K * n_mb})")
    peak_bytes = torch.cuda.max_memory_allocated()
    metrics = {k: v.item() for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    if all(torch.equal(a, p) for a, p in zip(before, model.parameters())):
        raise AssertionError("the train steps did not change the parameters")
    warm_ms = sum(step_ms[1:]) / len(step_ms[1:])

    # Where the time goes, warm, at this configuration's shapes.
    inputs_ms = host_ms(lambda: fused_inputs(model, state.env_states, state.gen, env_cfg,
                                             BENCH_T, BENCH_P))
    s0, noise, pool, wT = fused_inputs(model, state.env_states, state.gen, env_cfg,
                                       BENCH_T, BENCH_P)
    b1_ms = time_cuda(lambda: rf.fused_rollout(s0, noise, pool, wT, env_cfg, ACTION_STD), 1, 3)
    _, obs_t, misc, boot = ppo.rollout_from_inputs(model, state.env_states, noise, pool, env_cfg)
    gae = lambda: gae_advantages(misc[:, 9], misc[:, 8], misc[:, 10] > 0.5, boot,
                                 pcfg.gamma, pcfg.gae_lambda)
    gae_ms = time_cuda(gae, 2, 10)
    returns, advs = gae()
    aux_t = ppo.pack_aux_t(misc, returns, advs)
    n_all = BENCH_T * BENCH_B // BENCH_TILE
    blocks = torch.randperm(n_all, generator=state.gen, device=DEVICE)[: n_all // n_mb]
    blocks = blocks.to(torch.int32)
    kw = dict(tile=BENCH_TILE, action_std=ACTION_STD, clip_eps=CLIP_EPS,
              entropy_coef=ENTROPY_COEF)
    b2_ms = time_cuda(lambda: pf.fused_ppo_grad_t(model, obs_t, aux_t, blocks, **kw), 2, 10)
    update_ms = host_ms(lambda: ppo.ppo_update_t(model, opt, obs_t, aux_t, state.gen, pcfg), 1)
    state, adam_ms, adam_calls = optimizer_in_step(step, state)
    if adam_calls != BENCH_K * n_mb:
        raise AssertionError(f"a train step made {adam_calls} optimizer steps")
    state, prof = profile_step(step, state)
    n_params = sum(p.numel() for p in model.parameters())
    rows = BENCH_B * BENCH_T // n_mb
    bound_ms, bound_by, flops, _ = grad_bound(rows, n_all // n_mb, model.hidden, n_params)
    launches_b2 = BENCH_K * n_mb
    out = {
        "phase": "train", "seconds": time.perf_counter() - t0, "card": card(),
        "B": BENCH_B, "T": BENCH_T, "K": BENCH_K, "minibatches": n_mb, "tile": BENCH_TILE,
        "launches_per_step": launches, "step_ms": step_ms, "warm_step_ms": warm_ms,
        "env_steps_per_s": BENCH_B * BENCH_T / (warm_ms / 1e3),
        "metrics": metrics, "peak_memory_bytes": peak_bytes,
        "parts_ms": {"inputs_pool_and_noise_host": inputs_ms, "rollout_kernel": b1_ms,
                     "gae": gae_ms, "grad_kernel_per_launch": b2_ms,
                     "grad_kernel_x_launches": b2_ms * launches_b2, "adam_in_step": adam_ms,
                     "adam_calls_in_step": adam_calls, "ppo_update_t_host": update_ms},
        "share_rollout_kernel": b1_ms / warm_ms,
        "share_grad_kernel": b2_ms * launches_b2 / warm_ms,
        "grad_kernel_bound_ms": bound_ms, "grad_kernel_bound_by": bound_by,
        "grad_kernel_f32_tflops": flops / (b2_ms / 1e3) / 1e12,
        "profile": prof,
    }
    emit(out)
    return out


def phase_learn() -> dict:
    """From scratch at the trainer's defaults, evaluating every
    LEARN_EVAL_EVERY updates; passes at the first eval with eval_solved >=
    LEARN_SOLVED, fails if none reaches it by LEARN_MAX_UPDATES."""
    t0 = time.perf_counter()
    env_cfg = EnvConfig()
    pcfg = PPOConfig(lr=LEARN_LR, k_epochs=10, fused_update=True)
    tcfg = TrainConfig(num_envs=LEARN_B, rollout_steps=LEARN_T, network_size=128,
                       fused_rollout=True, fused_pool=4)
    model, opt, state = ppo.ppo_init(LEARN_SEED, env_cfg, pcfg, tcfg, device=DEVICE)
    step = ppo.make_train_step(model, opt, env_cfg, pcfg, tcfg)
    eval_fn = ppo.make_eval_fn(model, env_cfg, LEARN_EPISODES)
    eval_gen = torch.Generator(device=DEVICE).manual_seed(LEARN_SEED + 1000)
    tile = ppo.update_t_tile(pcfg, LEARN_T, LEARN_B)
    curve, solved_at, first_launches = [], None, None
    train_s = eval_s = 0.0
    for u in range(1, LEARN_MAX_UPDATES + 1):
        t_u = time.perf_counter()
        if u == 1:
            rf.fused_rollout.launches = pf.fused_ppo_grad_t.launches = 0
        state, met = step(state)
        if u == 1:
            sync()
            first_launches = (rf.fused_rollout.launches, pf.fused_ppo_grad_t.launches)
        train_s += time.perf_counter() - t_u
        if u % LEARN_EVAL_EVERY == 0:
            sync()
            t_e = time.perf_counter()
            ev = {k: v.item() for k, v in eval_fn(eval_gen).items()}
            eval_s += time.perf_counter() - t_e
            row = {"update": u, "solved_frac": met["solved_frac"].item(),
                   "eval_solved": ev["eval_solved"], "eval_reward": ev["eval_reward"],
                   "seconds": time.perf_counter() - t0}
            curve.append(row)
            print(json.dumps({"learn_curve": row}), flush=True)
            if ev["eval_solved"] >= LEARN_SOLVED:
                solved_at = u
                break
    out = {
        "phase": "learn", "seconds": time.perf_counter() - t0, "seed": LEARN_SEED,
        "B": LEARN_B, "T": LEARN_T, "lr": LEARN_LR, "tile": tile,
        "launches_first_update": first_launches, "curve": curve, "solved_at_update": solved_at,
        "train_seconds": train_s, "eval_seconds": eval_s,
        "ms_per_update": 1e3 * train_s / max(curve[-1]["update"] if curve else 1, 1),
    }
    emit(out)
    if first_launches != (1, pcfg.k_epochs):
        raise AssertionError(f"the first update launched {first_launches}, want (1, 10)")
    if solved_at is None:
        raise AssertionError(f"no eval reached eval_solved >= {LEARN_SOLVED} by update "
                             f"{LEARN_MAX_UPDATES}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # Plain-version products in full f32, as the kernels compute them.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    kvp = phase_kernel_vs_plain()
    gvp = phase_grad_t_vs_plain()
    sl = phase_slice()
    phase_fly()
    tr = phase_train()
    phase_learn()
    max_err = max([r["max_abs_err"] for r in kvp["runs"]] + [sl["compare"]["max_abs_err"]])
    b1_launches, b2_launches = tr["launches_per_step"][-1]
    emit({"kernels": [
        {
            "name": "rollout_fused", "route": "cuda",
            "source": KERNELS["rollout_fused"][0], "replaces": KERNELS["rollout_fused"][1],
            "launches": b1_launches, "max_abs_err": max_err,
            "ms": sl["kernel_ms"], "plain_ms": sl["plain_ms"],
            "bound_ms": sl["bound_ms"], "bound_by": sl["bound_by"], "library_ms": None,
        },
        {
            "name": "ppo_fused_t", "route": "cuda",
            "source": KERNELS["ppo_fused_t"][0], "replaces": KERNELS["ppo_fused_t"][1],
            "launches": b2_launches, "max_abs_err": gvp["max_abs_err"],
            "ms": gvp["kernel_ms"], "plain_ms": gvp["plain_ms"],
            "bound_ms": gvp["bound_ms"], "bound_by": gvp["bound_by"], "library_ms": None,
        },
    ], "seconds": time.perf_counter() - t0})
    print(card(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
