"""The port's slice as a whole, on the CPU: the shipped solved controller
flown through the port's rollout against the JAX package's, the
`rollout_batch_fused` entry point, the card-by-default rule, and the rule
that nothing of the port imports JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.config import EnvConfig as JEnvConfig
from autonomous_quadrotor_environment_tpu.envs import hover as jhover
from autonomous_quadrotor_environment_tpu.fixtures import load_solved_controller as jload_solved
from autonomous_quadrotor_environment_tpu.ops import rollout_fused as jrf
from autonomous_quadrotor_environment_tpu_torch import resolve_device
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.config import EnvConfig
from autonomous_quadrotor_environment_tpu_torch.envs import hover as thover
from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
from autonomous_quadrotor_environment_tpu_torch.ops import rollout_fused as trf
from torch_parity import n, port_states, t

B = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_solved_controller_flies_like_jax_for_200_steps():
    """Zero noise, so the action is the actor mean; same 16 JAX reset states
    and the same JAX-drawn pool. Tolerance 1e-4 (abs and rel) on the whole
    observation trajectory: the two sides differ only in float summation
    order (XLA vs PyTorch CPU products), about 1e-7 per step, which the
    stable closed loop of the solved controller does not amplify past 1e-4
    over 200 steps."""
    steps = 200
    jc = JEnvConfig()
    keys = jax.random.split(jax.random.PRNGKey(10), B)
    js = jax.jit(jax.vmap(lambda k: jhover.reset(k, jc)))(keys)
    pool_keys = jax.random.split(jax.random.PRNGKey(11), (2, B))
    pool = jax.vmap(jrf.pack_env_state)(
        jax.jit(jax.vmap(jax.vmap(lambda k: jhover.reset(k, jc))))(pool_keys)
    )
    _, jparams = jload_solved()
    wT = jrf.transpose_leaves(jparams)
    s0 = jrf.pack_env_state(js)
    noise = jnp.zeros((steps, 4, B))
    C = jrf._scalars(jc)
    s_j, outs_j = jax.jit(lambda *a: jrf.rollout_twin(*a, C=C, action_std=0.1))(
        s0, noise, pool, wT
    )

    model = load_solved_controller(device="cpu")
    s_t, obs_t, misc_t = trf.fused_rollout(
        trf.pack_env_state(port_states(js)), t(noise), t(pool),
        trf.transpose_leaves(model), EnvConfig(), model.action_std,
    )
    np.testing.assert_array_equal(n(misc_t[:, 10:11]), np.asarray(outs_j[5]))
    np.testing.assert_allclose(n(obs_t), np.asarray(outs_j[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n(misc_t[:, 9:10]), np.asarray(outs_j[4]), rtol=1e-4, atol=1e-4)
    # The controller flies: the newest velocity error in the window (rows
    # 64:67) shrinks from the first step to the last.
    speed = np.linalg.norm(n(obs_t[:, 64:67]), axis=1)  # (T, B)
    assert speed[-1].mean() < 0.2 * speed[0].mean()


def test_rollout_batch_fused_on_cpu():
    cfg = EnvConfig()
    model = load_solved_controller(device="cpu")
    gen = torch.Generator().manual_seed(0)
    states = thover.reset(gen, cfg, n=B)
    new_states, roll, bootstrap = tppo.rollout_batch_fused(model, states, gen, cfg, 12)
    assert roll.obs.shape == (12, B, 75) and roll.actions.shape == (12, B, 4)
    assert roll.logprobs.shape == (12, B, 4) and roll.values.shape == (12, B)
    assert roll.dones.dtype == torch.bool and bootstrap.shape == (B,)
    for v in (roll.obs, roll.actions, roll.values, roll.rewards, bootstrap, new_states.x):
        assert torch.isfinite(v).all()
    # The first observation is the start state's window, the bootstrap the
    # critic at the final one, and the final window ends in the last action.
    assert torch.equal(roll.obs[0], states.hist)
    with torch.no_grad():
        assert torch.allclose(bootstrap, model(new_states.hist)[1])
    assert torch.allclose(new_states.hist[:, 60:64], roll.actions[-1])
    assert (new_states.i == states.i + 12).all()  # no episode ends in 12 steps here
    # Logprob of the reparameterized sample action = mean + 0.1 * eps.
    with torch.no_grad():
        mean = model(roll.obs[0])[0]
    eps = (roll.actions[0] - mean) / 0.1
    want = -0.5 * eps**2 - np.log(0.1) - 0.5 * np.log(2 * np.pi)
    assert torch.allclose(roll.logprobs[0], want, atol=1e-4)


def test_rollout_batch_fused_raw_returns_the_kernel_layout():
    cfg = EnvConfig()
    model = load_solved_controller(device="cpu")
    states = thover.reset(torch.Generator().manual_seed(1), cfg, n=B)
    _, obs_t, misc, bootstrap = tppo.rollout_batch_fused_raw(
        model, states, torch.Generator().manual_seed(2), cfg, 4, pool_size=2
    )
    assert obs_t.shape == (4, 75, B) and misc.shape == (4, 16, B)
    assert not misc[:, 12:16].any() and bootstrap.shape == (B,)


def test_entry_points_use_the_card_by_default():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            load_solved_controller()


BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "einops",
           "autonomous_quadrotor_environment_tpu")

_IMPORT_ALL = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
import autonomous_quadrotor_environment_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
import chip_smoke
assert callable(chip_smoke.main)
mods = sorted(m for m in sys.modules if m.startswith(pkg.__name__))
for name in ("agents.gae", "agents.ppo", "ops.ppo_fused", "ops.ppo_fused_t", "ops.rollout_fused",
             "ops.render_kernel", "envs.sensors", "render.camera", "render.scene",
             "landing.reward", "landing.networks", "landing.env", "landing.ppo",
             "landing.oracle", "apps.eval_landing", "apps.train_control", "apps.robust_eval",
             "apps.train_landing", "device",
             "core.randomization", "utils.checkpoint", "utils.metrics", "utils.graphs",
             "fixtures", "baselines.pid", "baselines.velocity_pid", "baselines.lqr",
             "missions.targets", "missions.metrics", "missions.trajectories",
             "apps.classical_compare", "apps.step_response", "apps.missions_eval"):
    assert pkg.__name__ + "." + name in mods, name
print("imported", len(mods))
"""


def test_port_and_chip_smoke_import_nothing_of_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 48


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_without_the_repo(where, tmp_path):
    """No ok line and a non-zero exit: on a machine without a CUDA card, and
    in a directory that holds chip_smoke.py and nothing else of the repo."""
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        with open(os.path.join(REPO, "chip_smoke.py")) as src:
            (tmp_path / "chip_smoke.py").write_text(src.read())
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
