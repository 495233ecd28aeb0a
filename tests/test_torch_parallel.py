"""The port's data-parallel training (`parallel.dp`, `parallel.dp_landing`,
`parallel.launch`) on the CPU over gloo, against the JAX package's
`shard_map` over virtual CPU devices:

- gradients averaged over 2 and 4 spawned ranks against the port's
  single-process gradient of all the rows (rtol 2e-5, atol 1e-6: the JAX
  package's dp-against-single tolerance, tests/test_parallel.py:77-127)
  and against JAX's pmean over as many devices (the port's gradient-parity
  tolerance against JAX, tests/test_torch_ppo.py:128: the two frameworks
  sum in other orders);
- one dp train step on 2 ranks against JAX's `make_parallel_train_step` on
  a 2-device mesh, JAX's per-device draws injected (parameters within
  atol lr * 0.05, metrics rtol 5e-4: tests/test_torch_train.py's);
- a world of one rank against the serial step, bit for bit;
- the kernels' gates read at the per-rank batch, and B4 refused under a
  reduce;
- a rank that raises or dies fails the run at once, nothing left hanging;
- one landing dp step on 2 ranks against the single-process step on all
  the envs from the same draws.

Each spawned rank pins one torch thread and runs a function of
`tests/torch_dp_ranks.py`, which imports no JAX."""

import dataclasses
import datetime
import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from autonomous_quadrotor_environment_tpu import config as jcfg
from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.agents.ppo import ppo_loss as jppo_loss
from autonomous_quadrotor_environment_tpu.parallel import (
    make_dp_mesh as jmake_dp_mesh,
    make_parallel_train_step as jmake_parallel_train_step,
    ppo_init_sharded as jppo_init_sharded,
)
from autonomous_quadrotor_environment_tpu.parallel.dp import shard_map
from autonomous_quadrotor_environment_tpu_torch import config as tcfg
from autonomous_quadrotor_environment_tpu_torch.agents import ppo as tppo
from autonomous_quadrotor_environment_tpu_torch.agents.networks import LEAVES
from autonomous_quadrotor_environment_tpu_torch.fixtures import load_solved_controller
from autonomous_quadrotor_environment_tpu_torch.landing import env as lenv
from autonomous_quadrotor_environment_tpu_torch.landing import ppo as lppo
from autonomous_quadrotor_environment_tpu_torch.parallel import dp, launch
import torch_dp_ranks
from torch_parity import one_torch_thread  # noqa: F401  (the module's fixture)
from torch_parity import jax_perms, jax_rollout_draws, port_env_config, port_states, t

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SPAWN = dict(threads=1, timeout=120, deadline=240)
STEPS, HIDDEN = 8, 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A process group of this process alone (gloo) and its `DPMesh`."""
    path = tmp_path_factory.mktemp("rendezvous") / "file"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield dp.make_dp_mesh("cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_grads_averaged_over_ranks_equal_jax_pmean(world):
    """The mean over `world` gloo ranks of each rank's `ppo_loss` gradients
    on its shard of 64 rows (one flat all_reduce), equal on every rank,
    against the gradient of all 64 rows in this process, and against JAX's
    pmean of the per-device gradients over as many virtual devices."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jmake_dp_mesh(world)
    model = JActorCritic(hidden=HIDDEN)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 75)))
    k = jax.random.PRNGKey(42)
    batch = (jax.random.normal(jax.random.fold_in(k, 0), (64, 75)),
             jax.random.normal(jax.random.fold_in(k, 1), (64, 4)) * 0.1,
             jax.random.normal(jax.random.fold_in(k, 2), (64, 4)),
             jax.random.normal(jax.random.fold_in(k, 3), (64,)),
             jax.random.normal(jax.random.fold_in(k, 4), (64,)))

    def loss_fn(p, b):
        return jppo_loss(model, p, *b, jcfg.PPOConfig())[0]

    def dp_grads(p, b):
        return jax.lax.pmean(jax.grad(loss_fn)(p, b), "dp")

    sharded = jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, P("dp"))), batch)
    g = jax.jit(shard_map(dp_grads, mesh=mesh, in_specs=(P(), tuple(P("dp") for _ in batch)),
                          out_specs=P(), check_rep=False))(params, sharded)
    rows = 64 // world
    shards = [tuple(np.asarray(x)[r * rows:(r + 1) * rows] for x in batch) for r in range(world)]
    got = launch.spawn(torch_dp_ranks.grads_rank, ["cpu"] * world, "gloo",
                       (_np_tree(params), shards), **SPAWN)
    for r in range(1, world):
        assert all(np.array_equal(a, b) for a, b in zip(got[0], got[r]))
    single = torch_dp_ranks.grads_of_rows(_np_tree(params), tuple(np.asarray(x) for x in batch))
    for (head, name, kind), port, one in zip(LEAVES, got[0], single):
        np.testing.assert_allclose(port, one, rtol=2e-5, atol=1e-6, err_msg=f"{head}/{name}")
        want = np.asarray(g["params"][head][name][kind])
        want = want.T if kind == "kernel" else want
        np.testing.assert_allclose(port, want, rtol=2e-4, atol=2e-7 + 1e-5 * np.abs(want).max(),
                                   err_msg=f"{head}/{name}/{kind}")


def test_dp_train_step_matches_jax_on_2_ranks():
    """One dp train step of the trainer's row-major path (per-step
    auto-reset, autograd update, 2 minibatches of 4 blocks) on 2 gloo ranks
    of 8 envs each, from the JAX package's 2-device init, with each
    device's draws (its key's rollout chains and permutations) injected."""
    env_cfg = jcfg.EnvConfig(bb_scale=0.15)
    ppo_kw = dict(k_epochs=2, minibatch_size=32, shuffle_block=8)
    jppo = jcfg.PPOConfig(**ppo_kw)
    jtrain = jcfg.TrainConfig(num_envs=16, rollout_steps=STEPS, network_size=HIDDEN)
    jmesh = jmake_dp_mesh(2)
    jmodel, tx, jstate = jppo_init_sharded(jax.random.PRNGKey(0), env_cfg, jppo, jtrain, jmesh)
    jnew, mj = jmake_parallel_train_step(jmodel, tx, env_cfg, jppo, jtrain, jmesh)(jstate)
    params = _np_tree(jstate.params)
    states, draws = [], []
    for d in range(2):
        shard = jax.tree.map(lambda x: np.asarray(x)[d * 8:(d + 1) * 8], jstate.env_states)
        _, k_roll, k_upd = jax.random.split(jnp.asarray(np.asarray(jstate.key)[d]), 3)
        noise, fresh_x0, _ = jax_rollout_draws(jmodel, jstate.params, shard, k_roll, env_cfg,
                                               STEPS, reset_pool=0)
        states.append(port_states(shard))
        draws.append(dict(noise=t(noise), fresh_x0=t(fresh_x0),
                          perms=torch.from_numpy(jax_perms(k_upd, 2, 8, 2))))
    got = launch.spawn(torch_dp_ranks.step_rank, ["cpu", "cpu"], "gloo",
                       (params, states, draws, port_env_config(env_cfg),
                        tcfg.PPOConfig(**ppo_kw),
                        tcfg.TrainConfig(num_envs=8, rollout_steps=STEPS, network_size=HIDDEN)),
                       **SPAWN)
    assert got[0]["same"] and got[1]["same"]
    for k, v in mj.items():
        np.testing.assert_allclose(got[0]["metrics"][k], float(v), rtol=5e-4, atol=1e-6,
                                   err_msg=k)
    want = _np_tree(jnew.params)["params"]
    for head, name, kind in LEAVES:
        np.testing.assert_allclose(got[0]["params"]["params"][head][name][kind],
                                   want[head][name][kind], atol=jppo.lr * 0.05, rtol=0,
                                   err_msg=f"{head}/{name}/{kind}")


@pytest.mark.parametrize("fused", [False, True])
def test_one_rank_world_equals_the_serial_step(one_rank, fused):
    """`ppo_init_sharded` and `make_parallel_train_step` on a world of one
    rank against `ppo_init` and `make_train_step`: the same model, envs and
    generator, and after 2 steps the same parameters, env states and
    metrics, bit for bit; on the row-major autograd path and on the fully
    fused one (the kernels' plain versions here)."""
    env_cfg = tcfg.EnvConfig(bb_scale=0.15)
    pcfg = tcfg.PPOConfig(k_epochs=2, minibatch_size=64, shuffle_block=8, fused_update=fused)
    tc = tcfg.TrainConfig(num_envs=16, rollout_steps=STEPS, network_size=HIDDEN,
                          fused_rollout=fused)
    m1, o1, s1 = tppo.ppo_init(3, env_cfg, pcfg, tc, device="cpu")
    m2, o2, s2 = dp.ppo_init_sharded(3, env_cfg, pcfg, tc, one_rank)
    assert torch.equal(s1.env_states.x, s2.env_states.x)
    assert torch.equal(s1.gen.get_state(), s2.gen.get_state())
    serial = tppo.make_train_step(m1, o1, env_cfg, pcfg, tc)
    par = dp.make_parallel_train_step(m2, o2, env_cfg, pcfg, tc, one_rank)
    assert tppo.train_branch(m2, o2, env_cfg, pcfg, tc, 16, True) == (
        "fused_t" if fused else "rowmajor")
    for _ in range(2):
        s1, met1 = serial(s1)
        s2, met2 = par(s2)
        assert all(torch.equal(met1[k], met2[k]) for k in met1)
    assert all(torch.equal(a, b) for a, b in zip(m1.parameters(), m2.parameters()))
    assert torch.equal(s1.env_states.hist, s2.env_states.hist)


def test_parallel_train_loop_equals_sequential_dp_steps(one_rank):
    """`make_parallel_train_loop(inner=2)` trains what two
    `make_parallel_train_step` calls train, bit for bit, with the metrics
    stacked per update (tests/test_parallel.py's loop test)."""
    env_cfg = tcfg.EnvConfig()
    pcfg = tcfg.PPOConfig(k_epochs=2, minibatch_size=64, shuffle_block=8)
    tc = tcfg.TrainConfig(num_envs=16, rollout_steps=STEPS, network_size=HIDDEN)
    m1, o1, s1 = dp.ppo_init_sharded(0, env_cfg, pcfg, tc, one_rank)
    m2, o2, s2 = dp.ppo_init_sharded(0, env_cfg, pcfg, tc, one_rank)
    step = dp.make_parallel_train_step(m1, o1, env_cfg, pcfg, tc, one_rank)
    rows = []
    for _ in range(2):
        s1, metrics = step(s1)
        rows.append(metrics)
    s2, stacked = dp.make_parallel_train_loop(m2, o2, env_cfg, pcfg, tc, one_rank, 2)(s2)
    for k, v in stacked.items():
        assert torch.equal(v, torch.stack([r[k] for r in rows])), k
    assert all(torch.equal(a, b) for a, b in zip(m1.parameters(), m2.parameters()))


def test_fused_gate_reads_the_per_rank_batch(one_rank):
    """32 envs over 8 ranks: each rank's 4 envs fail the transposed update's
    tile (gcd(128, 4) < 8) though the global 32 pass it, so the step falls
    back to the row-major branch and runs (the JAX package's ADVICE r3
    regression, tests/test_parallel.py:43-61), here in one process with
    ``local_envs=4``."""
    env_cfg = tcfg.EnvConfig()
    pcfg = tcfg.PPOConfig(k_epochs=2, fused_update=True, shuffle_block=128)
    tc = tcfg.TrainConfig(num_envs=32, rollout_steps=STEPS, network_size=HIDDEN,
                          fused_rollout=True)
    model, opt, _ = tppo.ppo_init(0, env_cfg, pcfg, tc, device="cpu")
    assert tppo.train_branch(model, opt, env_cfg, pcfg, tc) == "fused_t"
    assert tppo.train_branch(model, opt, env_cfg, pcfg, tc, local_envs=4) == "rowmajor"
    _, _, state = tppo.ppo_init(0, env_cfg, pcfg, dataclasses.replace(tc, num_envs=4),
                                device="cpu")
    state = dataclasses.replace(state, model=model, optimizer=opt)
    step = tppo.make_train_step(model, opt, env_cfg, pcfg, tc, grad_reduce=one_rank.mean,
                                metric_reduce=one_rank.mean_metrics, local_envs=4)
    state, metrics = step(state)
    assert state.update_i == 1 and torch.isfinite(metrics["loss"])


def test_b4_is_not_taken_under_a_reduce(one_rank, monkeypatch):
    """With fused_update and fused_adam, a reduce keeps the Adam step out of
    kernel B4 (JAX ppo.py:400-404): B3 gives each minibatch's gradients,
    the reduce averages them, then `torch.optim.Adam` steps."""
    assert tppo.update_plan(tcfg.PPOConfig(fused_update=True, fused_adam=True), 1024,
                            reduced=True).branch == "fused"
    assert tppo.update_plan(tcfg.PPOConfig(fused_update=True, fused_adam=True),
                            1024).branch == "fused_adam"
    env_cfg = tcfg.EnvConfig()
    pcfg = tcfg.PPOConfig(k_epochs=2, minibatch_size=64, shuffle_block=8, fused_update=True,
                          fused_adam=True)
    tc = tcfg.TrainConfig(num_envs=16, rollout_steps=STEPS, network_size=HIDDEN)
    model, opt, state = dp.ppo_init_sharded(0, env_cfg, pcfg, tc, one_rank)
    calls = []
    b3 = tppo.pfr.fused_ppo_grad

    def counted(*args, **kwargs):
        calls.append(1)
        return b3(*args, **kwargs)

    def refused(*args, **kwargs):
        raise AssertionError("B4 under a reduce")

    monkeypatch.setattr(tppo.pfr, "fused_ppo_grad", counted)
    monkeypatch.setattr(tppo.pfr, "fused_ppo_grad_adam", refused)
    reduces = []
    mean = one_rank.mean
    monkeypatch.setattr(dp.DPMesh, "mean", lambda self, g: reduces.append(1) or mean(g))
    state, metrics = dp.make_parallel_train_step(model, opt, env_cfg, pcfg, tc, one_rank)(state)
    assert len(calls) == 4 and len(reduces) == 4 + 1  # 2 epochs x 2 minibatches, the metrics
    assert torch.isfinite(metrics["loss"])


@pytest.mark.parametrize("how", ["raises", "dies"])
def test_a_failing_rank_fails_the_run_and_leaves_nothing_waiting(how):
    """Rank 1 raises, or exits without a word, while rank 0 waits for it in
    an all_reduce: the parent raises naming rank 1 within seconds (not the
    collective's 120 s timeout) and no rank outlives the call."""
    t0 = time.perf_counter()
    with pytest.raises(launch.RankError, match="rank 1"):
        launch.spawn(torch_dp_ranks.failing_rank, ["cpu", "cpu"], "gloo", (how,), **SPAWN)
    assert time.perf_counter() - t0 < 60
    assert not [p for p in multiprocessing.active_children() if p.is_alive()]


def _rank_draws(draws: lppo.RolloutDraws, world: int, b: int, pool: int) -> list:
    """Each rank's share of a landing rollout's draws over ``b`` envs: its
    envs' columns of each decision's draws, and of the reset pool's
    slot-major rows (row p * b + e)."""
    out = []
    n = b // world
    for r in range(world):
        sl = slice(r * n, (r + 1) * n)

        def pool_rows(x, k):  # (k lead axes, pool * b, ...) -> (k lead axes, pool * n, ...)
            y = x.reshape(x.shape[:k] + (pool, b) + x.shape[k + 1:])
            y = y[(slice(None),) * (k + 1) + (sl,)]
            return y.reshape(x.shape[:k] + (pool * n,) + x.shape[k + 1:])

        out.append(lppo.RolloutDraws(
            pool=lenv.ResetDraws(*(pool_rows(x, 0) for x in draws.pool)),
            pool_noise=type(draws.pool_noise)(*(pool_rows(x, 1) for x in draws.pool_noise)),
            action_eps=draws.action_eps[:, sl],
            noise=type(draws.noise)(*(x[:, :, sl] for x in draws.noise))))
    return out


def test_dp_landing_step_matches_the_single_process_steps():
    """One landing dp step on 2 gloo ranks of 2 envs each (2 decisions, the
    reset pool of 2, one full-batch epoch) against the single-process step
    of each rank's envs from the same draws, in this process: the ranks'
    averaged gradient equal to the mean of the two single-process
    gradients, and the averaged metrics to the mean of theirs (each rank
    normalizes its own advantages, as each device does in the JAX
    package, so a rank's batch is its own, not a slice of one global
    batch); the parameters equal on both ranks."""
    cfgs = lenv.LandingConfigs.default(training=True)
    pcfg = dataclasses.replace(tcfg.PPOConfig.landing_variant(), k_epochs=1)
    b, steps, pool, world = 4, 2, 2, 2
    ctrl = load_solved_controller(device="cpu")
    draws = _rank_draws(lppo.draw_rollout(torch.Generator().manual_seed(5), cfgs, b, steps, pool),
                        world, b, pool)
    grads, metrics = [], []
    for r in range(world):
        model, opt, state = lppo.landing_ppo_init(0, cfgs, pcfg, b, ctrl, device="cpu")
        rank = dp.DPMesh(rank=r, size=world, device=torch.device("cpu"))
        state = dataclasses.replace(state, env_states=dp.shard(state.env_states, b, rank),
                                    obs=dp.shard(state.obs, b, rank))
        step = lppo.make_landing_train_step(model, opt, cfgs, pcfg, ctrl, steps,
                                            grad_reduce=lambda g: grads.append(g) or g)
        metrics.append(step(state, rollout_draws=draws[r])[1])
    got = launch.spawn(torch_dp_ranks.landing_rank, ["cpu"] * world, "gloo",
                       (0, b, steps, draws, pcfg), **SPAWN)
    assert got[0]["same"] and got[1]["same"]
    for g, w0, w1 in zip(got[0]["grads"], grads[0], grads[1]):
        w = ((w0 + w1) / 2).numpy()
        assert np.linalg.norm(g - w) <= 1e-6 * np.linalg.norm(w)
    for k in metrics[0]:
        want = float((metrics[0][k] + metrics[1][k]) / 2)
        np.testing.assert_allclose(got[0]["metrics"][k], want, rtol=1e-6, err_msg=k)


def test_dp_refuses_more_ranks_than_cards():
    """``--dp N`` needs N cards, one rank each, and says how many there are;
    on the CPU every rank runs over gloo."""
    with pytest.raises(ValueError, match="this machine has"):
        launch.rank_devices(torch.cuda.device_count() + 1)
    assert launch.rank_devices(3, "cpu") == (["cpu"] * 3, "gloo")
