"""The port's camera-facing and human-facing apps and host utilities on the
CPU, as the JAX package's tests/test_apps.py and test_analysis_utils.py
drive theirs, and against the JAX package's modules on the same inputs: the
native preview renderer (its code the JAX package's, its images the JAX
package's renderer's), replay's terminal frames and HUD, the watch
dashboard over the JSONL that the port's `train_control` writes, the live
mission rig (each mode's chunk steppers against the mission runners, the
true-state mode against the JAX package's, and switching modes headless),
manual flight from a script and from the autopilot with
`aggregate_pilot_logs`, the forward-latency sweep, the analysis package
(its code and its results the JAX package's), `Timer`, the memory census
and the build-directory switch."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu import analysis as janalysis
from autonomous_quadrotor_environment_tpu import native as jnative
from autonomous_quadrotor_environment_tpu.agents.networks import ActorCritic as JActorCritic
from autonomous_quadrotor_environment_tpu.analysis import plots as jplots
from autonomous_quadrotor_environment_tpu.apps import missions_eval as jme
from autonomous_quadrotor_environment_tpu.apps import replay as jreplay
from autonomous_quadrotor_environment_tpu.apps import watch as jwatch
from autonomous_quadrotor_environment_tpu.config import EnvConfig as JEnvConfig
from autonomous_quadrotor_environment_tpu.config import SensorConfig as JSensorConfig
from autonomous_quadrotor_environment_tpu.missions import target_parse as jtarget_parse
from autonomous_quadrotor_environment_tpu.utils import load_params
from autonomous_quadrotor_environment_tpu_torch import analysis, native
from autonomous_quadrotor_environment_tpu_torch.agents.networks import ActorCritic, to_flax
from autonomous_quadrotor_environment_tpu_torch.analysis import (
    aggregate_pilot_logs,
    episodes_to_solve,
    training_curves,
)
from autonomous_quadrotor_environment_tpu_torch.apps import (
    forward_bench,
    live_mission,
    manual_flight,
    replay,
    train_control,
    watch,
)
from autonomous_quadrotor_environment_tpu_torch.analysis import plots
from autonomous_quadrotor_environment_tpu_torch.apps import missions_eval as me
from autonomous_quadrotor_environment_tpu_torch.apps.robust_eval import load_policy
from autonomous_quadrotor_environment_tpu_torch.config import EnvConfig, SensorConfig
from autonomous_quadrotor_environment_tpu_torch.fixtures import SOLVED_CONTROLLER
from autonomous_quadrotor_environment_tpu_torch.missions import stack_trajectories, target_parse
from autonomous_quadrotor_environment_tpu_torch.ops import _build, render_kernel
from autonomous_quadrotor_environment_tpu_torch.utils import (
    Timer,
    device_memory_stats,
    live_array_summary,
    save_params,
)
from autonomous_quadrotor_environment_tpu_torch.utils import graphs
from autonomous_quadrotor_environment_tpu_torch.utils.cache import enable_compilation_cache
from torch_parity import (  # noqa: F401 (one_torch_thread: the fixture below)
    jax_mission_sensor_draws,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

needs_preview = pytest.mark.skipif(not native.preview_available(),
                                   reason="g++ is not available to build the preview")


@needs_preview
def test_native_preview_renderer():
    st = np.zeros(13)
    st[6] = 1.0
    st[4] = -3.0
    img = native.render_preview(st, (0.0, 0.0), cam_offset=(1.0, 1.0, 2.0), width=160,
                                height=120)
    assert img.shape == (120, 160, 3) and img.dtype == np.uint8
    gray = img.mean(-1)
    assert (gray < 40).any() and (gray > 200).any()  # the marker's squares
    frames = native.render_trajectory(np.tile(st, (4, 1)), width=80, height=60)
    assert frames.shape == (4, 60, 80, 3)
    np.testing.assert_array_equal(frames[0], native.render_preview(st, width=80, height=60))
    assert os.path.dirname(native._lib_path()) == _build.BUILD_DIR


@needs_preview
@pytest.mark.skipif(not jnative.preview_available(),
                    reason="make is not available to build the JAX package's preview")
def test_native_preview_images_are_the_jax_packages():
    """The same states, markers and camera offsets through both packages'
    renderers give the same pixels."""
    rng = np.random.default_rng(0)
    states = np.zeros((6, 13))
    states[:, 0:5:2] = rng.uniform(-1.0, 1.0, (6, 3)) - [0.0, 0.0, 2.0]
    q = rng.normal(size=(6, 4)) * [0.1, 0.1, 0.1, 1.0] + [0.0, 0.0, 0.0, 2.0]
    states[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    for st, marker, off in zip(states, rng.uniform(-0.5, 0.5, (6, 2)),
                               rng.uniform(1.0, 3.0, (6, 3))):
        np.testing.assert_array_equal(
            native.render_preview(st, tuple(marker), tuple(off), 96, 72),
            jnative.render_preview(st, tuple(marker), tuple(off), 96, 72))
    np.testing.assert_array_equal(native.render_trajectory(states, width=64, height=48),
                                  jnative.render_trajectory(states, width=64, height=48))


@needs_preview
def test_native_source_is_the_jax_packages():
    """The renderer's code is the JAX package's: the sources differ only in
    the header comment that says how each is built."""
    here = os.path.dirname(native.__file__)
    jax_src = os.path.join(here, "..", "..", "autonomous_quadrotor_environment_tpu", "native",
                           "preview.cpp")
    code = lambda p: [ln for ln in open(p).read().splitlines() if not ln.startswith("//")]
    assert code(os.path.join(here, "preview.cpp")) == code(jax_src)


@needs_preview
def test_replay_writes_frames_and_runs_live(tmp_path, capsys):
    states = np.zeros((100, 13))
    states[:, 6] = 1.0
    states[:, 4] = np.linspace(0, -4, 100)
    log = str(tmp_path / "flight.npy")
    np.save(log, states)
    out = replay.main(["--log", log, "--mode", "orbit", "--every", "25", "--width", "80",
                       "--height", "60", "--out", str(tmp_path / "frames")])
    assert len(out["frames"]) == 4
    size = len(b"P6 80 60 255\n") + 80 * 60 * 3
    assert all(os.path.getsize(f) == size for f in out["frames"])
    r = replay.main(["--log", log, "--live", "--fps", "100", "--term-cols", "20",
                     "--max-seconds", "0.1"])
    assert r["live"] and r["frames"] >= 5
    assert "rpy=(+0.00,+0.00,+0.00)" in capsys.readouterr().out


def test_replay_text_is_the_jax_packages():
    """`ansi_frame` on one image at three widths and `hud_line` along one
    state log give the JAX package's strings."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    for cols in (7, 20, 80):
        assert replay.ansi_frame(img, cols) == jreplay.ansi_frame(img, cols)
    states = rng.normal(size=(40, 13))
    states[:, 6:10] += [3.0, 0.0, 0.0, 0.0]
    for t, x in enumerate(states):
        assert replay.hud_line(0.05 * t, x) == jreplay.hud_line(0.05 * t, x)


def test_watch_renders_the_port_trainers_jsonl(tmp_path):
    """`watch --once` over the JSONL of a 2-update `train_control` run of
    the port."""
    train_control.main(["--updates", "2", "--eval-every", "1", "--num-envs", "8",
                        "--rollout-steps", "4", "--eval-episodes", "2", "--device", "cpu",
                        "--out", str(tmp_path)])
    (jsonl,) = [p for p in os.listdir(tmp_path) if p.endswith(".jsonl")]
    out = watch.main([str(tmp_path / jsonl), "--once"])
    assert f"({len(watch.read_rows(str(tmp_path / jsonl)))} log rows)" in out
    for label in ("eval reward", "critic loss", "latest"):
        assert label in out
    path = str(tmp_path / jsonl)
    assert watch.render(watch.read_rows(path), path) == jwatch.render(jwatch.read_rows(path),
                                                                     path)
    for values, width in (([3.0, None, 1.0, 2.5], 60), (list(np.linspace(0, 1, 150)), 40)):
        assert watch.sparkline(values, width) == jwatch.sparkline(values, width)


LIVE_EP, LIVE_CHUNK, LIVE_FRAMES = 1, 5, 8


@pytest.fixture(scope="module")
def live_setup():
    cfg = EnvConfig(n_steps=me.MISSION_STEPS, direct_control=True, training=False)
    model = load_policy(SOLVED_CONTROLLER, 128, torch.device("cpu"))
    traj = stack_trajectories([me._make_traj(target_parse(LIVE_EP), cfg.dt)])
    draws = jax_mission_sensor_draws(0, LIVE_EP + 1, LIVE_CHUNK * LIVE_FRAMES)
    draws = me.SensorDraws(draws.drift_u[LIVE_EP:],
                           graphs.tree_map(lambda a: a[:, LIVE_EP:], draws.noise))
    return cfg, model, traj, draws


def _fly_live(live_setup, mode):
    """``LIVE_FRAMES`` frames of one mode's `live_mission` chunk stepper from
    the mission's start: each frame's last log row."""
    cfg, model, traj, draws = live_setup
    step = live_mission.make_steppers(cfg, model, SensorConfig(), LIVE_CHUNK)[mode]
    carry = me.make_mission_body(cfg, model, SensorConfig(), False)[1](1, draws.drift_u)
    rows = []
    with torch.no_grad():
        for f in range(LIVE_FRAMES):
            noise = graphs.tree_map(lambda a: a[f * LIVE_CHUNK:(f + 1) * LIVE_CHUNK], draws.noise)
            carry, row = step(carry, f * LIVE_CHUNK, noise, (traj.positions, traj.velocities))
            rows.append(row[0].numpy())
    return np.stack(rows)


def test_live_mission_true_state_frames_match_jax(live_setup):
    """The true-state mode (deterministic) frame by frame against the JAX
    package's true-state mission run, whose body its live rig steps: every
    frame's log row within the missions' parity tolerance (rtol 1e-4)."""
    cfg, model, traj, draws = live_setup
    steps = LIVE_CHUNK * LIVE_FRAMES
    jcfg = JEnvConfig(n_steps=me.MISSION_STEPS, direct_control=True, training=False)
    jmodel = JActorCritic(hidden=128)
    jparams = load_params(SOLVED_CONTROLLER,
                          jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 75))))
    run = jme.make_rl_mission_runner(jcfg, jmodel, jparams, JSensorConfig(), False, steps)
    want = np.asarray(run(jme._make_traj(jtarget_parse(LIVE_EP), jcfg.dt), jax.random.PRNGKey(0)))
    got = _fly_live(live_setup, 0)
    np.testing.assert_allclose(got, want[LIVE_CHUNK - 1::LIVE_CHUNK], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", [1, 2])
def test_live_mission_sensor_frames_are_the_runners(live_setup, mode):
    """The MEMS and hybrid modes' chunks of 5 (the hybrid one's fixes due at
    steps 1, 11, 21 and 31, its chunks keyed by phases 0 and 5) give, frame
    by frame, the rows of `missions_eval`'s runner on the same draws, to
    the bit; the runner is held to the JAX package's in
    tests/test_torch_missions_cli.py and test_torch_missions_vision.py."""
    cfg, model, traj, draws = live_setup
    run = me.make_rl_mission_runner(cfg, model, SensorConfig(), True, LIVE_CHUNK * LIVE_FRAMES,
                                    use_vision=mode == 2)
    want = run(traj, draws)[0]
    np.testing.assert_array_equal(_fly_live(live_setup, mode), want[LIVE_CHUNK - 1::LIVE_CHUNK])


def test_live_mission_switches_modes_headless():
    """The three modes over one carry, switched by scripted hotkeys; the
    hybrid mode's chunks of 5 start at phases 0 and 5 of its 10-step
    cadence."""
    r = live_mission.main(["--policy", SOLVED_CONTROLLER, "--headless-keys", ".2.3.1",
                           "--max-seconds", "0.5", "--fps", "20", "--device", "cpu"])
    assert r["mode_switches"] == 3 and r["frames"] >= 5 and r["mode"] == "true-state"


def test_manual_flight_scripted_and_autopilot(tmp_path):
    """--script with an untrained width-16 controller and --autopilot with
    the solved one: one episode each, logged through the CSV that
    `aggregate_pilot_logs` pools (properties, not values: the draws differ
    from the JAX package's, whose seed is a salted string hash); the
    autopilot lands its episode (it does at this user's seed)."""
    torch.manual_seed(0)
    ctrl = str(tmp_path / "ctrl.msgpack")
    save_params(ctrl, to_flax(ActorCritic(hidden=16)))
    cmds = np.zeros((200, 3))
    cmds[:, 2] = -1.0
    script = str(tmp_path / "cmds.npy")
    np.save(script, cmds)
    before = render_kernel.render_nadir_batch.launches
    out = manual_flight.main(["--controller", ctrl, "--controller-size", "16", "--user",
                              "test", "--episodes", "1", "--script", script, "--out",
                              str(tmp_path / "runs"), "--device", "cpu"])
    assert render_kernel.render_nadir_batch.launches == before  # the CPU renders plainly
    assert len(out["episodes"]) == 1 and os.path.exists(out["log"])
    assert aggregate_pilot_logs(str(tmp_path / "runs" / "log_*_eval.csv"))["episodes"] == 1
    ap = manual_flight.main(["--controller", SOLVED_CONTROLLER, "--user", "ap", "--episodes",
                             "1", "--autopilot", "--out", str(tmp_path / "runs"), "--device",
                             "cpu"])
    agg = aggregate_pilot_logs(str(tmp_path / "runs" / "log_*_eval.csv"))
    assert agg["episodes"] == 2
    assert ap["episodes"][0]["Solved"] == 1 and ap["episodes"][0]["Time"] > 0


def test_forward_bench_rows():
    rows = forward_bench.main(["--iters", "2", "--batch", "64", "--device", "cpu"])
    assert [r["size"] for r in rows] == list(forward_bench.SIZES)
    assert all(r["device"] == "cpu" and r["latency_single_us"] > 0 for r in rows)


ANALYSIS = ("flight_logs.py", "training_logs.py", "plots.py")


@pytest.mark.parametrize("name", ANALYSIS)
def test_analysis_source_is_the_jax_packages(name):
    """`analysis/` is a copy of the JAX package's: each module's source is
    the same."""
    here = os.path.dirname(analysis.__file__)
    jax_dir = os.path.dirname(janalysis.__file__)
    assert open(os.path.join(here, name)).read() == open(os.path.join(jax_dir, name)).read()


@pytest.fixture(scope="module")
def log_set(tmp_path_factory):
    """One set of CSV logs: training logs of two sizes and three seeds (one
    stopped early, one never solving), a file that is no size's, and two
    pilots' episode logs."""
    d = tmp_path_factory.mktemp("logs")
    rng = np.random.default_rng(2)
    for size in (64, 128):
        for seed, n in enumerate((12, 7, 12)):
            r = np.cumsum(rng.uniform(-20.0, 150.0 if seed != 2 else 40.0, n))
            _write_log(str(d / f"log_{size}_{seed}.csv"), list(r), solved_scale=700.0)
    _write_log(str(d / "log_final_0.csv"), [1.0, 2.0])
    pilots = d / "pilots"
    pilots.mkdir()
    for user, n in (("ann", 5), ("bo", 3)):
        with open(pilots / f"log_{user}_eval.csv", "w") as f:
            f.write("Episode,Delta V,Reward,Time,Solved\n")
            for ep in range(n):
                dv, rew, t = rng.normal(0, 0.4), rng.uniform(-5, 20), rng.uniform(2, 9)
                f.write(f"{ep},{dv},{rew},{t},{int(rew > 5)}\n")
    return d


def _analyses(a, d):
    paths = sorted(str(p) for p in d.glob("log_*_*.csv"))
    return {
        "training_curves": a.training_curves(paths),
        "size_sweep_summary": a.size_sweep_summary(str(d)),
        "episodes_to_solve": [(a.episodes_to_solve(p), a.episodes_to_solve(
            p, reward_threshold=None, solved_threshold=0.9)) for p in paths],
        "flight_hours_to_solve": [(a.flight_hours_to_solve(p, reward_threshold=300.0),
                                   a.flight_hours_to_solve(p, solved_threshold=0.5, dt=0.02))
                                  for p in paths],
        "aggregate_pilot_logs": (a.aggregate_pilot_logs(str(d / "pilots" / "log_*_eval.csv")),
                                 a.aggregate_pilot_logs(str(d / "pilots" / "none_*.csv"))),
    }


@pytest.mark.parametrize("fn", ["training_curves", "size_sweep_summary", "episodes_to_solve",
                                "flight_hours_to_solve", "aggregate_pilot_logs"])
def test_analysis_matches_jax(log_set, fn):
    """Each analysis of the one log set gives the JAX package's result."""
    got = _analyses(analysis, log_set)[fn]
    assert got == _analyses(janalysis, log_set)[fn]
    assert got and got != [(None, None)] * len(got)


def test_plots_match_jax(log_set, tmp_path):
    """Each figure of both packages from the same inputs: the same PNG, and
    the same band summary."""
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(3)
    states = np.cumsum(rng.normal(0, 0.05, (50, 13)), axis=0)
    curves = analysis.training_curves(sorted(str(p) for p in log_set.glob("log_64_*.csv")))
    errors = rng.normal(0, 0.2, (8, 100, 3))
    results = {"pid": np.abs(rng.normal(0, 0.3, (4, 60, 12))),
               "rl": np.abs(rng.normal(0, 0.2, (4, 60, 12)))}
    for pk, tag in ((plots, "port"), (jplots, "jax")):
        out = tmp_path / tag
        out.mkdir()
        pk.plot_trajectory_3d(states, str(out / "traj.png"), target=[1.0, 0.0, 2.0])
        pk.plot_training_curves(curves, str(out / "curves.png"), metric="solved")
        pk.plot_landing_stats(errors, str(out / "landing.png"))
        pk.plot_controller_comparison(results, str(out / "compare.png"))
        summary = pk.sweep_band_figure(str(log_set), [64, 128, 256], [0, 1, 2],
                                       str(out / "bands.png"))
        (out / "bands.json").write_text(json.dumps(summary, sort_keys=True))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 6
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def _write_log(path, rewards, solved_scale=10.0):
    with open(path, "w") as f:
        f.write("Training Count,Total Timesteps,Total Episodes,Reward avg,Solved avg\n")
        for i, r in enumerate(rewards):
            f.write(f"{i},{(i + 1) * 100},{(i + 1) * 10},{r},{min(r / solved_scale, 1.0)}\n")


def test_analysis_reads_training_logs(tmp_path):
    path = str(tmp_path / "log_128_0.csv")
    _write_log(path, [1.0, 5.0, 9.0])
    curves = training_curves([path])
    assert curves[path]["reward"] == [1.0, 5.0, 9.0]
    assert episodes_to_solve(path, reward_threshold=4.0) == 20
    assert episodes_to_solve(path, reward_threshold=None, solved_threshold=0.9) == 30


def test_timer_memdebug_and_build_directory(tmp_path):
    t = Timer()
    for _ in range(2):
        with t.measure():
            torch.ones(8).sum()
    assert len(t.times) == 2 and t.last >= 0 and t.mean >= 0
    keep = torch.zeros(1000)
    census = live_array_summary()
    assert census["count"] >= 1 and census["bytes"] >= keep.numel() * 4
    assert device_memory_stats("cpu") == {}
    default = _build.BUILD_DIR
    try:
        enable_compilation_cache(str(tmp_path / "build"))
        assert _build.BUILD_DIR == str(tmp_path / "build") and os.path.isdir(_build.BUILD_DIR)
    finally:
        _build.BUILD_DIR = default
    json.dumps(census)


def test_build_directory_from_the_environment(tmp_path, monkeypatch):
    """The apps' call without an argument points the build directory at
    ``AQE_TORCH_BUILD_DIR`` where it is set, as the JAX package's does at
    ``AQE_TPU_CACHE``, and leaves it where it is otherwise."""
    import importlib

    from autonomous_quadrotor_environment_tpu_torch.utils import cache

    default = _build.BUILD_DIR
    try:
        monkeypatch.setenv("AQE_TORCH_BUILD_DIR", str(tmp_path / "env"))
        importlib.reload(cache).enable_compilation_cache()
        assert _build.BUILD_DIR == str(tmp_path / "env") and os.path.isdir(_build.BUILD_DIR)
        _build.BUILD_DIR = default
        monkeypatch.delenv("AQE_TORCH_BUILD_DIR")
        importlib.reload(cache).enable_compilation_cache()
        assert _build.BUILD_DIR == default
    finally:
        _build.BUILD_DIR = default
        monkeypatch.delenv("AQE_TORCH_BUILD_DIR", raising=False)
        importlib.reload(cache)
