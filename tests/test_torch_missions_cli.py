"""The port's mission, step-response and polish entry points against the
JAX package's, on the CPU: `missions_eval` with the PID and with the solved
fixture on the true state (300 steps) and on the fused sensor estimate
with the JAX package's own draws injected (50 steps), per episode;
`--vision` refused with the ROADMAP item that will port it;
`step_response` (200 steps); `train_control --polish` for 2 updates."""

import numpy as np
import pytest

from autonomous_quadrotor_environment_tpu.apps import missions_eval as jme
from autonomous_quadrotor_environment_tpu.apps import step_response as jsr
from autonomous_quadrotor_environment_tpu_torch.apps import missions_eval as me
from autonomous_quadrotor_environment_tpu_torch.apps import step_response as sr
from autonomous_quadrotor_environment_tpu_torch.apps import train_control
from autonomous_quadrotor_environment_tpu_torch.fixtures import SOLVED_CONTROLLER
from torch_parity import jax_mission_sensor_draws

# Each episode's mean tracking error over the run: float32 closed loops that
# differ in last bits (library transcendentals, summation order), averaged.
RTOL, ATOL = 1e-4, 1e-7


def _errors(res):
    return np.array([r["mean_track_err"] for r in res["episodes"]])


@pytest.mark.parametrize("policy", [False, True])
def test_missions_eval_matches_jax(policy, tmp_path):
    argv = ["--steps", "300"] + (["--policy", SOLVED_CONTROLLER] if policy else [])
    want = jme.main(argv + ["--out", str(tmp_path / "jax")])
    got = me.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    name = "rl" if policy else "pid"
    assert (tmp_path / "port" / f"{name}_results.csv").read_text().splitlines()[0] == (
        tmp_path / "jax" / f"{name}_results.csv").read_text().splitlines()[0]
    np.testing.assert_allclose(_errors(got), _errors(want), rtol=RTOL, atol=ATOL)
    for g, w in zip(got["episodes"], want["episodes"]):
        assert g.keys() == w.keys() and g["mission_class"] == w["mission_class"]
        np.testing.assert_allclose([g["Over X"], g["SS Z"]], [w["Over X"], w["SS Z"]],
                                   rtol=1e-4, atol=1e-5)


def test_missions_eval_sensors_with_the_jax_draws(tmp_path, monkeypatch):
    """--sensors at 50 steps, each episode's sensor draws walked down the
    JAX package's own key chains and injected into the port: the fused
    estimate and so the flight follow JAX's, episode by episode."""
    steps, seed = 50, 3
    monkeypatch.setattr(me, "draw_sensors", lambda s, e, n, device: jax_mission_sensor_draws(
        s, e, n))
    argv = ["--steps", str(steps), "--seed", str(seed), "--policy", SOLVED_CONTROLLER,
            "--sensors"]
    want = jme.main(argv + ["--out", str(tmp_path / "jax")])
    got = me.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    assert (tmp_path / "port" / "rl_sens_results.csv").exists()
    np.testing.assert_allclose(_errors(got), _errors(want), rtol=RTOL, atol=ATOL)


def test_missions_eval_refuses_vision(tmp_path):
    with pytest.raises(NotImplementedError, match="A15"):
        me.main(["--policy", SOLVED_CONTROLLER, "--vision", "--device", "cpu",
                 "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_step_response_matches_jax():
    argv = ["--policy", SOLVED_CONTROLLER, "--steps", "200"]
    want = jsr.main(argv)
    got = sr.main(argv + ["--device", "cpu"])
    assert list(got) == list(want)
    for case in want:
        for k, w in want[case].items():
            if k.endswith("_s") or w is None:
                assert got[case][k] == w, (case, k)
            else:
                np.testing.assert_allclose(got[case][k], w, rtol=1e-4, atol=1e-5)


def test_train_control_polish_runs(tmp_path, capsys):
    """`--polish --resume-from` the solved fixture for 2 updates at a tiny
    batch, lr 0 so that the weights stay the fixture's: at the eval after
    them the polish runner flies the 20 classical starts and reads the RL
    leg's rate on the CPU, 0.95 (episode 16 diverges; classical_compare);
    0.95 < 1, so the gate does not accept and nothing is saved as solved."""
    result = train_control.main([
        "--polish", "--resume-from", SOLVED_CONTROLLER, "--lr", "0", "--updates", "2",
        "--eval-every", "2", "--num-envs", "8", "--rollout-steps", "4", "--eval-episodes",
        "2", "--device", "cpu", "--out", str(tmp_path)])
    assert result["polish_classical"] == 0.95
    assert capsys.readouterr().out.count("polish: classical leg 95%") == 1
    assert (tmp_path / "nn_final_128_0.msgpack").exists()
    assert not (tmp_path / "solved").exists()
