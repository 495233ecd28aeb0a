"""Interactive live mission rig: fly, watch, and switch control modes LIVE.

Counterpart of `apps/live_mission.py` in the JAX package: the reference's
interactive inspection stack — the Panda3D window with the operation-mode
menu that flips True-State / MEMS / Hybrid on the RUNNING sim with a live
estimation-error readout (reference: config/menu.py:28-78), the
orbit/chase camera with r/c hotkeys and WASD/QE free movement
(models/camera_control.py:3-127), and the real-time 20 FPS pacing of the
eval viewer (conf_eval.prc via manual_flight_add/quad_controller.py:60-62)
— as a dependency-free ANSI terminal app over the native C++ preview
renderer.

Hotkeys (raw terminal):
  1 / 2 / 3   switch control mode live: True-State / MEMS / Hybrid-vision
  c           toggle chase cam <-> orbit cam        (camera_control 'c')
  r           reset camera offset                   (camera_control 'r')
  w/a/s/d/e/z move the chase-camera offset          (camera_control WASD/QE)
  q           quit

The three control modes are chunk steppers over the SAME carry
(apps/missions_eval.make_mission_body), so a mode switch calls another
stepper on the live state. On the CUDA card (the default; ``--device cpu``
otherwise) each frame's chunk of physics steps (5 at 20 fps) is one replay
of its mode's CUDA graph, captured at the mode's first use and never
again. The hybrid mode's fixes are due every 10 steps, which a chunk of 5
does not hold fixed, so its graphs are keyed by the chunk's first step
modulo 10: two graphs, one with the fix and one without. Each frame's
sensor draws come from one generator, seeded from ``--seed`` and the
episode, whatever the mode.

    python -m autonomous_quadrotor_environment_tpu_torch.apps.live_mission \
        --policy autonomous_quadrotor_environment_tpu/fixtures/nn_solved_128_0.msgpack
"""

from __future__ import annotations

import argparse
import math
import select
import sys
import time

import numpy as np
import torch

from ..config import EnvConfig, SensorConfig
from ..device import resolve_device
from ..envs.sensors import draw_sensor_noise
from ..missions import episode_n, stack_trajectories, target_parse
from ..utils import graphs
from ..utils.cache import enable_compilation_cache
from .missions_eval import (
    _SENSORS,
    MISSION_STEPS,
    VISION_EVERY,
    _make_traj,
    make_mission_body,
)
from .replay import ansi_frame, hud_line
from .robust_eval import load_policy
from .train_control import stream

MODES = ("true-state", "mems", "hybrid")


class Hotkeys:
    """Raw-terminal hotkey poller (same technique as manual_flight.KeyInput)."""

    def __init__(self):
        import termios
        import tty

        self.termios = termios
        self.fd = sys.stdin.fileno()
        self.old = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)

    def close(self):
        self.termios.tcsetattr(self.fd, self.termios.TCSADRAIN, self.old)

    def poll(self) -> list[str]:
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            keys.append(sys.stdin.read(1).lower())
        return keys


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--policy", type=str, required=True)
    p.add_argument("--policy-size", type=int, default=128)
    p.add_argument("--episode", type=int, default=0,
                   help="target-table episode (missions/targets.py)")
    p.add_argument("--mode", type=int, default=0, choices=(0, 1, 2),
                   help="initial mode: 0 true-state, 1 MEMS, 2 hybrid")
    p.add_argument("--fps", type=float, default=20.0)
    p.add_argument("--term-cols", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-seconds", type=float, default=0.0,
                   help="stop after this much sim time (0 = full mission)")
    p.add_argument("--headless-keys", type=str, default=None,
                   help="scripted hotkey string, one char per frame "
                   "(CI-testable path; no raw terminal, no drawing)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card when omitted")
    return p


def make_steppers(env_cfg: EnvConfig, model, scfg: SensorConfig, chunk: int) -> list:
    """One chunk stepper per mode, ``step(carry, i0, noise, table) ->
    (carry, last log row)``: the ``chunk`` steps from step ``i0`` (a Python
    int) as one `graphs.scan` chunk, its graph keyed by the mode (and, for
    the hybrid mode, by ``i0 % VISION_EVERY``)."""
    params = list(model.parameters())
    steppers = []
    for mode, (use_sensors, use_vision) in enumerate(((False, False), (True, False),
                                                      (True, True))):
        body, _ = make_mission_body(env_cfg, model, scfg, use_sensors, use_vision)

        def step(carry, i0, noise, table, body=body, mode=mode, use_vision=use_vision):
            carry, logs = graphs.scan(("live_mission", mode, id(model), env_cfg, scfg), body,
                                      carry, chunk, xs=noise, consts=table, params=params,
                                      period=VISION_EVERY if use_vision else None, start=i0)
            return carry, logs[-1]

        steppers.append(step)
    return steppers


@torch.no_grad()
def main(argv=None) -> dict:
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    from ..native import preview_available, render_preview

    headless = args.headless_keys is not None
    if not headless and not preview_available():
        raise SystemExit("native preview renderer unavailable (needs g++)")
    device = resolve_device(args.device)

    env_cfg = EnvConfig(n_steps=MISSION_STEPS, direct_control=True, training=False)
    scfg = SensorConfig()
    model = load_policy(args.policy, args.policy_size, device)

    episode = args.episode % episode_n()
    traj = stack_trajectories([_make_traj(target_parse(episode), env_cfg.dt)]).to(device)
    table = (traj.positions, traj.velocities)

    # Physics steps per rendered frame: sim time tracks wall time at --fps.
    chunk = max(int(round(1.0 / (args.fps * env_cfg.dt))), 1)
    steppers = make_steppers(env_cfg, model, scfg, chunk)
    _, init = make_mission_body(env_cfg, model, scfg, False)
    gen = torch.Generator(device=device).manual_seed(stream(args.seed, _SENSORS, episode))
    carry = init(1, torch.rand(1, 3, generator=gen, device=device))
    mode = args.mode
    # Capture the initial mode's graph before pacing starts.
    steppers[mode](carry, 0, draw_sensor_noise(gen, (chunk, 1)), table)

    cam_neutral = np.array([3.0, 3.0, 2.0])
    cam_offset = cam_neutral.copy()
    orbit = False
    moves = {"w": (0, -0.5, 0), "s": (0, 0.5, 0), "a": (-0.5, 0, 0),
             "d": (0.5, 0, 0), "e": (0, 0, 0.5), "z": (0, 0, -0.5)}

    keys_src = None if headless else Hotkeys()
    switches = 0
    frames = 0
    t_next = time.perf_counter()
    frame_budget = 1.0 / args.fps
    try:
        for f in range(MISSION_STEPS // chunk):
            sim_t = f * chunk * env_cfg.dt
            if args.max_seconds and sim_t >= args.max_seconds:
                break
            if headless:
                pressed = [args.headless_keys[f]] if f < len(args.headless_keys) else []
            else:
                pressed = keys_src.poll()
            for ch in pressed:
                if ch == "q":
                    raise KeyboardInterrupt
                if ch in "123":
                    new_mode = int(ch) - 1
                    if new_mode != mode:
                        mode = new_mode
                        switches += 1
                elif ch == "c":
                    orbit = not orbit
                elif ch == "r":
                    cam_offset = cam_neutral.copy()
                    orbit = False
                elif ch in moves:
                    cam_offset = cam_offset + np.asarray(moves[ch])

            noise = draw_sensor_noise(gen, (chunk, 1))
            carry, log = steppers[mode](carry, f * chunk, noise, table)
            log = log[0].cpu().double().numpy()
            x, err_norm, est_err = log[:13], log[16], log[17]

            if not headless:
                if orbit:
                    a = 2 * math.pi * sim_t / 8.0
                    off = (4.0 * math.cos(a), 4.0 * math.sin(a), 2.0)
                else:
                    off = tuple(cam_offset)
                img = render_preview(x, (0.0, 0.0), off, 320, 240)
                sys.stdout.write(
                    "\x1b[H\x1b[2J" + ansi_frame(img, args.term_cols) + "\n"
                    + f"[{MODES[mode]:>10}]  " + hud_line(sim_t, x) + "\n"
                    + f"track err {err_norm:6.3f} m   INS est err {est_err:6.3f} m   "
                    + "(1/2/3 mode, c cam, r reset, wasdez move, q quit)\n"
                )
                sys.stdout.flush()
            frames += 1
            t_next += frame_budget
            delay = t_next - time.perf_counter()
            if not headless and delay > 0:
                time.sleep(delay)
    except KeyboardInterrupt:
        pass  # intentional: 'q'/^C ends the live session; cleanup in finally
    finally:
        if keys_src is not None:
            keys_src.close()
    return {"frames": frames, "mode": MODES[mode], "mode_switches": switches}


if __name__ == "__main__":
    main()
