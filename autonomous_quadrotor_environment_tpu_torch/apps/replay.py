"""Flight replay viewer: render a trajectory through the native preview.

Counterpart of `apps/replay.py` in the JAX package, on the host: the
reference's interactive inspection rig
(reference: models/camera_control.py:3-127 — orbit/chase cameras with
WASD/QE movement and hotkeys — and the plotter's 3D view): renders a saved
trajectory (T, 13) .npy log to an image sequence with a chase camera or an
orbiting camera, via the C++ preview renderer. Headless-friendly (frames to
PPM/PNG); a display is not required.

Live mode (--live) adds the reference's real-time paced viewing: frames are
clocked at --fps wall-clock (the reference's conf_eval.prc fixes the eval
viewer to 20 FPS, manual_flight_add/quad_controller.py:60-62), drawn
directly in the terminal as ANSI half-block pixels with the HUD line
(sim-time, position, velocity, attitude) the reference overlays on screen.

Example:
    python -m autonomous_quadrotor_environment_tpu_torch.apps.replay \
        --log runs/flight.npy --mode orbit --out runs/frames
    python -m autonomous_quadrotor_environment_tpu_torch.apps.replay \
        --log runs/flight.npy --live
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--log", type=str, required=True, help="(T, 13) state .npy")
    p.add_argument("--marker", type=float, nargs=2, default=(0.0, 0.0))
    p.add_argument("--mode", choices=("chase", "orbit"), default="chase")
    p.add_argument("--orbit-radius", type=float, default=4.0)
    p.add_argument("--orbit-period", type=float, default=8.0, help="seconds/rev")
    p.add_argument("--chase-offset", type=float, nargs=3, default=(3.0, 3.0, 2.0))
    p.add_argument("--every", type=int, default=10, help="render every Nth state")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--live", action="store_true",
                   help="real-time paced terminal viewer instead of files")
    p.add_argument("--fps", type=float, default=20.0,
                   help="live-mode wall-clock frame rate (reference "
                   "conf_eval.prc: 20)")
    p.add_argument("--term-cols", type=int, default=96)
    p.add_argument("--max-seconds", type=float, default=0.0,
                   help="live mode: stop after this much sim time (0 = all)")
    p.add_argument("--out", type=str, default="runs/replay")
    return p


def ansi_frame(img: np.ndarray, cols: int) -> str:
    """Downsample (H, W, 3) uint8 to `cols` wide and draw with 24-bit-color
    upper-half-block characters (2 pixels per cell)."""
    h, w, _ = img.shape
    rows = max(int(cols * h / w * 0.5) * 2, 2)
    ys = (np.arange(rows) * (h / rows)).astype(int)
    xs = (np.arange(cols) * (w / cols)).astype(int)
    small = img[np.ix_(ys, xs)]
    out = []
    for r in range(0, rows - 1, 2):
        line = []
        for c in range(cols):
            tr, tg, tb = small[r, c]
            br, bg, bb = small[r + 1, c]
            line.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def hud_line(t: float, x: np.ndarray) -> str:
    """The reference viewer's on-screen state text (quad_controller.py HUD)."""
    import torch

    from ..core.quaternion import quat_euler, quat_normalize

    ang = quat_euler(quat_normalize(torch.tensor(np.asarray(x[6:10], np.float32)))).numpy()
    return (
        f"t={t:6.2f}s  pos=({x[0]:+5.2f},{x[2]:+5.2f},{x[4]:+5.2f})  "
        f"vel=({x[1]:+5.2f},{x[3]:+5.2f},{x[5]:+5.2f})  "
        f"rpy=({ang[0]:+5.2f},{ang[1]:+5.2f},{ang[2]:+5.2f})"
    )


def _camera_offset(args, t: int):
    if args.mode == "orbit":
        a = 2 * math.pi * (t * args.dt) / args.orbit_period
        return (
            args.orbit_radius * math.cos(a),
            args.orbit_radius * math.sin(a),
            2.0,
        )
    return tuple(args.chase_offset)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ..native import preview_available, render_preview, save_ppm

    if not preview_available():
        raise SystemExit("native preview renderer unavailable (needs g++)")

    states = np.load(args.log)

    if args.live:
        # Real-time pacing: one rendered frame per 1/fps wall seconds; the
        # sim advances fps*dt states per frame (sim time == wall time).
        stride = max(int(round(1.0 / (args.fps * args.dt))), 1)
        frame_budget = 1.0 / args.fps
        n_frames = 0
        t_next = time.perf_counter()
        for t in range(0, len(states), stride):
            sim_t = t * args.dt
            if args.max_seconds and sim_t > args.max_seconds:
                break
            img = render_preview(
                states[t], tuple(args.marker), _camera_offset(args, t), 320, 240
            )
            sys.stdout.write(
                "\x1b[H\x1b[2J" + ansi_frame(img, args.term_cols) + "\n"
                + hud_line(sim_t, states[t]) + "\n"
            )
            sys.stdout.flush()
            n_frames += 1
            t_next += frame_budget
            delay = t_next - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        return {"frames": n_frames, "live": True}

    os.makedirs(args.out, exist_ok=True)
    frames = []
    for n, t in enumerate(range(0, len(states), args.every)):
        img = render_preview(
            states[t], tuple(args.marker), _camera_offset(args, t),
            args.width, args.height,
        )
        path = f"{args.out}/frame_{n:05d}.ppm"
        save_ppm(path, img)
        frames.append(path)
    print(f"{len(frames)} frames -> {args.out}")
    return {"frames": frames}


if __name__ == "__main__":
    main()
