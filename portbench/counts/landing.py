"""Operations and bytes of the visual-landing train step: the two-trunk CNN
actor-critic, the frozen controller in each decision's frames, and the
nadir render of each observation."""

from __future__ import annotations

from . import hover

IMAGE = (3, 84, 84)
# (in channels, out channels, kernel, stride) of each trunk's convolutions,
# on the plain image (the space-to-depth layout computes the same products)
CONVS = ((3, 64, 8, 4), (64, 128, 4, 2), (128, 128, 3, 1))
TRUNK_OUT = 768
SENS, ACT = 75, 3
# Float operations of the render per pixel, each sin or cos counted as one:
# 2 for the height, 8 for the hit point, 2 for the footprint, 2 + 2
# offsets, 2 x 18 for the square waves, 7 for the checker value, 2 + 24 for
# the board and border masks, 12 for the ground wave, 4 for the board
# color, 3 x 9 for the channels.
RENDER_OPS_PER_PIXEL = 128


def trunk_layers() -> list:
    """(name, multiply-adds per image, multiply-adds of its input's
    gradient) of one trunk's layers."""
    _, h, w = IMAGE
    out, c = [], IMAGE[0]
    for i, (cin, cout, k, s) in enumerate(CONVS):
        h, w = (h - k) // s + 1, (w - k) // s + 1
        macs = h * w * cout * k * k * cin
        out.append((f"conv{i}", macs, 0 if i == 0 else macs))
        c = cout
    flat = c * h * w
    out.append(("dense", flat * TRUNK_OUT, flat * TRUNK_OUT))
    return out


def head_layers() -> list:
    """(name, multiply-adds per row) of the four heads."""
    return [("actor_fc1", (TRUNK_OUT + SENS) * TRUNK_OUT), ("actor_out", TRUNK_OUT * ACT),
            ("critic_fc1", (TRUNK_OUT + SENS + ACT) * TRUNK_OUT), ("critic_out", TRUNK_OUT)]


def forward_flops() -> int:
    """FLOP of actor and critic on one observation: both trunks and the
    heads."""
    macs = 2 * sum(m for _, m, _ in trunk_layers()) + sum(m for _, m in head_layers())
    return 2 * macs


def update_flops_per_row() -> int:
    """FLOP of one row's forward and backward in the update: the forward,
    every weight gradient (as many again), and the data gradients of every
    layer but the first convolution, whose input (the image) takes none."""
    trunk_data = sum(d for _, _, d in trunk_layers())
    # the heads' data gradients reach the trunks' outputs only
    heads_data = 2 * TRUNK_OUT * TRUNK_OUT + TRUNK_OUT * ACT + TRUNK_OUT
    return 2 * forward_flops() + 2 * (2 * trunk_data + heads_data)


def controller_flops(hidden: int = 128) -> int:
    """FLOP of the frozen controller's deterministic actor on one row."""
    return 2 * (SENS * hidden + hidden * hidden + hidden * hover.ACT)


def step_flops(b: int, decisions: int, reset_pool: int, k_epochs: int, frames: int,
               ctrl_hidden: int = 128) -> float:
    """One landing train step: actor and critic at each decision and once
    more for the bootstrap, the controller in each decision's frames and in
    the reset pool's warm-up frames, and K epochs of forward and backward
    over all decisions."""
    rollout = b * (decisions + 1) * forward_flops()
    ctrl = b * (decisions + reset_pool) * frames * controller_flops(ctrl_hidden)
    update = k_epochs * b * decisions * update_flops_per_row()
    return float(rollout + ctrl + update)


def render_bound_s(b: int, peak_flops: float, peak_bytes: float) -> float:
    """Least seconds of one render of ``b`` images: the larger of the bytes
    (each env's 5 input floats read once, the float32 image written once)
    over the memory rate and the pixels' operations over the f32 peak."""
    pixels = float(b) * IMAGE[1] * IMAGE[2]
    return max(4.0 * (b * 5 + IMAGE[0] * pixels) / peak_bytes,
               RENDER_OPS_PER_PIXEL * pixels / peak_flops)
