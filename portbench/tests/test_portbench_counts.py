"""The frozen counts against their hand values, and the landing CNN's count
against a layer-by-layer sum taken from the plain reference's own layers."""

import math

import torch

from portbench.counts import hover, landing, peaks


def test_hover_counts_match_their_hand_values():
    assert hover.forward_flops(75, 128) == 105_216
    assert hover.grad_flops_per_row(75, 128) == 277_248
    assert hover.step_flops(8192, 256, 10, 75, 128) == 8192 * 256 * (105_216 + 10 * 277_248)
    assert hover.n_params(75, 128) == 2 * (75 * 128 + 128 + 128 * 128 + 128) + 128 * 4 + 4 + 129


def _macs_by_hooks(dtype=torch.float32):
    """Multiply-adds of one image through the reference CNN, counted from
    each layer's input and output shapes."""
    from portbench.drivers.landing_ppo import leaf_spec
    from portbench.harness import make_leaves
    from portbench.reference.landing_ppo import CNN
    import json
    import os

    from portbench import harness

    with open(os.path.join(harness.ROOT, "portbench", "configs", "landing_cnn_ctrl128.json")) as f:
        config = json.load(f)
    cnn = CNN(make_leaves(leaf_spec(config), 0, "cpu"), dtype, False)
    total = [0]
    conv, lin = torch.nn.functional.conv2d, torch.nn.functional.linear

    def counting_conv(x, w, b, stride):
        y = conv(x, w, b, stride)
        total[0] += y.numel() // y.shape[0] * w[0].numel()
        return y

    def counting_lin(x, w, b):
        y = lin(x, w, b)
        total[0] += w.numel()
        return y

    import portbench.reference.landing_ppo as ref
    saved = ref.F.conv2d, ref.F.linear
    ref.F.conv2d, ref.F.linear = counting_conv, counting_lin
    try:
        img, sens = torch.rand(1, 3, 84, 84), torch.rand(1, 75)
        cnn.critic(img, sens, cnn.actor(img, sens))
    finally:
        ref.F.conv2d, ref.F.linear = saved
    return total[0]


def test_landing_forward_count_is_the_layer_sum():
    assert landing.forward_flops() == 2 * _macs_by_hooks()
    assert landing.forward_flops() == 112_897_536


def test_landing_update_count():
    trunk = landing.trunk_layers()
    assert [m for _, m, _ in trunk] == [4_915_200, 10_616_832, 7_225_344, 4_816_896]
    fwd = landing.forward_flops() // 2
    data = 2 * (10_616_832 + 7_225_344 + 4_816_896) + 2 * 768 * 768 + 768 * 3 + 768
    assert landing.update_flops_per_row() == 2 * (2 * fwd + data)
    step = landing.step_flops(1024, 24, 2, 5, 10)
    ctrl = 2 * (75 * 128 + 128 * 128 + 128 * 4)
    assert step == 1024 * 25 * 2 * fwd + 1024 * 26 * 10 * ctrl + 5 * 1024 * 24 * (
        landing.update_flops_per_row())


def test_render_bound():
    b = 1024
    bytes_ = 4.0 * (b * 5 + 3 * b * 84 * 84)
    assert math.isclose(landing.render_bound_s(b, peaks.F32_FLOPS, peaks.HBM_BYTES),
                        max(bytes_ / peaks.HBM_BYTES, 128 * b * 84 * 84 / peaks.F32_FLOPS))
