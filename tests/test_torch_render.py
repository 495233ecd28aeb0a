"""The port's camera and renderer (B5's plain version) against the JAX
package's, on the CPU; and the render kernel's wrapper, which takes the
plain version for CPU tensors without counting a launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.config import CameraConfig as JCam
from autonomous_quadrotor_environment_tpu.config import MarkerConfig as JMarker
from autonomous_quadrotor_environment_tpu.ops.render_kernel import render_nadir_batch_pallas
from autonomous_quadrotor_environment_tpu.render import camera as jcamera
from autonomous_quadrotor_environment_tpu.render import scene as jscene
from autonomous_quadrotor_environment_tpu_torch.config import CameraConfig, MarkerConfig
from autonomous_quadrotor_environment_tpu_torch.ops import render_kernel as rk
from autonomous_quadrotor_environment_tpu_torch.render import camera as tcamera
from autonomous_quadrotor_environment_tpu_torch.render import scene as tscene
from torch_parity import n, t

# The JAX package's own bound between its renderer and its Pallas kernel
# (tests/test_ops.py): both sides compute the same float32 expressions,
# apart from the order of a few multiply-adds and the sin/cos libraries.
ATOL = 2e-5


def _poses():
    """8 poses: random, plus one 0.02 m above the ground (footprint 2.4e-4
    m, the sharpest edges), one with the marker far off-frame, one at
    brightness 0.6 and one high (7 m) over a marker at the frame's edge."""
    rng = np.random.default_rng(0)
    quad = np.stack([rng.normal(0, 1, 8), rng.normal(0, 1, 8), rng.uniform(-4.9, 1.5, 8)], -1)
    marker = rng.normal(0, 0.8, (8, 2))
    bright = rng.uniform(0.5, 1.2, 8)
    quad[0, 2] = -5.0 + 0.02
    marker[0] = quad[0, :2] + (0.05, 0.0)  # mid-square: the 2 cm view has no edge
    marker[1] = (6.0, -7.0)
    bright[2] = 0.6
    quad[3] = (0.3, -0.4, 2.0)
    marker[3] = (2.9, -0.4)
    return quad.astype(np.float32), marker.astype(np.float32), bright.astype(np.float32)


def test_camera_matches_jax():
    jc, tc = jcamera.make_camera(JCam()), tcamera.make_camera(CameraConfig())
    for name in ("fx", "fy", "cx", "cy", "width", "height"):
        assert float(getattr(tc, name)) == float(getattr(jc, name)), name
    np.testing.assert_array_equal(n(tc.k), np.asarray(jc.k))
    np.testing.assert_array_equal(n(tcamera.pixel_rays(tc)), np.asarray(jcamera.pixel_rays(jc)))
    np.testing.assert_array_equal(n(tcamera.nadir_rotation()),
                                  np.asarray(jcamera.nadir_rotation()))
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    r = n(tcamera.nadir_rotation())
    tr = np.array([0.1, -0.2, 3.0], np.float32)
    (uv_t, z_t), (uv_j, z_j) = (
        tcamera.project_points(tc, t(pts), t(r), t(tr)),
        jcamera.project_points(jc, pts, r, tr),
    )
    np.testing.assert_allclose(n(uv_t), np.asarray(uv_j), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(n(z_t), np.asarray(z_j), rtol=1e-6)


def test_render_nadir_matches_jax_and_the_pallas_kernel():
    """atol 2e-5 against JAX's `render_nadir` (vmapped) and against
    `render_nadir_batch_pallas` in interpret mode, as tests/test_ops.py
    holds those two together."""
    quad, marker, bright = _poses()
    jc = jcamera.make_camera(JCam())
    want = jax.vmap(lambda p, m, b: jscene.render_nadir(jc, p, m, JMarker(), brightness=b))(
        quad, marker, bright)
    pallas = render_nadir_batch_pallas(jnp.asarray(quad), jnp.asarray(marker), JCam(),
                                       JMarker(), brightness=jnp.asarray(bright),
                                       interpret=True)
    got = tscene.render_nadir(tcamera.make_camera(CameraConfig()), t(quad), t(marker),
                              MarkerConfig(), brightness=t(bright))
    assert got.shape == (8, 3, 84, 84) and got.is_contiguous()
    nhwc = n(got.permute(0, 2, 3, 1))
    np.testing.assert_allclose(nhwc, np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(nhwc, np.asarray(pallas), atol=ATOL, rtol=0)
    # The poses reach what they are there for: the marker fills the low
    # camera's view, the off-frame one is absent, brightness 0.6 dims.
    board = np.abs(nhwc[:, :, :, 0] - nhwc[:, :, :, 1]) < 1e-6  # grey board pixels
    assert board[0].mean() > 0.99 and not board[1].any()
    assert nhwc[2].max() <= 0.6 * 0.95 + 1e-6


def test_render_nadir_batch_plain_at_a_wide_non_square_camera():
    """B5's plain version at 320 x 240 pixels (wider than 256, and not
    square) against the JAX package's Pallas kernel in interpret mode, which
    takes any `CameraConfig`: within 1e-4."""
    quad, marker, bright = _poses()
    jcam, cam = JCam(width=320, height=240), CameraConfig(width=320, height=240)
    want = render_nadir_batch_pallas(jnp.asarray(quad), jnp.asarray(marker), jcam, JMarker(),
                                     brightness=jnp.asarray(bright), interpret=True)
    got = rk.render_nadir_batch_plain(t(quad), t(marker), cam, MarkerConfig(),
                                      brightness=t(bright))
    assert got.shape == (8, 3, 240, 320)
    np.testing.assert_allclose(n(got.permute(0, 2, 3, 1)), np.asarray(want), atol=1e-4, rtol=0)


def test_render_nadir_at_an_edge_two_centimetres_below():
    """The camera 0.02 m over the board's center line, an edge between
    squares: the image's slope there is 0.5 / footprint (about 2,000 per
    metre), so one float32 ulp of the hit point moves a pixel by ~1e-4.
    The port computes the hit point as JAX's `render_nadir` does and stays
    within 2e-5 of it; the Pallas kernel forms it in another order, and
    the port stays within 2e-5 of the gap JAX's two renderers keep from
    each other there."""
    quad = np.array([[0.21, -0.13, -4.98], [0.21, -0.13, -4.99]], np.float32)
    marker = quad[:, :2].copy()
    jc = jcamera.make_camera(JCam())
    want = np.asarray(jax.vmap(lambda p, m: jscene.render_nadir(jc, p, m, JMarker()))(
        quad, marker))
    pallas = np.asarray(render_nadir_batch_pallas(jnp.asarray(quad), jnp.asarray(marker),
                                                  JCam(), JMarker(), interpret=True))
    got = n(tscene.render_nadir(tcamera.make_camera(CameraConfig()), t(quad), t(marker),
                                MarkerConfig()).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    jax_gap = np.abs(want - pallas).max()
    assert np.abs(got - pallas).max() <= jax_gap + ATOL
    # The edge is in view: both squares' colors appear.
    assert got.min() < 0.1 and got.max() > 0.9


def test_render_pinhole_matches_jax_at_tilted_poses_with_sky():
    """A camera tilted 100 degrees from nadir sees sky above the horizon."""
    jc, tc = jcamera.make_camera(JCam()), tcamera.make_camera(CameraConfig())
    rng = np.random.default_rng(2)
    rots, poss = [], []
    for ang in (0.3, 1.2, 1.75, -2.0):
        c, s = np.cos(ang), np.sin(ang)
        tilt = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        rots.append(tilt @ np.asarray(jcamera.nadir_rotation()))
        poss.append([rng.normal(), rng.normal(), rng.uniform(0.5, 4.0)])
    rots, poss = np.stack(rots).astype(np.float32), np.asarray(poss, np.float32)
    marker = rng.normal(0, 0.5, (4, 2)).astype(np.float32)
    want = jax.vmap(lambda r, p, m: jscene.render_pinhole(jc, r, p, m, JMarker()))(
        rots, poss, marker)
    got = n(tscene.render_pinhole(tc, t(rots), t(poss), t(marker), MarkerConfig())
            .permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    sky = np.all(np.abs(got - np.array(tscene.SKY_RGB, np.float32)) < 1e-6, axis=-1)
    assert sky[2].any() and sky[3].any() and not sky[0].any()


@pytest.mark.parametrize("x", [-0.35, -0.1, 0.05, 0.3])
def test_square_wave_parity_is_a_floor_mod(x):
    """Negative cells: parity 1 where floor(x/s) is odd, never -1 (the
    `fmod` trap); matches JAX at every offset."""
    soft = torch.tensor(1e-4)
    xs = torch.linspace(x, x + 0.3, 301)
    got = tscene._smooth_square_wave(xs, 0.1023, soft)
    want = jscene._smooth_square_wave(jnp.asarray(n(xs)), 0.1023, jnp.asarray(1e-4))
    np.testing.assert_allclose(n(got), np.asarray(want), atol=ATOL)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_render_nadir_batch_takes_the_plain_version_on_the_cpu():
    quad, marker, bright = _poses()
    before = rk.render_nadir_batch.launches
    got = rk.render_nadir_batch(t(quad), t(marker), CameraConfig(), MarkerConfig(),
                                brightness=t(bright))
    want = tscene.render_nadir(tcamera.make_camera(CameraConfig()), t(quad), t(marker),
                               MarkerConfig(), brightness=t(bright))
    assert torch.equal(got, want)
    assert torch.equal(got, rk.render_nadir_batch_plain(t(quad), t(marker), brightness=t(bright)))
    assert rk.render_nadir_batch.launches == before == 0
    # Default brightness is 1, the ground height a parameter.
    ones = rk.render_nadir_batch(t(quad), t(marker), ground_z_env=-4.0)
    want = tscene.render_nadir(tcamera.make_camera(CameraConfig()), t(quad), t(marker),
                               MarkerConfig(), ground_z_env=-4.0)
    assert torch.equal(ones, want)


def test_kernel_constants_round_as_the_plain_version():
    g = rk._geometry(CameraConfig(), MarkerConfig())
    assert np.float32(g["half_w"]) == np.float32(10 * 0.5 * 0.2046 / 2.0)
    assert np.float32(g["fx"]) == np.float32(35.0 / 36.0 * 84)
