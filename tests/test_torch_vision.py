"""The port's vision pipeline against the JAX package's, on the CPU: corner
response, NMS, corner count and ordered corners at 240 x 240 on the JAX
package's own renders (and the lowest-index-first tie break on a response
with real plateaus); the homography initialization and Gauss-Newton PnP on
synthetic projections; `_so3_exp` and its forward-mode Jacobian at w = 0;
calibration; the complementary fusion from a filled ring and as a no-op;
and `vision_pose` / `vision_correction_step` at the missions' 480 x 480,
a batch of 3 against three JAX calls."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autonomous_quadrotor_environment_tpu.config import CameraConfig as JCam
from autonomous_quadrotor_environment_tpu.config import MarkerConfig as JMarker
from autonomous_quadrotor_environment_tpu.envs.sensors import SensorState as JSensorState
from autonomous_quadrotor_environment_tpu.render import camera as jcamera
from autonomous_quadrotor_environment_tpu.render import scene as jscene
from autonomous_quadrotor_environment_tpu.vision import calibration as jcal
from autonomous_quadrotor_environment_tpu.vision import corners as jcorners
from autonomous_quadrotor_environment_tpu.vision import fusion as jfusion
from autonomous_quadrotor_environment_tpu.vision import pipeline as jpipe
from autonomous_quadrotor_environment_tpu.vision import pnp as jpnp
from autonomous_quadrotor_environment_tpu_torch.config import CameraConfig, MarkerConfig
from autonomous_quadrotor_environment_tpu_torch.envs.sensors import SensorState
from autonomous_quadrotor_environment_tpu_torch.render import camera as tcamera
from autonomous_quadrotor_environment_tpu_torch.vision import calibration as tcal
from autonomous_quadrotor_environment_tpu_torch.vision import corners as tcorners
from autonomous_quadrotor_environment_tpu_torch.vision import fusion as tfusion
from autonomous_quadrotor_environment_tpu_torch.vision import pipeline as tpipe
from autonomous_quadrotor_environment_tpu_torch.vision import pnp as tpnp
from torch_parity import n, one_torch_thread, t  # noqa: F401 (one_torch_thread: below)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The three round trips of the JAX package's tests/test_vision.py (the
# first sits over the board's center: its NMS has real plateaus), one tilted
# body-attached view and one with the board out of view:
# (quad xy, marker xy, height, quaternion).
POSES = [((0.0, 0.0), (0.0, 0.0), 1.6, (1.0, 0.0, 0.0, 0.0)),
         ((0.3, -0.2), (0.1, 0.1), 2.0, (1.0, 0.0, 0.0, 0.0)),
         ((-0.2, 0.25), (-0.1, 0.2), 1.2, (1.0, 0.0, 0.0, 0.0)),
         ((0.1, 0.05), (0.0, 0.0), 2.4, (0.9962, 0.0523, -0.0436, 0.0523)),
         ((5.0, 0.0), (0.0, 0.0), 2.0, (1.0, 0.0, 0.0, 0.0))]


def _gray(pose, size):
    """The JAX package's grayscale render of ``pose`` (body-attached camera)."""
    (qx, qy), mxy, h, quat = pose
    cam = jcamera.make_camera(JCam(width=size, height=size))
    from autonomous_quadrotor_environment_tpu.core.quaternion import quat_rot_mat
    r_wc = jcamera.nadir_rotation() @ quat_rot_mat(jnp.asarray(quat, jnp.float32)).T
    img = jscene.render_pinhole(cam, r_wc, jnp.asarray([qx, qy, h], jnp.float32),
                                jnp.asarray(mxy, jnp.float32), JMarker())
    return jnp.mean(img, axis=-1)


@pytest.fixture(scope="module")
def grays():
    return [_gray(p, 240) for p in POSES]


def test_corner_response_nms_and_count_match_jax(grays):
    """The response to the JAX package's images: the box filter's prefix sums
    add in XLA's CPU order, so the maps agree far inside 1e-5; NMS and the
    corner count on the same response are equal."""
    batch = t(np.stack([np.asarray(g) for g in grays]))
    resp = tcorners.corner_response(batch)
    for k, g in enumerate(grays):
        want = np.asarray(jcorners.corner_response(g))
        np.testing.assert_allclose(n(resp[k]), want, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(n(tcorners._nms(t(want)[None])[0]),
                                      np.asarray(jcorners._nms(jnp.asarray(want))))
    np.testing.assert_array_equal(n(tcorners.count_corners(batch)),
                                  [int(jcorners.count_corners(g)) for g in grays])


def test_chessboard_corners_match_jax(grays):
    """The selected peak set is JAX's at every pose; the ordered, refined
    corners within 1e-3 px; the found flags equal (the board out of view
    is not found)."""
    batch = t(np.stack([np.asarray(g) for g in grays]))
    uv, ok = tcorners.chessboard_corners_nadir(batch)
    peaks = tcorners._nms(tcorners.corner_response(batch))
    _, idx = tcorners._top_k(peaks.reshape(len(grays), -1), 54)
    for k, g in enumerate(grays):
        juv, jok = jcorners.chessboard_corners_nadir(g)
        _, jidx = jax.lax.top_k(jcorners._nms(jcorners.corner_response(g)).reshape(-1), 54)
        assert set(n(idx[k]).tolist()) == set(np.asarray(jidx).tolist()), k
        assert bool(ok[k]) == bool(jok)
        np.testing.assert_allclose(n(uv[k]), np.asarray(juv), atol=1e-3, rtol=0)
    assert n(ok).tolist() == [True, True, True, True, False]


def test_top_k_breaks_ties_lowest_index_first():
    """A response with real plateaus (the NMS of the view over the board's
    center, whose middle column of corners lands between two pixels) and
    a synthetic one of exact ties, zeros included: the port's picks are
    `lax.top_k`'s, in its order."""
    resp = np.asarray(jcorners.corner_response(_gray(POSES[0], 240)))
    peaks = np.asarray(jcorners._nms(jnp.asarray(resp))).reshape(-1)
    rng = np.random.default_rng(0)
    ties = rng.integers(0, 4, size=(3, 500)).astype(np.float32) * 0.25
    for rows in (peaks[None], ties):
        vals, idx = tcorners._top_k(t(rows), 54)
        jvals, jidx = jax.vmap(lambda r: jax.lax.top_k(r, 54))(jnp.asarray(rows))
        np.testing.assert_array_equal(n(idx), np.asarray(jidx))
        np.testing.assert_array_equal(n(vals), np.asarray(jvals))
    assert len(set(peaks[np.asarray(jidx)[0]].tolist())) < 54  # the plateau is real


def _synthetic(trials, seed, size=320):
    """Projections of the board through known general poses, 0.1 px noise."""
    cam = jcamera.make_camera(JCam(width=size, height=size))
    obj = jpnp.board_object_points(JMarker())
    rng = np.random.default_rng(seed)
    uvs = []
    for _ in range(trials):
        w = rng.normal(0, 0.15, 3)
        r = np.asarray(jpnp._so3_exp(jnp.asarray(w, jnp.float32))) @ np.asarray(
            jcamera.nadir_rotation())
        pos = np.array([rng.normal(0, 0.2), rng.normal(0, 0.2), rng.uniform(1.0, 3.0)])
        uv, _ = jcamera.project_points(cam, obj, jnp.asarray(r, jnp.float32),
                                       jnp.asarray(-(r @ pos), jnp.float32))
        uvs.append(np.asarray(uv) + rng.normal(0, 0.1, (54, 2)))
    return cam, obj, np.asarray(uvs, np.float32)


def _init_f64(obj_xy, uv_n):
    """`_homography_init` of the float32 inputs in float64 (numpy's eigh and
    svd): the exact answer that both packages' float32 solvers approach."""
    x, y = obj_xy[:, 0].astype(np.float64), obj_xy[:, 1].astype(np.float64)
    u, v = uv_n[:, 0].astype(np.float64), uv_n[:, 1].astype(np.float64)
    z, o = np.zeros_like(x), np.ones_like(x)
    a = np.concatenate([np.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1),
                        np.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)])
    h = np.linalg.eigh(a.T @ a)[1][:, 0].reshape(3, 3)
    h = h / np.linalg.norm(h[:, 0]) * np.sign(h[2, 2])
    u_, _, vt = np.linalg.svd(np.stack([h[:, 0], h[:, 1], np.cross(h[:, 0], h[:, 1])], -1))
    return u_ @ vt, h[:, 2]


def test_homography_init_and_solve_pnp_match_jax():
    """The initial pose after the eigenvector's sign is fixed by h3[2] (the
    port's Jacobi sweeps and polar iteration against LAPACK's float32 eigh
    and svd), then the pose after 10 Gauss-Newton steps. The float32
    smallest eigenvector of A^T A carries an error of about eps ||A^T A|| /
    gap: the port's init lies within 1e-5 of the float64 answer, the JAX
    package's within 2e-4 (1.04e-4 at the second trial), so the two are
    held to each other at 2e-4. After Gauss-Newton R and t agree within
    1e-4, the rms within 1e-4 px."""
    jcam, obj, uvs = _synthetic(5, 0)
    tcam = tcamera.make_camera(CameraConfig(width=320, height=320))
    uv_n = np.stack([(uvs[..., 0] - float(jcam.cx)) / float(jcam.fx),
                     (uvs[..., 1] - float(jcam.cy)) / float(jcam.fy)], -1).astype(np.float32)
    r0, t0 = tpnp._homography_init(tpnp.board_object_points()[:, :2], t(uv_n))
    r, tt, rms = tpnp.solve_pnp(tcam, tpnp.board_object_points(), t(uvs))
    np.testing.assert_array_equal(n(tpnp.board_object_points()), np.asarray(obj))
    for k in range(len(uvs)):
        exact_r, exact_t = _init_f64(np.asarray(obj[:, :2]), uv_n[k])
        np.testing.assert_allclose(n(r0[k]), exact_r, atol=1e-5, rtol=0)
        np.testing.assert_allclose(n(t0[k]), exact_t, atol=1e-5, rtol=0)
        jr0, jt0 = jpnp._homography_init(obj[:, :2], jnp.asarray(uv_n[k]))
        np.testing.assert_allclose(n(r0[k]), np.asarray(jr0), atol=2e-4, rtol=0)
        np.testing.assert_allclose(n(t0[k]), np.asarray(jt0), atol=2e-4, rtol=0)
        jr, jt, jrms = jpnp.solve_pnp(jcam, obj, jnp.asarray(uvs[k]))
        np.testing.assert_allclose(n(r[k]), np.asarray(jr), atol=1e-4, rtol=0)
        np.testing.assert_allclose(n(tt[k]), np.asarray(jt), atol=1e-4, rtol=0)
        assert abs(float(rms[k]) - float(jrms)) < 1e-4
        pos, _ = tpnp.camera_pose_from_pnp(r[k:k + 1], tt[k:k + 1])
        jpos, _ = jpnp.camera_pose_from_pnp(jr, jt)
        np.testing.assert_allclose(n(pos[0]), np.asarray(jpos), atol=1e-4, rtol=0)


def test_so3_exp_and_its_jacobian_at_zero_match_jax():
    ws = np.array([[0.0, 0.0, 0.0], [0.1, -0.2, 0.3], [1e-8, 0, 0], [0, 2.0, 0]], np.float32)
    np.testing.assert_allclose(n(tpnp._so3_exp(t(ws))),
                               np.asarray(jax.vmap(jpnp._so3_exp)(ws)), atol=1e-6, rtol=0)
    for w in ws[:2]:
        got = n(torch.func.jacfwd(tpnp._so3_exp)(t(w)))
        want = np.asarray(jax.jacfwd(jpnp._so3_exp)(jnp.asarray(w)))
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # at w = 0 the Jacobian is the three generators of so(3)
    gen = n(torch.func.jacfwd(tpnp._so3_exp)(torch.zeros(3)))
    np.testing.assert_allclose(gen[..., 0], [[0, 0, 0], [0, 0, -1], [0, 1, 0]], atol=1e-6)


def test_calibration_and_reprojection_rms_match_jax():
    cfg = JCam(width=240, height=240)
    cam = jcamera.make_camera(cfg)
    obj = np.asarray(jpnp.board_object_points(JMarker()))
    rng = np.random.default_rng(1)
    views, uvs = [], []
    for _ in range(10):
        r = np.asarray(jpnp._so3_exp(jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32))) @ \
            np.asarray(jcamera.nadir_rotation())
        pos = np.array([rng.normal(0, 0.3), rng.normal(0, 0.3), rng.uniform(1.0, 3.0)])
        tr = -(r @ pos)
        views.append(obj @ r.T + tr)
        uv, _ = jcamera.project_points(cam, obj, jnp.asarray(r, jnp.float32),
                                       jnp.asarray(tr, jnp.float32))
        uvs.append(np.asarray(uv) + rng.normal(0, 0.05, (54, 2)))
    views, uvs = np.asarray(views, np.float32), np.asarray(uvs, np.float32)
    want = jcal.calibrate_camera(jnp.asarray(views), jnp.asarray(uvs), 240, 240)
    got = tcal.calibrate_camera(t(views), t(uvs), 240, 240)
    for name in ("fx", "fy", "cx", "cy"):
        assert abs(getattr(got, name) - float(getattr(want, name))) < 1e-3, name
    assert (got.width, got.height) == (240, 240)
    assert abs(got.fx - cfg.fx) < 0.5 and abs(got.fy - cfg.fy) < 0.5
    rms = tcal.reprojection_rms(got, t(views), t(uvs))
    np.testing.assert_allclose(float(rms), float(jcal.reprojection_rms(want, views, uvs)),
                               rtol=1e-4)


def _jsens(pos, vel, quat):
    z = jnp.zeros(())
    return JSensorState(a_b_accel=z, a_b_grav=z, g_b=z, m_b=z, a_b_d=z, g_b_d=z, m_b_d=z,
                        pos_ins=jnp.asarray(pos, jnp.float32),
                        vel_ins=jnp.asarray(vel, jnp.float32),
                        quat_ins=jnp.asarray(quat, jnp.float32), r_est=jnp.eye(3))


def _tsens(pos, vel, quat):
    e = len(pos)
    z = torch.zeros(e)
    return SensorState(a_b_accel=z, a_b_grav=z, g_b=z, m_b=z, a_b_d=z, g_b_d=z, m_b_d=z,
                       pos_ins=t(np.asarray(pos, np.float32)),
                       vel_ins=t(np.asarray(vel, np.float32)),
                       quat_ins=t(np.asarray(quat, np.float32)),
                       r_est=torch.eye(3).expand(e, 3, 3))


def test_vision_fuse_from_a_filled_ring_matches_jax():
    """60 fixes per episode, two episodes with their own paths and one fix
    rejected in the second: the ring fills past 50, the velocity gate
    opens, and every field follows the JAX package's, step by step."""
    rng = np.random.default_rng(3)
    pos0 = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 2.0]], np.float32)
    jf = [jfusion.vision_fusion_init(), jfusion.vision_fusion_init()]
    js = [_jsens(p, [0, 0, 0], [1, 0, 0, 0]) for p in pos0]
    tf = tfusion.vision_fusion_init(2)
    ts = _tsens(pos0, np.zeros((2, 3)), [[1, 0, 0, 0]] * 2)
    vpos = pos0.copy()
    for k in range(60):
        step = 10 * (k + 1) + 1
        vpos = vpos + np.array([[0.05, 0.0, 0.0], [0.0, 0.03, -0.01]], np.float32) \
            + rng.normal(0, 1e-3, (2, 3)).astype(np.float32)
        vquat = np.array([[0.9, 0.1, 0.0, 0.0], [0.95, 0.0, 0.05, 0.0]], np.float32)
        ok = np.array([True, k != 30])
        for e in range(2):
            jf[e], js[e] = jfusion.vision_fuse(jf[e], js[e], jnp.asarray(vpos[e]),
                                               jnp.asarray(vquat[e]), jnp.asarray(ok[e]),
                                               jnp.asarray(step, jnp.int32), 0.01)
        tf, ts = tfusion.vision_fuse(tf, ts, t(vpos), t(vquat), t(ok),
                                     torch.tensor(step), 0.01)
        for e in range(2):
            for name in ("pos_ins", "vel_ins", "quat_ins"):
                np.testing.assert_allclose(n(getattr(ts, name)[e]),
                                           np.asarray(getattr(js[e], name)),
                                           rtol=1e-6, atol=1e-6)
            for name in ("prev_pos", "prev_valid", "prev_step", "vel_ring", "count"):
                np.testing.assert_allclose(n(getattr(tf, name)[e]),
                                           np.asarray(getattr(jf[e], name)),
                                           rtol=1e-6, atol=1e-6)
    assert n(tf.count).tolist() == [59, 58]
    assert float(ts.vel_ins[0, 0]) > 0.04  # pulled toward 0.5 m/s


def test_vision_fuse_is_a_no_op_when_not_ok():
    ts = _tsens([[1.0, 2.0, 3.0]], [[0.1, 0.2, 0.3]], [[1.0, 0, 0, 0]])
    tf = tfusion.vision_fusion_init(1)
    tf2, ts2 = tfusion.vision_fuse(tf, ts, torch.zeros(1, 3), t([[1.0, 0, 0, 0]]),
                                   torch.tensor([False]), torch.tensor(5), 0.01)
    for name in ("pos_ins", "vel_ins", "quat_ins"):
        assert torch.equal(getattr(ts2, name), getattr(ts, name))
    for a, b in zip(tf2, tf):
        assert torch.equal(a, b)


def test_vision_pose_and_correction_step_batched_match_jax():
    """Three missions'-camera (480 x 480) views as one batch against three
    JAX calls: a level one, a tilted body-attached one and one without the
    board; then the correction step on them, due (step 11) and off its
    cadence (step 12, the identity)."""
    cam, mk = CameraConfig(width=480, height=480), MarkerConfig()
    jcam, jmk = JCam(width=480, height=480), JMarker()
    picks = [POSES[1], POSES[3], POSES[4]]
    pos = np.array([[qx, qy, h - 5.0] for (qx, qy), _, h, _ in picks], np.float32)
    mxy = np.array([m for _, m, _, _ in picks], np.float32)
    quat = np.array([q for *_, q in picks], np.float32)
    got = tpipe.vision_pose(t(pos), t(mxy), cam, mk, quad_quat=t(quat))
    want = [jpipe.vision_pose(jnp.asarray(pos[k]), jnp.asarray(mxy[k]), jcam, jmk,
                              quad_quat=jnp.asarray(quat[k])) for k in range(3)]
    assert n(got.ok).tolist() == [bool(w.ok) for w in want] == [True, True, False]
    for k in range(2):
        np.testing.assert_allclose(n(got.pos_env[k]), np.asarray(want[k].pos_env), atol=1e-4)
        np.testing.assert_allclose(n(got.quat[k]), np.asarray(want[k].quat), atol=1e-4)
        assert abs(float(got.rms[k]) - float(want[k].rms)) < 1e-3

    ins = pos + np.array([0.3, -0.2, 0.1], np.float32)
    tsens = _tsens(ins, np.zeros((3, 3)), [[1, 0, 0, 0]] * 3)
    tf = tfusion.vision_fusion_init(3)
    for step, phase in ((11, 1), (12, 2)):
        f2, s2, out = tpipe.vision_correction_step(
            tf, tsens, t(pos), t(mxy), torch.tensor(step), 0.01, cam, mk,
            quad_quat=t(quat), phase=phase)
        for k in range(3):
            jf2, js2, jout = jpipe.vision_correction_step(
                jfusion.vision_fusion_init(), _jsens(ins[k], [0, 0, 0], [1, 0, 0, 0]),
                jnp.asarray(pos[k]), jnp.asarray(mxy[k]), jnp.asarray(step, jnp.int32), 0.01,
                jcam, jmk, quad_quat=jnp.asarray(quat[k]))
            assert bool(out.ok[k]) == bool(jout.ok)
            np.testing.assert_allclose(n(s2.pos_ins[k]), np.asarray(js2.pos_ins), atol=1e-4)
            np.testing.assert_allclose(n(s2.quat_ins[k]), np.asarray(js2.quat_ins), atol=1e-4)
            np.testing.assert_allclose(n(f2.prev_pos[k]), np.asarray(jf2.prev_pos), atol=1e-4)
            assert int(f2.prev_step[k]) == int(jf2.prev_step)
        if phase != 1:
            assert s2 is tsens and f2 is tf and not bool(out.ok.any())
            assert torch.isinf(out.rms).all()
        else:
            assert n(out.ok).tolist() == [True, True, False]
