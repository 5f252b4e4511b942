"""The port's SE(3), SH and projection against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both. Tolerance: float32
elementwise math in a different operation order (matmul and einsum sums),
so rtol/atol 1e-5 relative to values of order one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_tpu.cameras.cameras import Cameras as JCameras
from splat_tpu.ops import projection as jproj
from splat_tpu.ops import se3 as jse3
from splat_tpu.ops import sh as jsh
from splat_tpu_torch.cameras.cameras import Cameras as TCameras
from splat_tpu_torch.ops import projection as tproj
from splat_tpu_torch.ops import se3 as tse3
from splat_tpu_torch.ops import sh as tsh

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here, and
    the suite's xdist workers would each start a full intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(t_val, j_val, **tol):
    np.testing.assert_allclose(t_val.detach().numpy(), np.asarray(j_val), **(tol or TOL))


@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 3)) * 0.8
    w[:4] *= 1e-6                       # the series branches near theta = 0
    q = rng.normal(size=(64, 4))
    return w.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("name", ["so3_exp", "so3_left_jacobian", "skew", "quat_normalize"])
def test_se3_unary_matches_jax(vecs, name):
    w, q = vecs
    arg = q if name == "quat_normalize" else w
    _close(getattr(tse3, name)(_t(arg)), getattr(jse3, name)(jnp.asarray(arg)))


def test_quat_rotmat_roundtrip_matches_jax(vecs):
    _, q = vecs
    qn = np.asarray(jse3.quat_normalize(jnp.asarray(q)))
    R_j = jse3.quat_to_rotmat(jnp.asarray(qn))
    R_t = tse3.quat_to_rotmat(_t(qn))
    _close(R_t, R_j)
    _close(tse3.rotmat_to_quat(R_t), jse3.rotmat_to_quat(R_j))
    _close(tse3.so3_log(R_t), jse3.so3_log(R_j), rtol=1e-4, atol=1e-4)


def test_se3_advance_and_pose_delta_match_jax(vecs):
    w, _ = vecs
    R0 = np.asarray(jse3.so3_exp(jnp.asarray(w[:8])))
    p0, v, om, phi, dp = (w[8:16], w[16:24], w[24:32], w[32:40] * 0.1, w[40:48])
    t = np.float32(0.037)
    for got, want in zip(
        tse3.se3_advance_c2w(_t(R0), _t(p0), _t(v), _t(om), torch.tensor(t)),
        jse3.se3_advance_c2w(jnp.asarray(R0), jnp.asarray(p0), jnp.asarray(v),
                             jnp.asarray(om), jnp.asarray(t)),
    ):
        _close(got, want)
    for got, want in zip(
        tse3.pose_delta_so3xr3(_t(R0), _t(p0), _t(phi), _t(dp)),
        jse3.pose_delta_so3xr3(jnp.asarray(R0), jnp.asarray(p0), jnp.asarray(phi),
                               jnp.asarray(dp)),
    ):
        _close(got, want)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(50, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    c = rng.normal(size=(50, 16, 3)).astype(np.float32)
    _close(tsh.eval_sh_basis(degree, _t(d)), jsh.eval_sh_basis(degree, jnp.asarray(d)))
    _close(tsh.sh_to_rgb(degree, _t(d), _t(c)), jsh.sh_to_rgb(degree, jnp.asarray(d), jnp.asarray(c)))


def _scene(n=200, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * np.array([0.8, 0.6, 1.0]) + np.array([0, 0, 3.0])
    # behind the camera, and just in front of / at the near plane (z = 0.01)
    means[:5, 2] = -rng.uniform(0.5, 2.0, size=5)
    means[5:10, 2] = 0.01 + np.array([0.0, 1e-6, 1e-4, 1e-3, 5e-3])
    means[5:10, :2] = rng.normal(size=(5, 2)) * 0.3
    scales = np.exp(rng.normal(size=(n, 3)) * 0.4) * 0.05
    quats = rng.normal(size=(n, 4))
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(size=3) * 0.1, jnp.float32)))
    t = rng.normal(size=3) * 0.1
    return [a.astype(np.float32) for a in (means, scales, quats, R, t)]


@pytest.mark.parametrize("vel", [False, True])
def test_project_gaussians_matches_jax(vel):
    means, scales, quats, R, t = _scene()
    kw_j, kw_t = {}, {}
    if vel:
        lv, av = np.float32([0.5, -0.3, 0.2]), np.float32([0.1, 0.15, -0.1])
        kw_j = dict(lin_vel=jnp.asarray(lv), ang_vel=jnp.asarray(av))
        kw_t = dict(lin_vel=_t(lv), ang_vel=_t(av))
    cam = (40.0, 42.0, 24.0, 16.0, 48, 32)
    pj = jproj.project_gaussians(*(jnp.asarray(a) for a in (means, scales, quats, R, t)),
                                 *cam, **kw_j)
    pt = tproj.project_gaussians(*(_t(a) for a in (means, scales, quats, R, t)), *cam, **kw_t)
    assert not bool(pt.valid[:5].any()), "Gaussians behind the camera must be culled"
    for field in tproj.ProjectedGaussians._fields:
        got, want = getattr(pt, field), getattr(pj, field)
        if field == "valid":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want)
    np.testing.assert_allclose(
        tproj.scale_quat_to_cov3d(_t(scales), _t(quats)).numpy(),
        np.asarray(jproj.scale_quat_to_cov3d(jnp.asarray(scales), jnp.asarray(quats))),
        **TOL)


def test_camera_conventions_match_jax(vecs):
    w, _ = vecs
    R = np.asarray(jse3.so3_exp(jnp.asarray(w[:6])))
    c2w = np.concatenate([R, w[6:12, :, None]], axis=-1)                # (6, 3, 4)
    Rj, pj = JCameras.gl_to_cv_c2w(jnp.asarray(c2w))
    Rt, pt = TCameras.gl_to_cv_c2w(_t(c2w))
    _close(Rt, Rj)
    _close(pt, pj)
    _close(TCameras.cv_to_gl_c2w(Rt, pt), JCameras.cv_to_gl_c2w(Rj, pj))
    _close(TCameras.vel_gl_to_cv(_t(w[:6])), JCameras.vel_gl_to_cv(jnp.asarray(w[:6])))
    f = np.full(6, 30.0, np.float32)
    jc = JCameras(Rj, pj, f, f, f, f, 64, 48)
    tc = TCameras(Rt, pt, _t(f), _t(f), _t(f), _t(f), 64, 48)
    for got, want in zip(tc[3].w2c(), jc[3].w2c()):
        _close(got, want)
    assert len(tc[1:4]) == 3 and int(tc[-1].cam_idx[0]) == 5
