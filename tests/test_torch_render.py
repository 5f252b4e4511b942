"""The port's render slice end to end against the JAX package on the CPU.

One model is made by the JAX package's `init_model` (plus seeded numpy noise
on the SH, opacities and optimizer deltas), carried across with
`params_from_numpy`, and rendered by both `render_camera`s. Tolerances: the
port composites in log space with a sequential recurrence, the JAX jnp tile
path in linear space with a chunked cumulative product, so values differ by
float32 rounding: linear rgb and alpha atol 1e-4, depth 1e-3 (depths are
~4), gamma-encoded rgb 1e-3 (the 1/2.2 power amplifies differences near the
1e-6 clip).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_tpu.cameras import optimizers as j_camopt
from splat_tpu.cameras.cameras import Cameras as JCameras
from splat_tpu.models import splatfacto as jsf
from splat_tpu.ops import projection as jproj
from splat_tpu.ops import rasterize as jrast
from splat_tpu_torch.cameras import optimizers as t_camopt
from splat_tpu_torch.models import splatfacto as tsf
from splat_tpu_torch.models.convert import cameras_from_numpy, params_from_numpy
from splat_tpu_torch.ops import projection as tproj
from splat_tpu_torch.ops import rasterize as trast

N_CAMS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here, and
    the suite's xdist workers would each start a full intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(camera_mode="SO3xR3", vel_enabled=True, zero_vel=False, tile=8, **kw):
    """Matching (jax_config, port_config)."""
    common = dict(blur_samples=5, sh_degree=3, tile_size=tile, max_per_tile=128,
                  max_tiles_per_gaussian=16, background_color="auto")
    common.update(kw)
    jc = jsf.SplatfactoConfig(
        impl="jnp", chunk=16, **common,
        camera_optimizer=j_camopt.CameraOptConfig(mode=camera_mode),
        camera_velocity_optimizer=j_camopt.VelocityOptConfig(
            enabled=vel_enabled, zero_initial_velocities=zero_vel))
    tc = tsf.SplatfactoConfig(
        impl="auto", **common,
        camera_optimizer=t_camopt.CameraOptConfig(mode=camera_mode),
        camera_velocity_optimizer=t_camopt.VelocityOptConfig(
            enabled=vel_enabled, zero_initial_velocities=zero_vel))
    return jc, tc


def _model(jc):
    """JAX ModelParams with nonzero SH, opacity and optimizer deltas, and its
    numpy tree."""
    rng = np.random.default_rng(7)
    pts = (rng.normal(size=(160, 3)) * np.array([0.6, 0.45, 0.5])).astype(np.float32)
    rgb = rng.integers(0, 255, size=(160, 3)).astype(np.uint8)
    params = jsf.init_model(pts, rgb, N_CAMS, 2, jc, capacity=192)
    g = params.gaussians
    g = g._replace(
        features_rest=jnp.asarray(rng.normal(size=g.features_rest.shape) * 0.1, jnp.float32),
        opacities_logit=jnp.asarray(rng.normal(size=g.opacities_logit.shape), jnp.float32),
        scales_log=g.scales_log + 0.7,
    )

    def perturb(d, scale):
        return {k: v + jnp.asarray(rng.normal(size=v.shape) * scale, jnp.float32)
                for k, v in d.items()}

    params = params._replace(
        gaussians=g,
        background_logit=jnp.asarray([0.3, -0.2, 0.1], jnp.float32),
        camera_opt=perturb(params.camera_opt, 0.01),
        velocity_opt=perturb(params.velocity_opt, 0.05),
    )
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else np.asarray(v))
            for k, v in params._asdict().items() if k != "gaussians"}
    tree["gaussians"] = {k: np.asarray(v) for k, v in g._asdict().items()}
    return params, tree


def _cameras(img_w, img_h):
    rng = np.random.default_rng(3)
    R = np.stack([np.eye(3)] * N_CAMS).astype(np.float32)
    fields = dict(
        R_c2w=R, p_c2w=np.float32([[0.05 * i, -0.03 * i, -4.0] for i in range(N_CAMS)]),
        fx=np.full(N_CAMS, img_w * 1.1, np.float32), fy=np.full(N_CAMS, img_w * 1.1, np.float32),
        cx=np.full(N_CAMS, img_w / 2, np.float32), cy=np.full(N_CAMS, img_h / 2, np.float32),
        width=img_w, height=img_h,
        lin_vel=(rng.normal(size=(N_CAMS, 3)) * 0.6).astype(np.float32),
        ang_vel=(rng.normal(size=(N_CAMS, 3)) * 0.3).astype(np.float32),
        exposure_time=np.full(N_CAMS, 0.08, np.float32),
        rolling_shutter_time=np.full(N_CAMS, 0.05, np.float32),
    )
    jcam = JCameras(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                       for k, v in fields.items()})
    return jcam, cameras_from_numpy(fields, device="cpu")


CASES = {
    "fused_so3xr3": dict(),
    "fused_anchored_se3": dict(camera_mode="SE3", blur_anchors=2),
    "exact_zero_init_vel": dict(blur_mode="exact", zero_vel=True),
    "fused_rect_tile_ragged": dict(tile=(16, 8), img=(44, 30)),
    "one_sample_no_vel_opt": dict(blur_samples=1, vel_enabled=False),
}


def _render_both(case, j_impl="jnp", t_impl="auto", cam_index=2):
    spec = dict(CASES[case])
    img_w, img_h = spec.pop("img", (48, 32))
    jc, tc = _configs(**spec)
    jc = dataclasses.replace(jc, impl=j_impl)
    tc = dataclasses.replace(tc, impl=t_impl)
    jparams, tree = _model(jc)
    tparams = params_from_numpy(tree, device="cpu")
    jcam, tcam = _cameras(img_w, img_h)
    out_j = jsf.render_camera(jparams, jcam[cam_index], jc, 3,
                              jsf.background_color(jparams, jc))
    out_t = tsf.render_camera(tparams, tcam[cam_index], tc, 3,
                              tsf.background_color(tparams, tc))
    return out_j, out_t, jc, tc


def _assert_match(out_j, out_t, jc, tc):
    for name, tol in (("rgb", 1e-4), ("alpha", 1e-4), ("transmittance", 1e-4),
                      ("depth", 1e-3)):
        got = getattr(out_t, name).detach().numpy()
        want = np.asarray(getattr(out_j, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=tol, err_msg=name)
    np.testing.assert_allclose(tsf.gamma_encode(out_t.rgb, tc).detach().numpy(),
                               np.asarray(jsf.gamma_encode(out_j.rgb, jc)), atol=1e-3)
    assert float(out_t.alpha.max()) > 0.3, "the scene must be visible"


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_camera_matches_jax(case):
    _assert_match(*_render_both(case))


def test_render_camera_matches_jax_pallas():
    _assert_match(*_render_both("fused_so3xr3", j_impl="pallas"))


def test_render_camera_torch_route_matches_kernel_route():
    """impl="torch" (dense id table) and the kernel route's plain versions
    (seg_copy from the sorted stream) composite the same rows: equal."""
    _, out_auto, _, _ = _render_both("fused_anchored_se3")
    _, out_torch, _, _ = _render_both("fused_anchored_se3", t_impl="torch")
    for a, b in zip(out_auto, out_torch):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_route_is_differentiable_on_cpu():
    """Every leaf gets a finite gradient, the opacity included: the plain
    compositor's alpha reads only the detached log-opacity column, so the
    opacity gradient has to come from the analytic backward's column 8."""
    _, tc = _configs()
    _, tree = _model(_configs()[0])
    tparams = params_from_numpy(tree, device="cpu")
    g = tparams.gaussians
    leaves = (g.means, g.opacities_logit, g.scales_log, g.features_dc)
    for leaf in leaves:
        leaf.requires_grad_(True)
    _, tcam = _cameras(48, 32)
    out = tsf.render_camera(tparams, tcam[1], tc, 3, torch.zeros(3))
    out.rgb.mean().backward()
    for leaf in leaves:
        assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().sum() > 0


def test_blur_helpers_match_jax():
    jc, tc = _configs()
    jcam, tcam = _cameras(48, 32)
    for a in (0, 3):
        assert tsf.resolve_blur_anchors(dataclasses.replace(tc, blur_anchors=a), tcam) == \
            jsf.resolve_blur_anchors(dataclasses.replace(jc, blur_anchors=a), jcam)
    np.testing.assert_allclose(
        tsf.blur_sample_times(torch.tensor(0.06), tc).numpy(),
        np.asarray(jsf.blur_sample_times(jnp.float32(0.06), jc)), rtol=1e-6)
    for step in (0, 1500, 99999):
        assert tsf.active_sh_degree(tc, step) == int(jsf.active_sh_degree(jc, step))
    img = np.linspace(0, 1.2, 30, dtype=np.float32)
    np.testing.assert_allclose(tsf.apply_black_level(torch.tensor(img), tc).numpy(),
                               np.asarray(jsf.apply_black_level(jnp.asarray(img), jc)))


@pytest.mark.parametrize("reduce,row_offset", [(None, 0), ("mean", 0), (None, 16), ("mean", 8)])
def test_rasterize_fused_matches_jax(reduce, row_offset):
    """rasterize_fused on a row strip of a taller image (rolling-shutter time
    over the full height), per-sample and blur-averaged outputs."""
    rng = np.random.default_rng(11)
    n, w, h = 150, 40, 24
    means = rng.normal(size=(n, 3)) * np.array([0.5, 0.35, 0.6]) + np.array([0, 0, 4.0])
    scales = np.exp(rng.normal(size=(n, 3)) * 0.3) * 0.1
    quats = rng.normal(size=(n, 4))
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, size=n).astype(np.float32)
    proj = jproj.project_gaussians(
        *(jnp.asarray(a, jnp.float32) for a in (means, scales, quats)),
        jnp.eye(3), jnp.zeros(3), 36.0, 36.0, w / 2, h / 2, w, h,
        lin_vel=jnp.array([0.4, -0.3, 0.2]), ang_vel=jnp.array([0.1, 0.1, -0.1]))
    eps = np.float32([-0.03, -0.01, 0.01, 0.03])
    bg = np.float32([0.2, 0.3, 0.4])
    kw = dict(rolling_shutter_time=0.04, tile_size=8, max_per_tile=128,
              max_tiles_per_gaussian=16, rs_full_height=h + 2 * row_offset,
              rs_row_offset=row_offset, reduce=reduce)
    want = jrast.rasterize_fused(proj, jnp.asarray(colors), jnp.asarray(opac), w, h,
                                 jnp.asarray(bg), eps=jnp.asarray(eps), impl="jnp", chunk=16,
                                 **kw)
    tp = tproj.ProjectedGaussians(*(torch.tensor(np.array(f)) for f in proj))
    got = trast.rasterize_fused(tp, torch.tensor(colors), torch.tensor(opac), w, h,
                                torch.tensor(bg), eps=torch.tensor(eps), **kw)
    for name, tol in (("rgb", 1e-4), ("alpha", 1e-4), ("transmittance", 1e-4),
                      ("depth", 1e-3)):
        g, ww = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == ww.shape, name
        np.testing.assert_allclose(g, ww, atol=tol, err_msg=name)
