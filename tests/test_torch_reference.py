"""The port's reference renderer (`ops/reference.py:render_reference`) against
the JAX package's on the CPU.

- the same projected inputs (64 Gaussians, 32x24, chunk 16) with and without
  rolling shutter and tile emulation: rgb, alpha and depth within atol 1e-5;
- the chunk size changes nothing (atol 1e-5, as the JAX test holds it);
- the single-Gaussian analytic case (rtol 1e-5);
- gradients of a weighted sum of rgb and alpha with respect to the means,
  conics, colours, opacities and pixel velocities against `jax.grad`: within
  rtol 1e-4 of each element, plus 1e-6 of the largest |gradient| of its
  leaf (float32 sums in another order);
- with tile emulation it is an oracle of the port's tile route
  (`ops/rasterize.py:rasterize`, `impl="torch"`): rgb, alpha, transmittance
  and the alpha-weighted depth sum within atol 1e-5 (the depth itself is
  that sum over alpha, which multiplies float32 rounding where alpha is small).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_tpu.ops import projection as jproj
from splat_tpu.ops import reference as jref
from splat_tpu_torch.ops import projection as tproj
from splat_tpu_torch.ops import rasterize as trast
from splat_tpu_torch.ops import reference as tref

W, H = 32, 24
ATOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n=64, seed=0, vel=True):
    """The port's projection of n seeded Gaussians: (proj, colors, opacities)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * np.array([0.6, 0.5, 1.0]) + np.array([0, 0, 4.0])
    scales = np.exp(rng.normal(size=(n, 3)) * 0.3) * 0.1
    quats = rng.normal(size=(n, 4))
    colors = rng.uniform(0.0, 1.0, size=(n, 3))
    opac = rng.uniform(0.3, 0.95, size=(n,))
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    kw = dict(lin_vel=f32([0.4, -0.3, 0.1]), ang_vel=f32([0.05, 0.1, -0.02])) if vel else {}
    proj = tproj.project_gaussians(f32(means), f32(scales), f32(quats), torch.eye(3),
                                   torch.zeros(3), 30.0, 30.0, W / 2, H / 2, W, H, **kw)
    return proj, f32(colors), f32(opac)


def _jax_proj(proj):
    return jproj.ProjectedGaussians(**{k: jnp.asarray(v.detach().numpy())
                                       for k, v in proj._asdict().items()})


BG = np.array([0.1, 0.2, 0.3], np.float32)


@pytest.mark.parametrize("rs", [0.0, 0.04], ids=["global", "rolling"])
@pytest.mark.parametrize("tile", [None, 8], ids=["full", "tile8"])
def test_render_reference_matches_jax(rs, tile):
    proj, colors, opac = _scene()
    kw = dict(rolling_shutter_time=rs, chunk=16, tile_size=tile,
              max_tiles_per_gaussian=16 if tile else None)
    want = jref.render_reference(_jax_proj(proj), jnp.asarray(colors.numpy()),
                                 jnp.asarray(opac.numpy()), W, H, jnp.asarray(BG), **kw)
    got = tref.render_reference(proj, colors, opac, W, H, torch.as_tensor(BG), **kw)
    assert float(got.alpha.max()) > 0.5
    for name in ("rgb", "alpha", "depth", "transmittance"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=ATOL, err_msg=name)


def test_chunk_size_changes_nothing():
    proj, colors, opac = _scene(n=33, seed=3)
    outs = [tref.render_reference(proj, colors, opac, W, H, torch.as_tensor(BG),
                                  rolling_shutter_time=0.03, chunk=c) for c in (4, 7, 33, 64)]
    for o in outs[1:]:
        for name in ("rgb", "alpha", "depth"):
            np.testing.assert_allclose(getattr(o, name).numpy(), getattr(outs[0], name).numpy(),
                                       atol=ATOL, err_msg=name)


def test_single_gaussian_analytic():
    img, fx = 32, 40.0
    proj = tproj.project_gaussians(
        torch.tensor([[0.0, 0.0, 4.0]]), torch.tensor([[0.3, 0.3, 0.3]]),
        torch.tensor([[1.0, 0.0, 0.0, 0.0]]), torch.eye(3), torch.zeros(3),
        fx, fx, img / 2, img / 2, img, img)
    out = tref.render_reference(proj, torch.tensor([[1.0, 0.5, 0.25]]), torch.tensor([0.8]),
                                img, img, torch.zeros(3))
    # the mean projects to (16, 16); pixel (15, 15)'s centre is 0.5 px off on each axis
    var = (fx * 0.3 / 4.0) ** 2 + tproj.COV2D_DILATION
    a = float(proj.compensations[0]) * 0.8 * np.exp(-0.5 * (0.5 ** 2 + 0.5 ** 2) / var)
    np.testing.assert_allclose(float(out.alpha[15, 15]), a, rtol=1e-5)
    np.testing.assert_allclose(out.rgb[15, 15].numpy(), a * np.array([1.0, 0.5, 0.25]), rtol=1e-5)
    np.testing.assert_allclose(float(out.depth[15, 15]), 4.0, rtol=1e-5)
    # far from the footprint nothing composites
    assert float(out.alpha[0, 0]) == 0.0


LEAVES = ("means2d", "conics", "pix_vels")


@pytest.mark.parametrize("tile", [None, 8], ids=["full", "tile8"])
def test_gradients_match_jax(tile):
    proj, colors, opac = _scene(n=48, seed=5)
    rng = np.random.default_rng(9)
    w_rgb = rng.normal(size=(H, W, 3)).astype(np.float32)
    w_alpha = rng.normal(size=(H, W)).astype(np.float32)
    kw = dict(rolling_shutter_time=0.04, chunk=16, tile_size=tile,
              max_tiles_per_gaussian=16 if tile else None)
    jp = _jax_proj(proj)

    def jloss(means2d, conics, pix_vels, colors_, opac_):
        p = jp._replace(means2d=means2d, conics=conics, pix_vels=pix_vels)
        out = jref.render_reference(p, colors_, opac_, W, H, jnp.asarray(BG), **kw)
        return jnp.sum(out.rgb * w_rgb) + jnp.sum(out.alpha * w_alpha)

    j_args = [getattr(jp, k) for k in LEAVES] + [jnp.asarray(colors.numpy()),
                                                jnp.asarray(opac.numpy())]
    want = jax.grad(jloss, argnums=tuple(range(5)))(*j_args)

    t_args = [getattr(proj, k).detach().clone().requires_grad_(True) for k in LEAVES]
    t_args += [colors.clone().requires_grad_(True), opac.clone().requires_grad_(True)]
    p = proj._replace(**dict(zip(LEAVES, t_args[:3])))
    out = tref.render_reference(p, t_args[3], t_args[4], W, H, torch.as_tensor(BG), **kw)
    loss = (out.rgb * torch.as_tensor(w_rgb)).sum() + (out.alpha * torch.as_tensor(w_alpha)).sum()
    got = torch.autograd.grad(loss, t_args)
    for name, g, wnt in zip(LEAVES + ("colors", "opacities"), got, want):
        wnt = np.asarray(wnt)
        assert np.abs(wnt).max() > 0, name
        np.testing.assert_allclose(g.numpy(), wnt, rtol=GRAD_RTOL,
                                   atol=1e-6 * np.abs(wnt).max(), err_msg=name)


@pytest.mark.parametrize("rs", [0.0, 0.04], ids=["global", "rolling"])
def test_reference_is_an_oracle_of_the_tile_route(rs):
    proj, colors, opac = _scene(seed=7)
    bg = torch.as_tensor(BG)
    want = tref.render_reference(proj, colors, opac, W, H, bg, rolling_shutter_time=rs,
                                 chunk=16, tile_size=8, max_tiles_per_gaussian=16)
    got = trast.rasterize(proj, colors, opac, W, H, bg, rolling_shutter_time=rs, tile_size=8,
                          max_per_tile=64, max_tiles_per_gaussian=16, impl="torch")
    for name in ("rgb", "alpha", "transmittance"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name).numpy(),
                                   atol=ATOL, err_msg=name)
    # depth is a ratio over alpha: compare the alpha-weighted sum both compute
    np.testing.assert_allclose((got.depth * got.alpha).numpy(), (want.depth * want.alpha).numpy(),
                               atol=ATOL, err_msg="depth * alpha")
