"""The port's training step against the JAX package on the CPU.

The model, cameras and configs are tests/test_torch_render.py's (JAX
`init_model` plus seeded numpy noise, 48x32 images, K = 128); the target
images are seeded numpy noise. JAX runs its jnp tile path (`impl="jnp"`),
the port its kernel route's plain versions (`impl="auto"` on CPU tensors).

Tolerances:
- loss: rtol 1e-5; each loss term rtol 1e-5 or atol 1e-5 (SSIM is a mean
  of per-window ratios whose flat windows carry ~1e-5 of rounding, below).
- gradients: every leaf, the means2d probe included, within
  1e-4 * max|JAX leaf gradient| + 1e-8 elementwise (the largest seen is
  1.1e-5 of the leaf's max; the quaternions' gradients are ~1e-9, as the
  seed Gaussians are isotropic). The two compositors differ (a log-space
  sequential recurrence with the analytic backward, against autodiff of a
  linear-space chunked product), so gradients differ by float32 rounding
  carried through projection and SH.
- SSIM map atol 1e-4: in a flat window blur(x^2) - blur(x)^2 cancels to
  rounding noise (~1e-8) that the c2 = 9e-4 stabiliser turns into ~3e-5,
  and the two convolutions sum their taps in different orders. SSIM and
  PSNR values rtol 1e-5; the SSIM gradient 1e-3 of its max.
- the optimizer against optax fed identical gradients: rtol 1e-6 on the
  parameters plus 2e-5 of each leaf's total update. optax forms the bias
  corrections 1 - b^t in float32 (1 - 0.999 is off by 1.3e-5 there),
  torch.optim.Adam in float64.
- three train steps: losses rtol 1e-4, the densification statistics
  rtol 1e-4 plus 1e-4 of their max.
The loss's autograd graph holds no scatter-add node (the camera deltas are
taken by a one-hot sum, the fetches and the compositor have gather-form
backwards).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_backward import SCATTER_NODES, _graph_nodes
from test_torch_render import _cameras, _configs, _model

from splat_tpu.engine import trainer as jtr
from splat_tpu.models import splatfacto as jsf
from splat_tpu.models import strategy as jst
from splat_tpu.ops import ssim as jssim
from splat_tpu_torch.engine import trainer as ttr
from splat_tpu_torch.models import splatfacto as tsf
from splat_tpu_torch.models import strategy as tst
from splat_tpu_torch.models.convert import params_from_numpy
from splat_tpu_torch.ops import ssim as tssim

W, H = 48, 32
SH_STEP = 3000   # every SH band active

CASES = {
    "fused_so3xr3": dict(),
    "anchored_se3": dict(camera_mode="SE3", blur_anchors=2),
    "exact_zero_init_vel": dict(blur_mode="exact", zero_vel=True, blur_samples=3),
    "fused_cam_off_no_vel": dict(camera_mode="off", vel_enabled=False),
    "one_sample_rect_tile": dict(blur_samples=1, tile=(16, 8)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here, and
    the suite's xdist workers would each start a full intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _targets(n, seed=9):
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=(n, H, W, 3)).astype(np.float32)


def _leaves(tparams):
    """(name, tensor) of every trainable port leaf, in a fixed order."""
    g = tparams.gaussians
    out = [(f"gaussians.{f}", getattr(g, f)) for f in tsf.GaussianParams._fields if f != "alive"]
    out.append(("background_logit", tparams.background_logit))
    for group in ("camera_opt", "velocity_opt"):
        out += [(f"{group}.{k}", v) for k, v in sorted(getattr(tparams, group).items())]
    return out


def _jax_leaf(tree, name):
    head, _, tail = name.partition(".")
    node = getattr(tree, head)
    if not tail:
        return node
    return node[tail] if isinstance(node, dict) else getattr(node, tail)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    spec = dict(CASES[case])
    jc, tc = _configs(**spec)
    jparams, tree = _model(jc)
    jcam, tcam = _cameras(W, H)
    gt = _targets(1)[0]
    cam = 1
    deg = int(jsf.active_sh_degree(jc, SH_STEP))

    def j_loss(p, probe):
        bg = jsf.background_color(p, jc, jax.random.PRNGKey(0))
        out = jsf.render_camera(p, jcam[cam], jc, deg, bg, means2d_probe=probe)
        return jsf.compute_losses(jsf.gamma_encode(out.rgb, jc), jnp.asarray(gt), p, jc)

    probe_j = jnp.zeros_like(jparams.gaussians.means[:, :2])
    (loss_j, aux_j), (grads_j, probe_grad_j) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jparams, probe_j)

    tparams = params_from_numpy(tree, device="cpu")
    leaves = _leaves(tparams)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    probe = torch.zeros((tparams.gaussians.means.shape[0], 2), requires_grad=True)
    out = tsf.render_camera(tparams, tcam[cam], tc, tsf.active_sh_degree(tc, SH_STEP),
                            tsf.background_color(tparams, tc), means2d_probe=probe)
    loss, aux = tsf.compute_losses(tsf.gamma_encode(out.rgb, tc), torch.tensor(gt), tparams, tc)
    scatter = sorted(n for n in _graph_nodes(loss.grad_fn) if n.startswith(SCATTER_NODES))
    assert not scatter, f"scatter-add on the tape: {scatter}"
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    assert set(aux) == set(aux_j)
    for k in aux:
        np.testing.assert_allclose(aux[k].item(), float(aux_j[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    pairs = [(name, leaf.grad, _jax_leaf(grads_j, name)) for name, leaf in leaves]
    pairs.append(("means2d_probe", probe.grad, probe_grad_j))
    for name, got, want in pairs:
        want = np.asarray(want)
        scale = np.abs(want).max()
        if name != "background_logit" and not name.startswith("gaussians.features_rest"):
            assert scale > 0, f"zero reference gradient for {name}"
        assert got is not None, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale + 1e-8,
                                   err_msg=f"gradient of {name}")


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_psnr_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(40, 30, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    b[:12, :12] = 0.3                       # a flat patch: variances cancel to ~0
    a[:12, :12] = 0.3
    np.testing.assert_allclose(tssim.ssim_map(torch.tensor(a), torch.tensor(b)).numpy(),
                               np.asarray(jssim.ssim_map(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(tssim.ssim(torch.tensor(a), torch.tensor(b))),
                               float(jssim.ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(float(tssim.psnr(torch.tensor(a), torch.tensor(b))),
                               float(jssim.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    # the gradient: the blur's backward is a padded forward blur
    ta = torch.tensor(a, requires_grad=True)
    tssim.ssim(ta, torch.tensor(b)).backward()
    want = jax.grad(lambda x: jssim.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3 * np.abs(np.asarray(want)).max())


def test_optimizer_matches_optax():
    """Three updates from identical seeded gradients, with a short max_steps
    so the exponential decays move between updates."""
    jc, _ = _configs()
    jparams, tree = _model(jc)
    jtc, ttc = jtr.TrainerConfig(max_steps=4), ttr.TrainerConfig(max_steps=4)
    opt = jtr.build_optimizer(jparams, jtc)
    state = opt.init(jparams)
    tparams = params_from_numpy(tree, device="cpu")
    topt = ttr.Optimizer(tparams, ttc)
    leaves = _leaves(tparams)
    assert not tparams.gaussians.alive.requires_grad
    start = {name: leaf.detach().clone().numpy() for name, leaf in leaves}
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = {name: rng.normal(size=leaf.shape).astype(np.float32) for name, leaf in leaves}
        jgrads = jax.tree.map(jnp.zeros_like, jparams)
        jg = jgrads.gaussians._replace(**{n.split(".")[1]: jnp.asarray(v)
                                          for n, v in grads.items() if n.startswith("gauss")})
        jgrads = jgrads._replace(
            gaussians=jg, background_logit=jnp.asarray(grads["background_logit"]),
            camera_opt={k: jnp.asarray(grads[f"camera_opt.{k}"]) for k in jparams.camera_opt},
            velocity_opt={k: jnp.asarray(grads[f"velocity_opt.{k}"])
                          for k in jparams.velocity_opt})
        updates, state = opt.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, leaf in leaves:
            leaf.grad = torch.tensor(grads[name])
        topt.step()
    assert topt.schedule.last_epoch == 3
    for name, leaf in leaves:
        want = np.asarray(_jax_leaf(jparams, name))
        moved = np.abs(want - start[name]).max()
        assert moved > 0, name
        np.testing.assert_allclose(leaf.detach().numpy(), want, rtol=1e-6, atol=2e-5 * moved,
                                   err_msg=name)
    np.testing.assert_array_equal(tparams.gaussians.alive.numpy(),
                                  np.asarray(jparams.gaussians.alive))


def test_train_steps_match_jax():
    """Three train steps on three cameras: the loss sequence, n_visible and
    the densification statistics against `_train_step_body`."""
    jc, tc = _configs()
    jparams, tree = _model(jc)
    jcam, tcam = _cameras(W, H)
    gts = _targets(3, seed=10)
    jtc, ttc = jtr.TrainerConfig(max_steps=100), ttr.TrainerConfig(max_steps=100)
    jopt = jtr.build_optimizer(jparams, jtc)
    jstate, jstrat = jopt.init(jparams), jst.init_strategy_state(192)
    step_j = jax.jit(jtr._train_step_body, static_argnums=(0, 1))
    tparams = params_from_numpy(tree, device="cpu")
    topt = ttr.Optimizer(tparams, ttc)
    tstrat = tst.init_strategy_state(192, device="cpu")
    for i in range(3):
        jparams, jstate, jstrat, loss_j, aux_j = step_j(
            jc, jopt, jparams, jstate, jstrat, jcam[i], jnp.asarray(gts[i]), SH_STEP + i,
            jax.random.PRNGKey(i))
        loss, aux, tstrat = ttr.train_step(tparams, topt, tstrat, tc, tcam[i],
                                           torch.tensor(gts[i]), SH_STEP + i)
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4, err_msg=f"step {i}")
        assert int(aux["n_visible"]) == int(aux_j["n_visible"]), i
    np.testing.assert_array_equal(tstrat.grad_count.numpy(), np.asarray(jstrat.grad_count))
    want = np.asarray(jstrat.grad_accum)
    np.testing.assert_allclose(tstrat.grad_accum.numpy(), want, rtol=1e-4,
                               atol=1e-4 * want.max())
    np.testing.assert_allclose(tparams.gaussians.means.detach().numpy(),
                               np.asarray(jparams.gaussians.means), rtol=1e-5, atol=1e-6)


def test_binning_counts_match_jax():
    jc, tc = _configs()
    jparams, tree = _model(jc)
    jcam, tcam = _cameras(W, H)
    tparams = params_from_numpy(tree, device="cpu")
    for cfg_j, cfg_t in ((jc, tc), (dataclasses.replace(jc, rasterize_mode="classic"),
                                    dataclasses.replace(tc, rasterize_mode="classic"))):
        want = np.asarray(jsf.binning_counts(jparams, jcam[2], cfg_j))
        got = tsf.binning_counts(tparams, tcam[2], cfg_t).numpy()
        np.testing.assert_array_equal(got, want)
        assert want.max() > 0
