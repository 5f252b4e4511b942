"""The port's training loop against the JAX package on the CPU.

Both trainers get the same scene: `splat_tpu.data.synthetic.generate_scene`
and `parse_scene` make it once (48 px, 80 Gaussians, 17 frames of which 3 are
eval cameras), and the port takes it as numpy arrays through
`scene_from_numpy`. The JAX package runs its jnp tile path, the port its
kernels' plain versions. Random draws are shared: the camera order is a numpy
sequence fed to both `_next_camera_index`es, and the split offsets are the
JAX refine's own `jax.random` draws handed to the port's `_split_noise`.

Tolerances:
- Optimizer growth and slot zeroing, then one more update, against
  `zero_gaussian_opt_slots` / `grow_opt_state` / `grow_capacity`: rtol 1e-6
  plus 2e-5 of each leaf's total movement (optax forms Adam's bias
  corrections in float32, torch in float64), moments rtol 1e-6 plus 1e-6 of
  each moment's max (torch forms m + (g - m)(1 - b), optax b m + (1 - b) g).
- the eval-camera step against `make_eval_opt_step`, two steps: the eval
  leaves rtol 1e-5 plus 1e-5 of their movement; every other leaf bitwise
  where it was.
- `_level_data`: intrinsics, sizes and images exact (the box mean is taken on
  the host in the same numpy arithmetic).
- `_maybe_adapt_tile_capacity` on scripted counts: the same decisions,
  `max_per_tile`, `max_total_entries`, overflow share and stream pressure.
- the loop, 45 steps with warmup 10 and a refine at step 30: per-step loss
  rtol 1e-3 up to the refine (largest seen 2e-5) and 2e-2 after it, the
  refine's counts and the alive mask after it equal, the means after it
  rtol 1e-4 except the split Gaussians' two copies (atol 0.02: their offsets
  turn with the quaternions, which drift apart), the Gaussian count at the
  end equal, eval PSNR within 0.05 dB before and after.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_render import _cameras, _configs, _model

from splat_tpu.cameras import optimizers as j_camopt
from splat_tpu.data import dataparser as jdp
from splat_tpu.data import dataset as jds
from splat_tpu.data import synthetic
from splat_tpu.engine import trainer as jtr
from splat_tpu.models import splatfacto as jsf
from splat_tpu.models import strategy as jst
from splat_tpu_torch.cameras import optimizers as t_camopt
from splat_tpu_torch.engine import trainer as ttr
from splat_tpu_torch.models import splatfacto as tsf
from splat_tpu_torch.models import strategy as tst
from splat_tpu_torch.models.convert import (named_leaves, optimizer_state_from_numpy,
                                            params_from_numpy, scene_from_numpy,
                                            strategy_state_from_numpy)

W, H = 48, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here, and
    the suite's xdist workers would each start a full intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(jparams):
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else np.asarray(v))
            for k, v in jparams._asdict().items() if k != "gaussians"}
    tree["gaussians"] = {k: np.asarray(v) for k, v in jparams.gaussians._asdict().items()}
    return tree


def _jax_leaf(tree, name):
    head, _, tail = name.partition(".")
    node = getattr(tree, head)
    if not tail:
        return node
    return node[tail] if isinstance(node, dict) else getattr(node, tail)


def _jax_grads(jparams, grads):
    """A JAX gradient tree from {leaf name: array}; zeros elsewhere."""
    z = jax.tree.map(jnp.zeros_like, jparams)
    g = z.gaussians._replace(**{n.split(".")[1]: jnp.asarray(v) for n, v in grads.items()
                                if n.startswith("gaussians.")})
    groups = {grp: {k: jnp.asarray(grads[f"{grp}.{k}"]) for k in getattr(jparams, grp)}
              for grp in ("camera_opt", "velocity_opt")}
    return z._replace(gaussians=g, background_logit=jnp.asarray(grads["background_logit"]),
                      **groups)


def _adam_moments(state, jparams):
    """optax's mu, nu by leaf name and the update count, from a
    multi_transform state."""
    labels = jtr.param_labels(jparams)
    mu, nu, count = {}, {}, None
    for name in named_leaves(params_from_numpy(_tree(jparams), device="cpu")):
        label = _jax_leaf(labels, name)
        if label == "frozen":
            continue
        adam = state.inner_states[label].inner_state[0]
        mu[name] = np.asarray(_jax_leaf(adam.mu, name))
        nu[name] = np.asarray(_jax_leaf(adam.nu, name))
        count = int(adam.count)
    return mu, nu, count


def test_optimizer_growth_and_slot_zeroing_match_jax():
    jc, _ = _configs()
    jparams, _ = _model(jc)                       # capacity 192
    cap, new_cap = 192, 384
    jtc, ttc = jtr.TrainerConfig(max_steps=6), ttr.TrainerConfig(max_steps=6)
    jopt = jtr.build_optimizer(jparams, jtc)
    jstate = jopt.init(jparams)
    tparams = params_from_numpy(_tree(jparams), device="cpu")
    topt = ttr.Optimizer(tparams, ttc)
    rng = np.random.default_rng(5)
    trainable = lambda p: {n: v for n, v in named_leaves(p).items()   # noqa: E731
                           if n != "gaussians.alive" and not n.startswith("eval_")}

    def update(jparams, jstate, tparams, opt=topt):
        grads = {n: rng.normal(size=tuple(v.shape)).astype(np.float32)
                 for n, v in trainable(tparams).items()}
        updates, jstate = jopt.update(_jax_grads(jparams, grads), jstate, jparams)
        for n, leaf in trainable(tparams).items():
            leaf.grad = torch.tensor(grads[n])
        opt.step()
        return optax.apply_updates(jparams, updates), jstate

    before = {n: v.detach().clone().numpy() for n, v in trainable(tparams).items()}
    for _ in range(3):
        jparams, jstate = update(jparams, jstate, tparams)
    changed = rng.uniform(size=cap) < 0.3
    jstate = jtr.zero_gaussian_opt_slots(jstate, jnp.asarray(changed), cap)
    topt.zero_slots(torch.tensor(changed))
    jparams = jparams._replace(gaussians=jst.grow_capacity(jparams.gaussians, new_cap))
    jstate = jtr.grow_opt_state(jstate, cap, new_cap)
    g = tparams.gaussians
    grown = tst.grow_capacity(tsf.GaussianParams(*(t.detach() for t in g)), new_cap)
    topt.grow({getattr(g, f): getattr(grown, f) for f in g._fields if f != "alive"})
    tparams = tparams._replace(gaussians=grown)
    assert topt.schedule.last_epoch == 3, "the decays' count survives growth"
    assert all(p.shape[0] == new_cap for p in topt.gaussian_leaves())
    assert set(map(id, topt.params)) == {id(v) for v in trainable(tparams).values()}

    # the moments: zeroed slots, carried rows, zero padding
    mu, nu, count = _adam_moments(jstate, jparams)
    assert count == 3
    for name, leaf in trainable(tparams).items():
        st_ = topt.adam.state[leaf]
        assert float(st_["step"]) == 3
        for key, want in (("exp_avg", mu[name]), ("exp_avg_sq", nu[name])):
            np.testing.assert_allclose(st_[key].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=f"{name} {key}")
        if name.startswith("gaussians."):
            assert not st_["exp_avg"][cap:].any() and not st_["exp_avg"][:cap][changed].any()
            assert st_["exp_avg"][:cap][~changed].abs().min() > 0

    jparams, jstate = update(jparams, jstate, tparams)
    for name, leaf in trainable(tparams).items():
        want = np.asarray(_jax_leaf(jparams, name))
        moved = np.abs(want[:before[name].shape[0]] - before[name]).max()
        assert moved > 0 and leaf.shape == want.shape, name
        np.testing.assert_allclose(leaf.detach().numpy(), want, rtol=1e-6, atol=2e-5 * moved,
                                   err_msg=name)

    # the numpy carrier puts a fresh Optimizer in the same state
    mu, nu, count = _adam_moments(jstate, jparams)
    fresh_params = params_from_numpy(_tree(jparams), device="cpu")
    fresh = ttr.Optimizer(fresh_params, ttc)
    optimizer_state_from_numpy(fresh, fresh_params, mu, nu, count)
    assert fresh.schedule.last_epoch == topt.schedule.last_epoch == 4
    for a, b in zip(fresh.adam.param_groups, topt.adam.param_groups):
        assert a["name"] == b["name"]
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-12)
    jparams, jstate = update(jparams, jstate, fresh_params, fresh)
    for name, leaf in trainable(fresh_params).items():
        want = np.asarray(_jax_leaf(jparams, name))
        moved = np.abs(want[:before[name].shape[0]] - before[name]).max()
        np.testing.assert_allclose(leaf.detach().numpy(), want, rtol=1e-6, atol=2e-5 * moved,
                                   err_msg=name)


def test_eval_opt_step_matches_jax():
    jc, tc = _configs(optimize_eval_cameras=True)
    jparams, _ = _model(jc)
    rng = np.random.default_rng(2)
    jparams = jparams._replace(
        eval_camera_opt={k: v + jnp.asarray(rng.normal(size=v.shape) * 0.01, jnp.float32)
                         for k, v in jparams.eval_camera_opt.items()},
        eval_velocity_opt={k: v + jnp.asarray(rng.normal(size=v.shape) * 0.05, jnp.float32)
                           for k, v in jparams.eval_velocity_opt.items()})
    assert set(jparams.eval_camera_opt) == {"phi", "dp"}
    jcam, tcam = _cameras(W, H)
    gts = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    jtc, ttc = jtr.TrainerConfig(), ttr.TrainerConfig()
    jeval = optax.adam(jtc.lr_camera_opt, eps=1e-15)
    jstate = jeval.init({"cam": jparams.eval_camera_opt, "vel": jparams.eval_velocity_opt})
    jstep = jtr.make_eval_opt_step(jc, jeval)
    tparams = params_from_numpy(_tree(jparams), device="cpu")
    ttr.Optimizer(tparams, ttc)                   # the scene's leaves require grad, as in a run
    teval = ttr.EvalOptimizer(tparams, ttc)
    start = {n: v.detach().clone() for n, v in named_leaves(tparams).items()}
    for i in range(2):                            # eval cameras 0 and 1
        jparams, jstate = jstep(jparams, jstate, jcam[i], jnp.asarray(gts[i]),
                                jnp.asarray(3000 + i), jax.random.PRNGKey(i))
        loss = ttr.eval_opt_step(tparams, teval, tc, tcam[i], torch.tensor(gts[i]), 3000 + i)
        assert np.isfinite(float(loss))
    for name, leaf in named_leaves(tparams).items():
        if name.startswith("eval_"):
            want = np.asarray(_jax_leaf(jparams, name))
            moved = np.abs(want - start[name].numpy()).max()
            assert moved > 0, name
            np.testing.assert_allclose(leaf.detach().numpy(), want, rtol=1e-5,
                                       atol=1e-5 * moved, err_msg=name)
        else:
            assert torch.equal(leaf.detach(), start[name]), f"{name} moved"
            assert leaf.grad is None, f"{name} was given a gradient"


# ------------------------------------------------------------- the trainers
@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The JAX ParsedScene with its image caches, and the same scene as the
    numpy tree `scene_from_numpy` takes."""
    out = tmp_path_factory.mktemp("torch_train_scene")
    synthetic.generate_scene(out, n_gaussians=80, n_frames=17, img_size=48, exposure=0.08,
                             n_blur_samples=5, seed=3, eval_interval=8, gamma=2.2)
    cfg = jdp.DataParserConfig(eval_mode="interval", eval_interval=8, orientation_method="none",
                               center_method="none", auto_scale_poses=False)
    jscene = jdp.parse_scene(out, cfg)
    train_imgs, eval_imgs = jds.load_scene_images(jscene)

    def cam_fields(cams):
        d = {k: np.asarray(getattr(cams, k)) for k in cams._leaf_names}
        return dict(d, width=cams.width, height=cams.height)

    tree = dict(train_cameras=cam_fields(jscene.train_cameras),
                eval_cameras=cam_fields(jscene.eval_cameras),
                train_images=train_imgs.images, eval_images=eval_imgs.images,
                train_paths=jscene.train_paths, eval_paths=jscene.eval_paths,
                points_xyz=jscene.points_xyz, points_rgb=jscene.points_rgb)
    return jscene, tree


def _model_configs(**kw):
    base = dict(blur_samples=3, sh_degree=1, sh_degree_interval=50, tile_size=8,
                max_per_tile=128, max_tiles_per_gaussian=16, warmup_length=10, refine_every=30,
                reset_alpha_every=1000, background_color="black", gamma=2.2,
                densify_grad_thresh=0.003, cull_alpha_thresh=0.05)
    base.update(kw)
    jc = jsf.SplatfactoConfig(
        chunk=16, **base, camera_optimizer=j_camopt.CameraOptConfig(mode="SO3xR3"),
        camera_velocity_optimizer=j_camopt.VelocityOptConfig(enabled=True))
    tc = tsf.SplatfactoConfig(
        **base, camera_optimizer=t_camopt.CameraOptConfig(mode="SO3xR3"),
        camera_velocity_optimizer=t_camopt.VelocityOptConfig(enabled=True))
    return jc, tc


def _trainers(scenes, jtc_kw=None, **model_kw):
    jscene, tree = scenes
    jc, tc = _model_configs(**model_kw)
    kw = dict(max_steps=45, seed=0, log_every=1, **(jtc_kw or {}))
    jt = jtr.Trainer(jscene, jc, jtr.TrainerConfig(**kw))
    scene, train_imgs, eval_imgs = scene_from_numpy(tree, device="cpu")
    tt = ttr.Trainer(scene, tc, ttr.TrainerConfig(**kw), train_images=train_imgs,
                     eval_images=eval_imgs, device="cpu")
    return jt, tt


def test_trainer_config_carries_across_field_by_field():
    jf = {f.name: f.default for f in dataclasses.fields(jtr.TrainerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(ttr.TrainerConfig)}
    assert jf == tf
    ttr.TrainerConfig(**dataclasses.asdict(jtr.TrainerConfig(max_steps=7, scan_steps=4)))


def test_trainer_starts_in_the_jax_trainers_state(scenes, tmp_path):
    jt, tt = _trainers(scenes, optimize_eval_cameras=True)
    for name, leaf in named_leaves(tt.params).items():
        np.testing.assert_array_equal(leaf.detach().numpy(),
                                      np.asarray(_jax_leaf(jt.params, name)), err_msg=name)
    assert tt.model_config.blur_anchors == jt.model_config.blur_anchors >= 1
    assert tt.eval_optimizer is not None and jt.eval_opt_state is not None
    assert len(tt.train_cams) == len(jt.train_cams) == 14 and len(tt.eval_cams) == 3
    np.testing.assert_array_equal(tt.eval_cams.cam_idx.numpy(), [0, 1, 2])
    # checkpoints are ported (tests/test_torch_checkpoint.py): the initial state round-trips
    path = tt.save_checkpoint(tmp_path / "step_0")
    before = {name: leaf.detach().clone() for name, leaf in named_leaves(tt.params).items()}
    with torch.no_grad():
        tt.params.gaussians.means.add_(1.0)
    tt.load_checkpoint(path)
    assert tt.step == 0
    for name, leaf in named_leaves(tt.params).items():
        assert torch.equal(leaf, before[name]), name


def test_level_data_matches_jax(scenes):
    jt, tt = _trainers(scenes, num_downscales=2, resolution_schedule=20)
    assert tt._resolution_level() == jt._resolution_level() == 2
    for level in (0, 1, 2):
        jcams, jimgs = jt._level_data(level)
        tcams, timgs = tt._level_data(level)
        assert (tcams.width, tcams.height) == (jcams.width, jcams.height) == (48 >> level,) * 2
        for k in ("fx", "fy", "cx", "cy", "R_c2w", "p_c2w", "lin_vel", "exposure_time"):
            np.testing.assert_array_equal(getattr(tcams, k).numpy(), np.asarray(getattr(jcams, k)),
                                          err_msg=f"level {level} {k}")
        assert timgs.shape == tuple(jimgs.shape)
        np.testing.assert_array_equal(timgs.numpy(), np.asarray(jimgs))
        assert tt._level_data(level)[1] is timgs, "cached"
    tt.step = jt.step = 25
    assert tt._resolution_level() == jt._resolution_level() == 1
    tt.step = jt.step = 400
    assert tt._resolution_level() == jt._resolution_level() == 0


def test_level_data_crops_to_a_multiple_of_the_factor(scenes):
    _, tree = scenes
    tree = dict(tree, train_images=tree["train_images"][:, :47, :45],
                train_cameras=dict(tree["train_cameras"], width=45, height=47))
    scene, train_imgs, eval_imgs = scene_from_numpy(tree, device="cpu")
    tt = ttr.Trainer(scene, _model_configs()[1], ttr.TrainerConfig(), train_images=train_imgs,
                     eval_images=eval_imgs, device="cpu")
    cams, imgs = tt._level_data(2)
    assert imgs.shape[1:] == (11, 11, 3) and (cams.width, cams.height) == (11, 11)
    want = tree["train_images"][:, :44, :44].reshape(-1, 11, 4, 11, 4, 3).mean(axis=(2, 4))
    np.testing.assert_allclose(imgs.numpy(), want, rtol=0, atol=1e-7)


SCRIPT = [   # (per-tile counts, what the step is there to show)
    ([10, 300, 5, 128], "first probe over tolerance: the streak starts"),
    ([10, 128, 5, 100], "under tolerance: the streak resets"),
    ([10, 300, 5, 128], "over again: streak 1"),
    ([10, 700, 5, 128], "second in a row: K grows to 1024 (the fullest tile needs 700)"),
    ([10, 5000, 5, 128], "over"),
    ([10, 5000, 5, 128], "second in a row: capped at max_tile_capacity"),
    ([2048, 5000, 2048, 2048], "K at its ceiling; the stream's pressure passes 80 %"),
    ([10, 10, 5, 10], "quiet"),
]


@pytest.mark.parametrize("max_total_entries", [0, 2000])
def test_adapt_tile_capacity_decides_as_jax(scenes, max_total_entries):
    jt, tt = _trainers(scenes, dict(max_tile_capacity=2048), max_total_entries=max_total_entries)
    assert tt._maybe_adapt_tile_capacity() is False, "no camera trained yet"
    jt._probe_cam = tt._probe_cam = object()
    seen_k = set()
    for counts, what in SCRIPT:
        arr = np.asarray(counts, np.int32)
        jt._binning_probe = lambda params, cam, arr=arr: arr
        tt._probe_counts = lambda cam, arr=arr: arr
        assert tt._maybe_adapt_tile_capacity() == jt._maybe_adapt_tile_capacity(), what
        for field in ("max_per_tile", "max_total_entries"):
            assert getattr(tt.model_config, field) == getattr(jt.model_config, field), what
        assert tt._tile_overflow_frac == jt._tile_overflow_frac, what
        assert tt._entry_stream_pressure == getattr(jt, "_entry_stream_pressure", None), what
        seen_k.add(tt.model_config.max_per_tile)
    assert seen_k == {128, 1024, 2048}
    if max_total_entries:
        assert tt.model_config.max_total_entries > max_total_entries
    off = dataclasses.replace(tt.trainer_config, adapt_tile_capacity=False)
    tt.trainer_config = off
    assert tt._maybe_adapt_tile_capacity() is False


def test_training_loop_matches_jax(scenes):
    """45 steps across a refine at step 30 (see the module docstring for the
    tolerances), with the eval-camera step every 5 steps."""
    jt, tt = _trainers(scenes, dict(eval_opt_every=5), optimize_eval_cameras=True,
                       densify_grad_thresh=2e-4)
    n_train = len(tt.train_cams)
    rng = np.random.default_rng(0)
    order = np.concatenate([rng.permutation(n_train) for _ in range(4)])
    jt._next_camera_index = lambda n: int(order[jt.step])
    tt._next_camera_index = lambda n: int(order[tt.step])

    # the first refine's split offsets, as make_refine draws them
    cap = tt.params.gaussians.alive.shape[0]
    _, k_split = jax.random.split(jax.random.PRNGKey(jt.trainer_config.seed))
    eps = np.asarray(jax.random.normal(k_split, (cap, 3)))
    eps2 = np.asarray(jax.random.normal(jax.random.fold_in(k_split, 1), (cap, 3)))
    tt._split_noise = lambda shape: (torch.tensor(eps), torch.tensor(eps2))
    jinfo = []
    refine = jt.refine

    def spy(*a, **k):
        out = refine(*a, **k)
        jinfo.append({k: int(v) for k, v in out[3].items()})
        return out

    jt.refine = spy
    psnr0_j, psnr0_t = jt.evaluate()["psnr"], tt.evaluate()["psnr"]
    assert abs(psnr0_t - psnr0_j) <= 0.05

    jhist, thist = jt.run(30), tt.run(30)
    assert [r["step"] for r in thist] == [r["step"] for r in jhist] == list(range(1, 31))
    np.testing.assert_allclose([r["loss"] for r in thist], [r["loss"] for r in jhist], rtol=1e-3)
    assert len(jinfo) == 1 and len(tt.refine_events) == 1
    event = tt.refine_events[0]
    assert {k: event[k] for k in jinfo[0]} == jinfo[0]
    assert event["step"] == 30 and event["n_split"] + event["n_cloned"] > 0
    assert not event["reset"] and event["capacity"] == cap
    np.testing.assert_array_equal(tt.params.gaussians.alive.numpy(),
                                  np.asarray(jt.params.gaussians.alive))
    # a split's two copies are offset along the Gaussian's rotated axes, and
    # the quaternions have drifted apart by then (their gradients are rounding
    # noise while the seed Gaussians are isotropic, and Adam normalises it)
    tmeans = tt.params.gaussians.means.detach().numpy()
    jmeans = np.asarray(jt.params.gaussians.means)
    close = np.isclose(tmeans, jmeans, rtol=1e-4, atol=1e-5).all(axis=1)
    assert 0 < (~close).sum() <= 2 * event["n_split"]
    np.testing.assert_allclose(tmeans, jmeans, rtol=0, atol=0.02)
    assert [r["n_alive"] for r in thist] == [r["n_alive"] for r in jhist]
    for rec in thist:
        assert all(np.isfinite(v) for v in rec.values())
        assert {"step_ms_p50", "wall_s"} <= set(rec)
    assert thist[-1]["tile_overflow_frac"] == jhist[-1]["tile_overflow_frac"]

    jt.run(15)
    tt.run(15)
    assert tt.step == jt.step == 45
    np.testing.assert_allclose([r["loss"] for r in tt.history[30:]],
                               [r["loss"] for r in jt.history[30:]], rtol=2e-2)
    assert tt.history[-1]["n_alive"] == jt.history[-1]["n_alive"]
    # the eval cameras were optimised (steps 0, 5, ..., 40), the scene's leaves trained
    for name in ("eval_camera_opt.phi", "eval_camera_opt.dp", "camera_opt.dp"):
        leaf = named_leaves(tt.params)[name].detach().numpy()
        want = np.asarray(_jax_leaf(jt.params, name))
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(leaf, want, rtol=0, atol=0.05 * np.abs(want).max(),
                                   err_msg=name)
    # the scene's cameras stand still, and at zero velocity with symmetric
    # sample times the loss is stationary in the velocity: its gradient is
    # rounding noise (~1e-7, of either sign) that Adam turns into full steps,
    # so the velocity corrections only have to move, not to agree
    for name in ("eval_velocity_opt.dv", "velocity_opt.dom"):
        leaf = named_leaves(tt.params)[name].detach().numpy()
        assert 0 < np.abs(leaf).max() <= 45 * 1e-3 and np.isfinite(leaf).all(), name
    mj, mt = jt.evaluate(), tt.evaluate()
    assert set(mt) == {"psnr", "ssim"}
    assert abs(mt["psnr"] - mj["psnr"]) <= 0.05, (mt, mj)
    assert abs(mt["ssim"] - mj["ssim"]) <= 2e-3
    assert mt["psnr"] > psnr0_t, "training raises the eval PSNR"
    assert tuple(tt.render_eval(0).shape) == (48, 48, 3)


def test_run_reaches_reset_growth_and_pause(scenes):
    """The schedule's other branches on the port alone: a capacity small
    enough to grow at the first refine (Adam's moments carried, the step
    after growth finite), an opacity reset at every refine followed by the
    paused refine, scan_steps accepted, and the camera order a permutation
    per epoch drawn from the seeded generator."""
    _, tree = scenes
    scene, train_imgs, eval_imgs = scene_from_numpy(tree, device="cpu")
    _, mc = _model_configs(warmup_length=10, refine_every=20, reset_alpha_every=1,
                           densify_grad_thresh=1e-5, initial_capacity=96, cull_alpha_thresh=0.005,
                           cull_scale_thresh=100.0)
    tc = ttr.TrainerConfig(max_steps=100, seed=0, log_every=10, scan_steps=8,
                           grow_threshold=0.7)

    def make():
        return ttr.Trainer(scene, mc, tc, train_images=train_imgs, eval_images=eval_imgs,
                           device="cpu")

    t = make()
    assert t.params.gaussians.alive.shape[0] == 96
    seen = []
    draw = t._next_camera_index
    t._next_camera_index = lambda n: seen.append(draw(n)) or seen[-1]
    hist = t.run(100)
    n_train = len(t.train_cams)
    pause = n_train + mc.refine_every
    expected, last_reset = [], -(10**9)
    for s in range(20, 101, 20):
        if s - last_reset > pause:
            expected.append(s)
            if s + pause <= tc.max_steps:
                last_reset = s
    assert [e["step"] for e in t.refine_events] == expected == [20, 60, 100]
    assert [e["reset"] for e in t.refine_events] == [True, True, False]
    first = t.refine_events[0]
    assert first["grew"] and first["capacity"] == 192
    assert first["n_split"] + first["n_cloned"] == 16 == first["n_alive"] - 80, "trimmed to fit"
    cap = t.refine_events[-1]["capacity"]
    assert cap in (192, 384)
    g = t.params.gaussians
    assert all(getattr(g, f).shape[0] == cap for f in g._fields)
    assert t.strat_state.grad_accum.shape == (cap,)
    for leaf in t.optimizer.gaussian_leaves():
        st_ = t.optimizer.adam.state[leaf]
        assert st_["exp_avg"].shape == leaf.shape and float(st_["step"]) == 100
    assert t.optimizer.schedule.last_epoch == 100
    assert all(np.isfinite(r["loss"]) for r in hist) and [r["step"] for r in hist] == list(
        range(10, 101, 10))
    assert hist[2]["loss"] < 2 * hist[1]["loss"], "no jump across the growth at step 20"
    for e in range(100 // n_train):
        assert sorted(seen[e * n_train:(e + 1) * n_train]) == list(range(n_train))
    assert seen[:n_train] != seen[n_train:2 * n_train]
    t2 = make()
    seen2 = []
    draw2 = t2._next_camera_index
    t2._next_camera_index = lambda n: seen2.append(draw2(n)) or seen2[-1]
    t2.run(20)
    assert seen2 == seen[:20], "the same seed gives the same camera order"
    a, b = make()._split_noise((4, 3))
    assert torch.equal(a, make()._split_noise((4, 3))[0]), "seeded split sampling"
    assert not torch.equal(a, b)


def test_strategy_state_carrier():
    state = strategy_state_from_numpy(np.float32([0.5, 0.0, 2.0]), np.int32([3, 0, 9]),
                                      seed=1, device="cpu")
    assert state.grad_count.dtype == torch.int32 and state.grad_accum.dtype == torch.float32
    assert state.grad_accum.tolist() == [0.5, 0.0, 2.0] and state.grad_count.tolist() == [3, 0, 9]


def _trainer_state(t):
    """Every leaf and the three generators' states, cloned."""
    state = {name: leaf.detach().clone() for name, leaf in named_leaves(t.params).items()}
    for key, gen in (("sampler", t._sampler), ("background", t._bg_generator),
                     ("split", t.strat_state.generator)):
        state[f"generator.{key}"] = gen.get_state().clone()
    return state


@pytest.mark.parametrize("background", ["black", "white", "auto"])
def test_evaluate_leaves_the_training_run_alone(scenes, background):
    """A run with `evaluate()` between two `run` chunks ends bitwise where the
    same run without it ends: leaves and generator states (the eval render
    draws from none of the training streams)."""
    _, tree = scenes
    _, mc = _model_configs(background_color=background, optimize_eval_cameras=True)
    tc = ttr.TrainerConfig(max_steps=8, seed=0, log_every=4, eval_opt_every=2)

    def make():
        scene, train_imgs, eval_imgs = scene_from_numpy(tree, device="cpu")
        return ttr.Trainer(scene, mc, tc, train_images=train_imgs, eval_images=eval_imgs,
                           device="cpu")

    straight, paused = make(), make()
    straight.run(8)
    paused.run(4)
    assert np.isfinite(paused.evaluate()["psnr"])
    paused.run(4)
    a, b = _trainer_state(straight), _trainer_state(paused)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_evaluate_refuses_a_random_background(scenes):
    """The JAX eval render passes no key, and its background_color asserts
    one for "random": the port raises, naming the mode, and draws nothing."""
    _, tree = scenes
    _, mc = _model_configs(background_color="random")
    scene, train_imgs, eval_imgs = scene_from_numpy(tree, device="cpu")
    t = ttr.Trainer(scene, mc, ttr.TrainerConfig(max_steps=2, seed=0), train_images=train_imgs,
                    eval_images=eval_imgs, device="cpu")
    t.run(2)
    before = _trainer_state(t)
    with pytest.raises(ValueError, match="random"):
        t.evaluate()
    after = _trainer_state(t)
    for name in before:
        assert torch.equal(before[name], after[name]), name
