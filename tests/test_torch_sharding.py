"""The port's multi-device mesh (`splat_tpu_torch/parallel/`) on the CPU.

Ranks are processes on gloo, spawned by `parallel.launch` (a `file://`
rendezvous in a temporary directory). Each world size (1, 2, 4 and 8 ranks)
is spawned once: a module-scoped fixture runs every case of that size on its
ranks, rank 0 writes numpy arrays, and the tests compare them with the port on
one device (in this process) and with the JAX package's mesh
(`splat_tpu.parallel.sharding` on the 8 virtual CPU devices of
`tests/conftest.py`). Every rank runs one thread. This module imports no JAX
at its top: the spawned ranks import it.

The scenes are the JAX sharding tests' own (`tests/test_sharding.py`):
`make_setup` (60 Gaussians, 32 px, S = 4 fused blur samples, rolling shutter)
and `mesh_scene` (the synthetic generator's 48 px scene, 17 frames).

Tolerances (the JAX package's, tests/test_sharding.py:76,129,319-356):
- the sharded loss against the single-device loss rtol 2e-5 / atol 2e-6;
  every gradient, each Gaussian leaf and the means2d probe, atol 2e-5 /
  rtol 1e-3;
- against the JAX package's sharded loss rtol 1e-5, gradients as above;
- the data axis: 3 steps of a 2-camera batch against one device on the
  batch's mean loss, losses rtol 2e-5 / atol 1e-6, the Gaussians as
  `assert_gaussians_close` (atol 5e-3, mean 5e-4), the densification
  statistics atol 1e-3 / rtol 1e-4;
- the trainer, 15 steps across a refine: equal alive counts, eval renders
  above 35 dB PSNR of each other, the means' mean |diff| below 2e-3; a
  mesh checkpoint bitwise through save -> load -> save;
- `cli.fit --mesh.enabled True` on 2 ranks (torchrun) within 0.05 dB of the
  single-process fit's eval PSNR after 20 steps.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from splat_tpu_torch.cameras.cameras import Cameras
from splat_tpu_torch.engine import config as tcfg
from splat_tpu_torch.engine import trainer as ttr
from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.models import strategy as st
from splat_tpu_torch.models.convert import cameras_from_numpy, named_leaves, scene_from_numpy
from splat_tpu_torch.ops.ssim import psnr
from splat_tpu_torch.parallel import launch, sharding

ROOT = Path(__file__).resolve().parents[1]
STEP_MAX_SH = 10**6
TRAIN_STEPS = 15
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(atol=2e-5, rtol=1e-3)


# ---------------------------------------------------------------- inputs
def model_config(**kw):
    base = dict(blur_samples=4, sh_degree=1, tile_size=8, max_per_tile=64,
                max_tiles_per_gaussian=16, background_color="black", gamma=2.2,
                use_scale_regularization=True)
    base.update(kw)
    return sf.SplatfactoConfig(**base)


def make_setup(img=32, n=60, seed=0):
    """tests/test_sharding.py's make_setup in the port (the same numpy draws)."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    rgb = rng.integers(0, 255, size=(n, 3)).astype(np.uint8)
    cfg = model_config()
    params = sf.init_model(pts, rgb, 2, 1, cfg, device="cpu")
    cam = cameras_from_numpy(dict(
        R_c2w=np.eye(3)[None], p_c2w=[[0.0, 0.0, -4.0]], fx=[img * 1.2], fy=[img * 1.2],
        cx=[img / 2.0], cy=[img / 2.0], width=img, height=img, lin_vel=[[0.4, 0.1, 0.0]],
        ang_vel=[[0.0, 0.1, 0.05]], exposure_time=[0.2], rolling_shutter_time=[0.03],
        cam_idx=[0]), device="cpu")
    gt = torch.tensor(rng.uniform(size=(img, img, 3)), dtype=torch.float32)
    return params, cfg, cam, gt


def second_camera(cam: Cameras) -> Cameras:
    """tests/test_sharding.py's second camera of the data batch."""
    return dataclasses.replace(
        cam, p_c2w=cam.p_c2w + torch.tensor([[0.1, -0.05, 0.2]]),
        lin_vel=torch.tensor([[0.1, 0.3, 0.0]]), ang_vel=torch.tensor([[0.05, 0.0, 0.1]]),
        cam_idx=torch.ones(1, dtype=torch.int64))


def trainer_model_config(**kw):
    base = dict(blur_samples=4, sh_degree=1, sh_degree_interval=15, tile_size=8,
                max_per_tile=128, max_tiles_per_gaussian=16, warmup_length=5, refine_every=10,
                reset_alpha_every=1000, background_color="black", gamma=2.2,
                densify_grad_thresh=1e-6, cull_alpha_thresh=1e-3)
    base.update(kw)
    return sf.SplatfactoConfig(**base)


def single_loss(params, cfg, cam, gt, sh_deg=None, probe=None):
    bg = sf.background_color(params, cfg)
    out = sf.render_camera(params, cam, cfg, cfg.sh_degree if sh_deg is None else sh_deg, bg,
                           means2d_probe=probe)
    return sf.compute_losses(sf.gamma_encode(out.rgb, cfg), gt, params, cfg)[0]


def _trainable(params):
    for name, leaf in named_leaves(params).items():
        if not name.endswith("alive"):
            leaf.requires_grad_(True)


# ------------------------------------------------------- on every rank
def _shard(mesh, params):
    if mesh.shape["gauss"] == 1:
        return params
    return params._replace(gaussians=sf.GaussianParams(
        *(sharding.shard_rows(mesh, t) for t in params.gaussians)))


def _loss_case(mesh, case):
    params, cfg, cam, gt = make_setup()
    cfg = dataclasses.replace(cfg, **case.get("cfg", {}))
    if case.get("rest"):
        g = params.gaussians
        params = params._replace(gaussians=g._replace(features_rest=g.features_rest
                                                      + case["rest"]))
    p = _shard(mesh, params)
    _trainable(p)
    probe = torch.zeros_like(p.gaussians.means[:, :2], requires_grad=True)
    share, info = sharding.sharded_loss(mesh, p, cam, gt, cfg, case["step"], probe=probe)
    out = {"loss": sharding.world_sum(mesh, share).numpy(),
           "overflow": info["slab_overflow"].numpy()}
    if case.get("grads"):
        share.backward()
        gauss = [t for t in p.gaussians if t.requires_grad]
        replicated = [t for n, t in named_leaves(p).items()
                      if not n.startswith("gaussians.")]
        sharding.reduce_gradients(mesh, gauss + [probe], replicated)
        for name, leaf in named_leaves(p).items():
            if leaf.grad is not None:
                g = leaf.grad
                out[f"grad.{name}"] = (sharding.gather_rows(mesh, g) if name.startswith("gaussians.")
                                       else g).numpy()
        out["grad.probe"] = sharding.gather_rows(mesh, probe.grad).numpy()
    return out


def _data_loss_case(mesh, case):
    params, cfg, cam1, gt1 = make_setup(seed=0)
    _, _, _, gt2 = make_setup(seed=7)
    cam, gt = ((cam1, gt1), (second_camera(cam1), gt2))[mesh.coords["data"]]
    share, _ = sharding.sharded_loss(mesh, _shard(mesh, params), cam, gt, cfg, STEP_MAX_SH)
    return {"loss": sharding.world_sum(mesh, share).numpy()}


def _scene(tree):
    return scene_from_numpy(tree, device="cpu")


def _localize(cams: Cameras) -> Cameras:
    """The trainer's camera tables: cam_idx by position within the split."""
    return dataclasses.replace(cams, cam_idx=torch.arange(len(cams)))


def _data_steps_case(mesh, case):
    """3 sharded steps on a 2-camera batch of mesh_scene's train cameras."""
    scene, train_imgs, _ = _scene(case["tree"])
    mc = trainer_model_config(warmup_length=1000, refine_every=1000)
    params = sf.init_model(scene.points_xyz, scene.points_rgb, len(scene.train_cameras),
                           len(scene.eval_cameras), mc, seed=0, device="cpu")
    opt = ttr.Optimizer(params, ttr.TrainerConfig(seed=0))
    strat = st.init_strategy_state(params.gaussians.alive.shape[0], 0, device="cpu")
    params, strat = sharding.shard_train_state(mesh, params, opt, strat)
    cams = _localize(scene.train_cameras)
    imgs = torch.as_tensor(train_imgs.images)
    losses = []
    for s in range(3):
        i = 2 * s + mesh.coords["data"]
        loss, _, strat = sharding.sharded_train_step(mesh, params, opt, strat, mc, cams[i],
                                                     imgs[i], s)
        losses.append(float(loss))
    params, strat = sharding.gather_train_state(mesh, params, opt, strat)
    out = {"losses": np.asarray(losses), "grad_accum": strat.grad_accum.numpy(),
           "grad_count": strat.grad_count.numpy()}
    out.update({f"g.{f}": t.detach().numpy() for f, t in zip(sf.GaussianParams._fields,
                                                              params.gaussians)})
    return out


def _mesh_trainer(mesh, tree, mc, noise, order, device="cpu", **tc_kw):
    scene, train_imgs, eval_imgs = _scene(tree)
    tc = ttr.TrainerConfig(**{"max_steps": TRAIN_STEPS, "seed": 0, "sync_every": 100,
                              "log_every": 1, **tc_kw})
    t = ttr.Trainer(scene, mc, tc, train_images=train_imgs, eval_images=eval_imgs,
                    device=device, mesh=mesh)
    t._next_camera_indices = lambda n, c: [int(order[t.step * c + j]) for j in range(c)]
    if noise is not None:
        t._split_noise = lambda shape: (torch.tensor(noise[0]), torch.tensor(noise[1]))
    return t


def _trainer_case(mesh, case):
    mc = trainer_model_config()
    t = _mesh_trainer(mesh, case["tree"], mc, case["noise"], case["order"])
    n0 = t._n_alive()
    hist = t.run(TRAIN_STEPS)
    out = {"n_alive_start": np.asarray(n0), "n_alive": np.asarray(t._n_alive()),
           "losses": np.asarray([r["loss"] for r in hist]),
           "refines": np.asarray([e["step"] for e in t.refine_events]),
           "renders": torch.stack([t.render_eval(i) for i in range(len(t.eval_cams))]).numpy()}
    with t.global_view():
        out["means"] = t.params.gaussians.means.detach().numpy().copy()
    if case.get("checkpoint"):
        ckpt = Path(case["out"]) / f"ckpt_{case['id']}"
        t.save_checkpoint(ckpt / "a")
        t2 = _mesh_trainer(mesh, case["tree"], mc, case["noise"], case["order"])
        t2.load_checkpoint(ckpt / "a")
        t2.save_checkpoint(ckpt / "b")
        out["local_equal"] = np.asarray(all(
            torch.equal(a, b) for a, b in zip(named_leaves(t.params).values(),
                                               named_leaves(t2.params).values())))
    return out


def _eval_opt_case(mesh, case):
    from splat_tpu_torch.cameras import optimizers as cam_opt

    mc = trainer_model_config(
        warmup_length=1000, refine_every=1000, optimize_eval_cameras=True,
        camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"),
        camera_velocity_optimizer=cam_opt.VelocityOptConfig(enabled=True))
    t = _mesh_trainer(mesh, case["tree"], mc, None, case["order"], eval_opt_every=2)
    scene0 = [x.detach().clone() for x in t.params.gaussians]
    eval0 = {k: v.detach().clone() for k, v in named_leaves(t.params).items()
             if k.startswith("eval_")}
    sharding.sharded_eval_opt_step(mesh, t.params, t.eval_optimizer, t.model_config,
                                   t.eval_cams[0], t._eval_imgs_dev[0], 0)
    now = named_leaves(t.params)
    moved = sum(float((now[k] - v).abs().sum()) for k, v in eval0.items())
    same = all(torch.equal(a, b) for a, b in zip(t.params.gaussians, scene0))
    return {"moved": np.asarray(moved), "scene_equal": np.asarray(same)}


CASE_FNS = {"loss": _loss_case, "data_loss": _data_loss_case, "data_steps": _data_steps_case,
            "trainer": _trainer_case, "eval_opt": _eval_opt_case}


def run_cases(rank, world, device, cases, out_dir):
    """Every case on this rank; rank 0 writes out_dir/<id>.npz."""
    torch.set_num_threads(1)
    for case in cases:
        mesh = sharding.make_mesh(case["shape"])
        assert mesh.world == world, (case["id"], mesh)
        res = CASE_FNS[case["kind"]](mesh, {**case, "out": out_dir})
        if rank == 0:
            np.savez(Path(out_dir) / f"{case['id']}.npz", **res)


def _spawn(tmp_path_factory, name, world, cases):
    out = tmp_path_factory.mktemp(name)
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"          # the spawned ranks inherit it
    try:
        launch.launch(run_cases, world, args=(cases, str(out)), device="cpu")
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    res = {c["id"]: dict(np.load(out / f"{c['id']}.npz")) for c in cases}
    res["dir"] = out
    return res


def _loss(cid, shape, **kw):
    return {"id": cid, "kind": "loss", "shape": shape, "step": STEP_MAX_SH, **kw}


# ------------------------------------------------------------- fixtures
@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh_scene(tmp_path_factory):
    """tests/test_sharding.py's mesh_scene: the JAX ParsedScene and the same
    scene as the numpy tree `scene_from_numpy` takes."""
    from splat_tpu.data import dataparser as jdp
    from splat_tpu.data import dataset as jds
    from splat_tpu.data import synthetic

    out = tmp_path_factory.mktemp("mesh_scene")
    synthetic.generate_scene(out, n_gaussians=80, n_frames=17, img_size=48, exposure=0.08,
                             n_blur_samples=5, seed=3, eval_interval=8, gamma=2.2)
    jscene = jdp.parse_scene(out, jdp.DataParserConfig(
        eval_mode="interval", eval_interval=8, orientation_method="none",
        center_method="none", auto_scale_poses=False))
    train_imgs, eval_imgs = jds.load_scene_images(jscene)

    def cam_fields(cams):
        return dict({k: np.asarray(getattr(cams, k)) for k in cams._leaf_names},
                    width=cams.width, height=cams.height)

    tree = dict(train_cameras=cam_fields(jscene.train_cameras),
                eval_cameras=cam_fields(jscene.eval_cameras),
                train_images=train_imgs.images, eval_images=eval_imgs.images,
                train_paths=jscene.train_paths, eval_paths=jscene.eval_paths,
                points_xyz=jscene.points_xyz, points_rgb=jscene.points_rgb)
    return jscene, tree


@pytest.fixture(scope="module")
def shared_draws(mesh_scene):
    """One camera order for every trainer, and the first refine's split
    offsets as the JAX refine draws them (make_refine splits the strategy
    key, PRNGKey(seed), and draws both offsets from k_split)."""
    import jax

    _, tree = mesh_scene
    scene, _, _ = _scene(tree)
    cap = sf.init_model(scene.points_xyz, scene.points_rgb, len(scene.train_cameras),
                        len(scene.eval_cameras), trainer_model_config(), seed=0,
                        device="cpu").gaussians.alive.shape[0]
    _, k_split = jax.random.split(jax.random.PRNGKey(0))
    noise = (np.asarray(jax.random.normal(k_split, (cap, 3))),
             np.asarray(jax.random.normal(jax.random.fold_in(k_split, 1), (cap, 3))))
    n_train = len(scene.train_cameras)
    rng = np.random.default_rng(0)
    order = np.concatenate([rng.permutation(n_train) for _ in range(6)])
    return noise, order


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _spawn(tmp_path_factory, "world1", 1, [_loss("b1t1", {}, grads=True)])


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(tmp_path_factory, "world2", 2, [
        _loss("slab_g2", {"gauss": 2}, cfg={"gauss_shard_mode": "slab"}, grads=True),
    ])


@pytest.fixture(scope="module")
def world4(tmp_path_factory, mesh_scene, shared_draws):
    _, tree = mesh_scene
    noise, order = shared_draws
    trainer = dict(tree=tree, noise=noise, order=order)
    return _spawn(tmp_path_factory, "world4", 4, [
        _loss("b2t2", {"blur": 2, "tile": 2}, grads=True),
        _loss("b1t4", {"tile": 4}),
        _loss("b4t1", {"blur": 4}),
        _loss("gather_g2b2t1", {"gauss": 2, "blur": 2}),
        _loss("gather_g2b1t2", {"gauss": 2, "tile": 2}, grads=True),
        _loss("gather_g4b1t1", {"gauss": 4}),
        _loss("slab_g2b2t1", {"gauss": 2, "blur": 2}, cfg={"gauss_shard_mode": "slab"}),
        _loss("slab_g4b1t1", {"gauss": 4}, cfg={"gauss_shard_mode": "slab"}),
        _loss("slab_g4_overflow", {"gauss": 4},
              cfg={"gauss_shard_mode": "slab", "slab_slack": 0.2}),
        {**_loss("sh0", {"blur": 2, "tile": 2}), "step": 0},
        {**_loss("sh0_rest", {"blur": 2, "tile": 2}), "step": 0, "rest": 0.3},
        _loss("sh_max_rest", {"blur": 2, "tile": 2}, rest=0.3),
        {"id": "data_loss", "kind": "data_loss", "shape": {"data": 2, "tile": 2}},
        {"id": "data_steps", "kind": "data_steps", "shape": {"data": 2, "tile": 2}, "tree": tree},
        {"id": "trainer_g2t2", "kind": "trainer", "shape": {"gauss": 2, "tile": 2},
         "checkpoint": True, **trainer},
        {"id": "trainer_d2t2", "kind": "trainer", "shape": {"data": 2, "tile": 2}, **trainer},
        {"id": "eval_opt", "kind": "eval_opt", "shape": {"gauss": 2, "tile": 2}, **trainer},
    ])


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return _spawn(tmp_path_factory, "world8", 8,
                  [_loss("gather_g2b2t2", {"gauss": 2, "blur": 2, "tile": 2})])


# ------------------------------------------------------------ references
_SINGLE = {}


def single_device(step=STEP_MAX_SH, rest=0.0, **cfg_kw):
    """The port on one device: loss and every gradient (the probe's too)."""
    key = (step, rest, tuple(sorted(cfg_kw.items())))
    if key not in _SINGLE:
        params, cfg, cam, gt = make_setup()
        cfg = dataclasses.replace(cfg, **cfg_kw)
        g = params.gaussians
        params = params._replace(gaussians=g._replace(features_rest=g.features_rest + rest))
        _trainable(params)
        probe = torch.zeros_like(params.gaussians.means[:, :2], requires_grad=True)
        loss = single_loss(params, cfg, cam, gt, sf.active_sh_degree(cfg, step), probe)
        loss.backward()
        grads = {f"grad.{n}": t.grad.numpy() for n, t in named_leaves(params).items()
                 if t.grad is not None}
        grads["grad.probe"] = probe.grad.numpy()
        _SINGLE[key] = (loss.item(), grads)
    return _SINGLE[key]


@pytest.fixture(scope="module")
def jax_mesh():
    """The JAX package's sharded loss and gradients on the virtual CPU mesh,
    on the same inputs: (blur, tile) = (2, 2) and gather (gauss, blur, tile)
    = (2, 1, 2)."""
    import jax
    import jax.numpy as jnp
    from test_sharding import make_setup as jax_setup

    from splat_tpu.parallel import sharding as jsh

    params, cfg, cam, gt = jax_setup()
    probe = jnp.zeros_like(params.gaussians.means[:, :2])
    out = {}
    for cid, (n_gauss, n_blur, n_tile) in {"b2t2": (1, 2, 2), "gather_g2b1t2": (2, 1, 2)}.items():
        loss_fn = jsh.make_sharded_loss(cfg, jsh.make_mesh(n_blur, n_tile, n_gauss=n_gauss),
                                        with_probe=True)
        val, (g, gp) = jax.jit(jax.value_and_grad(
            lambda p, pr: loss_fn(p, cam, gt, pr, jnp.asarray(STEP_MAX_SH), jax.random.PRNGKey(0)),
            argnums=(0, 1)))(params, probe)
        grads = {f"grad.gaussians.{f}": np.asarray(getattr(g.gaussians, f))
                 for f in sf.GaussianParams._fields}
        grads["grad.background_logit"] = np.asarray(g.background_logit)
        grads["grad.probe"] = np.asarray(gp)
        out[cid] = (float(val), grads)
    return out, params


def _check_grads(got, grads):
    names = sorted(k for k in got if k.startswith("grad."))
    assert "grad.probe" in names and "grad.gaussians.means" in names
    for name in names:
        np.testing.assert_allclose(got[name], grads[name], err_msg=name, **GRAD_TOL)
    for name, g in grads.items():         # a leaf without a gradient here has none there
        if name not in got:
            assert not np.any(g), name


LOSS_CASES = [("world1", "b1t1", {}), ("world4", "b2t2", {}), ("world4", "b1t4", {}),
              ("world4", "b4t1", {}), ("world4", "gather_g2b2t1", {}),
              ("world4", "gather_g2b1t2", {}), ("world4", "gather_g4b1t1", {}),
              ("world4", "slab_g2b2t1", {"gauss_shard_mode": "slab"}),
              ("world4", "slab_g4b1t1", {"gauss_shard_mode": "slab"}),
              ("world2", "slab_g2", {"gauss_shard_mode": "slab"}),
              ("world8", "gather_g2b2t2", {})]


@pytest.mark.parametrize("world,cid,cfg_kw", LOSS_CASES, ids=[c[1] for c in LOSS_CASES])
def test_mesh_loss_matches_single_device(request, world, cid, cfg_kw):
    got = request.getfixturevalue(world)[cid]
    want, _ = single_device(**cfg_kw)
    np.testing.assert_allclose(float(got["loss"]), want, **LOSS_TOL)
    assert int(got["overflow"]) == 0


GRAD_CASES = [("world1", "b1t1", {}), ("world4", "b2t2", {}),
              ("world4", "gather_g2b1t2", {}), ("world2", "slab_g2", {"gauss_shard_mode": "slab"})]


@pytest.mark.parametrize("world,cid,cfg_kw", GRAD_CASES, ids=[c[1] for c in GRAD_CASES])
def test_mesh_grads_match_single_device(request, world, cid, cfg_kw):
    """Every leaf's gradient and the probe's: a factor of the world size in
    any exchange's backward would show here."""
    got = request.getfixturevalue(world)[cid]
    _, grads = single_device(**cfg_kw)
    _check_grads(got, grads)
    assert np.abs(got["grad.probe"]).sum() > 0


@pytest.mark.parametrize("cid", ["b2t2", "gather_g2b1t2"])
def test_mesh_matches_jax_mesh(world4, jax_mesh, cid):
    refs, _ = jax_mesh
    want, grads = refs[cid]
    got = world4[cid]
    np.testing.assert_allclose(float(got["loss"]), want, rtol=1e-5)
    _check_grads(got, grads)


def test_inputs_are_the_jax_tests_inputs(jax_mesh):
    _, jparams = jax_mesh
    params, _, _, _ = make_setup()
    for f in sf.GaussianParams._fields:
        np.testing.assert_array_equal(getattr(params.gaussians, f).numpy(),
                                      np.asarray(getattr(jparams.gaussians, f)), err_msg=f)


def test_sh_warmup_at_step_zero(world4):
    """Step 0 renders at SH degree 0 on the mesh, as on one device; with
    nonzero degree-1 coefficients degree 0 and the full degree differ."""
    want, _ = single_device(step=0)
    np.testing.assert_allclose(float(world4["sh0"]["loss"]), want, **LOSS_TOL)
    lo, hi = float(world4["sh0_rest"]["loss"]), float(world4["sh_max_rest"]["loss"])
    np.testing.assert_allclose(lo, single_device(step=0, rest=0.3)[0], **LOSS_TOL)
    np.testing.assert_allclose(hi, single_device(rest=0.3)[0], **LOSS_TOL)
    assert abs(lo - hi) > 1e-6, "the SH degree schedule had no effect"


def test_slab_overflow_counted_not_fatal(world4):
    """Buckets of slack 0.2 overflow (the 60 live Gaussians all sit in the
    first of 4 shards of the 512 slots, 15 a slab against buckets of 8): the
    rows past them are dropped and counted, and the loss still evaluates (to
    another value)."""
    got = world4["slab_g4_overflow"]
    assert int(got["overflow"]) > 0
    assert np.isfinite(float(got["loss"]))
    assert abs(float(got["loss"]) - single_device()[0]) > 1e-6


def test_data_axis_batch_is_mean_of_single_losses(world4):
    params, cfg, cam1, gt1 = make_setup(seed=0)
    _, _, _, gt2 = make_setup(seed=7)
    a = float(single_loss(params, cfg, cam1, gt1))
    b = float(single_loss(params, cfg, second_camera(cam1), gt2))
    np.testing.assert_allclose(float(world4["data_loss"]["loss"]), (a + b) / 2, rtol=2e-5,
                               atol=1e-6)


def test_data_axis_steps_match_batch_mean_reference(world4, mesh_scene):
    """3 steps of a 2-camera batch on (data 2, tile 2) against one device
    stepping on the batch's mean loss (tests/test_sharding.py:460)."""
    _, tree = mesh_scene
    scene, train_imgs, _ = _scene(tree)
    mc = trainer_model_config(warmup_length=1000, refine_every=1000)
    params = sf.init_model(scene.points_xyz, scene.points_rgb, len(scene.train_cameras),
                           len(scene.eval_cameras), mc, seed=0, device="cpu")
    opt = ttr.Optimizer(params, ttr.TrainerConfig(seed=0))
    strat = st.init_strategy_state(params.gaussians.alive.shape[0], 0, device="cpu")
    cams, imgs = _localize(scene.train_cameras), torch.as_tensor(train_imgs.images)
    losses = []
    for s in range(3):
        opt.zero_grad()
        probe = torch.zeros_like(params.gaussians.means[:, :2], requires_grad=True)
        loss = sum(single_loss(params, mc, cams[i], imgs[i], sf.active_sh_degree(mc, s), probe)
                   for i in (2 * s, 2 * s + 1)) / 2
        loss.backward()
        opt.step()
        visible = torch.linalg.norm(probe.grad, dim=-1) > 0
        strat = st.accumulate_grads(strat, probe.grad, visible, cams.width, cams.height)
        losses.append(float(loss))
    got = world4["data_steps"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5, atol=1e-6)
    for f, t in zip(sf.GaussianParams._fields, params.gaussians):
        d = np.abs(got[f"g.{f}"] - t.detach().numpy())
        assert d.max() <= 5e-3 and d.mean() <= 5e-4, (f, d.max(), d.mean())
    np.testing.assert_allclose(got["grad_accum"], strat.grad_accum.numpy(), atol=1e-3, rtol=1e-4)
    np.testing.assert_array_equal(got["grad_count"], strat.grad_count.numpy())


RESOLVE_CASES = [  # (MeshConfig fields, blur_samples, img_h)
    (dict(enabled=True), 4, 64), (dict(enabled=True), 5, 64), (dict(enabled=True), 3, 48),
    (dict(enabled=True, gauss=2, blur=1, tile=4), 5, 64), (dict(enabled=True, tile=2), 4, 64),
    (dict(enabled=True, blur=2), 4, 32), (dict(enabled=True, data=2), 10, 64),
    (dict(enabled=True, data=2, gauss=2), 0, 16)]


@pytest.mark.parametrize("mc,s,img_h", RESOLVE_CASES)
def test_resolve_mesh_matches_jax(mc, s, img_h):
    from splat_tpu.models import splatfacto as jsf
    from splat_tpu.parallel import sharding as jsh

    jmesh = jsh.resolve_mesh(jsh.MeshConfig(**mc), jsf.SplatfactoConfig(blur_samples=s,
                                                                        tile_size=8),
                             img_h, n_devices=8)
    got = sharding.resolve_mesh(tcfg.MeshConfig(**mc), model_config(blur_samples=s), img_h, 8)
    assert got == {a: int(jmesh.shape[a]) for a in sharding.AXES}


def test_init_distributed_refuses_a_silent_single_process(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_RUN_ID", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert sharding.init_distributed(device="cpu") is False   # nothing to read: one process
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="refusing to continue"):
        sharding.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def test_mesh_entry_points_take_cuda_unless_asked(monkeypatch):
    """`launch` and `init_distributed` run on the card by default, as every
    entry point of the port does: with no card they raise, never fall back
    to gloo on the CPU."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "TORCHELASTIC_RUN_ID", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.launch(run_cases, 1, args=([], "unused"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharding.init_distributed()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("slack,d", [(2.0, 4), (0.5, 2), (2.0, 1)])
def test_slab_buckets_hold_each_slabs_rows_in_order(slack, d):
    """Bucket k holds slab k's rows in their order, then zero rows; the rows
    past a bucket's capacity are dropped and counted; rows of slab d (not
    live) go nowhere."""
    gen = torch.Generator().manual_seed(3)
    rows = torch.rand((64, 18), generator=gen) + 0.5
    slab = torch.randint(0, d + 1, (64,), generator=gen)
    send, overflow = sharding.slab_buckets(rows, slab, d, slack)
    cap = send.shape[1]
    assert cap % 8 == 0 or cap == rows.shape[0]
    dropped = 0
    for k in range(d):
        mine = rows[slab == k]
        kept = mine[:cap]
        dropped += mine.shape[0] - kept.shape[0]
        assert torch.equal(send[k, :kept.shape[0]], kept)
        assert not send[k, kept.shape[0]:].any()
    assert int(overflow) == dropped
    assert (dropped > 0) == (slack < 1.0)


# ---------------------------------------------------------------- trainer
@pytest.fixture(scope="module")
def single_trainer(mesh_scene, shared_draws):
    _, tree = mesh_scene
    noise, order = shared_draws
    scene, train_imgs, eval_imgs = _scene(tree)
    t = ttr.Trainer(scene, trainer_model_config(),
                    ttr.TrainerConfig(max_steps=TRAIN_STEPS, seed=0, sync_every=100, log_every=1),
                    train_images=train_imgs, eval_images=eval_imgs, device="cpu")
    t._next_camera_index = lambda n: int(order[t.step])
    t._split_noise = lambda shape: (torch.tensor(noise[0]), torch.tensor(noise[1]))
    n0 = int(t.params.gaussians.alive.sum())
    t.run(TRAIN_STEPS)
    return t, n0


@pytest.fixture(scope="module")
def jax_mesh_trainers(mesh_scene, shared_draws):
    """The JAX sharded trainer on the same mesh shapes, camera order and
    split noise (its own refine's draws)."""
    from test_sharding import small_mesh
    from test_sharding import trainer_model_config as jax_trainer_config

    from splat_tpu.engine import trainer as jtr

    jscene, _ = mesh_scene
    _, order = shared_draws
    mc = jax_trainer_config(densify_grad_thresh=1e-6, cull_alpha_thresh=1e-3)
    out = {}
    for cid, shape in {"trainer_g2t2": dict(gauss=2, blur=1, tile=2),
                       "trainer_d2t2": dict(data=2, gauss=1, blur=1, tile=2)}.items():
        jt = jtr.Trainer(jscene, mc, jtr.TrainerConfig(max_steps=TRAIN_STEPS, seed=0,
                                                      sync_every=100),
                         mesh=small_mesh(mc, **shape))
        jt._next_camera_indices = lambda n, c, jt=jt: [int(order[jt.step * c + j])
                                                       for j in range(c)]
        jt.run(TRAIN_STEPS)
        out[cid] = (int(np.asarray(jt.params.gaussians.alive).sum()),
                    np.stack([np.asarray(jt.render_eval(i)) for i in range(len(jt.eval_cams))]))
    return out


def _min_psnr(a, b):
    return min(float(psnr(torch.as_tensor(x), torch.as_tensor(y))) for x, y in zip(a, b))


def test_mesh_trainer_matches_single_device(world4, single_trainer):
    """gauss 2 x tile 2, 15 steps across the refine at step 10."""
    t, n0 = single_trainer
    got = world4["trainer_g2t2"]
    assert list(got["refines"]) == [e["step"] for e in t.refine_events] == [10]
    n = int(t.params.gaussians.alive.sum())
    assert int(got["n_alive"]) == n != n0, "the refine changed the population alike"
    renders = torch.stack([t.render_eval(i) for i in range(len(t.eval_cams))]).numpy()
    assert _min_psnr(got["renders"], renders) > 35.0
    d = np.abs(got["means"] - t.params.gaussians.means.detach().numpy())
    assert d.mean() < 2e-3, d.mean()
    np.testing.assert_allclose(got["losses"], [r["loss"] for r in t.history], rtol=1e-3)


@pytest.mark.parametrize("cid", ["trainer_g2t2", "trainer_d2t2"])
def test_mesh_trainer_matches_jax_mesh_trainer(world4, jax_mesh_trainers, cid):
    """The same mesh shape, camera order and split noise on both packages
    (data 2 draws two cameras a step, so its reference is the JAX mesh)."""
    n_alive, renders = jax_mesh_trainers[cid]
    got = world4[cid]
    assert int(got["n_alive"]) == n_alive != int(got["n_alive_start"])
    assert _min_psnr(got["renders"], renders) > 35.0


def test_mesh_checkpoint_roundtrip_and_single_device_load(world4, mesh_scene, single_trainer):
    """A mesh checkpoint reloads bitwise (save -> load -> save) on the mesh,
    and loads into a single-device trainer, which renders what the mesh did."""
    ckpt = world4["dir"] / "ckpt_trainer_g2t2"
    assert bool(world4["trainer_g2t2"]["local_equal"])
    with np.load(ckpt / "a" / "state.npz") as a, np.load(ckpt / "b" / "state.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _, tree = mesh_scene
    scene, train_imgs, eval_imgs = _scene(tree)
    t = ttr.Trainer(scene, trainer_model_config(), ttr.TrainerConfig(max_steps=TRAIN_STEPS, seed=0),
                    train_images=train_imgs, eval_images=eval_imgs, device="cpu")
    t.load_checkpoint(ckpt / "a")
    assert t.step == TRAIN_STEPS
    renders = torch.stack([t.render_eval(i) for i in range(len(t.eval_cams))]).numpy()
    np.testing.assert_allclose(renders, world4["trainer_g2t2"]["renders"], atol=1e-5)
    t.save_checkpoint(world4["dir"] / "single")
    with np.load(ckpt / "a" / "state.npz") as a, \
            np.load(world4["dir"] / "single" / "state.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mesh_eval_opt_moves_eval_tables_not_scene(world4):
    got = world4["eval_opt"]
    assert float(got["moved"]) > 0, "the eval cameras' corrections did not move"
    assert bool(got["scene_equal"]), "the eval step moved the scene"


# -------------------------------------------------------------- the CLI
def test_cli_fit_on_a_two_rank_mesh(tmp_path):
    """`cli.fit --mesh.enabled True --device cpu` under torchrun with 2 ranks
    (tile 2 by the auto-fill) writes rank 0's metrics.json, within 0.05 dB
    of the single-process fit's PSNR."""
    from splat_tpu_torch.cli import fit as t_fit
    from splat_tpu_torch.data import synthetic

    scene = tmp_path / "scene"
    synthetic.generate_scene(scene, n_gaussians=100, n_frames=9, img_size=32, exposure=0.05,
                             rolling_shutter=0.02, n_blur_samples=3, seed=1, device="cpu")
    argv = ["--data", str(scene), "--device", "cpu", "--max-num-iterations", "20",
            "--steps-per-save", "20", "--seed", "0", "--experiment-name", "x",
            "--pipeline.model.blur-samples", "2", "--pipeline.model.tile-size", "8",
            "--pipeline.model.max-per-tile", "128", "--pipeline.model.sh-degree", "1",
            "nerfstudio-data", "--eval-mode", "interval", "--eval-interval", "4",
            "--orientation-method", "none"]
    single = t_fit.main(["splatfacto", "--output-dir", str(tmp_path / "single"), "--timestamp",
                         "t", *argv])
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "splat_tpu_torch.cli.fit", "splatfacto", "--output-dir", str(tmp_path / "mesh"),
         "--timestamp", "t", "--mesh.enabled", "True", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh: data=1 x gauss=1 x blur=1 x tile=2  (2 of 2 devices, gloo)" in proc.stdout
    run_dir = tmp_path / "mesh" / "x" / "splatfacto" / "t"
    metrics = json.loads((run_dir / "metrics.json").read_text())
    assert metrics["mesh"]["world"] == 2 and metrics["mesh"]["backend"] == "gloo"
    want = json.loads((single / "metrics.json").read_text())["results"]["psnr"]
    assert abs(metrics["results"]["psnr"] - want) <= 0.05, (metrics["results"], want)
    assert sorted(p.name for p in (run_dir / "checkpoints").iterdir()) == ["step_20"]
    assert math.isfinite(metrics["results"]["ssim"])
