"""The port's checkpoints on the CPU, case for case the JAX package's
checkpoint tests (`tests/test_trainer.py`): round trip, resume across refine
boundaries, cross-feature-set loads in both directions, a params-only
checkpoint, a smaller and a larger initial capacity; and a JAX trainer's state
carried across by `trainer_state_from_numpy`.

The scene (48 px, 80 Gaussians, 17 frames of which 3 are eval cameras) is
written by the port's generator and trained from its files.

Tolerances: everything the port writes and reads back is bitwise (the format
stores float32 arrays as they are, the generators' states byte for byte), and
a resumed run equals the uninterrupted one bitwise, leaves, Adam moments,
strategy state and generator states, because on the CPU every op of the step
is deterministic. The JAX trainer's state after 10 steps, loaded into the port:
the two packages' `evaluate()` PSNRs within 1e-3 dB (the same float32 model
rendered by two rasterizers; `tests/test_torch_trainer.py` sees 1e-4 dB).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
from test_torch_trainer import _adam_moments, _tree

from splat_tpu.cameras import optimizers as j_camopt
from splat_tpu.data import dataparser as jdp
from splat_tpu.engine import trainer as jtr
from splat_tpu.models import splatfacto as jsf
from splat_tpu_torch.cameras import optimizers as cam_opt
from splat_tpu_torch.data import dataparser, synthetic
from splat_tpu_torch.engine import trainer as tr
from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.models.convert import named_leaves, trainer_state_from_numpy

MODEL = dict(blur_samples=3, sh_degree=1, sh_degree_interval=50, tile_size=8, max_per_tile=128,
             max_tiles_per_gaussian=16, warmup_length=40, refine_every=60,
             reset_alpha_every=1000, background_color="black", gamma=2.2,
             densify_grad_thresh=0.003, cull_alpha_thresh=0.05)
PARSER = dict(eval_mode="interval", eval_interval=8, orientation_method="none",
              center_method="none", auto_scale_poses=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt_scene")
    synthetic.generate_scene(out, n_gaussians=80, n_frames=17, img_size=48, exposure=0.08,
                             n_blur_samples=5, seed=3, eval_interval=8, gamma=2.2, device="cpu")
    return out


@pytest.fixture(scope="module")
def scene(scene_dir):
    return dataparser.parse_scene(scene_dir, dataparser.DataParserConfig(**PARSER))


def _config(**kw):
    return sf.SplatfactoConfig(**{**MODEL, **kw})


def _flagship(**kw):
    return _config(camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"),
                   camera_velocity_optimizer=cam_opt.VelocityOptConfig(enabled=True),
                   optimize_eval_cameras=True, **kw)


def _trainer(scene, mc, tc):
    return tr.Trainer(scene, mc, tc, device="cpu")


def _assert_same_state(a: tr.Trainer, b: tr.Trainer):
    """Leaves, both optimizers' states, strategy state and generators, bitwise."""
    assert a.step == b.step and a._order == b._order
    assert a._last_reset_step == b._last_reset_step
    la, lb = named_leaves(a.params), named_leaves(b.params)
    assert la.keys() == lb.keys()
    for name in la:
        assert torch.equal(la[name], lb[name]), name
    pairs = [(a.optimizer.adam, b.optimizer.adam, a.optimizer.params, b.optimizer.params)]
    if a.eval_optimizer is not None:
        pairs.append((a.eval_optimizer.adam, b.eval_optimizer.adam, a.eval_optimizer.leaves,
                      b.eval_optimizer.leaves))
    for oa, ob, pa, pb in pairs:
        for x, y in zip(pa, pb):
            sa, sb = oa.state.get(x, {}), ob.state.get(y, {})
            assert sa.keys() == sb.keys()
            for key in sa:
                assert torch.equal(sa[key], sb[key]), key
    assert a.optimizer.schedule.last_epoch == b.optimizer.schedule.last_epoch
    assert [g["lr"] for g in a.optimizer.adam.param_groups] == \
        [g["lr"] for g in b.optimizer.adam.param_groups]
    assert torch.equal(a.strat_state.grad_accum, b.strat_state.grad_accum)
    assert torch.equal(a.strat_state.grad_count, b.strat_state.grad_count)
    for ga, gb in ((a._sampler, b._sampler), (a._bg_generator, b._bg_generator),
                   (a.strat_state.generator, b.strat_state.generator)):
        assert torch.equal(ga.get_state(), gb.get_state())


def test_checkpoint_roundtrip(scene, tmp_path):
    mc, tc = _config(), tr.TrainerConfig(max_steps=30, seed=0)
    t = _trainer(scene, mc, tc)
    assert t.train_images.decoder in ("native", "pil", "png") and len(t.train_images) == 14
    t.run(30)
    img_before = t.render_eval(0)
    path = t.save_checkpoint(tmp_path / "ckpt")
    assert sorted(p.name for p in path.iterdir()) == ["meta.json", "state.npz"]
    with np.load(path / "state.npz", allow_pickle=False) as npz:      # plain arrays only
        assert all(npz[k].dtype != object for k in npz.files)
        assert "gaussians.means" in npz.files and "opt_state.gaussians.means.exp_avg" in npz.files
    meta = json.loads((path / "meta.json").read_text())
    assert meta["step"] == 30 and meta["schedule_count"] == 30

    t2 = _trainer(scene, mc, tc)
    t2.load_checkpoint(path)
    assert t2.step == 30
    assert torch.equal(t2.render_eval(0), img_before)
    _assert_same_state(t, t2)


def test_checkpoint_resume_continues_trajectory_bitwise(scene, tmp_path):
    """save -> fresh trainer -> load -> run equals the uninterrupted run
    across two refines (steps 40 and 60), with every optimised group on and a
    random background, so all three generators are in use."""
    mc = _flagship(warmup_length=10, refine_every=20, densify_grad_thresh=1e-4,
                   background_color="random")
    tc = tr.TrainerConfig(max_steps=60, seed=0, eval_opt_every=3, log_every=20)
    t_ref = _trainer(scene, mc, tc)
    t_ref.run(60)
    assert [e["step"] for e in t_ref.refine_events] == [20, 40, 60]
    assert any(e["n_split"] + e["n_cloned"] > 0 for e in t_ref.refine_events[1:])

    t1 = _trainer(scene, mc, tc)
    t1.run(25)
    t1.save_checkpoint(tmp_path / "ckpt_full")
    t2 = _trainer(scene, mc, tc)
    t2.load_checkpoint(tmp_path / "ckpt_full")
    _assert_same_state(t1, t2)
    t2.run(35)
    _assert_same_state(t_ref, t2)
    assert [e["step"] for e in t2.refine_events] == [40, 60]
    assert t2.refine_events == t_ref.refine_events[1:]
    assert t2.history[-1]["loss"] == t_ref.history[-1]["loss"]


def test_checkpoint_cross_feature_set_load(scene, tmp_path, capsys):
    """A full checkpoint saved with the eval cameras optimised loads under a
    configuration without them, and the other way round: the model restores
    exactly, the groups whose structure differs keep the current state (one
    message names them), and training resumes."""
    mc_on = _config(camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"),
                    optimize_eval_cameras=True)
    tc = tr.TrainerConfig(max_steps=40, seed=0)
    t1 = _trainer(scene, mc_on, tc)
    t1.run(20)
    assert t1.eval_optimizer is not None
    t1.save_checkpoint(tmp_path / "ckpt_on")

    mc_off = dataclasses.replace(mc_on, optimize_eval_cameras=False)
    t2 = _trainer(scene, mc_off, tc)
    assert t2.eval_optimizer is None
    t2.load_checkpoint(tmp_path / "ckpt_on")
    said = capsys.readouterr().out
    assert said.count("\n") == 1 and "feature-set mismatch" in said
    assert "'eval_camera_opt'" in said and "'eval_opt_state'" in said and "'opt_state'" in said
    assert "gaussians" not in said
    assert t2.step == 20
    assert torch.equal(t2.params.gaussians.means, t1.params.gaussians.means)
    assert torch.equal(t2.params.camera_opt["phi"], t1.params.camera_opt["phi"])
    assert not t2.optimizer.adam.state, "the mismatched optimizer state is not applied"
    assert torch.equal(t2.strat_state.grad_accum, t1.strat_state.grad_accum)
    t2.run(10)
    assert t2.step == 30

    t3 = _trainer(scene, mc_off, tc)
    t3.run(10)
    t3.save_checkpoint(tmp_path / "ckpt_off")
    t4 = _trainer(scene, mc_on, tc)
    t4.load_checkpoint(tmp_path / "ckpt_off")
    assert "feature-set mismatch" in capsys.readouterr().out
    assert torch.equal(t4.params.gaussians.means, t3.params.gaussians.means)
    assert not t4.params.eval_camera_opt["phi"].any(), "the current eval corrections are kept"
    t4.run(5)
    assert t4.step == 15


def _strip_to_params_only(path):
    """Rewrite a checkpoint as one that holds the model and the step only."""
    with np.load(path / "state.npz") as npz:
        arrays = {k: npz[k] for k in npz.files
                  if k.split(".")[0] not in ("opt_state", "eval_opt_state", "strat_state",
                                             "sampling")}
    np.savez(path / "state.npz", **arrays)
    meta = json.loads((path / "meta.json").read_text())
    groups = {k: v for k, v in meta["groups"].items() if k.endswith("_opt")}
    (path / "meta.json").write_text(json.dumps({"step": meta["step"], "groups": groups}))


def test_params_only_checkpoint_rederives_the_stream(scene, tmp_path):
    """Loaded into a trainer that has already trained, a checkpoint without a
    sampling group drops the stale epoch order and takes the last opacity
    reset from the schedule (refine every 10, reset every 2 refines: 20)."""
    mc = _config(warmup_length=10, refine_every=10, reset_alpha_every=2)
    tc = tr.TrainerConfig(max_steps=60, seed=0)
    t1 = _trainer(scene, mc, tc)
    t1.run(25)
    path = t1.save_checkpoint(tmp_path / "ck_legacy")
    _strip_to_params_only(path)

    t2 = _trainer(scene, mc, tc)
    t2.run(12)          # a live sampling stream and Adam state
    assert t2._order is not None
    moments = {k: v["exp_avg"].clone() for k, v in t2.optimizer.adam.state.items()}
    t2.load_checkpoint(path)
    assert t2.step == 25 and t2._order is None
    assert t2._last_reset_step == 20
    assert torch.equal(t2.params.gaussians.means, t1.params.gaussians.means)
    for leaf, m in moments.items():      # the optimizer keeps its current state
        assert torch.equal(t2.optimizer.adam.state[leaf]["exp_avg"], m)
    t2.run(3)
    assert t2.step == 28
    t3 = _trainer(scene, _config(), tc)     # no resets on this schedule
    t3.load_checkpoint(path)
    assert t3._last_reset_step == -(10**9)


@pytest.mark.parametrize("initial_capacity", [0, 2048], ids=["smaller", "larger"])
def test_load_adapts_to_the_stored_capacity(scene, tmp_path, initial_capacity):
    tc = tr.TrainerConfig(max_steps=20, seed=0)
    t1 = _trainer(scene, _config(initial_capacity=1024), tc)
    t1.run(6)
    path = t1.save_checkpoint(tmp_path / "ckpt")
    t2 = _trainer(scene, _config(initial_capacity=initial_capacity), tc)
    assert t2.params.gaussians.alive.shape[0] == (initial_capacity or 512)
    t2.load_checkpoint(path)
    assert t2.params.gaussians.alive.shape[0] == 1024
    assert t2.strat_state.grad_accum.shape[0] == 1024
    _assert_same_state(t1, t2)
    t1.run(4)
    t2.run(4)
    _assert_same_state(t1, t2)


def test_load_refuses_a_model_of_another_shape(scene, tmp_path):
    tc = tr.TrainerConfig(max_steps=20, seed=0)
    path = _trainer(scene, _config(sh_degree=1), tc).save_checkpoint(tmp_path / "ckpt")
    with pytest.raises(ValueError, match="features_rest"):
        _trainer(scene, _config(sh_degree=2), tc).load_checkpoint(path)


def test_trainer_state_from_a_jax_trainer(scene_dir, scene):
    """A model trained 10 steps by the JAX package, its checkpoint's state
    dict handed over as numpy arrays, evaluated and continued by the port."""
    jscene = jdp.parse_scene(scene_dir, jdp.DataParserConfig(**PARSER))
    opts = dict(optimize_eval_cameras=True)
    jmc = jsf.SplatfactoConfig(**MODEL, chunk=16, **opts,
                               camera_optimizer=j_camopt.CameraOptConfig(mode="SO3xR3"))
    jt = jtr.Trainer(jscene, jmc, jtr.TrainerConfig(max_steps=40, seed=0, eval_opt_every=3))
    jt.run(10)
    mu, nu, count = _adam_moments(jt.opt_state, jt.params)
    emu, enu = {}, {}
    for group, key in (("eval_camera_opt", "cam"), ("eval_velocity_opt", "vel")):
        for k in getattr(jt.params, group):
            emu[f"{group}.{k}"] = np.asarray(jt.eval_opt_state[0].mu[key][k])
            enu[f"{group}.{k}"] = np.asarray(jt.eval_opt_state[0].nu[key][k])
    tree = _tree(jt.params)
    tree.update(
        step=np.asarray(jt.step), opt_state={"mu": mu, "nu": nu, "count": count},
        eval_opt_state={"mu": emu, "nu": enu, "count": int(jt.eval_opt_state[0].count)},
        strat_state={"grad_accum": np.asarray(jt.strat_state.grad_accum),
                     "grad_count": np.asarray(jt.strat_state.grad_count)},
        sampling={k: np.asarray(v) for k, v in jt._sampling_state().items() if k != "key"})

    mc = _config(**opts, camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"))
    t = _trainer(scene, mc, tr.TrainerConfig(max_steps=40, seed=0, eval_opt_every=3))
    trainer_state_from_numpy(t, tree)
    assert t.step == 10 and count == 10
    np.testing.assert_array_equal(t.params.gaussians.means.detach().numpy(),
                                  np.asarray(jt.params.gaussians.means))
    state = t.optimizer.adam.state[t.params.gaussians.means]
    np.testing.assert_array_equal(state["exp_avg"].numpy(), mu["gaussians.means"])
    assert float(state["step"]) == 10 and t.optimizer.schedule.last_epoch == 10
    assert t.eval_optimizer.adam.state[t.params.eval_camera_opt["phi"]]["exp_avg"].abs().sum() > 0
    assert int(t.strat_state.grad_count.max()) == int(np.asarray(jt.strat_state.grad_count).max())
    assert t._order == [int(i) for i in np.asarray(jt._order)]
    want, got = jt.evaluate(), t.evaluate()
    assert abs(got["psnr"] - want["psnr"]) < 1e-3, (got, want)
    t.run(5)
    assert t.step == 15 and np.isfinite(t.evaluate()["psnr"])
