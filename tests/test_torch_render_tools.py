"""The port's render tools against the JAX package's on the CPU.

- `render_model.colorize_depth` bitwise equal to the JAX function (which
  reads matplotlib's turbo), on random depth and alpha with NaN and inf;
  `depth_to_normals` within atol 1e-6;
- `cameras/paths.py` against `splat_tpu/cameras/paths.py` at 50 path
  parameters, and `build_path_json` for the original trajectory and the
  orbit: poses and linear velocities within atol 1e-5; angular velocities
  within two float32 ulps of the difference rotation times the finite
  difference's scale, time_scale / (2 du) (both packages take the SO(3) log
  of a rotation 2 du from identity in float32, whose arccos resolves it to
  about one ulp: 1.5e-4 rad/s at time_scale 2.5, measured 1.3e-4);
- `export.export_ply`: bytes identical to the JAX function's;
- the slice as a whole: a JAX `Trainer` trained 10 steps on a fixture scene,
  carried into the port's trainer (`models.convert.trainer_state_from_numpy`);
  on the same cameras `render_model`'s PNGs, a `render_video` frame with
  simulated blur and rolling shutter, and the viewer's render with and
  without a crop box are within one 8-bit level of the JAX renders, and the
  depth maps within rtol 1e-4 (where alpha > 0.05); a novel-view camera with
  cam_idx 0 renders the same whatever train camera 0's correction is;
- the viewer's HTTP routes (`/`, `/render` with exposure, rolling shutter and
  a crop box, `/export.ply` full and cropped), and `fit --vis viewer`: the
  training loop publishes its snapshots to the viewer it serves, which
  answers mid-run and closes with the run;
- the kernel wrappers' launch counters lose no launch to concurrent host
  threads (16 threads, a 1 us switch interval).
"""
import argparse
import importlib.util
import json
import sys
import types
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_tpu.cameras import optimizers as j_camopt
from splat_tpu.cameras import paths as jpaths
from splat_tpu.cameras.cameras import Cameras as JCameras
from splat_tpu.data import dataparser as jdp
from splat_tpu.engine import trainer as jtr
from splat_tpu.models import splatfacto as jsf
from splat_tpu_torch.cameras import optimizers as cam_opt
from splat_tpu_torch.cameras import paths as tpaths
from splat_tpu_torch.cli import export as t_export
from splat_tpu_torch.cli import fit as t_fit
from splat_tpu_torch.cli import render_model as t_render_model
from splat_tpu_torch.cli import render_video as t_render_video
from splat_tpu_torch.cli import viewer as t_viewer
from splat_tpu_torch.data import dataparser, synthetic
from splat_tpu_torch.data.png import decode_png, read_png
from splat_tpu_torch.engine import trainer as tr
from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.models.convert import trainer_state_from_numpy

ROOT = Path(__file__).resolve().parents[1]
MODEL = dict(blur_samples=3, sh_degree=1, sh_degree_interval=50, tile_size=8, max_per_tile=128,
             max_tiles_per_gaussian=16, warmup_length=40, refine_every=60,
             reset_alpha_every=1000, background_color="black", gamma=2.2,
             rolling_shutter_compensation=True, optimize_eval_cameras=True)
PARSER = dict(eval_mode="interval", eval_interval=8, orientation_method="none",
              center_method="none", auto_scale_poses=False)
RES = 40
LEVEL = 1        # one 8-bit level


def _script(name):
    """Import cli/<name>.py of the JAX package (scripts, not a package)."""
    sys.path.insert(0, str(ROOT / "cli"))
    spec = importlib.util.spec_from_file_location(f"jax_cli_{name}", ROOT / "cli" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- numpy tools
def test_colorize_depth_is_bitwise_the_jax_function():
    j_rm = _script("render_model")
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 9.0, size=(48, 40)).astype(np.float32)
    alpha = rng.uniform(0.0, 1.0, size=(48, 40)).astype(np.float32)
    depth[3, :7] = np.nan
    depth[5, 2:5] = np.inf
    depth[6, 0] = -np.inf
    alpha[7, :] = 0.05                      # the threshold itself is invalid
    for a in (alpha, None):
        want, got = j_rm.colorize_depth(depth, a), t_render_model.colorize_depth(depth, a)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    # no valid pixel: black
    np.testing.assert_array_equal(t_render_model.colorize_depth(depth, np.zeros_like(alpha)),
                                  j_rm.colorize_depth(depth, np.zeros_like(alpha)))
    # float64 input, a constant map, NaN everywhere but one pixel
    d64 = rng.uniform(1, 2, size=(9, 11))
    np.testing.assert_array_equal(t_render_model.colorize_depth(d64), j_rm.colorize_depth(d64))
    flat = np.full((5, 6), 3.0, np.float32)
    np.testing.assert_array_equal(t_render_model.colorize_depth(flat), j_rm.colorize_depth(flat))
    lone = np.full((4, 4), np.nan, np.float32)
    lone[1, 2] = 2.0
    np.testing.assert_array_equal(t_render_model.colorize_depth(lone), j_rm.colorize_depth(lone))


def test_depth_to_normals_matches_jax():
    j_rm = _script("render_model")
    rng = np.random.default_rng(1)
    depth = (3.0 + rng.normal(size=(24, 32)) * 0.1).astype(np.float32)
    want = j_rm.depth_to_normals(depth, 30.0, 31.0, 16.0, 12.0)
    got = t_render_model.depth_to_normals(depth, 30.0, 31.0, 16.0, 12.0)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _key_poses(n=7, seed=2):
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        pos = np.array([np.cos(0.4 * i) * 3, np.sin(0.4 * i) * 3, 1.0]) + rng.normal(size=3) * 0.05
        poses.append(jpaths.look_at(pos, np.zeros(3)))
    return np.stack(poses)


def _w_tol(time_scale: float, du: float = 1e-3) -> float:
    """Two float32 ulps of the difference rotation, in rad/s."""
    return 2 * 2.0 ** -23 * time_scale / (2 * du)


def test_pose_spline_and_velocities_match_jax():
    keys = _key_poses()
    js, ts = jpaths.PoseSpline(keys), tpaths.PoseSpline(keys)
    us = np.linspace(0, len(keys) - 1, 50)
    np.testing.assert_allclose(ts(us), js(us), atol=1e-5)
    for u in us:
        jv, jw = jpaths.path_velocities_gl(js, float(u), time_scale=2.5)
        tv, tw = tpaths.path_velocities_gl(ts, float(u), time_scale=2.5)
        np.testing.assert_allclose(tv, jv, atol=1e-5)
        np.testing.assert_allclose(tw, np.asarray(jw), atol=_w_tol(2.5))
    np.testing.assert_array_equal(tpaths.look_at(np.array([1.0, 2.0, 3.0]), np.zeros(3)),
                                  jpaths.look_at(np.array([1.0, 2.0, 3.0]), np.zeros(3)))


@pytest.mark.parametrize("original", [True, False], ids=["original", "orbit"])
def test_build_path_json_matches_jax(original, scene_dir):
    j_rv = _script("render_video")
    meta = json.loads((scene_dir / "transforms.json").read_text())
    tf = {"transform": [[1.0, 0, 0, 0.1], [0, 1.0, 0, -0.2], [0, 0, 1.0, 0.3]], "scale": 0.8}
    args = argparse.Namespace(original_trajectory=original, zoom=1.5, playback_speed=1.0,
                              blur_scale=1.0, fps=8, seconds=1.0, fov=60.0, width=0, height=0)
    want = j_rv.build_path_json(args, meta, tf)
    got = t_render_video.build_path_json(args, meta, tf)
    frames_w, frames_g = want.pop("camera_path"), got.pop("camera_path")
    assert got == want and len(frames_g) == len(frames_w) == 8
    n_key = len(meta["frames"]) if original else 13
    w_tol = _w_tol((n_key - 1) / args.seconds * args.playback_speed)
    for fw, fg in zip(frames_w, frames_g):
        assert fg.keys() == fw.keys()
        for k in fw:
            tol = w_tol if k == "camera_angular_velocity" else 1e-5
            np.testing.assert_allclose(fg[k], fw[k], atol=tol, err_msg=k)


def test_export_ply_bytes_equal_jax(tmp_path):
    j_ex = _script("export")
    rng = np.random.default_rng(3)
    n, b = 37, 3
    arrays = (rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32),
              rng.normal(size=(n, 4)).astype(np.float32), rng.normal(size=(n,)).astype(np.float32),
              rng.normal(size=(n, 3)).astype(np.float32),
              rng.normal(size=(n, b, 3)).astype(np.float32))
    j_ex.export_ply(tmp_path / "j.ply", *arrays)
    t_export.export_ply(tmp_path / "t.ply", *arrays)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


# --------------------------------------------------- the slice as a whole
@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("tools_scene")
    synthetic.generate_scene(out, n_gaussians=120, n_frames=17, img_size=RES, exposure=0.08,
                             rolling_shutter=0.03, n_blur_samples=3, seed=5, eval_interval=8,
                             gamma=2.2, trajectory="shake", device="cpu")
    return out


def _tree(jparams):
    tree = {k: ({kk: np.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else np.asarray(v))
            for k, v in jparams._asdict().items() if k != "gaussians"}
    tree["gaussians"] = {k: np.asarray(v) for k, v in jparams.gaussians._asdict().items()}
    return tree


@pytest.fixture(scope="module")
def trainers(scene_dir):
    """(JAX trainer after 10 steps, the port's trainer in the same state,
    JAX model config, the port's model config)."""
    jscene = jdp.parse_scene(scene_dir, jdp.DataParserConfig(**PARSER))
    jmc = jsf.SplatfactoConfig(**MODEL, chunk=16,
                               camera_optimizer=j_camopt.CameraOptConfig(mode="SO3xR3"),
                               camera_velocity_optimizer=j_camopt.VelocityOptConfig(enabled=True))
    jt = jtr.Trainer(jscene, jmc, jtr.TrainerConfig(max_steps=40, seed=0, eval_opt_every=3))
    jt.run(10)
    mc = sf.SplatfactoConfig(**MODEL, camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"),
                             camera_velocity_optimizer=cam_opt.VelocityOptConfig(enabled=True))
    scene = dataparser.parse_scene(scene_dir, dataparser.DataParserConfig(**PARSER))
    t = tr.Trainer(scene, mc, tr.TrainerConfig(max_steps=40, seed=0), device="cpu")
    tree = _tree(jt.params)
    tree["step"] = np.asarray(jt.step)
    trainer_state_from_numpy(t, tree)
    assert t.step == 10
    # the corrections are live: train camera 0's pose correction is not zero
    assert float(t.params.camera_opt["phi"][0].abs().sum()) > 0
    return jt, t, jmc, mc


def _levels(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def test_render_model_matches_jax(trainers, tmp_path):
    jt, t, jmc, mc = trainers
    n = t_render_model.render_split(t, mc, tmp_path, "eval", depth=True, normals=True)
    assert n == len(jt.eval_cams) == 3
    sh = int(jsf.active_sh_degree(jmc, jt.step))
    for i in range(n):
        out = jsf.render_camera(jt.params, jt.eval_cams[i], jmc, sh,
                                jsf.background_color(jt.params, jmc), is_eval_camera=True)
        want = (np.clip(np.asarray(jsf.gamma_encode(out.rgb, jmc)), 0, 1) * 255).astype(np.uint8)
        got = read_png(tmp_path / f"{i:05d}_pred.png")
        assert want.std() > 1 and _levels(got, want) <= LEVEL, i
        gt = read_png(tmp_path / f"{i:05d}_gt.png")
        np.testing.assert_array_equal(gt, (jt.eval_images.images[i] * 255).astype(np.uint8))
        depth = np.load(tmp_path / f"{i:05d}_depth.npy")
        seen = np.asarray(out.alpha) > 0.05
        assert seen.mean() > 0.2
        np.testing.assert_allclose(depth[seen], np.asarray(out.depth)[seen], rtol=1e-4)
        assert read_png(tmp_path / f"{i:05d}_depth.png").shape == (RES, RES, 3)
        assert read_png(tmp_path / f"{i:05d}_normal.png").shape == (RES, RES, 3)


def _path_json(scene_dir, blur_scale=1.0):
    meta = json.loads((scene_dir / "transforms.json").read_text())
    tf = {"transform": [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]], "scale": 1.0}
    args = argparse.Namespace(original_trajectory=True, zoom=1.5, playback_speed=1.0,
                              blur_scale=blur_scale, fps=4, seconds=1.0, fov=60.0, width=0,
                              height=0)
    return t_render_video.build_path_json(args, meta, tf)


def _jax_path_frame(jt, jmc, path_json, frame, fov=60.0):
    """A path frame rendered as the JAX package's render_video does."""
    mcfg = jsf.SplatfactoConfig(**{
        **{f: getattr(jmc, f) for f in jmc.__dataclass_fields__},
        "blur_samples": max(jmc.blur_samples, 5) if path_json["exposure_time"] > 0 else 0,
        "rolling_shutter_compensation": True})
    w, h = path_json["render_width"], path_json["render_height"]
    fl = 0.5 * h / np.tan(0.5 * np.radians(fov))
    c2w = jnp.asarray(np.array(frame["camera_to_world"]).reshape(4, 4)[None], jnp.float32)
    R_cv, p = JCameras.gl_to_cv_c2w(c2w)
    cam = JCameras(
        R_cv, p, fx=jnp.full((1,), fl), fy=jnp.full((1,), fl), cx=jnp.full((1,), w / 2.0),
        cy=jnp.full((1,), h / 2.0), width=w, height=h,
        lin_vel=JCameras.vel_gl_to_cv(jnp.asarray([frame["camera_linear_velocity"]], jnp.float32)),
        ang_vel=JCameras.vel_gl_to_cv(jnp.asarray([frame["camera_angular_velocity"]],
                                                  jnp.float32)),
        exposure_time=jnp.full((1,), path_json["exposure_time"]),
        rolling_shutter_time=jnp.full((1,), path_json["rolling_shutter_time"]),
        cam_idx=jnp.zeros((1,), jnp.int32))
    params = jt.params._replace(camera_opt={}, velocity_opt={})
    out = jsf.render_camera(params, cam, mcfg, int(jsf.active_sh_degree(mcfg, jt.step)),
                            jsf.background_color(jt.params, mcfg))
    return (np.clip(np.asarray(jsf.gamma_encode(out.rgb, mcfg)), 0, 1) * 255).astype(np.uint8)


def test_render_video_frame_matches_jax(trainers, scene_dir):
    jt, t, jmc, mc = trainers
    pj = _path_json(scene_dir)
    assert pj["exposure_time"] > 0 and pj["rolling_shutter_time"] > 0
    mcfg = t_render_video.path_config(mc, pj)
    assert mcfg.blur_samples == 5 and mcfg.rolling_shutter_compensation
    sh = int(sf.active_sh_degree(mcfg, t.step))
    frame = pj["camera_path"][1]
    cam = t_render_video.path_camera(frame, pj, 60.0, t.device)
    got = t_render_model.to_uint8(t_render_video.render_frame(t.params, cam, mcfg, sh))
    want = _jax_path_frame(jt, jmc, pj, frame)
    assert want.std() > 1 and _levels(got, want) <= LEVEL
    # the exposure shows: the same frame without it renders otherwise
    sharp = _path_json(scene_dir, blur_scale=0.0)
    s_cfg = t_render_video.path_config(mc, sharp)
    s_cam = t_render_video.path_camera(sharp["camera_path"][1], sharp, 60.0, t.device)
    assert s_cfg.blur_samples == 0
    assert _levels(t_render_model.to_uint8(t_render_video.render_frame(t.params, s_cam, s_cfg, sh)),
                   got) > 2


def test_novel_views_ignore_train_camera_zero(trainers, scene_dir):
    """A path camera has cam_idx 0; train camera 0's correction must not move it."""
    _, t, _, mc = trainers
    pj = _path_json(scene_dir)
    mcfg = t_render_video.path_config(mc, pj)
    cam = t_render_video.path_camera(pj["camera_path"][2], pj, 60.0, t.device)
    sh = int(sf.active_sh_degree(mcfg, t.step))
    base = t_render_video.render_frame(t.params, cam, mcfg, sh)
    bent = t.params._replace(
        camera_opt={k: v + 0.05 for k, v in t.params.camera_opt.items()},
        velocity_opt={k: v + 0.5 for k, v in t.params.velocity_opt.items()})
    np.testing.assert_array_equal(t_render_video.render_frame(bent, cam, mcfg, sh), base)
    # while a render through the corrections does move
    moved = sf.render_camera(bent, cam, mcfg, sh, sf.background_color(bent, mcfg))
    assert float((sf.gamma_encode(moved.rgb, mcfg) - torch.as_tensor(base)).abs().max()) > 0.01


@pytest.mark.parametrize("crop", [None, (0.2, 0.8, 0.0, 1.0, 0.1, 0.9)], ids=["whole", "crop"])
def test_viewer_render_matches_jax(trainers, crop):
    jt, t, jmc, mc = trainers
    j_viewer = _script("viewer")
    jv = j_viewer.ViewerState.from_trainer(types.SimpleNamespace(model=jmc), jt, res=32)
    tv = t_viewer.ViewerState.from_trainer(types.SimpleNamespace(model=mc), t, res=32)
    np.testing.assert_allclose(tv.center, jv.center, atol=1e-6)
    for exp, rs in ((0.0, 0.0), (0.05, 0.02)):
        want = decode_png(jv.render(0.4, 0.3, 3.0, exp, rs, crop=crop))
        got = decode_png(tv.render(0.4, 0.3, 3.0, exp, rs, crop=crop))
        assert got.shape == (32, 32, 3) and want.std() > 1
        assert _levels(got, want) <= LEVEL, (exp, rs)


def test_viewer_routes(trainers):
    _, t, _, mc = trainers
    state = t_viewer.ViewerState.from_trainer(types.SimpleNamespace(model=mc), t, res=24)
    server = t_viewer.serve(state, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert b"<html" in urllib.request.urlopen(f"{url}/", timeout=60).read().lower()
        png = urllib.request.urlopen(f"{url}/render?yaw=0.3&pitch=0.2&r=3&exp=0.05&rs=0.01",
                                     timeout=120).read()
        assert png[:4] == b"\x89PNG" and decode_png(png).shape == (24, 24, 3)
        png_c = urllib.request.urlopen(f"{url}/render?yaw=0.3&pitch=0.2&r=3"
                                       "&cx0=0.2&cx1=0.8&cy0=0&cy1=1&cz0=0&cz1=1",
                                       timeout=120).read()
        assert decode_png(png_c).shape == (24, 24, 3)
        ply = urllib.request.urlopen(f"{url}/export.ply", timeout=60).read()
        assert ply.startswith(b"ply\nformat binary_little_endian")
        ply_c = urllib.request.urlopen(f"{url}/export.ply?cx0=0.45&cx1=0.55&cy0=0.45&cy1=0.55"
                                       "&cz0=0.45&cz1=0.55", timeout=60).read()

        def n_verts(b):
            return int(b.split(b"element vertex ")[1].split(b"\n")[0])

        assert n_verts(ply) == int(t.params.gaussians.alive.sum())
        assert n_verts(ply_c) < n_verts(ply)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{url}/nothing", timeout=60)
    finally:
        server.shutdown()
        server.server_close()


def test_fit_serves_the_live_viewer(scene_dir, tmp_path, monkeypatch):
    """`fit --vis viewer` serves the viewer while it trains, publishes a
    snapshot at every logged window and chunk end (once per step), and closes
    it at the end."""
    servers, published, pngs = [], [], []
    serve, publish = t_viewer.serve, t_viewer.ViewerState.publish

    def serve_here(state, host="0.0.0.0", port=7007, block=False):
        servers.append(serve(state, "127.0.0.1", 0, block))
        return servers[-1]

    def publish_and_look(self, trainer):
        before = getattr(self, "_snapshot", None)
        publish(self, trainer)
        if self.snapshot() is not before:       # a copy made
            published.append(trainer.step)
        if trainer.step == 4:       # mid-run: a request served from the other thread
            url = f"http://127.0.0.1:{servers[0].server_address[1]}/render?exp=0.05&rs=0.02"
            pngs.append(urllib.request.urlopen(url, timeout=120).read())

    monkeypatch.setattr(t_viewer, "serve", serve_here)
    monkeypatch.setattr(t_viewer.ViewerState, "publish", publish_and_look)
    run_dir = t_fit.main([
        "splatfacto", "--data", str(scene_dir), "--output-dir", str(tmp_path),
        "--experiment-name", "live", "--device", "cpu", "--vis", "viewer",
        "--max-num-iterations", "12", "--steps-per-save", "6", "--trainer.log-every", "4",
        "--pipeline.model.blur-samples", "2", "--pipeline.model.tile-size", "8",
        "--pipeline.model.sh-degree", "1", "nerfstudio-data", "--orientation-method", "none"])
    assert published == [0, 4, 6, 8, 12]        # each step copied once
    assert (run_dir / "metrics.json").exists()
    img = decode_png(pngs[0])
    assert img.shape == (256, 256, 3) and img.std() > 0
    with pytest.raises(urllib.error.URLError):      # closed with the run
        urllib.request.urlopen(f"http://127.0.0.1:{servers[0].server_address[1]}/", timeout=5)


def test_launch_counts_survive_threads():
    """The kernel wrappers' counters take launches from several host threads
    (the live viewer renders beside training) without losing one."""
    import threading

    from splat_tpu_torch.ops.cuda import build

    def wrapper():
        pass

    wrapper.launches = 0
    n_threads, per_thread = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [build.count_launch(wrapper)
                                                    for _ in range(per_thread)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per_thread
