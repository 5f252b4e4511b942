"""The port's real-capture input tools against the JAX package's, on the CPU.

Each test writes the same seeded fixtures to `tmp_path` (in the layouts
`tests/test_pipelines.py` writes), runs the JAX module (`cli/*.py`,
`splat_tpu/data/*.py`) and the port's counterpart on them, and compares:
- COLMAP text model -> transforms.json: the JSON bytes and `sparse_pc.ply`
  bytes equal, for every camera model the parser takes;
- `run_colmap`: the backend dispatch, the messages without a binary, the
  dry-run plan, and the export after `model_converter` (faked) equal;
- `combine` (first pass in its three intrinsics modes, rolling-shutter
  override, missing frames, second pass), the blur-score split and the
  synthetic converter: equal JSON, poses within 1e-12, equal pixels;
- the converter's LCG: the same sequence;
- triangulation and reprojection: within 1e-10;
- `process_sai_inputs` / `process_sai_custom`: the same command plan, the
  same exposure from `data.jsonl`, the same output from a stand-in
  `sai-cli` (a patched `subprocess.check_call`), a zip recording, the same
  `SystemExit` without it;
- `process_deblur_nerf_inputs`: the three passes with SfM faked the same way
  in both packages, the pose transfer and the deblurring split equal.
Then the capture pipeline end to end on the port: a generated scene's COLMAP
text model and VIO directory (`scripts_dev/synthetic_capture_torch.py`) through
`run_colmap --text-model`, `combine`, the split and 10 steps of `cli.fit`.
"""
import argparse
import importlib.util
import json
import shutil
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from splat_tpu.data import colmap_io as j_colmap
from splat_tpu.data import seedpoints as j_seed
from splat_tpu_torch.cli import combine as t_combine
from splat_tpu_torch.cli import process_deblur_nerf_inputs as t_pdn
from splat_tpu_torch.cli import process_sai_custom as t_psc
from splat_tpu_torch.cli import process_sai_inputs as t_psi
from splat_tpu_torch.cli import process_synthetic_inputs as t_syn
from splat_tpu_torch.cli import run_colmap as t_rc
from splat_tpu_torch.cli import train_eval_split_by_blur_score as t_split
from splat_tpu_torch.data import colmap_io as t_colmap
from splat_tpu_torch.data import seedpoints as t_seed

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "cli"))

import combine as j_combine  # noqa: E402
import process_deblur_nerf_inputs as j_pdn  # noqa: E402
import process_sai_custom as j_psc  # noqa: E402
import process_sai_inputs as j_psi  # noqa: E402
import process_synthetic_inputs as j_syn  # noqa: E402
import run_colmap as j_rc  # noqa: E402
import train_eval_split_by_blur_score as j_split  # noqa: E402
from test_pipelines import make_raw_scene  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here, and
    the suite's xdist workers would each start a full intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, atol=1e-12, path="$"):
    """Equal JSON trees, floats within atol."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], atol, f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, atol, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= atol, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _json(path):
    return json.loads(Path(path).read_text())


def _png(path, n=4, seed=0):
    from splat_tpu_torch.data.png import write_png

    write_png(path, np.random.default_rng(seed).integers(0, 255, (n, n, 3)).astype(np.uint8))


# ------------------------------------------------------------ COLMAP text model
CAMERA_LINES = {
    "PINHOLE": "1 PINHOLE 64 48 60.0 61.0 32.0 24.0",
    "SIMPLE_PINHOLE": "1 SIMPLE_PINHOLE 64 48 60.5 32.0 24.0",
    "SIMPLE_RADIAL": "1 SIMPLE_RADIAL 64 48 60.5 32.0 24.0 0.0125",
    "RADIAL": "1 RADIAL 64 48 60.5 32.0 24.0 0.0125 -0.003",
    "OPENCV": "1 OPENCV 64 48 60.0 61.0 32.0 24.0 0.0125 -0.003 0.0011 -0.0007",
}


def write_text_model(text: Path, camera_line: str, n_images=7, n_points=50, seed=0):
    """A COLMAP TXT model: random poses, names out of order, 2D-point lines
    that are numbers or empty, and a point cloud."""
    rng = np.random.default_rng(seed)
    text.mkdir(parents=True, exist_ok=True)
    (text / "cameras.txt").write_text(f"# Camera list\n# comment\n{camera_line}\n")
    lines = ["# Image list with two lines of data per image:"]
    for i in rng.permutation(n_images):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3) * 2
        lines.append(f"{i + 1} " + " ".join(repr(float(v)) for v in (*q, *t))
                     + f" 1 frame_{i:05d}.png")
        lines.append("" if i % 2 else " ".join(f"{v:.3f}" for v in rng.uniform(0, 48, 6)))
    (text / "images.txt").write_text("\n".join(lines) + "\n")
    pts = rng.normal(size=(n_points, 3))
    cols = rng.integers(0, 256, (n_points, 3))
    (text / "points3D.txt").write_text("# 3D point list\n" + "\n".join(
        f"{i + 1} {x!r} {y!r} {z!r} {r} {g} {b} 0.5 1 2"
        for i, ((x, y, z), (r, g, b)) in enumerate(zip(pts.tolist(), cols.tolist()))) + "\n")


@pytest.mark.parametrize("model", sorted(CAMERA_LINES))
def test_colmap_text_to_transforms_matches_jax(tmp_path, model):
    write_text_model(tmp_path / "text", CAMERA_LINES[model])
    jmeta = j_colmap.colmap_text_to_transforms(tmp_path / "text", tmp_path / "j")
    tmeta = t_colmap.colmap_text_to_transforms(tmp_path / "text", tmp_path / "t")
    assert tmeta == jmeta and len(tmeta["frames"]) == 7
    for name in ("transforms.json", "sparse_pc.ply"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_colmap_parsers_refuse_as_jax(tmp_path):
    cams = tmp_path / "cameras.txt"
    cams.write_text("1 FISHEYE 64 48 60 32 24 0.1\n")
    for mod in (j_colmap, t_colmap):
        with pytest.raises(ValueError, match="unsupported COLMAP camera model FISHEYE"):
            mod.parse_cameras_txt(cams)
    cams.write_text("# only comments\n\n")
    for mod in (j_colmap, t_colmap):
        with pytest.raises(ValueError, match="no camera found"):
            mod.parse_cameras_txt(cams)
    imgs = tmp_path / "images.txt"
    imgs.write_text("1 2 3\n1.0 2.0 -1 3.0 4.0 -1 5 6 7 8\n")
    assert t_colmap.parse_images_txt(imgs) == j_colmap.parse_images_txt(imgs) == []
    pts = tmp_path / "points3D.txt"
    pts.write_text("# none\n")
    for a, b in zip(t_colmap.parse_points3d_txt(pts), j_colmap.parse_points3d_txt(pts)):
        assert a.dtype == b.dtype and a.shape == b.shape == (0,)


# --------------------------------------------------------------------- run_colmap
def _no_binaries(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)


def test_run_colmap_without_binary_raises_as_jax(tmp_path, monkeypatch):
    _no_binaries(monkeypatch)
    messages = []
    for mod in (j_rc, t_rc):
        assert mod.colmap_available() is False
        with pytest.raises(SystemExit) as e:
            mod.process(tmp_path / "rec", tmp_path / "out", 2, False)
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "colmap binary not found" in messages[0]


def test_run_sfm_once_dispatches_as_jax(tmp_path, monkeypatch):
    messages = []
    for mod in (j_rc, t_rc):
        monkeypatch.setattr(mod, "hloc_available", lambda: False)
        with pytest.raises(SystemExit) as e:
            mod.run_sfm_once(tmp_path, tmp_path, backend="hloc")
        messages.append(str(e.value))
        called = {}
        monkeypatch.setattr(mod, "run_colmap_once",
                            lambda img, work: called.setdefault("colmap", (img, work)) and True)
        assert mod.run_sfm_once(tmp_path / "a", tmp_path / "b", backend="colmap") is True
        assert called["colmap"] == (tmp_path / "a", tmp_path / "b")
    assert messages[0] == messages[1] and "hloc is not installed" in messages[0]
    assert t_rc.hloc_available() == j_rc.hloc_available()


def test_run_colmap_dry_run_prints_the_jax_plan(tmp_path, capsys):
    prefix = tmp_path / "proc"
    for rec in ("rec_b", "rec_a"):
        (prefix / "sai-cli" / rec).mkdir(parents=True)
    plans = []
    for mod in (j_rc, t_rc):
        mod.main(["all", "--processed-prefix", str(prefix), "--dry_run"])
        mod.main(["--processed-prefix", str(prefix), "--case_number", "2", "--dry_run",
                  "--sfm-backend", "hloc"])
        mod.main(["--processed-prefix", str(prefix)])      # lists the cases
        plans.append(capsys.readouterr().out)
    assert plans[0] == plans[1]
    assert f"colmap: {prefix}/sai-cli/rec_a/images -> {prefix}/colmap-sai-cli-imgs/rec_a" \
        in plans[1]


def _fake_model_converter(text_model: Path):
    """subprocess.run standing in for `colmap model_converter`: copies a text
    model to --output_path."""
    def run(cmd, **kw):
        assert cmd[:2] == ["colmap", "model_converter"]
        shutil.copytree(text_model, cmd[cmd.index("--output_path") + 1], dirs_exist_ok=True)
        return argparse.Namespace(returncode=0, stderr="", stdout="")
    return run


def test_export_transforms_matches_jax(tmp_path, monkeypatch):
    write_text_model(tmp_path / "text", CAMERA_LINES["OPENCV"], seed=3)
    for mod, out in ((j_rc, "j"), (t_rc, "t")):
        monkeypatch.setattr(mod.subprocess, "run", _fake_model_converter(tmp_path / "text"))
        work = tmp_path / f"work_{out}"
        (work / "sparse" / "0").mkdir(parents=True)
        mod.export_transforms(work, tmp_path / out)
    for name in ("transforms.json", "sparse_pc.ply"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_run_colmap_exports_a_text_model(tmp_path):
    write_text_model(tmp_path / "text", CAMERA_LINES["PINHOLE"], seed=4)
    rec = tmp_path / "proc" / "sai-cli" / "rec0"
    (rec / "images").mkdir(parents=True)
    _png(rec / "images" / "frame_00000.png")
    outs = t_rc.main([str(rec), "--text-model", str(tmp_path / "text"), "--processed-prefix",
                      str(tmp_path / "proc")])
    assert outs == [tmp_path / "proc" / "colmap-sai-cli-imgs" / "rec0"]
    j_colmap.colmap_text_to_transforms(tmp_path / "text", tmp_path / "j")
    for name in ("transforms.json", "sparse_pc.ply"):
        assert (outs[0] / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert (outs[0] / "images" / "frame_00000.png").read_bytes() == \
        (rec / "images" / "frame_00000.png").read_bytes()
    (tmp_path / "proc" / "sai-cli" / "rec1").mkdir()
    with pytest.raises(SystemExit, match="one input folder"):
        t_rc.main(["all", "--text-model", str(tmp_path / "text"), "--processed-prefix",
                   str(tmp_path / "proc")])


# ------------------------------------------------------------------------ combine
CALIB = {"cameras": [{"model": "brown-conrady", "focalLengthX": 11.5, "focalLengthY": 11.25,
                      "principalPointX": 2.1, "principalPointY": 1.9,
                      "distortionCoefficients": [0.01, -0.002, 0.0005, 0.0001, 0.003, 0.0]}]}


def make_combine_tree(root: Path, n=7, drop=None, seed=0):
    """COLMAP-side and VIO-side folders of one recording (the VIO's world a
    scaled, rotated, shifted copy of COLMAP's); `drop` leaves a frame out of
    COLMAP's registration."""
    rng = np.random.default_rng(seed)
    src = root / "proc" / "colmap-sai-cli-imgs" / "rec1"
    sai = root / "proc" / "sai-cli" / "rec1"
    for d in (src, sai):
        (d / "images").mkdir(parents=True)
    frames_src, frames_sai = [], []
    for i in range(n):
        name = f"im{i}.png"
        _png(src / "images" / name, seed=i)
        _png(sai / "images" / name, seed=i)
        pos = rng.normal(size=3)
        m_sai = np.eye(4)
        m_sai[:3, 3] = pos
        m_src = np.eye(4)
        m_src[:3, 3] = pos * 2.5 + 0.3
        if i != drop:
            frames_src.append({"file_path": f"./images/{name}", "transform_matrix": m_src.tolist(),
                               "colmap_im_id": i + 1})
        frames_sai.append({"file_path": f"images/{name}", "transform_matrix": m_sai.tolist(),
                           "camera_linear_velocity": rng.normal(size=3).tolist(),
                           "camera_angular_velocity": rng.normal(size=3).tolist(),
                           "motion_blur_score": float(rng.uniform())})
    (src / "transforms.json").write_text(json.dumps(
        {"fl_x": 10.0, "fl_y": 10.5, "cx": 2.0, "cy": 2.0, "w": 4, "h": 4,
         "applied_transform": np.eye(4)[:3].tolist(), "frames": frames_src}))
    (src / "sparse_pc.ply").write_bytes(b"ply\n")
    (sai / "transforms.json").write_text(json.dumps(
        {"fl_x": 9.0, "fl_y": 9.0, "cx": 2.0, "cy": 2.0, "w": 4, "h": 4, "fx": 9.0, "fy": 9.0,
         "orientation_override": "none", "auto_scale_poses_override": False,
         "exposure_time": 0.01, "rolling_shutter_time": 0.005, "frames": frames_sai}))
    return src, sai


COMBINE_CASES = {
    "vels": ([], None),
    "keep_intrinsics": (["--keep_intrinsics"], None),
    "calibration": (["--override_calibration", "CALIB"], None),
    "rolling_shutter": (["--set_rolling_shutter_to", "0.0275"], None),
    "keep_and_rolling_shutter": (["--keep_intrinsics", "--set_rolling_shutter_to", "0.02"], None),
    "tolerate_missing": (["--tolerate_missing"], 3),
    "missing_frame": ([], 3),
}


@pytest.mark.parametrize("case", sorted(COMBINE_CASES))
def test_combine_matches_jax(tmp_path, case, capsys):
    flags, drop = COMBINE_CASES[case]
    (tmp_path / "calib.json").write_text(json.dumps(CALIB))
    flags = [str(tmp_path / "calib.json") if f == "CALIB" else f for f in flags]
    src, sai = make_combine_tree(tmp_path, drop=drop)
    prefix = ["--processed-prefix", str(tmp_path / "proc")]
    j_combine.main([str(src), str(sai), str(tmp_path / "j"), *flags, *prefix])
    jout = capsys.readouterr().out
    outs = t_combine.main([str(src), str(sai), str(tmp_path / "t"), *flags, *prefix])
    assert capsys.readouterr().out == jout.replace(str(tmp_path / "j"), str(tmp_path / "t"))
    if case == "missing_frame":
        assert outs == [] and not (tmp_path / "j").exists() and not (tmp_path / "t").exists()
        return
    assert outs == [tmp_path / "t"]
    _close(_json(tmp_path / "t" / "transforms.json"), _json(tmp_path / "j" / "transforms.json"))
    assert sorted(p.name for p in (tmp_path / "t").rglob("*")) == \
        sorted(p.name for p in (tmp_path / "j").rglob("*"))
    merged = _json(tmp_path / "t" / "transforms.json")
    assert len(merged["frames"]) == (6 if drop is not None else 7)
    assert "colmap_im_id" not in merged["frames"][0]


def test_combine_refuses_another_calibration_model(tmp_path):
    """The JAX script asserts the model; the port raises whatever `-O` says."""
    (tmp_path / "calib.json").write_text(json.dumps(
        {"cameras": [dict(CALIB["cameras"][0], model="kannala-brandt")]}))
    src, sai = make_combine_tree(tmp_path)
    argv = [str(src), str(sai), str(tmp_path / "out"), "--override_calibration",
            str(tmp_path / "calib.json"), "--processed-prefix", str(tmp_path / "proc")]
    with pytest.raises(AssertionError):
        j_combine.main(argv)
    with pytest.raises(ValueError, match="kannala-brandt"):
        t_combine.main(argv)


def test_combine_second_pass_matches_jax(tmp_path):
    _, sai = make_combine_tree(tmp_path, seed=1)
    runs = tmp_path / "outputs" / "rec1" / "splatfacto" / "2024-01-01"
    runs.mkdir(parents=True)
    meta = _json(sai / "transforms.json")
    rng = np.random.default_rng(2)
    optimised = [{"file_path": f["file_path"],
                  "transform": (np.asarray(f["transform_matrix"])[:3]
                                + rng.normal(size=(3, 4)) * 1e-3).tolist()}
                 for f in meta["frames"]]
    (runs / "transforms_train.json").write_text(json.dumps(optimised))
    argv = [str(tmp_path / "outputs" / "rec1"), str(sai), None, "--pose_opt_pass_dir",
            str(tmp_path / "outputs"), "--processed-prefix", str(tmp_path / "proc")]
    j_combine.main([*argv[:2], str(tmp_path / "j"), *argv[3:]])
    t_combine.main([*argv[:2], str(tmp_path / "t"), *argv[3:]])
    got, want = _json(tmp_path / "t" / "transforms.json"), _json(tmp_path / "j" / "transforms.json")
    _close(got, want)
    # the optimised poses, velocities not rescaled on the second pass
    np.testing.assert_array_equal(np.asarray(got["frames"][2]["transform_matrix"])[:3],
                                  optimised[2]["transform"])
    assert got["frames"][2]["camera_linear_velocity"] == \
        meta["frames"][2]["camera_linear_velocity"]


# ----------------------------------------------------------- blur-score split
def make_scored_dataset(root: Path, n=19, seed=0):
    rng = np.random.default_rng(seed)
    src = root / "proc" / "ds" / "sess"
    (src / "images").mkdir(parents=True)
    frames = []
    for i in rng.permutation(n):
        name = f"f{i:03d}.png"
        _png(src / "images" / name, seed=int(i))
        frames.append({"file_path": f"images/{name}", "transform_matrix": np.eye(4).tolist(),
                       "motion_blur_score": float(rng.uniform(0.1, 1.0))})
    (src / "transforms.json").write_text(json.dumps({"frames": frames, "fl_x": 3.0}))
    (src / "sparse_pc.ply").write_bytes(b"ply\n")
    return src


@pytest.mark.parametrize("interval", [8, 5])
def test_blur_score_split_matches_jax(tmp_path, interval, capsys):
    make_scored_dataset(tmp_path)
    outs = {}
    for mod, name in ((j_split, "j"), (t_split, "t")):
        prefix = tmp_path / name / "proc"
        shutil.copytree(tmp_path / "proc", prefix)
        outs[name] = mod.main(["ds", "all", "--processed-prefix", str(prefix), "--interval",
                               str(interval)])
        capsys.readouterr()
    jdir = tmp_path / "j" / "proc" / "ds-blur-scored" / "sess"
    tdir = tmp_path / "t" / "proc" / "ds-blur-scored" / "sess"
    assert outs["t"] == [tdir]
    assert _json(tdir / "transforms.json") == _json(jdir / "transforms.json")
    names = sorted(p.name for p in (tdir / "images").iterdir())
    assert names == sorted(p.name for p in (jdir / "images").iterdir())
    for n in names:
        assert (tdir / "images" / n).read_bytes() == (jdir / "images" / n).read_bytes()
    assert sum(n.startswith("eval_") for n in names) == -(-19 // interval)


# ---------------------------------------------------------------- sai-cli tools
def _recordings(root: Path, n=3):
    for i in range(n):
        (root / f"rec{i}").mkdir(parents=True)
    (root / "notes.txt").write_text("not a recording")


@pytest.mark.parametrize("no_filter", [False, True])
def test_sai_inputs_plan_matches_jax(tmp_path, no_filter, capsys):
    _recordings(tmp_path / "raw")
    argv = ["--input-dir", str(tmp_path / "raw"), "--output-dir", str(tmp_path / "out"),
            "--dry_run"] + (["--no_blur_score_filter"] if no_filter else [])
    j_psi.main(argv)
    jout = capsys.readouterr().out
    cmds = t_psi.main(argv)
    assert capsys.readouterr().out == jout and len(cmds) == 3
    assert cmds[0][:5] == ["sai-cli", "process", str(tmp_path / "raw" / "rec0"),
                           str(tmp_path / ("out-no-blur-filter" if no_filter else "out")
                               / "rec0"), "--output_format"]
    assert t_psi.build_cmd(Path("a"), Path("b"), no_filter) == \
        j_psi.build_cmd(Path("a"), Path("b"), no_filter)


def test_sai_tools_without_binary_raise_as_jax(tmp_path, monkeypatch):
    _recordings(tmp_path / "raw", n=1)
    _no_binaries(monkeypatch)
    rec = tmp_path / "raw" / "rec0"
    (rec / "data.jsonl").write_text("{}\n")
    with zipfile.ZipFile(tmp_path / "rec0.zip", "w") as z:
        z.write(rec / "data.jsonl", "rec0/data.jsonl")
    for argv_j, argv_t, call in (
            (["--input-dir", str(tmp_path / "raw"), "--output-dir", str(tmp_path / "o")],) * 2
            + ("inputs",),
            ([str(tmp_path / "rec0.zip"), "--output-dir", str(tmp_path / "c")],) * 2 + ("custom",),
            ([str(rec), "--output-dir", str(tmp_path / "c")],) * 2 + ("custom",)):
        msgs = []
        for mod in ((j_psi, t_psi) if call == "inputs" else (j_psc, t_psc)):
            with pytest.raises(SystemExit) as e:
                mod.main(argv_j if mod in (j_psi, j_psc) else argv_t)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and "sai-cli not found" in msgs[0]


def test_exposure_from_data_jsonl_matches_jax(tmp_path):
    cases = {
        "frames": [{"frames": [{"exposureTimeSeconds": v}]} for v in (0.01, 0.02, 0.04)],
        "top_level": [{"exposure_time": 0.008}, {"exposureTimeSeconds": 0.012}, {"imu": 1}],
        "mixed": [{"exposure_time": 0.03, "frames": [{"exposure_time": 0.01},
                                                     {"exposureTimeSeconds": 0.02}]}],
        "none": [{"imu": [1, 2, 3]}],
    }
    for name, lines in cases.items():
        d = tmp_path / name
        d.mkdir()
        (d / "data.jsonl").write_text("\n".join(json.dumps(x) for x in lines) + "\nnot json\n")
        assert t_psc.exposure_from_data_jsonl(d) == j_psc.exposure_from_data_jsonl(d), name
    assert t_psc.exposure_from_data_jsonl(tmp_path / "missing") is None


def _stand_in_sai_cli(cmd, **kw):
    """subprocess.check_call standing in for `sai-cli process REC OUT ...`:
    a transforms.json without an exposure, holding the arguments it got."""
    assert cmd[:2] == ["sai-cli", "process"]
    out = Path(cmd[3])
    out.mkdir(parents=True, exist_ok=True)
    (out / "transforms.json").write_text(json.dumps(
        {"fl_x": 5.0, "frames": [{"file_path": "images/a.png"}], "args": cmd[4:]}))
    return 0


@pytest.mark.parametrize("zipped", [False, True])
def test_sai_custom_with_a_stand_in_sai_cli_matches_jax(tmp_path, monkeypatch, zipped, capsys):
    """A stand-in `sai-cli` writes a transforms.json without exposure; both
    scripts unpack the recording, run it and write the exposure from
    data.jsonl and the rolling-shutter override."""
    monkeypatch.setattr(shutil, "which", lambda name: f"/stand-in/{name}")
    for mod in (j_psc, t_psc):
        monkeypatch.setattr(mod.subprocess, "check_call", _stand_in_sai_cli)
    rec = tmp_path / "src" / "myrec"
    rec.mkdir(parents=True)
    (rec / "data.jsonl").write_text("\n".join(json.dumps({"frames": [{"exposure_time": v}]})
                                              for v in (0.004, 0.006, 0.005)))
    arg = rec
    if zipped:
        arg = tmp_path / "myrec.zip"
        with zipfile.ZipFile(arg, "w") as z:
            z.write(rec / "data.jsonl", "myrec/data.jsonl")
    for mod, name in ((j_psc, "j"), (t_psc, "t")):
        mod.main([str(arg), "--output-dir", str(tmp_path / name), "--skip_colmap",
                  "--set_rolling_shutter_to", "0.031"])
    capsys.readouterr()
    got, want = (_json(tmp_path / n / "myrec" / "transforms.json") for n in ("t", "j"))
    assert got == want
    assert got["exposure_time"] == 0.005 and got["rolling_shutter_time"] == 0.031
    assert got["args"] == t_psi.SAI_PARAMS


# ----------------------------------------------------------------- triangulation
def _look_at(pos):
    z = pos / np.linalg.norm(pos)
    x = np.cross([0, 0, 1.0], z)
    x /= np.linalg.norm(x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, np.cross(z, x), z, pos
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulation_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(200, 3)) * 0.5
    intr = {"fl_x": 100.0, "fl_y": 90.0, "cx": 32.0, "cy": 30.0}
    c1 = _look_at(np.array([4.0, 0.2, 0.5]) + rng.normal(size=3) * 0.1)
    c2 = _look_at(np.array([3.0, 2.5, 0.8]) + rng.normal(size=3) * 0.1)
    for c in (c1, c2):
        (jp, jok), (tp, tok) = j_seed.reproject_gl(pts, c, intr), t_seed.reproject_gl(pts, c, intr)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-10)
        np.testing.assert_array_equal(tok, jok)
    p1, _ = t_seed.reproject_gl(pts, c1, intr)
    p2, _ = t_seed.reproject_gl(pts, c2, intr)
    p1 = p1 + rng.normal(size=p1.shape) * 4.0          # some matches over the gate
    jrec, jkeep = j_seed.triangulate_pair(p1, p2, c1, c2, intr, 3.0)
    trec, tkeep = t_seed.triangulate_pair(p1, p2, c1, c2, intr, 3.0)
    np.testing.assert_array_equal(tkeep, jkeep)
    assert 0 < tkeep.sum() < len(pts)
    np.testing.assert_allclose(trec, jrec, rtol=0, atol=1e-10)
    d = rng.normal(size=(50, 3))
    np.testing.assert_allclose(t_seed.triangulate_midpoint(c1[:3, 3], d, c2[:3, 3], d[::-1]),
                               j_seed.triangulate_midpoint(c1[:3, 3], d, c2[:3, 3], d[::-1]),
                               rtol=0, atol=1e-10)


def _textured_views(n=4, size=96, seed=0):
    """Views of a textured plane (so SIFT finds matches) and their GL poses."""
    rng = np.random.default_rng(seed)
    tex = (rng.uniform(size=(size // 4, size // 4, 3)) * 255).astype(np.uint8)
    tex = np.kron(tex, np.ones((8, 8, 1), np.uint8))
    intr = {"fl_x": 80.0, "fl_y": 80.0, "cx": size / 2, "cy": size / 2}
    images, poses = [], []
    for i in range(n):
        shift = 4 * i
        images.append(np.ascontiguousarray(tex[shift:shift + size, shift:shift + size]))
        pose = np.eye(4)
        pose[:3, 3] = [shift / 80.0, -shift / 80.0, 1.0]
        poses.append(pose)
    return images, poses, intr


def test_generate_seed_points_matches_jax():
    pytest.importorskip("cv2")
    images, poses, intr = _textured_views()
    want = j_seed.generate_seed_points(images, poses, intr, max_reproj_px=10.0)
    got = t_seed.generate_seed_points(images, poses, intr, max_reproj_px=10.0)
    assert got.shape == want.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_seed_points_without_cv2_raise(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    images, poses, intr = _textured_views(n=2)
    with pytest.raises(ImportError, match="OpenCV"):
        t_seed.generate_seed_points(images, poses, intr)


# ------------------------------------------------------------ synthetic converter
def test_lcg_sequence_matches_jax():
    for seed in (1000, 7):
        j, t = j_syn.lcg_uniform(seed), t_syn.lcg_uniform(seed)
        assert [next(t) for _ in range(1000)] == [next(j) for _ in range(1000)]


SYN_CASES = {"plain": {}, "posenoise": dict(noisy_poses=True),
             "calib_noise": dict(noisy_poses=True, noisy_intrinsics=True)}


@pytest.mark.parametrize("case", sorted(SYN_CASES))
def test_process_synthetic_matches_jax(tmp_path, case):
    import cv2

    raw = tmp_path / "scene" / "raw_mb"
    make_raw_scene(raw, n_frames=11, img=24)
    # a grey and an RGBA frame: both converters keep three channels
    cv2.imwrite(str(raw / "img_002.png"), np.arange(24 * 24, dtype=np.uint8).reshape(24, 24))
    cv2.imwrite(str(raw / "img_003.png"),
                np.random.default_rng(1).integers(0, 255, (24, 24, 4)).astype(np.uint8))
    jmeta = j_syn.process_scene(raw, tmp_path / "j", **SYN_CASES[case])
    tmeta = t_syn.process_scene(raw, tmp_path / "t", **SYN_CASES[case])
    _close(tmeta, jmeta)
    _close(_json(tmp_path / "t" / "transforms.json"), _json(tmp_path / "j" / "transforms.json"))
    for f in tmeta["frames"]:
        want = cv2.cvtColor(cv2.imread(str(tmp_path / "j" / f["file_path"])), cv2.COLOR_BGR2RGB)
        got = t_syn.read_rgb8(tmp_path / "t" / f["file_path"])
        np.testing.assert_array_equal(got, want, err_msg=f["file_path"])


def test_synthetic_seed_cloud_and_plan_match_jax(tmp_path, capsys):
    pytest.importorskip("cv2")
    images, poses, intr = _textured_views(n=9, size=64)
    out = {}
    for name in ("j", "t"):
        d = tmp_path / name
        (d / "images").mkdir(parents=True)
        frames = []
        for i, (img, pose) in enumerate(zip(images, poses)):
            _ = __import__("cv2").imwrite(str(d / "images" / f"f{i}.png"), img[..., ::-1])
            frames.append({"file_path": f"./images/f{i}.png", "transform_matrix": pose.tolist(),
                           "camera_linear_velocity": [0.0, 0.0, 0.0] if i % 8 == 0 else [0.1, 0, 0],
                           "camera_angular_velocity": [0.0, 0.0, 0.0]})
        (d / "transforms.json").write_text(json.dumps(dict(intr, frames=frames)))
        out[name] = d
    j_syn.generate_seed_cloud(out["j"])
    t_syn.generate_seed_cloud(out["t"])
    assert (out["t"] / "sparse_pc.ply").read_bytes() == (out["j"] / "sparse_pc.ply").read_bytes()
    assert _json(out["t"] / "transforms.json") == _json(out["j"] / "transforms.json")

    meta = _json(out["t"] / "transforms.json")
    meta["frames"][0]["camera_angular_velocity"] = [0.0, 0.1, 0.0]
    (out["t"] / "transforms.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="f0.png has nonzero velocity"):
        t_syn.generate_seed_cloud(out["t"])

    raw_root = tmp_path / "raw"
    for scene in ("s1", "s0"):
        for sub in ("raw_mb", "raw_rs"):
            (raw_root / scene / sub).mkdir(parents=True)
    capsys.readouterr()
    j_syn.main(["--input-dir", str(raw_root), "--output-dir", str(tmp_path / "o"), "--dry_run"])
    jplan = capsys.readouterr().out
    outs = t_syn.main(["--input-dir", str(raw_root), "--output-dir", str(tmp_path / "o"),
                       "--dry_run"])
    assert capsys.readouterr().out == jplan and len(outs) == 6   # 3 variants x 2 scenes


# -------------------------------------------------------------- Deblur-NeRF converter
def test_deblur_tables_and_pose_transfer_match_jax():
    assert t_pdn.PAPER_BY_DATASET == j_pdn.PAPER_BY_DATASET
    assert t_pdn.KNOWN_INTRINSICS == j_pdn.KNOWN_INTRINSICS
    for name in ("blurwine", "blurtanabata2", "cozyroom", "blurfactory"):
        assert t_pdn.canonical_scene_name(name) == j_pdn.canonical_scene_name(name)
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(0)

    def rand_pose():
        m = np.eye(4)
        m[:3, :3] = Rotation.random(random_state=rng).as_matrix()
        m[:3, 3] = rng.normal(size=3)
        return m

    true = [rand_pose() for _ in range(19)]
    gauge = rand_pose()
    pass1 = {"fl_x": 1.0, "frames": [
        {"file_path": f"images/frame_{k + 1:05d}.png", "transform_matrix": (gauge @ p).tolist()}
        for k, p in enumerate(p for i, p in enumerate(true) if i % 8)]}
    pass2 = {"frames": [{"file_path": f"images/frame_{i + 1:05d}.png",
                         "transform_matrix": p.tolist()} for i, p in enumerate(true)]}
    got = t_pdn.transfer_novel_view_poses(pass1, pass2)
    _close(got, j_pdn.transfer_novel_view_poses(pass1, pass2), atol=1e-12)
    for i, f in enumerate(got["frames"]):
        np.testing.assert_allclose(f["transform_matrix"], gauge @ true[i], atol=1e-9)


def _deblur_scene(root: Path, n=10):
    case = root / "raw" / "synthetic_camera_motion_blur" / "blurwine"
    for sub in ("images_1", "images", "images_test"):
        (case / sub).mkdir(parents=True)
        for i in range(n):
            _png(case / sub / f"{i:03d}.png", seed=i + len(sub))
    (case / "images_1" / "000_depth.png").write_bytes(b"depth")
    return case


def _fake_sfm(mod, colmap_io, monkeypatch):
    """SfM standing in for COLMAP in one package's run_colmap: poses from the
    staged file names, exported through that package's text-model parser."""
    def run_sfm_once(image_dir, work, backend="colmap"):
        names = sorted(p.name for p in Path(image_dir).iterdir())
        text = Path(work) / "text"
        text.mkdir(parents=True)
        (text / "cameras.txt").write_text("1 PINHOLE 4 4 5.0 5.0 2.0 2.0\n")
        lines = []
        for k, name in enumerate(names):
            q = np.array([1.0, 0.01 * k, -0.02 * k, 0.005 * k])
            q /= np.linalg.norm(q)
            # ns-process-data names the registered frames frame_00001.png, ...
            fname = name if name.startswith("train_") else f"frame_{k + 1:05d}.png"
            lines.append(f"{k + 1} " + " ".join(repr(float(v)) for v in
                                                (*q, 0.1 * k, -0.05 * k, 2.0)) + f" 1 {fname}")
            lines.append("")
        (text / "images.txt").write_text("\n".join(lines) + "\n")
        (text / "points3D.txt").write_text("1 0.5 0.25 2.0 10 20 30 0.1\n")
        return True

    monkeypatch.setattr(mod, "colmap_available", lambda: True)
    monkeypatch.setattr(mod, "run_sfm_once", run_sfm_once)
    monkeypatch.setattr(mod, "export_transforms",
                        lambda work, out: colmap_io.colmap_text_to_transforms(Path(work) / "text",
                                                                              out))


@pytest.mark.parametrize("flags", [[], ["--exact_intrinsics"]])
def test_deblur_passes_match_jax(tmp_path, monkeypatch, flags, capsys):
    case = _deblur_scene(tmp_path)
    _fake_sfm(j_rc, j_colmap, monkeypatch)
    _fake_sfm(t_rc, t_colmap, monkeypatch)
    for mod, name in ((j_pdn, "j"), (t_pdn, "t")):
        for pass_no in (1, 2, 3):
            mod.main([str(case), "--processed-prefix", str(tmp_path / name),
                      "--pass-no", str(pass_no), *flags])
    capsys.readouterr()
    dirs = {str(p.relative_to(tmp_path / "t")): p.relative_to(tmp_path / "t")
            for p in (tmp_path / "t").glob("*/*")}
    suffix = "-exact-intrinsics" if flags else ""
    assert set(dirs) == {f"colmap-deblurnerf-synthetic-{s}/trolley" for s in
                         ("novel-view-temp", "novel-view" + suffix, "deblurring" + suffix)}
    for d in dirs.values():
        got, want = _json(tmp_path / "t" / d / "transforms.json"), \
            _json(tmp_path / "j" / d / "transforms.json")
        _close(got, want)
        assert sorted(p.name for p in (tmp_path / "t" / d).rglob("*")) == \
            sorted(p.name for p in (tmp_path / "j" / d).rglob("*"))
    temp = _json(tmp_path / "t" / dirs["colmap-deblurnerf-synthetic-novel-view-temp/trolley"]
                 / "transforms.json")
    assert len(temp["frames"]) == 8, "pass 1 holds every 8th frame out"
    novel = _json(tmp_path / "t" / dirs[f"colmap-deblurnerf-synthetic-novel-view{suffix}/trolley"]
                  / "transforms.json")
    assert len(novel["frames"]) == 10


def test_deblurring_split_matches_jax(tmp_path):
    """Pass 3's split on a registration named as ns-process-data names it."""
    rng = np.random.default_rng(4)
    test_dir = tmp_path / "images_test"
    test_dir.mkdir()
    names = [f"{i:03d}.png" for i in range(6)]
    for i, n in enumerate(names):
        _png(test_dir / n, seed=10 + i)
    got = {}
    for mod, name in ((j_pdn, "j"), (t_pdn, "t")):
        out = tmp_path / name
        (out / "images").mkdir(parents=True)
        frames = []
        for k in rng.permutation(6) if name == "j" else order:
            _png(out / "images" / f"frame_{k + 1:05d}.png", seed=int(k))
            frames.append({"file_path": f"./images/frame_{k + 1:05d}.png",
                           "transform_matrix": np.eye(4).tolist()})
        order = [int(Path(f["file_path"]).stem[-5:]) - 1 for f in frames]
        got[name] = mod.build_deblurring_split({"frames": frames, "w": 4}, names, out, test_dir,
                                               False)
    assert got["t"] == got["j"]
    assert sum(f["file_path"].startswith("images/eval_") for f in got["t"]["frames"]) == 6
    for name in ("j", "t"):
        assert sorted(p.name for p in (tmp_path / name / "images").iterdir()) == sorted(
            [f"eval_{n}" for n in names] + [f"train_{n}" for n in names])
    assert t_pdn.build_deblurring_split(got["t"], names, tmp_path / "t", test_dir, True) \
        is got["t"], "a split dataset is left as it is"


def test_deblur_without_colmap_raises_as_jax(tmp_path, monkeypatch, capsys):
    case = _deblur_scene(tmp_path)
    _no_binaries(monkeypatch)
    msgs = []
    for mod in (j_pdn, t_pdn):
        with pytest.raises(SystemExit) as e:
            mod.main([str(case), "--processed-prefix", str(tmp_path / "p")])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "colmap binary not found (external dependency)"


# ------------------------------------------------- the capture pipeline, end to end
def test_capture_pipeline_trains_on_the_port(tmp_path, capsys):
    """A generated scene's VIO directory and COLMAP text model (COLMAP's
    world a similarity of the VIO's) through `run_colmap --text-model`,
    `combine` and the blur-score split, as a user runs them, then `cli.fit`
    with the flagship flags of `cli/train.py` for the real-capture dataset.
    The JAX combine and split on the same inputs write the same JSON."""
    from splat_tpu_torch.cli import fit as t_fit
    from splat_tpu_torch.cli import train as t_train
    from splat_tpu_torch.data import synthetic

    spec = importlib.util.spec_from_file_location(
        "synthetic_capture_torch", REPO / "scripts_dev" / "synthetic_capture_torch.py")
    cap = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cap)

    gen = synthetic.generate_scene(tmp_path / "scene", n_gaussians=60, n_frames=16, img_size=32,
                                   exposure=0.06, rolling_shutter=0.02, n_blur_samples=3, seed=5,
                                   device="cpu")
    sim = cap.similarity(3)
    proc = tmp_path / "proc"
    vio = proc / "sai-cli" / "rec0"
    cap.write_vio_dir(tmp_path / "scene", vio)
    g = gen["gaussians"]
    cap.write_colmap_text(tmp_path / "scene", tmp_path / "text", g["means"].numpy(),
                          np.round(g["colors"].numpy() * 255), sim)
    (colmap_dir,) = t_rc.main([str(vio), "--text-model", str(tmp_path / "text"),
                               "--processed-prefix", str(proc)])
    (vels,) = t_combine.main([str(colmap_dir), str(vio), "--processed-prefix", str(proc)])
    (scored,) = t_split.main(["colmap-sai-cli-vels", "all", "--processed-prefix", str(proc)])
    assert scored == proc / "colmap-sai-cli-vels-blur-scored" / "rec0"
    j_combine.main([str(colmap_dir), str(vio), str(tmp_path / "j_vels"),
                    "--processed-prefix", str(proc)])
    assert _json(tmp_path / "j_vels" / "transforms.json") == _json(vels / "transforms.json")
    j_split.process(tmp_path / "j_vels", tmp_path / "j_split", 8, False)
    assert _json(tmp_path / "j_split" / "j_vels" / "transforms.json") == \
        _json(scored / "transforms.json")
    capsys.readouterr()

    merged, vmeta = _json(vels / "transforms.json"), _json(vio / "transforms.json")
    by_name = {Path(f["file_path"]).name: f for f in vmeta["frames"]}
    rot = cap.world_rotation(sim)
    for f in merged["frames"]:
        src = by_name[Path(f["file_path"]).name]
        np.testing.assert_allclose(cap.vio_pose(f["transform_matrix"], sim),
                                   src["transform_matrix"], rtol=0, atol=1e-9)
        world = np.asarray(f["transform_matrix"])[:3, :3] @ f["camera_linear_velocity"]
        want = sim[0] * rot @ (np.asarray(src["transform_matrix"])[:3, :3]
                               @ src["camera_linear_velocity"])
        np.testing.assert_allclose(world, want, rtol=0, atol=1e-9)
        assert f["camera_angular_velocity"] == src["camera_angular_velocity"]
    frames = sorted(vmeta["frames"], key=lambda f: f["file_path"])
    want_eval = {"eval_" + Path(min(frames[s:s + 8], key=lambda f: f["motion_blur_score"])
                                ["file_path"]).name for s in range(0, 16, 8)}
    assert {p.name for p in (scored / "images").glob("eval_*")} == want_eval

    dataset = "colmap-sai-cli-vels-blur-scored"
    _, flags = t_train.flags_to_variant_name_and_cmd(
        {"motion_blur", "rolling_shutter", "pose_opt", "velocity_opt"}, dataset, False)
    run = t_fit.main(["splatfacto", "--data", str(scored), "--output-dir", str(tmp_path / "out"),
                      "--experiment-name", "cap", "--timestamp", "t0", "--device", "cpu",
                      "--max-num-iterations", "10", "--steps-per-eval", "10",
                      "--steps-per-save", "10", "--pipeline.model.tile-size", "8", *flags,
                      "nerfstudio-data", "--eval-mode",
                      t_train.dataset_params(dataset)["eval_mode"]])
    metrics = _json(run / "metrics.json")
    assert np.isfinite(metrics["results"]["psnr"])
    config = _json(run / "config.json")
    assert config["dataparser"]["eval_mode"] == "filename" and config["model"]["blur_samples"] == 5
