"""The port's variant-matrix tools against the JAX package's on the CPU.

- `cli.train`: the dataset parameter packs, `variants_for_dataset` and
  `flags_to_variant_name_and_cmd` equal the JAX driver's for every variant
  of five dataset classes, with and without `--train_all`, and the commands
  a dry run prints differ only in the entry point (`-m
  splat_tpu_torch.cli.fit` for `cli/fit.py`);
- `cli.generate_synthetic_suite.derive_velnoise`: the same transforms.json
  as the JAX function's on a fixture scene;
- `cli.check_benchmark_ordering.check`: the JAX checker's answers on the
  cases of its own tests (`tests/test_cli.py`);
- end to end: the port's suite generator writes a one-session suite, and
  `cli.train --iters 30 --variants baseline,motion_blur -- --device cpu`
  trains both runs and renders their eval images in subprocesses: the run
  tree, both metrics.json, the PNGs, the port's `parse_outputs` rows equal to
  the JAX function's on the same tree, and both checkers' verdicts equal.
  Without `--device cpu` the same command fails at once here (no card).
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from splat_tpu_torch.cli import check_benchmark_ordering as t_check
from splat_tpu_torch.cli import generate_synthetic_suite as t_suite
from splat_tpu_torch.cli import parse_outputs as t_parse
from splat_tpu_torch.cli import train as t_train
from splat_tpu_torch.data import synthetic
from splat_tpu_torch.data.png import read_png

ROOT = Path(__file__).resolve().parents[1]
DATASETS = ["synthetic-mb", "synthetic-rs", "synthetic-mbrs", "synthetic-mb-velnoise",
            "colmap-sai-cli-vels-blur-scored"]


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


def _fit_args(line: str) -> list[str]:
    """A printed command from `splatfacto` on: what follows the entry point."""
    words = line.split()
    return words[words.index("splatfacto"):]


@pytest.mark.parametrize("train_all", [False, True], ids=["eval_split", "train_all"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_variant_matrix_matches_jax(dataset, train_all, tmp_path, capsys):
    j_train = _script("train")
    assert t_train.FEATURE_ORDER == j_train.FEATURE_ORDER
    assert t_train.dataset_params(dataset) == j_train.dataset_params(dataset)
    extra = ["pose_opt-motion_blur"]
    want = j_train.variants_for_dataset(dataset, extra)
    assert t_train.variants_for_dataset(dataset, extra) == want and len(want) >= 8
    for features in want:
        assert (t_train.flags_to_variant_name_and_cmd(features, dataset, train_all)
                == j_train.flags_to_variant_name_and_cmd(features, dataset, train_all))

    (tmp_path / "in" / dataset / "scene0").mkdir(parents=True)
    (tmp_path / "in" / dataset / "scene0" / "transforms.json").write_text("{}")
    argv = ["--dataset", dataset, "--input-dir", str(tmp_path / "in"), "--output-dir",
            str(tmp_path / "out"), "--draft", "--dry_run", "--extra-variants", extra[0],
            *(["--train_all"] if train_all else []), "--", "--device", "cpu"]
    capsys.readouterr()
    j_train.main(argv)
    j_lines = capsys.readouterr().out.splitlines()
    t_train.main(argv)
    t_lines = capsys.readouterr().out.splitlines()
    assert len(t_lines) == len(j_lines) == len(want) + 1
    assert t_lines[0] == j_lines[0]
    for jl, tl in zip(j_lines[1:], t_lines[1:]):
        assert tl.split()[1:3] == ["-m", "splat_tpu_torch.cli.fit"]
        assert _fit_args(tl) == _fit_args(jl)
    # a subset by name, as the JAX driver picks it
    sub = ["--variants", "motion_blur,baseline"]
    capsys.readouterr()
    j_train.main([*sub, *argv])
    j_sub = capsys.readouterr().out.splitlines()
    t_train.main([*sub, *argv])
    assert [_fit_args(x) for x in capsys.readouterr().out.splitlines()[1:]] == \
        [_fit_args(x) for x in j_sub[1:]]


def test_derive_velnoise_matches_jax(tmp_path):
    j_suite = _script("generate_synthetic_suite")
    src = tmp_path / "mb" / "scene0"
    synthetic.generate_scene(src, n_gaussians=20, n_frames=9, img_size=16, exposure=0.1,
                             n_blur_samples=2, seed=4, trajectory="shake", shake_amp=0.05,
                             device="cpu")
    j_suite.derive_velnoise(src, tmp_path / "j" / "scene0", seed=4)
    t_suite.derive_velnoise(src, tmp_path / "t" / "scene0", seed=4)
    got = (tmp_path / "t" / "scene0" / "transforms.json").read_text()
    assert got == (tmp_path / "j" / "scene0" / "transforms.json").read_text()
    assert got != (src / "transforms.json").read_text()
    for name in ("sparse_pc.ply", "images/frame_00000.png"):
        assert ((tmp_path / "t" / "scene0" / name).read_bytes()
                == (src / name).read_bytes()), name
    assert t_suite.VARIANTS == j_suite.VARIANTS
    assert t_suite.SCENE_TRAJECTORIES == j_suite.SCENE_TRAJECTORIES


def _rows(entries):
    return [{"dataset": d, "session": s, "variant": v, "psnr": p} for d, s, v, p in entries]


CHECK_CASES = {
    "good": _rows([("synthetic-mb", "scene0", "baseline", 24.0),
                   ("synthetic-mb", "scene0", "motion_blur", 27.5),
                   ("synthetic-mb", "scene0", "motion_blur-velocity_opt", 27.4),
                   ("synthetic-rs", "scene0", "baseline", 25.0),
                   ("synthetic-rs", "scene0", "rolling_shutter", 27.0)]),
    "mb_short": _rows([("synthetic-mb", "scene0", "baseline", 24.0),
                       ("synthetic-mb", "scene0", "motion_blur", 24.3)]),
    "vel_regress": _rows([("synthetic-mb", "scene0", "baseline", 24.0),
                          ("synthetic-mb", "scene0", "motion_blur", 27.5),
                          ("synthetic-mb", "scene0", "motion_blur-velocity_opt", 26.0)]),
    "empty": [],
    "velnoise_good": _rows([
        ("synthetic-mb-velnoise", "scene0", "baseline", 24.0),
        ("synthetic-mb-velnoise", "scene0", "motion_blur", 23.8),
        ("synthetic-mb-velnoise", "scene0", "motion_blur-velocity_opt", 26.0),
        ("synthetic-mb-velnoise", "scene0", "motion_blur-velocity_opt-zero_init", 25.5)]),
    "velnoise_bad": _rows([("synthetic-mb-velnoise", "scene0", "motion_blur", 23.8),
                           ("synthetic-mb-velnoise", "scene0", "motion_blur-velocity_opt", 23.9)]),
    "no_baseline": _rows([("synthetic-mb", "scene0", "motion_blur", 25.0)]),
    "zero_init": _rows([("synthetic-rs", "s", "baseline", 21.3),
                        ("synthetic-rs", "s", "rolling_shutter", 22.4),
                        ("synthetic-rs", "s", "rolling_shutter-velocity_opt-zero_init", 21.7)]),
    "zero_init_below": _rows([("synthetic-rs", "s", "baseline", 21.3),
                              ("synthetic-rs", "s", "rolling_shutter", 22.4),
                              ("synthetic-rs", "s", "rolling_shutter-velocity_opt-zero_init",
                               21.0)]),
    "missing_psnr": _rows([("synthetic-rs", "s", "baseline", None),
                           ("synthetic-rs", "s", "rolling_shutter", 22.4)]),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_matches_jax(case):
    j_check = _script("check_benchmark_ordering")
    rows = CHECK_CASES[case]
    for kw in (dict(margin=1.0, vel_tol=0.5), dict(margin=0.2, vel_tol=0.1, vel_win_margin=0.5,
                                                   zero_init_margin=0.5)):
        assert t_check.check(rows, **kw) == j_check.check(rows, **kw), kw


@pytest.fixture(scope="module")
def matrix_run(tmp_path_factory):
    """A one-session suite from the port's generator, and two variants of it
    trained and rendered by `cli.train` on the CPU (30 steps each)."""
    root = tmp_path_factory.mktemp("matrix")
    inputs, outputs = root / "inputs", root / "outputs"
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")      # the fit and render subprocesses' torch pools
    try:
        t_suite.main(["--input-dir", str(inputs), "--resolution", "32", "--scenes", "1",
                      "--n-gaussians", "100", "--n-frames", "9", "--blur-gt-samples", "3",
                      "--variants", "mb", "--device", "cpu"])
        configs = t_train.main(["--dataset", "synthetic-mb", "--input-dir", str(inputs),
                                "--output-dir", str(outputs), "--iters", "30",
                                "--variants", "baseline,motion_blur", "--", "--device", "cpu"])
    finally:
        mp.undo()
    return inputs, outputs, configs


def test_train_writes_the_run_tree(matrix_run):
    inputs, outputs, configs = matrix_run
    assert (inputs / "synthetic-mb" / "scene0" / "transforms.json").exists()
    assert len(configs) == 2
    for variant, config in zip(("baseline", "motion_blur"), configs):
        run_root = outputs / "synthetic-mb" / variant / "scene0" / "splatfacto"
        runs = list(run_root.iterdir())
        assert len(runs) == 1 and config == runs[0] / "config.json"
        run = runs[0]
        cfg = json.loads(config.read_text())
        assert cfg["device"] == "cpu" and cfg["max_num_iterations"] == 30
        assert cfg["model"]["blur_samples"] == (10 if variant == "motion_blur" else 0)
        assert cfg["model"]["cull_scale_thresh"] == 2.0
        m = json.loads((run / "metrics.json").read_text())
        assert np.isfinite(m["results"]["psnr"]) and np.isfinite(m["results"]["ssim"])
        for key in ("wall_clock_time_seconds", "train_time_seconds", "compile_time_seconds"):
            assert np.isfinite(m[key]), key
        # the driver's wall clock is the subprocess's: it holds the fit's own
        assert m["wall_clock_time_seconds"] >= m["train_time_seconds"]
        assert (run / "checkpoints" / "step_30" / "state.npz").exists()
        renders = run / "renders" / "eval"
        for i in range(2):                      # frames 0 and 8 of 9 are eval frames
            pred = read_png(renders / f"{i:05d}_pred.png")
            gt = read_png(renders / f"{i:05d}_gt.png")
            assert pred.shape == gt.shape == (32, 32, 3) and pred.std() > 0
            assert read_png(renders / f"{i:05d}_depth.png").shape == (32, 32, 3)
            assert np.isfinite(np.load(renders / f"{i:05d}_depth.npy")).any()
        assert not (renders / "00002_pred.png").exists()


def test_parse_outputs_and_checker_match_jax(matrix_run, capsys):
    _, outputs, _ = matrix_run
    j_parse = _script("parse_outputs")
    j_check = _script("check_benchmark_ordering")
    rows = t_parse.find_and_parse_directories_containing_splatting_metrics(outputs)
    assert rows == j_parse.find_and_parse_directories_containing_splatting_metrics(outputs)
    assert [(r["variant"], r["session"]) for r in rows] == [("baseline", "scene0"),
                                                            ("motion_blur", "scene0")]
    capsys.readouterr()
    t_parse.main(["--input-dir", str(outputs)])
    table = capsys.readouterr().out.splitlines()
    assert table[0].split() == t_parse.COLUMNS and len(table) == 3
    for margin in ("1.0", "-50"):
        argv = ["--input-dir", str(outputs), "--margin", margin]
        rc_j = j_check.main(argv)
        out_j = capsys.readouterr().out
        rc_t = t_check.main(argv)
        assert (rc_t, capsys.readouterr().out) == (rc_j, out_j)
    assert rc_t == 0          # at margin -50 the ordering holds


def test_train_without_device_flag_fails_here(matrix_run, tmp_path):
    """No card here: a run that forgets `--device cpu` must fail, not carry on."""
    inputs, _, _ = matrix_run
    with pytest.raises(subprocess.CalledProcessError):
        t_train.main(["--dataset", "synthetic-mb", "--input-dir", str(inputs),
                      "--output-dir", str(tmp_path), "--iters", "2", "--variants", "baseline",
                      "--no-render"])
