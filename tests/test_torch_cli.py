"""The port's command line against the JAX package's on the CPU.

- `parse_cli` of both packages on the flag lists `cli/train.py` emits for
  every variant of three dataset classes (the dotted model flags, the run
  flags and the `nerfstudio-data` block): equal model, trainer and dataparser
  fields (`chunk`, the one model field that only shapes the TPU kernels,
  aside), and `config.json` keys that differ only by it and the port's
  `device`; the `--mesh.*` flags parse into the same `MeshConfig` fields.
- `splat_tpu_torch.cli.fit.main([... "--device", "cpu"])` on a 32 px scene for
  30 steps with two evals and two checkpoints writes `config.json`,
  `dataparser_transforms.json`, `metrics_train.jsonl` and `metrics.json` with
  the keys of a JAX `cli/fit.py` run on the same scene (4 steps), trains (the
  loss falls), and `cli.evaluate` reloads the newest checkpoint, in this
  process and in a fresh one, to the PSNR `fit` reported (exact: the same
  model, renderer and images).
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from splat_tpu.engine import config as jcfg
from splat_tpu_torch.cli import evaluate as t_evaluate
from splat_tpu_torch.cli import fit as t_fit
from splat_tpu_torch.data import synthetic
from splat_tpu_torch.engine import config as tcfg

ROOT = Path(__file__).resolve().parents[1]
TPU_ONLY = ("chunk",)


def _script(name):
    """Import cli/<name>.py of the JAX package (scripts, not a package)."""
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


def _variant_cases():
    train = _script("train")
    cases = []
    for dataset in ("synthetic-mbrs", "smartphone-blur-scored", "colmap-sai-cli-vels"):
        for features in train.variants_for_dataset(dataset):
            name, flags = train.flags_to_variant_name_and_cmd(features, dataset, train_all=False)
            dp = train.dataset_params(dataset)
            mode = dp.get("eval_mode", "interval")
            data = ["nerfstudio-data", "--eval-mode", mode]
            if mode == "interval":
                data += ["--eval-interval", str(dp.get("eval_interval", 8))]
            if dp.get("orientation_method"):
                data += ["--orientation-method", dp["orientation_method"]]
            cases.append(pytest.param(
                ["splatfacto", "--data", "scene", "--output-dir", "out", "--experiment-name",
                 f"{dataset}/{name}", "--max-num-iterations", "3000", "--vis", "tensorboard",
                 *flags, "--pipeline.model.chunk", "64", "--trainer.log-every", "50", *data],
                id=f"{dataset}-{name}"))
    return cases


@pytest.mark.parametrize("argv", _variant_cases())
def test_parse_cli_matches_jax_parser(argv, tmp_path):
    want, got = jcfg.parse_cli(argv), tcfg.parse_cli(argv)
    model = {k: v for k, v in dataclasses.asdict(want.model).items() if k not in TPU_ONLY}
    assert dataclasses.asdict(got.model) == model
    assert dataclasses.asdict(got.trainer) == dataclasses.asdict(want.trainer)
    assert dataclasses.asdict(got.dataparser) == dataclasses.asdict(want.dataparser)
    assert dataclasses.asdict(got.mesh) == dataclasses.asdict(want.mesh)
    for field in ("data", "output_dir", "experiment_name", "method_name", "max_num_iterations",
                  "steps_per_save", "steps_per_eval", "vis", "viewer_port", "seed"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.device == "cuda"
    jcfg.save_config(want, tmp_path / "j.json")
    tcfg.save_config(got, tmp_path / "t.json")
    j, t = (json.loads((tmp_path / n).read_text()) for n in ("j.json", "t.json"))
    assert set(t) - set(j) == {"device"} and set(j) <= set(t)
    assert set(j["model"]) - set(t["model"]) == set(TPU_ONLY)
    for section in ("trainer", "dataparser", "mesh"):
        assert t[section] == j[section]
    assert tcfg.load_config(tmp_path / "t.json") == got
    # a config.json written by the JAX package loads here, without the TPU-only fields
    assert dataclasses.replace(tcfg.load_config(tmp_path / "j.json"), device="cuda") == got


def test_parse_cli_errors_and_unported_options(tmp_path):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError, match="unknown flag"):
            mod.parse_cli(["--pipeline.nothing", "1"])
        with pytest.raises(AttributeError, match="no field"):
            mod.parse_cli(["--pipeline.model.nothing", "1"])
        with pytest.raises(ValueError, match="missing value"):
            mod.parse_cli(["--data"])
        assert mod.parse_cli(["--pipeline.model.tile-size", "16x8"]).model.tile_size == (16, 8)
    assert "--pipeline.model.blur-samples" in tcfg.help_text()
    # the --mesh.* flags parse into the JAX CLI's MeshConfig fields
    mesh_flags = ["--mesh.enabled", "True", "--mesh.data", "2", "--mesh.gauss", "2",
                  "--mesh.blur", "0", "--mesh.tile", "4"]
    assert (dataclasses.asdict(tcfg.parse_cli(mesh_flags).mesh)
            == dataclasses.asdict(jcfg.parse_cli(mesh_flags).mesh)
            == dict(enabled=True, data=2, gauss=2, blur=0, tile=4))
    # the live viewer is ported: `--vis viewer` gets as far as reading the scene
    with pytest.raises(FileNotFoundError, match="nowhere"):
        t_fit.main(["--data", "nowhere", "--vis", "viewer", "--device", "cpu",
                    "--output-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        t_fit.main(["--device", "cpu"])


FLAGS = ["--pipeline.model.blur-samples", "3", "--pipeline.model.tile-size", "8",
         "--pipeline.model.max-per-tile", "128", "--pipeline.model.sh-degree", "1",
         "--pipeline.model.rolling-shutter-compensation", "True",
         "--pipeline.model.camera-optimizer.mode", "SO3xR3",
         "--pipeline.model.camera-velocity-optimizer.enabled", "True",
         "--pipeline.model.optimize-eval-cameras", "True"]
DATA_FLAGS = ["nerfstudio-data", "--eval-mode", "interval", "--eval-interval", "4",
              "--orientation-method", "none"]


def test_fit_and_evaluate_write_the_jax_contract(tmp_path):
    scene = tmp_path / "scene"
    synthetic.generate_scene(scene, n_gaussians=60, n_frames=9, img_size=32, exposure=0.08,
                             rolling_shutter=0.02, n_blur_samples=3, seed=5, device="cpu")
    run = t_fit.main(["splatfacto", "--data", str(scene), "--output-dir", str(tmp_path / "out"),
                      "--experiment-name", "exp", "--timestamp", "t0", "--device", "cpu",
                      "--max-num-iterations", "30", "--steps-per-eval", "15",
                      "--steps-per-save", "15", "--vis", "tensorboard", "--trainer.log-every", "10",
                      *FLAGS, *DATA_FLAGS])
    assert run == tmp_path / "out" / "exp" / "splatfacto" / "t0"
    jrun = _script("fit").main(
        ["splatfacto", "--data", str(scene), "--output-dir", str(tmp_path / "jout"),
         "--experiment-name", "exp", "--timestamp", "t0", "--max-num-iterations", "4",
         "--steps-per-eval", "2", "--trainer.log-every", "2", *FLAGS, *DATA_FLAGS])

    for name in ("config.json", "dataparser_transforms.json", "metrics_train.jsonl",
                 "metrics.json"):
        assert (run / name).exists() and (jrun / name).exists(), name
    metrics, jmetrics = (json.loads((d / "metrics.json").read_text()) for d in (run, jrun))
    assert metrics.keys() == jmetrics.keys()
    assert set(metrics["results"]) == {"psnr", "ssim"} <= set(jmetrics["results"])
    assert metrics["compile_time_seconds"] == 0.0, "no kernel is built on the CPU"
    assert metrics["checkpoint"] == str(run / "checkpoints" / "step_30")
    assert json.loads((run / "dataparser_transforms.json").read_text()) == \
        json.loads((jrun / "dataparser_transforms.json").read_text())
    records = [json.loads(line) for line in (run / "metrics_train.jsonl").read_text().splitlines()]
    jrecords = [json.loads(line)
                for line in (jrun / "metrics_train.jsonl").read_text().splitlines()]
    train, evals = ([r for r in records if ("loss" in r) == flag] for flag in (True, False))
    jtrain, jevals = ([r for r in jrecords if ("loss" in r) == flag] for flag in (True, False))
    assert [r["step"] for r in train] == [10, 15, 20, 30] and [r["step"] for r in evals] == [15, 30]
    assert set(jtrain[0]) <= set(train[0]) and set(evals[0]) <= set(jevals[0])
    assert train[-1]["loss"] < train[0]["loss"]
    assert evals[-1]["eval_psnr"] == metrics["results"]["psnr"]
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["step_15", "step_30"]
    assert list((run / "tensorboard").iterdir())
    config = json.loads((run / "config.json").read_text())
    assert config["device"] == "cpu" and config["model"]["blur_anchors"] >= 1
    assert config["trainer"]["max_steps"] == 20000 and config["max_num_iterations"] == 30

    out = t_evaluate.main(["--load-config", str(run / "config.json"), "--output-path",
                           str(tmp_path / "eval.json")])
    assert out["checkpoint_step"] == 30
    assert out["results"] == metrics["results"]
    assert json.loads((tmp_path / "eval.json").read_text()).keys() == {
        "experiment_name", "method_name", "checkpoint_step", "results", "eval_wall_clock_seconds"}
    # a fresh process reads the same checkpoint
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    done = subprocess.run(
        [sys.executable, "-m", "splat_tpu_torch.cli.evaluate", "--load-config",
         str(run / "config.json")], capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == metrics["results"]
    rewritten = json.loads((run / "metrics.json").read_text())
    assert rewritten["wall_clock_time_seconds"] == metrics["wall_clock_time_seconds"]
