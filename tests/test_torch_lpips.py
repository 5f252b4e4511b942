"""The port's LPIPS graph against the JAX package's, on the CPU.

There are no pretrained weights in the repository, so both graphs run on
seeded random weights in the .npz contract (`ops/lpips.random_weights`),
each package reading the file through its own environment variable:
- LPIPS of 64x64 pairs (and odd sizes, where the padding and pools
  differ): the port within 1e-5 relative of the JAX graph (float32
  convolutions in two libraries, summed in different orders);
- `lpips` / `lpips_batch` return None only without a weights file; a
  variable naming a missing file and a file missing a key raise;
- the weights are read once for each file and device, and again only when
  the file is rewritten or another is named;
- `Trainer.evaluate` gains `lpips` with weights (within 1e-4 relative of
  the JAX trainer's on the same scene and initial model: the two renders
  differ by float rounding) and has no such key without them; `cli.fit`'s
  metrics.json, `cli.evaluate` and `cli.parse_outputs` carry it;
- `convert_torch_checkpoint` packs a torch checkpoint into the contract.
"""
import json
import os

import numpy as np
import pytest
import torch

from splat_tpu.ops import lpips as j_lp
from splat_tpu_torch.ops import lpips as t_lp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here, and
    the suite's xdist workers would each start a full intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def weights(tmp_path, monkeypatch):
    """Seeded random weights, read by both packages."""
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **t_lp.random_weights(seed=0))
    monkeypatch.setenv(t_lp.ENV_VAR, str(path))
    monkeypatch.setenv("SPLAT_TPU_LPIPS_WEIGHTS", str(path))
    j_lp._WEIGHTS_CACHE = None
    yield path
    j_lp._WEIGHTS_CACHE = None


@pytest.fixture()
def no_weights(monkeypatch, tmp_path):
    monkeypatch.delenv(t_lp.ENV_VAR, raising=False)
    monkeypatch.setattr(t_lp, "DEFAULT_PATH", tmp_path / "absent.npz")


def _pair(seed, h=64, w=64, noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(h, w, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape) * noise, 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("seed,h,w,noise", [(0, 64, 64, 0.1), (1, 64, 64, 0.02),
                                            (2, 64, 64, 0.4), (3, 35, 37, 0.2)])
def test_lpips_matches_jax(weights, seed, h, w, noise):
    x, y = _pair(seed, h, w, noise)
    want = j_lp.lpips(x, y)
    got = t_lp.lpips(torch.from_numpy(x), torch.from_numpy(y))
    assert want > 0 and got == pytest.approx(want, rel=1e-5, abs=0), (got, want)
    assert t_lp.lpips(x, x) == pytest.approx(0.0, abs=1e-7)


def test_lpips_batch_matches_jax(weights):
    pairs = [_pair(s) for s in range(4, 7)]
    want = j_lp.lpips_batch([p for p, _ in pairs], [g for _, g in pairs])
    got = t_lp.lpips_batch([torch.from_numpy(p) for p, _ in pairs], [g for _, g in pairs])
    assert got == pytest.approx(want, rel=1e-5, abs=0)


def test_lpips_is_none_only_without_a_weights_file(no_weights, tmp_path, monkeypatch):
    x, y = _pair(0)
    assert t_lp.weights_path() is None and t_lp.load_weights() is None
    assert t_lp.lpips(x, y) is None and t_lp.lpips_batch([x], [y]) is None
    monkeypatch.setenv(t_lp.ENV_VAR, str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        t_lp.lpips(x, y)
    broken = {k: v for k, v in t_lp.random_weights().items() if k != "lin3.weight"}
    np.savez(tmp_path / "broken.npz", **broken)
    monkeypatch.setenv(t_lp.ENV_VAR, str(tmp_path / "broken.npz"))
    with pytest.raises(KeyError, match="lin3.weight"):
        t_lp.lpips_batch([x], [y])
    np.savez(tmp_path / "wrong.npz", **dict(t_lp.random_weights(), **{
        "features.3.weight": np.zeros((192, 7, 5, 5), np.float32)}))
    monkeypatch.setenv(t_lp.ENV_VAR, str(tmp_path / "wrong.npz"))
    with pytest.raises(RuntimeError):
        t_lp.lpips(x, y)


def test_weights_are_read_once_for_each_file_and_device(weights, tmp_path, monkeypatch):
    """An eval every `--steps-per-eval` steps reads the file once: the same
    tensors come back until the file is rewritten or another is named, and a
    named file that is gone still raises."""
    reads = []
    real_load = np.load
    monkeypatch.setattr(t_lp.np, "load", lambda *a, **k: reads.append(a[0]) or real_load(*a, **k))
    first = t_lp.load_weights("cpu")
    assert t_lp.load_weights("cpu") is first and t_lp.load_weights(torch.device("cpu")) is first
    x, y = _pair(0)
    t_lp.lpips_batch([x, y], [y, x])
    assert len(reads) == 1
    np.savez(weights, **t_lp.random_weights(seed=1))
    os.utime(weights, ns=(1, 1))
    second = t_lp.load_weights("cpu")
    assert second is not first and len(reads) == 2
    assert not torch.equal(second["lin0.weight"], first["lin0.weight"])
    other = tmp_path / "other.npz"
    np.savez(other, **t_lp.random_weights(seed=0))
    monkeypatch.setenv(t_lp.ENV_VAR, str(other))
    assert torch.equal(t_lp.load_weights("cpu")["lin0.weight"], first["lin0.weight"])
    assert len(reads) == 3
    other.unlink()
    with pytest.raises(FileNotFoundError, match="other.npz"):
        t_lp.load_weights("cpu")


def test_convert_torch_checkpoint(tmp_path, no_weights):
    rw = t_lp.random_weights(seed=3)
    torch.save({k: torch.from_numpy(v) for k, v in rw.items() if k.startswith("features")},
               tmp_path / "trunk.pth")
    torch.save({f"lin{k}.model.1.weight": torch.from_numpy(rw[f"lin{k}.weight"])
                for k in range(5)}, tmp_path / "alex.pth")
    t_lp.convert_torch_checkpoint(str(tmp_path / "alex.pth"), str(tmp_path / "w.npz"),
                                  str(tmp_path / "trunk.pth"))
    with np.load(tmp_path / "w.npz") as packed:
        assert sorted(packed.files) == sorted(t_lp.KEYS)
        for k in t_lp.KEYS:
            np.testing.assert_array_equal(packed[k], rw[k])


# ------------------------------------------------------------ the trainer and the CLI
def test_trainer_evaluate_lpips_matches_jax(tmp_path, monkeypatch):
    from splat_tpu.data import dataparser as jdp
    from splat_tpu.data import dataset as jds
    from splat_tpu.data import synthetic as jsyn
    from test_torch_trainer import _trainers

    out = tmp_path / "scene"
    jsyn.generate_scene(out, n_gaussians=80, n_frames=17, img_size=48, exposure=0.08,
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
    monkeypatch.delenv(t_lp.ENV_VAR, raising=False)
    monkeypatch.setattr(t_lp, "DEFAULT_PATH", tmp_path / "absent.npz")
    jt, tt = _trainers((jscene, tree))
    assert set(tt.evaluate()) == {"psnr", "ssim"}, "no weights: no lpips key"
    path = tmp_path / "w.npz"
    np.savez(path, **t_lp.random_weights(seed=1))
    monkeypatch.setenv(t_lp.ENV_VAR, str(path))
    monkeypatch.setenv("SPLAT_TPU_LPIPS_WEIGHTS", str(path))
    j_lp._WEIGHTS_CACHE = None
    try:
        mj, mt = jt.evaluate(), tt.evaluate()
    finally:
        j_lp._WEIGHTS_CACHE = None
    assert set(mt) == set(mj) == {"psnr", "ssim", "lpips"}
    assert mt["lpips"] > 0 and mt["lpips"] == pytest.approx(mj["lpips"], rel=1e-4)
    assert mt["psnr"] == pytest.approx(mj["psnr"], abs=0.05)


def test_fit_evaluate_and_parse_outputs_carry_lpips(tmp_path, monkeypatch, capsys):
    from splat_tpu_torch.cli import evaluate as t_evaluate
    from splat_tpu_torch.cli import fit as t_fit
    from splat_tpu_torch.cli import parse_outputs as t_parse
    from splat_tpu_torch.data import synthetic

    path = tmp_path / "w.npz"
    np.savez(path, **t_lp.random_weights(seed=2))
    monkeypatch.setenv(t_lp.ENV_VAR, str(path))
    scene = tmp_path / "scene"
    synthetic.generate_scene(scene, n_gaussians=60, n_frames=9, img_size=32, exposure=0.08,
                             rolling_shutter=0.02, n_blur_samples=3, seed=5, device="cpu")
    out_dir = tmp_path / "out"
    run = t_fit.main(["splatfacto", "--data", str(scene), "--output-dir", str(out_dir),
                      "--experiment-name", "synthetic-mb/baseline/scene0", "--timestamp", "t0",
                      "--device", "cpu", "--max-num-iterations", "6", "--steps-per-eval", "6",
                      "--steps-per-save", "6", "--pipeline.model.tile-size", "8",
                      "nerfstudio-data", "--eval-mode", "interval", "--eval-interval", "4",
                      "--orientation-method", "none"])
    metrics = json.loads((run / "metrics.json").read_text())["results"]
    assert set(metrics) == {"psnr", "ssim", "lpips"} and np.isfinite(metrics["lpips"])
    records = [json.loads(line) for line in (run / "metrics_train.jsonl").read_text().splitlines()]
    assert [r["eval_lpips"] for r in records if "loss" not in r] == [metrics["lpips"]]
    out = t_evaluate.main(["--load-config", str(run / "config.json"), "--output-path",
                           str(tmp_path / "eval.json")])
    assert out["results"] == metrics
    rows = t_parse.find_and_parse_directories_containing_splatting_metrics(out_dir)
    assert len(rows) == 1 and rows[0]["lpips"] == metrics["lpips"]
    capsys.readouterr()
