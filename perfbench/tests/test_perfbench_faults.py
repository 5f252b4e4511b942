"""`correct` comes out false when the timed path is broken underneath: a run
of each cell at a tiny size on the CPU (the harness's look for a chip
skipped, the program's plain route), with one fault planted in the program
for the run, against the cell's own limits. A sound run comes out true.

The faults a cell can have: a training step that returns its state
unchanged; half of the batch (the image's rows) left out of the loss, the
mean taken over the rest; a frame altered where it is produced. The cells
run on one chip, so no exchange between chips can be left out."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from .tiny import run_tiny


def test_sound_training_run_is_correct():
    out, _ = run_tiny("synth_mb.train")
    assert out["correct"] is True, out["checks"]


def test_training_step_that_leaves_the_state_unchanged(monkeypatch):
    from splat_tpu_torch.engine import trainer as tm

    monkeypatch.setattr(tm.Optimizer, "step", lambda self: self.schedule.step())
    out, _ = run_tiny("synth_mb.train")
    assert out["correct"] is False
    assert out["checks"]["change"]["value"] > out["checks"]["change"]["limit"]


def test_sound_training_run_with_an_eval_camera_step_is_correct():
    """phone_mbrs.train's checked steps hold the refine and an eval-camera
    step, which the reference follows."""
    out, _ = run_tiny("phone_mbrs.train")
    assert out["correct"] is True, out["checks"]


def test_eval_camera_step_that_leaves_the_state_unchanged(monkeypatch):
    from splat_tpu_torch.engine import trainer as tm

    monkeypatch.setattr(tm, "eval_opt_step", lambda *a, **k: torch.zeros(()))
    out, _ = run_tiny("phone_mbrs.train")
    assert out["correct"] is False
    assert out["checks"]["grad"]["value"] > out["checks"]["grad"]["limit"]


def test_loss_over_half_of_the_batch(monkeypatch):
    from splat_tpu_torch.models import splatfacto as sf

    full = sf.compute_losses

    def half(pred, gt, params, config):
        h = pred.shape[0] // 2
        return full(pred[:h], gt[:h], params, config)

    monkeypatch.setattr(sf, "compute_losses", half)
    out, _ = run_tiny("phone_mbrs.train")
    assert out["correct"] is False
    assert out["checks"]["loss"]["value"] > out["checks"]["loss"]["limit"]


def test_sound_view_run_is_correct():
    out, _ = run_tiny("phone_mbrs.view")
    assert out["correct"] is True, out["checks"]


def test_frame_altered_where_it_is_produced(monkeypatch):
    from splat_tpu_torch.cli import render_video as rv

    real = rv.render_frame

    def altered(*args, **kw):
        img = real(*args, **kw)
        img[img.shape[0] // 2, img.shape[1] // 3] = 1.0 - img[img.shape[0] // 2, img.shape[1] // 3]
        return img

    monkeypatch.setattr(rv, "render_frame", altered)
    out, _ = run_tiny("phone_mbrs.view")
    assert out["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["phone_mbrs.train", "phone_mbrs.view"])
def test_control_fails_on_the_card(cell):
    """The control, the reference computed with TF32 matrix products and
    convolutions in the program's place, fails the cell's limits at a size a
    test run holds (the readings at the cells' own sizes are in PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32, which the CPU has not")
    from perfbench.tests.tiny import tiny_cell
    from perfbench.traffic import train as tt
    from perfbench.traffic import view as tv

    cell, config, mix = tiny_cell(cell)
    sc = config["scene"]
    sc.update(width=320, height=240, fx=240.0, fy=240.0, cx=160.0, cy=120.0, capacity=16384,
              alive=12288)
    dev = torch.device("cuda")
    failed = []
    for seed in (11, 12, 13):
        if mix["kind"] == "train":
            ref = tt.reference_run(config, mix, seed, dev)
            ctl = tt.reference_run(config, mix, seed, dev, tf32=True)
            checks = tt.compare(ctl, ref)
        else:
            idx = tv.check_indices(mix, seed)
            checks = tv.compare(tv.reference_frames(config, mix, seed, dev, idx, tf32=True),
                                tv.reference_frames(config, mix, seed, dev, idx))
        failed.append(any(v > cell["limits"][k] for k, v in checks.items()))
    assert all(failed), failed
    assert np.isfinite(list(checks.values())).all()
