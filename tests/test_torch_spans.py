"""The port's layer spans, binning counters and step timer on the CPU
(`splat_tpu_torch/utils/profiling.py`).

- Outside a profiler `span` is one shared null context and builds no
  `record_function`.
- A small `Trainer.run` (48 px, 80 Gaussians, the flagship corrections, 3
  blur samples) that crosses a refine and eval-camera steps, under a
  CPU-only `torch.profiler`: every span of the training step appears, in its
  nesting.
- The binning counters: landed <= real <= candidates = binnings * N * M on
  every refine event, with one binning per anchor of each train and
  eval-camera step; a binning outside `Trainer.run` leaves them untouched;
  the history's rates are finite and appear from the first refine on.
- `StepTimer`: one entry per synchronised window, the windows tiling the run
  (on a scripted clock).
"""
import bisect
import json

import pytest
import torch

from splat_tpu_torch.cameras import optimizers as cam_opt
from splat_tpu_torch.data import dataparser, synthetic
from splat_tpu_torch.engine import trainer as tr
from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.ops import rasterize, tiling
from splat_tpu_torch.utils import profiling

MODEL = dict(blur_samples=3, blur_anchors=2, sh_degree=1, sh_degree_interval=50, tile_size=8,
             max_per_tile=128, max_tiles_per_gaussian=16, warmup_length=4, refine_every=6,
             reset_alpha_every=1000, background_color="black", gamma=2.2,
             densify_grad_thresh=0.003, cull_alpha_thresh=0.05,
             camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"),
             camera_velocity_optimizer=cam_opt.VelocityOptConfig(enabled=True),
             optimize_eval_cameras=True)
TRAINER = dict(max_steps=40, seed=0, eval_opt_every=4, log_every=2, sync_every=3)
STEPS = 14          # refines at 6 and 12; eval-camera steps at 0, 4, 8, 12
LAYERS = ("splat.project", "splat.bin", "splat.fetch", "splat.composite", "splat.loss",
          "splat.optimizer")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """MKL's threaded float32 exp costs milliseconds per small call here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    out = tmp_path_factory.mktemp("spans_scene")
    synthetic.generate_scene(out, n_gaussians=80, n_frames=17, img_size=48, exposure=0.08,
                             n_blur_samples=5, seed=3, eval_interval=8, gamma=2.2, device="cpu")
    return dataparser.parse_scene(out, dataparser.DataParserConfig(
        eval_mode="interval", eval_interval=8, orientation_method="none",
        center_method="none", auto_scale_poses=False))


def _trainer(scene):
    return tr.Trainer(scene, sf.SplatfactoConfig(**MODEL), tr.TrainerConfig(**TRAINER),
                      device="cpu")


@pytest.fixture(scope="module")
def profiled(scene, tmp_path_factory):
    """A trainer after STEPS steps under a CPU profiler, and the spans of
    the trace: {name: [(ts, end, tid)]} and the autograd ops' intervals."""
    t = _trainer(scene)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t.run(STEPS)
    path = tmp_path_factory.mktemp("spans_trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans, autograd = {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
        if e.get("cat") == "user_annotation" and e["name"].startswith("splat."):
            spans.setdefault(e["name"], []).append(iv)
        elif e["name"].startswith("autograd::engine::evaluate_function:"):
            autograd.append(iv)
    return t, spans, autograd


def _inside(iv, outer) -> bool:
    """Whether interval iv lies in one of `outer`, on the same thread."""
    return any(o[2] == iv[2] and o[0] <= iv[0] and iv[1] <= o[1] for o in outer)


def test_span_outside_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.span("splat.project"), profiling.span("splat.loss")
    assert a is b
    with a:
        pass
    monkeypatch.undo()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("splat.loss"), torch.profiler.record_function)


def test_trainer_run_emits_every_span(profiled):
    t, spans, _ = profiled
    assert [e["step"] for e in t.refine_events] == [6, 12]
    assert len(spans["splat.train_step"]) == STEPS
    assert len(spans["splat.eval_camera_step"]) == len(range(0, STEPS, 4))
    assert len(spans["splat.refine"]) == 2
    for name in LAYERS:
        assert spans.get(name), name


def test_spans_nest_as_the_layers_do(profiled):
    _, spans, autograd = profiled
    steps = spans["splat.train_step"] + spans["splat.eval_camera_step"]
    # the render's own: the projection inside a step; binning and fetch
    # inside the compositing that calls them (the fetch's backward span runs
    # inside autograd's evaluation, the probe's binning inside the refine)
    for iv in spans["splat.project"]:
        assert _inside(iv, steps)
    for name in ("splat.bin", "splat.fetch"):
        forward = [iv for iv in spans[name]
                   if not _inside(iv, autograd) and not _inside(iv, spans["splat.refine"])]
        assert forward and all(_inside(iv, spans["splat.composite"]) for iv in forward), name
    assert any(_inside(iv, spans["splat.refine"]) for iv in spans["splat.bin"])
    assert any(_inside(iv, autograd) for iv in spans["splat.composite"])
    assert any(_inside(iv, autograd) for iv in spans["splat.fetch"])
    for name in ("splat.loss", "splat.optimizer"):
        assert all(_inside(iv, steps) for iv in spans[name]), name
    # the refine runs between steps
    starts = sorted(iv[0] for iv in steps)
    for iv in spans["splat.refine"]:
        i = bisect.bisect_right(starts, iv[0])
        assert not _inside(iv, steps) and (i == len(starts) or iv[1] <= starts[i])


def test_binning_counters_on_refine_events(profiled):
    t, _, _ = profiled
    m = 1
    for s in tiling._spans(t.model_config.tile_size, t.model_config.max_tiles_per_gaussian):
        m *= s
    cap = t.params.gaussians.alive.shape[0]
    evals = {s for s in range(STEPS) if s % TRAINER["eval_opt_every"] == 0}
    start = 0
    for e in t.refine_events:
        steps = range(start, e["step"])
        # one binning per anchor of every train step and eval-camera step
        assert e["binnings"] == MODEL["blur_anchors"] * (len(steps) + len(evals & set(steps)))
        assert e["binning_candidates"] == e["binnings"] * cap * m
        assert 0 < e["binning_landed"] <= e["binning_real"] <= e["binning_candidates"]
        start = e["step"]


def test_history_carries_finite_binning_rates_after_the_first_refine(profiled):
    t, _, _ = profiled
    first = t.refine_events[0]["step"]
    for rec in t.history:
        assert all(isinstance(v, (int, float)) and v == v and abs(v) < float("inf")
                   for v in rec.values()), rec
        has = {"binning_yield", "landed_per_binning"} <= set(rec)
        assert has == (rec["step"] >= first), rec
    ev, rec = t.refine_events[0], next(r for r in t.history if r["step"] == first)
    assert rec["binning_yield"] == round(ev["binning_real"] / ev["binning_candidates"], 6)
    assert rec["landed_per_binning"] == round(ev["binning_landed"] / ev["binnings"], 1)


def test_a_binning_outside_run_is_not_counted(scene):
    t = _trainer(scene)
    t.run(2)
    before = t.binning_counters.read()
    assert before["binnings"] == 3 * MODEL["blur_anchors"]      # 2 steps, 1 eval-camera step
    cfg = t.model_config
    with torch.no_grad():
        t.render_eval(0)
        sf.binning_counts(t.params, t.train_cams[0], cfg)
        motion = sf.camera_motion(t.params, t.train_cams[0], cfg)
        proj, _ = sf.subframe_inputs(t.params, motion, cfg, 0, motion.eps[0])
        rasterize.bin_tiles(proj, torch.sigmoid(t.params.gaussians.opacities_logit),
                            t.train_cams.width, t.train_cams.height, motion.eps,
                            motion.rs_time, cfg.tile_size, cfg.max_per_tile)
    assert t.binning_counters.read() == before
    assert profiling.active_counters() is None


def test_counters_fold_and_take():
    c = profiling.BinningCounters()
    real = [torch.tensor(v, dtype=torch.int32) for v in (5, 0, 9)]
    counts = [torch.tensor(v, dtype=torch.int32) for v in ([1, 2], [0, 0], [4, 4])]
    for _ in range(c.FOLD):              # past one fold
        for r, k in zip(real, counts):
            c.add(10, r, k)
    n = 3 * c.FOLD
    want = {"binnings": n, "candidates": 10 * n, "real": 14 * c.FOLD, "landed": 11 * c.FOLD}
    assert c.read() == want and c.take() == want
    assert c.read() == {"binnings": 0, "candidates": 0, "real": 0, "landed": 0}
    c.restore(want)
    c.add(10, real[0], counts[0])
    assert c.read() == {"binnings": n + 1, "candidates": 10 * (n + 1),
                        "real": 14 * c.FOLD + 5, "landed": 11 * c.FOLD + 3}


def test_step_timer_windows_tile_the_run(monkeypatch):
    clock = iter(float(i) for i in range(100))
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer()
    # a run of 5 steps synchronised after steps 2 and 5, work between steps
    timer.start(fresh=True)               # t = 0
    for i in range(5):
        timer.start()                     # open: no clock read
        timer.stop(sync=i in (1, 4))      # t = 1 after step 2, t = 2 after step 5
    timer.finish()                        # t = 3: the tail joins the last window
    assert timer.windows == [(1.0, 2), (2.0, 3)]
    s = timer.summary()
    assert s["steps_per_s"] == pytest.approx(5 / 3) and s["step_ms_mean"] == pytest.approx(600)
    assert s["step_ms_p50"] == pytest.approx(2000 / 3)
    assert timer.summary(last_n=3) == {"step_ms_mean": pytest.approx(2000 / 3),
                                       "step_ms_p50": pytest.approx(2000 / 3),
                                       "step_ms_p95": pytest.approx(2000 / 3),
                                       "steps_per_s": pytest.approx(1.5)}
    # a new run starts a fresh chain: the time between runs is in no window
    timer.start(fresh=True)               # t = 4
    timer.stop(sync=True)                 # t = 5
    assert timer.windows[-1] == (1.0, 1)
    # a log record's wait closes a window that holds a step, and only then
    timer.start()
    timer.stop()
    timer.lap()                           # t = 6
    timer.lap()
    assert timer.windows[-2:] == [(1.0, 1), (1.0, 1)] and len(timer.windows) == 4


def test_trainer_step_times_agree_with_wall_time(scene):
    t = tr.Trainer(scene, sf.SplatfactoConfig(**MODEL),
                   tr.TrainerConfig(**{**TRAINER, "log_every": 100}), device="cpu")
    t.run(7)
    # synchronised after steps 3 and 6 (sync_every) and at the run's last step
    assert [k for _, k in t.timer.windows] == [3, 3, 1]
    (rec,) = t.history
    total = sum(sec for sec, _ in t.timer.windows)
    assert 0.9 * rec["wall_s"] <= total <= rec["wall_s"]
    assert rec["steps_per_s"] == pytest.approx(7 / total)
    assert rec["step_ms_mean"] == pytest.approx(total / 7 * 1e3)
