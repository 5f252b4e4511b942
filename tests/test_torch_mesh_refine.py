"""The refine block on a gauss-sharded mesh, the slab counters and the mesh
step's freedom from host waits, on the CPU (gloo ranks, one thread each).

* The shard-local refine (`sharding.refine_shard` through
  `Trainer._refine_boundary`) against the same block on one device over the
  gathered state: parameters, Adam's moments and step counts, the
  densification accumulators, the refine's counts, the growth and the
  adapted tile capacity, all bitwise. Two states on every mesh shape of
  `tests/test_torch_sharding.py`: one whose candidates outnumber the dead
  slots (they run out inside a shard, and most new rows land on another
  shard) and which grows, adapts its tile capacity and resets the
  opacities; one with room for every candidate.
* The mesh's train and eval-camera steps on a depth-slab mesh call nothing
  that waits for a CUDA device: no read of a tensor on the host, no
  host-to-device `torch.tensor`, no operation whose output size depends on
  the data (`nonzero`, `bincount`, boolean-mask indexing). Adam's step
  counts are host tensors on CUDA too, so reads inside `torch.optim` are
  not waits, nor are those of the kernels' CPU stand-ins (`*_plain`).
* The slab counters on a hand-made partition of depths over two ranks.
* Under a profiler, `splat.exchange` holds every forward exchange of the
  slab mesh's steps and refine (the slab trade, the slabs' merge, the
  gradients' sum, the refine's counts and rows), and `splat.refine` holds
  the refine's.
"""
import json
import math
import os
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from splat_tpu_torch.cameras import optimizers as cam_opt
from splat_tpu_torch.engine import trainer as ttr
from splat_tpu_torch.models import splatfacto as sf
from splat_tpu_torch.models.convert import scene_from_numpy
from splat_tpu_torch.parallel import launch, sharding
from splat_tpu_torch.utils import profiling

IMG = 32
CAPACITY = 1024


def tiny_tree(seed: int = 0) -> dict:
    """Two train cameras and one eval camera looking at a cloud of 64
    points, 32 x 32 frames of noise."""
    rng = np.random.default_rng(seed)

    def cams(n, z0):
        return dict(R_c2w=np.repeat(np.eye(3)[None], n, 0),
                    p_c2w=[[0.1 * i, 0.0, z0] for i in range(n)],
                    fx=[IMG * 1.2] * n, fy=[IMG * 1.2] * n, cx=[IMG / 2] * n, cy=[IMG / 2] * n,
                    width=IMG, height=IMG, lin_vel=[[0.3, 0.1, 0.0]] * n,
                    ang_vel=[[0.0, 0.05, 0.02]] * n, exposure_time=[0.1] * n,
                    rolling_shutter_time=[0.02] * n)

    return dict(train_cameras=cams(2, -4.0), eval_cameras=cams(1, -4.2),
                train_images=rng.uniform(size=(2, IMG, IMG, 3)).astype(np.float32),
                eval_images=rng.uniform(size=(1, IMG, IMG, 3)).astype(np.float32),
                points_xyz=(rng.normal(size=(64, 3)) * 0.5).astype(np.float32),
                points_rgb=rng.integers(0, 255, size=(64, 3)).astype(np.uint8))


def model_config(**kw) -> sf.SplatfactoConfig:
    base = dict(camera_optimizer=cam_opt.CameraOptConfig(mode="SO3xR3"),
                camera_velocity_optimizer=cam_opt.VelocityOptConfig(enabled=True),
                optimize_eval_cameras=True, blur_samples=4, sh_degree=1, tile_size=8,
                max_per_tile=4, max_tiles_per_gaussian=16, warmup_length=5, refine_every=10,
                reset_alpha_every=3, stop_split_at=10**6, background_color="black",
                densify_grad_thresh=2e-4, cull_alpha_thresh=0.1, initial_capacity=CAPACITY,
                gauss_shard_mode="slab")
    base.update(kw)
    return sf.SplatfactoConfig(**base)


def global_state(variant: str, seed: int = 5) -> dict:
    """A resumed state over the whole capacity: the Gaussians (alive slots
    dense at the front, sparse at the back, so the dead slots lie mostly in
    the last shards), the accumulators and Adam's moments."""
    rng = np.random.default_rng(seed)
    c = CAPACITY
    alive = (rng.uniform(size=c) < np.where(np.arange(c) < c // 2, 0.97, 0.55)).astype(np.float32)
    high = 0.5 if variant == "runout" else 0.15
    g = {"means": rng.normal(size=(c, 3)) * 0.5,
         "scales_log": rng.uniform(-4.5, -2.0, size=(c, 3)),
         "quats": rng.normal(size=(c, 4)),
         "opacities_logit": rng.normal(size=c) * 2.0,
         "features_dc": rng.normal(size=(c, 3)),
         "features_rest": rng.normal(size=(c, 3, 3)) * 0.1,
         "alive": alive}
    s = {"grad_accum": np.where(rng.uniform(size=c) < high, 1e-2, 1e-6) * 5,
         "grad_count": np.full(c, 5, np.int32)}
    m = {f: (rng.normal(size=g[f].shape) * 1e-3, rng.uniform(size=g[f].shape) * 1e-6)
         for f in g if f != "alive"}
    return {"g": {k: np.asarray(v, np.float32) for k, v in g.items()},
            "s": s, "m": {k: tuple(np.asarray(a, np.float32) for a in v) for k, v in m.items()}}


def make_trainer(variant: str, mesh=None) -> ttr.Trainer:
    scene, tr_imgs, ev_imgs = scene_from_numpy(tiny_tree(), device="cpu")
    grow = 0.7 if variant == "runout" else 0.99
    tc = ttr.TrainerConfig(max_steps=10**4, seed=3, grow_threshold=grow,
                           max_capacity=4 * CAPACITY, max_tile_capacity=64)
    t = ttr.Trainer(scene, model_config(), tc, train_images=tr_imgs, eval_images=ev_imgs,
                    device="cpu", mesh=mesh)
    st = global_state(variant)
    with t.global_view(), torch.no_grad():
        g = t.params.gaussians
        for f in sf.GaussianParams._fields:
            getattr(g, f).copy_(torch.from_numpy(st["g"][f]))
        t.strat_state = t.strat_state._replace(
            grad_accum=torch.from_numpy(st["s"]["grad_accum"]).float(),
            grad_count=torch.from_numpy(st["s"]["grad_count"]))
        for f, (m1, m2) in st["m"].items():
            t.optimizer.adam.state[getattr(g, f)] = {
                "step": torch.tensor(7.0), "exp_avg": torch.from_numpy(m1.copy()),
                "exp_avg_sq": torch.from_numpy(m2.copy())}
    t.step = 30 if variant == "runout" else 40          # refine 3: a reset
    t._probe_cam = t.train_cams[0]
    t._overflow_streak = 1
    return t


def snapshot(t: ttr.Trainer, event: dict) -> dict:
    """The whole state after the refine (gathered on a mesh), as arrays."""
    out = {f"event.{k}": np.asarray(v) for k, v in event.items() if not k.startswith(
        ("slab_", "refine_rows"))}
    out["max_per_tile"] = np.asarray(t.model_config.max_per_tile)
    with t.global_view():
        g = t.params.gaussians
        for f in sf.GaussianParams._fields:
            out[f"g.{f}"] = getattr(g, f).detach().numpy().copy()
            st = t.optimizer.adam.state.get(getattr(g, f))
            if st:
                out[f"m1.{f}"] = st["exp_avg"].numpy().copy()
                out[f"m2.{f}"] = st["exp_avg_sq"].numpy().copy()
                out[f"step.{f}"] = st["step"].numpy().copy()
        out["grad_accum"] = t.strat_state.grad_accum.numpy().copy()
        out["grad_count"] = t.strat_state.grad_count.numpy().copy()
    return out


# ------------------------------------------------------- the no-wait check
WAITS = {"item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__", "__index__",
         "nonzero", "bincount", "unique", "masked_select"}
HOST_COPIES = ("tensor", "as_tensor")      # from host data; a tensor argument stays put
# whose backward reads on the host whether a factor is zero
BACKWARD_WAITS = ("prod", "cumprod")


class NoHostWaits(torch.overrides.TorchFunctionMode):
    """Raises on any call that waits for a CUDA device on the card (a read to
    the host, a host-to-device `torch.tensor`, an output sized by the data,
    a boolean-mask index, a product whose backward checks for zeros),
    outside `torch.optim` and the kernels' plain versions (`*_plain`: what
    runs there on the card is the kernel)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        bool_index = name in ("__getitem__", "__setitem__") and any(
            isinstance(a, torch.Tensor) and a.dtype == torch.bool
            for a in (args[1] if isinstance(args[1], tuple) else (args[1],)))
        from_host = name in HOST_COPIES and not isinstance(args[0], torch.Tensor)
        from_host |= name in BACKWARD_WAITS and args[0].requires_grad
        exempt = any(f"{os.sep}torch{os.sep}optim{os.sep}" in fr.filename
                     or fr.name.endswith("_plain") for fr in traceback.extract_stack())
        if (name in WAITS or from_host or bool_index) and not exempt:
            raise AssertionError(f"the mesh step waits for the device: {name}")
        return func(*args, **kwargs)


def _step_case(mesh, case):
    t = make_trainer("roomy", mesh)
    t.step = 7
    cam, gt = t.train_cams[0], torch.as_tensor(t.train_images.images[0])
    for _ in range(2):          # the second step runs with Adam's state in place
        with NoHostWaits():
            sharding.sharded_train_step(mesh, t.params, t.optimizer, t.strat_state,
                                        t.model_config, cam, gt, t.step)
    with NoHostWaits():
        sharding.sharded_eval_opt_step(mesh, t.params, t.eval_optimizer, t.model_config,
                                       t.eval_cams[0], t._eval_imgs_dev[0], t.step)
    return {"ok": np.asarray(True)}


def _refine_case(mesh, case):
    t = make_trainer(case["variant"], mesh)
    event = t._refine_boundary(reset_pause=0)
    out = snapshot(t, event)
    if mesh.rank == 0:
        single = make_trainer(case["variant"])
        for k, v in snapshot(single, single._refine_boundary(reset_pause=0)).items():
            out[f"single.{k}"] = v
        if mesh.shape["gauss"] > 1:
            out["moved"] = np.asarray(event["refine_rows_moved"])
    return out


def _slab_counter_case(mesh, case):
    """Rank r holds depths r, r + 2, r + 4, ... (10 rows each, 2 of them
    dead): the global histogram puts depths 0-9 in slab 0 and 10-19 in slab
    1, so each rank keeps 4 live rows and trades 4."""
    r = mesh.coords["gauss"]
    depth = torch.arange(r, 20, 2, dtype=torch.float32)
    live = torch.ones(10, dtype=torch.bool)
    live[[1, 7]] = False
    rows = torch.zeros((10, 18))
    rows[:, 9] = depth
    rows[:, 8] = live.float()
    proj = sharding.projection.ProjectedGaussians(
        means2d=rows[:, 0:2], depths=depth, conics=rows[:, 2:5], radii=rows[:, 0],
        compensations=torch.ones(10), pix_vels=rows[:, 10:12], valid=live,
        extents=rows[:, 16:18])
    counters = profiling.SlabCounters()
    with profiling.counting(None, counters):
        sharding._depth_slab_exchange(proj, torch.zeros((10, 3)), live.float(),
                                      mesh.axes["gauss"], slack=0.4)
    return {k: np.asarray(v) for k, v in counters.take().items()}


def _spans_case(mesh, case):
    """Two steps across a refine (which has room for its candidates, so it
    grows nothing) under a CPU profiler: rank 0's collectives and spans."""
    t = make_trainer("roomy", mesh)
    t.step = 39
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t.run(2)
    path = Path(case["out"]) / f"trace{mesh.rank}.json"
    prof.export_chrome_trace(str(path))
    events = [{k: e[k] for k in ("name", "ts", "dur", "tid")}
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and (e["name"].startswith(("c10d::", "splat."))
                                         or "Backward" in e["name"])]
    return {"events": np.asarray(json.dumps(events))}


CASE_FNS = {"refine": _refine_case, "steps": _step_case, "slab_counters": _slab_counter_case,
            "spans": _spans_case}
VARIANTS = ("runout", "roomy")


def run_cases(rank, world, device, cases, out_dir):
    torch.set_num_threads(1)
    for case in cases:
        mesh = sharding.make_mesh(case["shape"])
        res = CASE_FNS[case["kind"]](mesh, {**case, "out": out_dir})
        if rank == 0:
            np.savez(Path(out_dir) / f"{case['id']}.npz", **res)


def _spawn(tmp_path_factory, world, cases):
    out = tmp_path_factory.mktemp(f"mesh_refine{world}")
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        launch.launch(run_cases, world, args=(cases, str(out)), device="cpu")
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return {c["id"]: dict(np.load(out / f"{c['id']}.npz")) for c in cases}


def _refines(shape_id, shape):
    return [{"id": f"{shape_id}_{v}", "kind": "refine", "shape": shape, "variant": v}
            for v in VARIANTS]


SHAPES = {2: {"g2": {"gauss": 2}},
          4: {"g4": {"gauss": 4}, "g2b2": {"gauss": 2, "blur": 2},
              "g2t2": {"gauss": 2, "tile": 2}, "d2t2": {"data": 2, "tile": 2},
              "b2t2": {"blur": 2, "tile": 2}},
          8: {"g2b2t2": {"gauss": 2, "blur": 2, "tile": 2}}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    extra = {2: [{"id": "slab_counters", "kind": "slab_counters", "shape": {"gauss": 2}},
                 {"id": "spans", "kind": "spans", "shape": {"gauss": 2}}],
             4: [{"id": "steps_g4", "kind": "steps", "shape": {"gauss": 4}},
                 {"id": "steps_g2t2", "kind": "steps", "shape": {"gauss": 2, "tile": 2}}],
             8: []}
    out = {}
    for world, shapes in SHAPES.items():
        cases = [c for sid, shape in shapes.items() for c in _refines(sid, shape)]
        out.update(_spawn(tmp_path_factory, world, cases + extra[world]))
    return out


REFINE_CASES = [(sid, v) for shapes in SHAPES.values() for sid in shapes for v in VARIANTS]


@pytest.mark.parametrize("sid,variant", REFINE_CASES,
                         ids=[f"{s}-{v}" for s, v in REFINE_CASES])
def test_shard_refine_is_the_gathered_refine_bitwise(worlds, sid, variant):
    got = worlds[f"{sid}_{variant}"]
    mesh_keys = sorted(k for k in got if not k.startswith("single.") and k != "moved")
    assert sorted(k[len("single."):] for k in got if k.startswith("single.")) == mesh_keys
    for k in mesh_keys:
        assert got[k].dtype == got[f"single.{k}"].dtype, k
        assert np.array_equal(got[k], got[f"single.{k}"]), k
    if variant == "runout":
        # the dead slots ran out, the capacity grew, the tile capacity and the
        # opacities moved, so every branch of the block ran
        assert int(got["event.n_split"]) + int(got["event.n_cloned"]) > 0
        assert bool(got["event.grew"]) and bool(got["event.adapted"]) and bool(got["event.reset"])
        assert got["g.alive"].shape[0] == 2 * CAPACITY
    if "moved" in got:
        assert int(got["moved"]) > 0           # new rows landed on another shard


def test_shard_refine_runs_out_of_dead_slots_inside_a_shard():
    """The run-out state's candidates pass the dead slots, whose last one
    lies inside a shard (not at a shard's end), on the 2- and 4-way axes."""
    st = global_state("runout")
    alive = st["g"]["alive"] > 0.5
    assert np.sum(st["s"]["grad_accum"] / 5 > 2e-4) > np.sum(~alive)
    for n in (2, 4):
        c = CAPACITY // n
        dead = np.flatnonzero(~alive)
        assert dead[-1] % c != c - 1


def test_mesh_steps_wait_for_nothing(worlds):
    assert bool(worlds["steps_g4"]["ok"]) and bool(worlds["steps_g2t2"]["ok"])


def test_no_host_waits_mode_catches_a_read():
    with pytest.raises(AssertionError, match="item"):
        with NoHostWaits():
            torch.ones(3).sum().item()
    with pytest.raises(AssertionError, match="__getitem__"):
        with NoHostWaits():
            torch.ones(3)[torch.ones(3) > 0]


def test_slab_counters_are_exact_on_a_hand_made_partition(worlds):
    got = worlds["slab_counters"]
    # slack 0.4 gives buckets of 8 rows (the least), so nothing is dropped;
    # rank 0's live depths 0 4 6 8 10 12 16 18 (2 and 14 dead): 4 to slab 0
    # (its own) and 4 to slab 1; it receives rank 1's 4 live rows below 10
    assert int(got["trades"]) == 1
    assert int(got["rows"]) == 4 and int(got["sent"]) == 4 and int(got["dropped"]) == 0
    assert math.isclose(float(got["fullest"]), 1.0)


def _within(e, spans):
    return any(s["tid"] == e["tid"] and s["ts"] <= e["ts"] <= s["ts"] + s["dur"] for s in spans)


def test_exchange_and_refine_spans_hold_the_exchanges(worlds):
    events = json.loads(str(worlds["spans"]["events"]))
    spans = {n: [e for e in events if e["name"] == n]
             for n in ("splat.exchange", "splat.refine", "splat.train_step")}
    backward = [e for e in events if "Backward" in e["name"]]
    comms = [e for e in events if e["name"].startswith("c10d::") and not _within(e, backward)]
    trades = [e for e in comms if e["name"] == "c10d::alltoall_base_"]
    gathers = [e for e in comms if e["name"] == "c10d::allgather_"]
    # each render (two train steps, an eval-camera step) trades and merges
    # once an anchor; the refine gathers its counts and trades its rows once
    assert len(trades) >= 4 and len(gathers) >= 4
    assert all(_within(e, spans["splat.exchange"]) for e in trades + gathers)
    in_refine = [e["name"] for e in trades + gathers if _within(e, spans["splat.refine"])]
    assert sorted(in_refine) == ["c10d::allgather_", "c10d::alltoall_base_"]
    sums = [e for e in comms if e["name"] == "c10d::allreduce_"
            and _within(e, spans["splat.exchange"]) and _within(e, spans["splat.train_step"])]
    assert len(sums) >= 2           # the gradients' sum of each step, among the slabs' own

