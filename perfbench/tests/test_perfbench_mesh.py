"""The four-card cell's pieces on the CPU: its three readers
(`exchange_ms.mesh4`, `exchange_link_roofline.mesh4`, `slab_imbalance.mesh4`)
on a canned trace with known values, and None where there is nothing to
read; the blocked reference (`perfbench/reference/blocked.py`) against the
whole one; and a tiny run of the cell on four gloo ranks, traced."""
from __future__ import annotations

import math
import types

import pytest
import torch

from perfbench.run import load_reader
from perfbench.tests import tiny
from perfbench.yardstick import links

MAIN = 10
CELL = "phone_mbrs_xl.mesh4"
READERS = ("exchange_ms.mesh4", "exchange_link_roofline.mesh4", "slab_imbalance.mesh4")


def _host(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": MAIN}


def _launch(corr, ts):
    return dict(_host("cudaLaunchKernel", ts, 1, "cuda_runtime"), args={"correlation": corr})


def _kernel(corr, name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


def _trace():
    """Two steps: in each, a slab trade and a merge under `splat.exchange`
    (NCCL kernels of 400 and 600 us), a composite kernel of 1000 us and a
    loss all-reduce of 100 us under the step span alone."""
    events = []
    for step, t0 in enumerate((0, 10_000)):
        c = 10 * step
        events += [_host("splat.train_step", t0, 5000),
                   _host("splat.exchange", t0 + 100, 200), _launch(c + 1, t0 + 150),
                   _host("splat.composite", t0 + 400, 200), _launch(c + 2, t0 + 450),
                   _host("splat.exchange", t0 + 700, 200), _launch(c + 3, t0 + 750),
                   _launch(c + 4, t0 + 950),
                   _kernel(c + 1, "ncclDevKernel_SendRecv", t0 + 20_000, 400),
                   _kernel(c + 2, "rasterize_fwd_kernel", t0 + 20_500, 1000),
                   _kernel(c + 3, "ncclDevKernel_AllGather_RING_LL", t0 + 21_600, 600),
                   _kernel(c + 4, "ncclDevKernel_AllReduce_Sum_f32", t0 + 22_300, 100)]
    return {"traceEvents": events}


INFO = {"mesh": {"data": 1, "gauss": 4, "blur": 1, "tile": 1}, "eval_opt": True,
        "eval_opt_every": 5, "blur_samples": 5, "width": 32, "height": 24,
        "replicated_floats": 1000, "eval_floats": 100}
SLAB = {"trades": 5, "rows": 3000, "sent": 2000, "dropped": 0, "fullest": 5.5}


def _ctx(trace=None, slab=SLAB, info=INFO):
    # steps 7191 and 7192: no eval-camera step among them
    return types.SimpleNamespace(trace=trace if trace is not None else _trace(), info=info,
                                 traced={"steps": 2, "start": 7191, "slab": slab},
                                 window={"refines": []})


def test_readers_give_known_values():
    ctx = _ctx()
    assert math.isclose(load_reader("exchange_ms.mesh4").read(ctx), (400 + 600) * 1e-3)
    assert math.isclose(load_reader("slab_imbalance.mesh4").read(ctx), 1.1)
    # 5000 rows of 72 bytes; 2 renders x 2 x 3 other slabs x 5 samples x 32 x 24
    # x 4 floats x 4 bytes; 2 steps x 1000 floats x 2 x 3 / 4 x 4 bytes
    moved = 5000 * 72 + 2 * 2 * 3 * 5 * 32 * 24 * 16 + 2 * 1000 * 1.5 * 4
    assert math.isclose(links.exchange_bytes(ctx), moved)
    seconds = 2 * (400 + 600 + 100) * 1e-6
    want = 100.0 * moved / (seconds * 450e9)
    assert math.isclose(load_reader("exchange_link_roofline.mesh4").read(ctx), want)
    assert 0 < want < 100


def test_an_eval_camera_step_adds_a_merge_and_its_leaves():
    ctx = _ctx()
    ctx.traced["start"] = 7194                      # steps 7194 and 7195: one eval step
    base = links.exchange_bytes(_ctx())
    extra = 2 * 3 * 5 * 32 * 24 * 16 + 100 * 1.5 * 4
    assert math.isclose(links.exchange_bytes(ctx), base + extra)


def test_readers_read_nothing_where_nothing_is_there():
    no_device = {"traceEvents": [e for e in _trace()["traceEvents"] if e["cat"] != "kernel"]}
    for name in ("exchange_ms.mesh4", "exchange_link_roofline.mesh4"):
        assert load_reader(name).read(_ctx(trace=no_device)) is None
    for name in ("exchange_link_roofline.mesh4", "slab_imbalance.mesh4"):
        assert load_reader(name).read(_ctx(slab=None)) is None
    assert load_reader("exchange_link_roofline.mesh4").read(_ctx(info={})) is None


def test_blocked_reference_is_the_whole_reference(monkeypatch):
    from perfbench.reference import blocked
    from perfbench.traffic import train, train_mesh

    torch.set_num_threads(2)
    _, config, mix = tiny.tiny_cell(CELL)
    dev = torch.device("cpu")
    whole = train.reference_run(config, mix, 7, dev)
    monkeypatch.setattr(blocked, "BLOCK", 60)       # 256 slots in 5 blocks
    got = train_mesh.reference_run(config, mix, 7, dev)
    assert got["k"] == whole["k"]
    checks = train.compare(got, whole)
    assert checks["loss"] < 1e-6 and checks["grad"] < 1e-5 and checks["change"] < 1e-6, checks


@pytest.fixture(scope="module")
def traced_run():
    from perfbench import run

    torch.set_num_threads(2)
    cell, config, mix = tiny.tiny_cell(CELL)
    # start 6998, 3 checked steps, chunks of 2: the stretch at the first chunk
    mix.update(warmup_steps=0, trace_phase=2, trace_steps=4)
    return run.run_cell(CELL, 2147483901, 0.2, True, device="cpu", cell=cell, config=config,
                        mix=mix)


def test_tiny_mesh_run_is_correct_and_reads_its_slabs(traced_run):
    out, lines = traced_run
    assert out["correct"], lines
    assert out["checks"]["slab_dropped"]["value"] == 0
    assert out["attempted"] >= 4 and out["failed"] == 0
    # the CPU trace has no device events: only the counter's reader reads
    assert set(out["metrics"]) & set(READERS) == {"slab_imbalance.mesh4"}
    assert out["metrics"]["slab_imbalance.mesh4"]["value"] >= 1.0
    assert '"mesh": {"data": 1, "gauss": 4, "blur": 1, "tile": 1}' in lines[0]
