"""The layer spans' reading (`perfbench/yardstick/spans.py`) and its readers on
a canned chrome trace: the innermost span wins; a backward kernel on
autograd's thread is reached through its `fwdbwd` flow; a kernel under a step
span alone, one under no span and one without a launch event are
unattributed; every new reader gives None on a trace without device events,
the span readers on one without `splat.*` spans, and the counters' readers
where the refine events lack the counters."""
from __future__ import annotations

import types

import pytest

from perfbench.run import load_reader
from perfbench.yardstick import spans

MAIN, AUTOGRAD_THREAD = 10, 20
SPAN_READERS = ("project_ms.train", "binning_ms.train", "fetch_ms.train", "loss_ms.train",
                "optimizer_ms.train", "host_enqueue_ms.train", "refine_ms.train",
                "unattributed_device.train")
COUNTER_READERS = ("binning_yield.train", "landed_entries.train")


def _host(name, ts, dur, tid=MAIN, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def _launch(corr, ts, tid=MAIN, name="cudaLaunchKernel", cat="cuda_runtime"):
    return dict(_host(name, ts, 1, tid, cat), args={"correlation": corr})


def _flow(ph, fid, ts, tid):
    e = {"ph": ph, "cat": "fwdbwd", "name": "fwdbwd", "id": fid, "ts": ts, "pid": 1, "tid": tid}
    return dict(e, bp="e") if ph == "f" else e


def _trace():
    """Host scopes and launches, and one device event a launch (each at its
    own time on the device, so busy time is their sum): {owner: us}."""
    host = [
        _host("splat.train_step", 0, 1000),
        _host("splat.composite", 100, 300),
        _host("splat.bin", 120, 80),
        _launch(1, 150), _launch(11, 130, name="cudaMemcpyAsync"),
        _launch(2, 250),                                     # composite, outside bin
        _host("splat.project", 500, 100),
        _host("aten::mm", 510, 10, cat="cpu_op"), _flow("s", 7, 510, MAIN),
        _launch(3, 515),
        _launch(4, 700),                                     # under the step span alone
        _host("splat.eval_camera_step", 1100, 200),
        _launch(5, 2000),                                    # under no span
        # autograd's thread: a backward op reached through its flow, a
        # hand-written backward with its own span, an op with no flow
        _host("autograd::engine::evaluate_function: MmBackward0", 800, 100, AUTOGRAD_THREAD,
              "cpu_op"),
        _host("MmBackward0", 801, 98, AUTOGRAD_THREAD, "cpu_op"),
        _flow("f", 7, 801, AUTOGRAD_THREAD),
        _launch(6, 850, AUTOGRAD_THREAD),
        _host("autograd::engine::evaluate_function: _CompositeBackward", 910, 80,
              AUTOGRAD_THREAD, "cpu_op"),
        _host("splat.composite", 911, 69, AUTOGRAD_THREAD),
        _launch(8, 950, AUTOGRAD_THREAD, name="cuLaunchKernel", cat="cuda_driver"),
        _host("autograd::engine::evaluate_function: torch::autograd::AccumulateGrad", 995, 4,
              AUTOGRAD_THREAD, "cpu_op"),
        _launch(9, 996, AUTOGRAD_THREAD),
        # the refine, with the probe's binning inside it
        _host("splat.refine", 3000, 500),
        _host("splat.bin", 3100, 100),
        _launch(12, 3150), _launch(13, 3300),
    ]
    durs = {1: (10, "splat.bin"), 11: (3, "splat.bin"), 2: (20, "splat.composite"),
            3: (30, "splat.project"), 4: (40, None), 5: (50, None), 6: (60, "splat.project"),
            8: (80, "splat.composite"), 9: (5, None), 99: (7, None), 12: (4, "splat.bin"),
            13: (6, "splat.refine")}
    device, t = [], 10_000
    for corr, (dur, _) in durs.items():
        cat = "gpu_memcpy" if corr == 11 else "kernel"
        device.append({"ph": "X", "cat": cat, "name": f"k{corr}", "ts": t, "dur": dur,
                       "pid": 0, "tid": 7, "args": {"correlation": corr}})
        t += dur + 5
    want = {}
    for dur, owner in durs.values():
        want[owner] = want.get(owner, 0) + dur
    return {"traceEvents": host + device}, want


def _ctx(trace, refines=()):
    return types.SimpleNamespace(trace=trace, traced={"steps": 2},
                                 window={"refines": list(refines)})


def test_each_device_event_goes_to_its_innermost_span():
    trace, want = _trace()
    got = spans.attribute(trace)
    assert got["events"] == 12 and got["launched"] == 11      # k99 has no launch
    assert got["us"] == pytest.approx(want)
    assert want[None] == 40 + 50 + 5 + 7


def test_the_readers_on_the_canned_trace():
    trace, want = _trace()
    refines = [{"step": 100, "binnings": 4, "binning_candidates": 4000, "binning_real": 600,
                "binning_landed": 500},
               {"step": 200, "binnings": 6, "binning_candidates": 6000, "binning_real": 400,
                "binning_landed": 300}]
    ctx = _ctx(trace, refines)
    got = {name: load_reader(name).read(ctx) for name in SPAN_READERS + COUNTER_READERS}
    busy = sum(want.values())
    assert got == pytest.approx({
        "project_ms.train": 90e-3 / 2, "binning_ms.train": 17e-3 / 2, "fetch_ms.train": 0.0,
        "loss_ms.train": 0.0, "optimizer_ms.train": 0.0,
        "host_enqueue_ms.train": (1000 + 200) * 1e-3 / 2, "refine_ms.train": 0.5,
        "unattributed_device.train": 100.0 * want[None] / busy,
        "binning_yield.train": 100.0 * 1000 / 10000, "landed_entries.train": 80e-6})


def test_no_device_events_no_reading():
    trace, _ = _trace()
    host_only = {"traceEvents": [e for e in trace["traceEvents"]
                                 if e["cat"] not in ("kernel", "gpu_memcpy")]}
    refines = [{"step": 100, "binnings": 4, "binning_candidates": 4000, "binning_real": 600,
                "binning_landed": 500}]
    ctx = _ctx(host_only, refines)
    for name in SPAN_READERS + COUNTER_READERS:
        assert load_reader(name).read(ctx) is None, name


def test_no_layer_spans_no_reading():
    """A program that opens no `splat.*` span: the span readers give None."""
    trace, _ = _trace()
    bare = {"traceEvents": [e for e in trace["traceEvents"]
                            if not e["name"].startswith(spans.PREFIX)]}
    ctx = _ctx(bare)
    for name in SPAN_READERS:
        assert load_reader(name).read(ctx) is None, name


def test_refine_events_without_counters_no_reading():
    """A program that does not count its binnings (refine events without the
    counters, or no refine in the window): the counters' readers give None."""
    trace, _ = _trace()
    for refines in ([], [{"step": 100, "n_culled": 3}]):
        ctx = _ctx(trace, refines)
        for name in COUNTER_READERS:
            assert load_reader(name).read(ctx) is None, name
