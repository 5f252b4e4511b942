"""The device's time by the program's layer spans in a `torch.profiler` chrome
trace: the benchmark's own reading of the `splat.*` spans the port opens
(`splat_tpu_torch/utils/profiling.py:span`). It imports nothing of the
program.

The rule. A device event (a kernel, copy or fill) belongs to the innermost
`splat.*` span that holds its launch on the same host thread; the launch is
the `cuda_runtime` or `cuda_driver` event with the same `correlation`. Where
the innermost holder is an autograd evaluation (`autograd::engine::
evaluate_function: ...`, on autograd's own thread), the trace's `fwdbwd`
flow leads from the backward op inside it to its forward op, and the event
belongs to the innermost `splat.*` span that holds the forward op. An event
whose owner is a step span (`splat.train_step`, `splat.eval_camera_step`), or
that nothing holds, or that has no launch event, is unattributed.
"""
from __future__ import annotations

import bisect
import collections

from . import trace as yt

PREFIX = "splat."
STEP_SPANS = ("splat.train_step", "splat.eval_camera_step")
AUTOGRAD = "autograd::engine::evaluate_function:"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def _innermost(intervals, points) -> dict:
    """For each point (t, key), the innermost of `intervals` (start, end,
    ...) that holds t, or None. The intervals are one thread's scopes, so
    each two are disjoint or nested."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points, key=lambda p: p[0]):
        while i < len(intervals) and intervals[i][0] <= t:
            iv = intervals[i]
            i += 1
            while stack and stack[-1][1] < iv[0]:
                stack.pop()
            stack.append(iv)
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1] if stack else None
    return out


def attribute(trace: dict) -> dict:
    """{"us": {owner: device microseconds}, "events": the device events,
    "launched": those that found their launch event}. owner is a span's name
    or None (unattributed)."""
    device, launch = [], {}
    holders = collections.defaultdict(list)      # thread -> [(start, end, name)]
    flow_start, flow_end = {}, collections.defaultdict(list)
    for e in yt.kernel_events(trace, yt.DEVICE_CATEGORIES):
        device.append((float(e["dur"]), e.get("args", {}).get("correlation")))
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    for e in events:
        cat, thread = e.get("cat"), (e.get("pid"), e.get("tid"))
        if cat == "fwdbwd":
            if e.get("ph") == "s":
                flow_start[e["id"]] = (float(e["ts"]), thread)
            elif e.get("ph") == "f":
                flow_end[thread].append((float(e["ts"]), e["id"]))
            continue
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, name = float(e["ts"]), e.get("name", "")
        if cat in LAUNCH_CATEGORIES and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (ts, thread)
        elif ((cat == "user_annotation" and name.startswith(PREFIX))
              or (cat == "cpu_op" and name.startswith(AUTOGRAD))):
            holders[thread].append((ts, ts + float(e["dur"]), name))
    for v in flow_end.values():
        v.sort()
    spans = {t: [iv for iv in ivs if iv[2].startswith(PREFIX)] for t, ivs in holders.items()}

    # the innermost holder of every launch, thread by thread
    by_thread = collections.defaultdict(list)
    for corr, (ts, thread) in launch.items():
        by_thread[thread].append((ts, corr))
    holder = {}
    for thread, points in by_thread.items():
        holder.update(_innermost(holders.get(thread, []), points))

    # an autograd evaluation's forward op, by its fwdbwd flow, and the span there
    forward = {}
    for corr, iv in holder.items():
        if iv is not None and not iv[2].startswith(PREFIX):
            thread = launch[corr][1]
            ends = flow_end.get(thread, [])
            j = bisect.bisect_left(ends, (iv[0],))
            if j < len(ends) and ends[j][0] <= iv[1] and ends[j][1] in flow_start:
                forward[corr] = flow_start[ends[j][1]]
    fwd_by_thread = collections.defaultdict(list)
    for corr, (ts, thread) in forward.items():
        fwd_by_thread[thread].append((ts, corr))
    fwd_span = {}
    for thread, points in fwd_by_thread.items():
        fwd_span.update(_innermost(spans.get(thread, []), points))

    def owner(corr):
        iv = holder.get(corr)
        if iv is not None and not iv[2].startswith(PREFIX):
            iv = fwd_span.get(corr)
        name = iv[2] if iv is not None else None
        return None if name in STEP_SPANS else name

    us = collections.Counter()
    launched = 0
    for dur, corr in device:
        found = corr is not None and corr in launch
        launched += found
        us[owner(corr) if found else None] += dur
    return {"us": dict(us), "events": len(device), "launched": launched}


def host_spans(trace: dict, names) -> list[float]:
    """The host durations (us) of the `splat.*` spans named `names`."""
    return [float(e["dur"]) for e in yt.kernel_events(trace, ("user_annotation",))
            if e["name"] in names]


def _attribution(ctx) -> dict | None:
    """`attribute(ctx.trace)`, once per context; None where the trace holds
    no device event (a CPU run) or no `splat.*` span (a program without
    them)."""
    if not hasattr(ctx, "_splat_attribution"):
        tr = ctx.trace
        found = (yt.kernel_events(tr, yt.DEVICE_CATEGORIES)
                 and any(e["name"].startswith(PREFIX)
                         for e in yt.kernel_events(tr, ("user_annotation",))))
        ctx._splat_attribution = attribute(tr) if found else None
    return ctx._splat_attribution


def layer_ms(ctx, span: str):
    """The device ms a step of the traced stretch that `span` owns."""
    a = _attribution(ctx)
    if a is None:
        return None
    return a["us"].get(span, 0.0) * 1e-3 / ctx.traced["steps"]


def unattributed_share(ctx):
    """The unattributed device time over the device's busy time, in %."""
    a = _attribution(ctx)
    if a is None:
        return None
    busy = yt.timeline(ctx.trace, yt.DEVICE_CATEGORIES)["busy_us"]
    return 100.0 * a["us"].get(None, 0.0) / busy


def host_ms_per_step(ctx, names):
    """The host ms of the spans `names` over the traced stretch's steps."""
    if _attribution(ctx) is None:
        return None
    return sum(host_spans(ctx.trace, names)) * 1e-3 / ctx.traced["steps"]


def refine_ms(ctx):
    """The host ms of a `splat.refine` span, the mean over the stretch's."""
    if _attribution(ctx) is None:
        return None
    durs = host_spans(ctx.trace, ("splat.refine",))
    return sum(durs) * 1e-3 / len(durs) if durs else None


def binning_sums(ctx) -> dict | None:
    """The binning counters summed over the window's refine events
    (`binnings`, `binning_candidates`, `binning_real`, `binning_landed`);
    None where the events do not carry them or the trace holds no device
    event."""
    keys = ("binnings", "binning_candidates", "binning_real", "binning_landed")
    events = ctx.window.get("refines", [])
    if (not yt.kernel_events(ctx.trace, yt.DEVICE_CATEGORIES) or not events
            or not all(k in e for e in events for k in keys)):
        return None
    sums = {k: sum(int(e[k]) for e in events) for k in keys}
    return sums if sums["binnings"] > 0 and sums["binning_candidates"] > 0 else None
