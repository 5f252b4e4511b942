"""Reading a `torch.profiler` chrome trace: the device's operations by name,
its busy time and idle gaps, and what the host was doing in each gap.

`load_trace`, `kernel_events`, `kernel_stats` and `timeline` are a frozen
copy of `splat_tpu_torch/utils/trace_report.py` at commit 49129b2; the
program's copy may change, this one does not. `gap_causes` is the
benchmark's own.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import glob
import gzip
import json
from pathlib import Path

# every event category in which the device itself runs an operation
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")


KERNEL_CATEGORIES = ("kernel",)


@dataclasses.dataclass
class KernelStat:
    name: str
    total_us: float
    count: int

    @property
    def mean_us(self) -> float:
        return self.total_us / self.count if self.count else 0.0


def load_trace(path: str | Path) -> dict:
    """A chrome trace: the file itself (.json or .json.gz), or the newest
    `*.json` / `*.json.gz` / `*.pt.trace.json` under a directory."""
    path = Path(path)
    if path.is_dir():
        files = [f for pat in ("*.json", "*.json.gz") for f in
                 glob.glob(str(path / "**" / pat), recursive=True)]
        if not files:
            raise FileNotFoundError(f"no chrome trace (*.json, *.json.gz) under {path}")
        path = Path(max(files, key=lambda f: Path(f).stat().st_mtime))
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)


def kernel_events(trace: dict, categories=KERNEL_CATEGORIES) -> list[dict]:
    """The complete events of the given categories that carry a duration."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in categories and "dur" in e]


def kernel_stats(trace: dict, categories=KERNEL_CATEGORIES) -> list[KernelStat]:
    """Device time and calls per kernel name, largest total first (ties in
    the order the names first appear)."""
    total: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for e in kernel_events(trace, categories):
        total[e["name"]] += float(e["dur"])
        count[e["name"]] += 1
    out = [KernelStat(name, total[name], count[name]) for name in total]
    out.sort(key=lambda s: -s.total_us)
    return out


def timeline(trace: dict, categories=KERNEL_CATEGORIES) -> dict:
    """The device's span, its busy time (the union of the kernels'
    intervals) and the idle gaps between them, all in microseconds."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in kernel_events(trace, categories))
    if not spans:
        return {"span_us": 0.0, "busy_us": 0.0, "idle_us": 0.0, "gaps": 0, "max_gap_us": 0.0,
                "busy_share": 0.0}
    busy, gaps = 0.0, []
    start, end = spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            gaps.append(s - end)
            start, end = s, e
        else:
            end = max(end, e)
    busy += end - start
    span = end - spans[0][0]
    return {"span_us": span, "busy_us": busy, "idle_us": sum(gaps), "gaps": len(gaps),
            "max_gap_us": max(gaps, default=0.0), "busy_share": busy / span if span > 0 else 0.0}


def gap_causes(trace: dict, categories=DEVICE_CATEGORIES, top: int = 10) -> list[list]:
    """Idle device time by what the host was doing when each gap began: the
    innermost host operation (`cpu_op` or a `user_annotation` span) open at
    that moment, or "(host idle)" where none was. [[name, seconds], ...],
    the largest total first, at most `top` entries."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in kernel_events(trace, categories))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in kernel_events(trace, HOST_CATEGORIES))
    starts = [h[0] for h in host]
    total: collections.Counter = collections.Counter()
    end = spans[0][1] if spans else 0.0
    for s, e in spans[1:]:
        if s > end:
            # the innermost host op open at `end`: among those that started
            # before it, the shortest that is still open
            i = bisect.bisect_right(starts, end)
            best = None
            for hs, he, name in host[max(0, i - 2000):i]:
                if he >= end and (best is None or he - hs < best[0]):
                    best = (he - hs, name)
            total[best[1] if best else "(host idle)"] += (s - end) * 1e-6
        end = max(end, e)
    return [[name, sec] for name, sec in total.most_common(top)]
