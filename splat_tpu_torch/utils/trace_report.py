"""Per-kernel device-time report from a `torch.profiler` chrome trace.

The JAX package's `utils/trace_report.py` ranks the device ops of an XLA
trace; this module does the same for the trace that
`torch.profiler.profile(...).export_chrome_trace(path)` writes: the complete
("X") events of category `kernel` (and, with `categories`, `gpu_memcpy` /
`gpu_memset`), grouped by name, ranked by total device time. Beside each
kernel's total and mean microseconds per iteration, its calls per iteration
and its share of all kernels' summed device time, it reports the device
timeline:
the span from the first kernel's start to the last one's end, the time some
kernel ran (overlaps counted once), and the idle gaps between kernels.

    python -m splat_tpu_torch.utils.trace_report TRACE(.json | .json.gz | dir)
        [--iters N] [--top K] [--categories kernel,gpu_memcpy,gpu_memset]
"""
from __future__ import annotations

import collections
import dataclasses
import glob
import gzip
import json
from pathlib import Path

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


def report(path: str | Path, iters: int = 1, top: int = 25,
           categories=KERNEL_CATEGORIES) -> str:
    """The ranked table as text; times per iteration are divided by `iters`
    (the steps the profiled window ran)."""
    trace = load_trace(path)
    stats = kernel_stats(trace, categories)
    tl = timeline(trace, categories)
    total = sum(s.total_us for s in stats)
    n = max(iters, 1)
    lines = [
        f"device: {tl['busy_us'] / n / 1e3:.3f} ms/iter busy of a {tl['span_us'] / n / 1e3:.3f} "
        f"ms/iter span (busy share {tl['busy_share']:.1%}); idle {tl['idle_us'] / n / 1e3:.3f} "
        f"ms/iter in {tl['gaps'] / n:.0f} gaps/iter, the longest {tl['max_gap_us']:.1f} us; "
        f"{sum(s.count for s in stats) / n:.0f} kernels/iter ({iters} iters)",
        f"{'us/iter':>10} {'mean us':>9} {'%':>5} {'calls':>7}  kernel",
    ]
    for s in stats[:top]:
        lines.append(f"{s.total_us / n:10.1f} {s.mean_us:9.2f} "
                     f"{100.0 * s.total_us / max(total, 1e-9):5.1f} {s.count / n:7.1f}  "
                     f"{s.name[:100]}")
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace")
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--categories", default=",".join(KERNEL_CATEGORIES))
    args = ap.parse_args(argv)
    print(report(args.trace, args.iters, args.top, tuple(args.categories.split(","))))


if __name__ == "__main__":
    main()
