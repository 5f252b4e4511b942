"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (perfbench/workloads/<cell>.json) names a configuration
(perfbench/configs/<name>.json), a traffic mix
(perfbench/traffic/<name>.json), the limits of its checks, and which of the
traffic's quantities each of its end-to-end metrics reports. The mix's
`kind` names the module perfbench/traffic/<kind>.py that builds the
program's state (set-up), drives the window, and computes the reference's
answers. A per-layer metric is the reader perfbench/metrics/<metric>.py,
reported in the cells that BENCHMARK.json lists for it.

The last line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device` and, traced, `breakdown`; last,
`checks`, every number compared beside its limit, which also end standard
error. Without enough CUDA devices it exits 3 and prints no result; if JAX
or the JAX package is loaded once the window has closed, it exits 4.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "splat_tpu")


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds. The program's nvcc builds go to
    splat_tpu_torch/ops/cuda/_build; these two are for the PyTorch extension
    and Triton caches a later kernel may use."""
    cache = CHECKOUT / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (splat_tpu_torch is not splat_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer_metrics(cell: str, bench: dict) -> list[dict]:
    """BENCHMARK.json's per-layer metrics that this cell reports."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cell_e2e = {n for n, m in e2e.items() if cell in m.get("workloads", [cell])}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in cell_e2e:
            out.append(m)
    return out


def load_reader(name: str):
    """perfbench/metrics/<name>.py as a module (names hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a per-layer reader reads: the cell, its window, the traced
    stretch (`trace`, a chrome-trace dict, and `traced`: its steps or frames
    and wall seconds), what the program's state was (`info`), and `work()`,
    the benchmark's count of the stretch's work."""

    def __init__(self, cell, traffic, config, mix, seed, device, res, info, trace):
        self.cell, self.traffic, self.config, self.mix = cell, traffic, config, mix
        self.seed, self.device, self.window, self.info = seed, device, res, info
        self.trace, self.traced = trace, res["traced"]
        self._work = None

    def work(self) -> dict:
        if self._work is None:
            self._work = self.traffic.traced_work(self.config, self.mix, self.seed, self.device,
                                                 self.window, self.info)
        return self._work


def profiler(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return lambda: torch.profiler.profile(activities=acts)


def export_trace(prof) -> dict:
    """The profiler's chrome trace, written under TMPDIR, read back by the
    frozen reader and deleted."""
    from perfbench.yardstick import trace as yt

    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return yt.load_trace(path)
    finally:
        os.unlink(path)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device=None,
             cell: dict | None = None, config: dict | None = None, mix: dict | None = None,
             bench: dict | None = None) -> tuple[dict, list[str]]:
    """One run; returns (the result object, the lines of checks). device None:
    the cell's CUDA devices, which must be there. The cell, its
    configuration, its mix and BENCHMARK.json are read by name unless given."""
    import torch

    from perfbench import harness

    cell = cell or harness.load("workloads", cell_name)
    config = config or harness.load("configs", cell["config"])
    mix = mix or harness.load("traffic", cell["traffic"])
    bench = bench or json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    dev = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    traffic = importlib.import_module(f"perfbench.traffic.{mix['kind']}")

    run = traffic.Run(cell, config, mix, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_START
    res = run.window(seconds, trace, profiler(dev))
    device_block = (harness.device_info(cell["chips"]) if dev.type == "cuda" else
                    {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    notes = dict(run.notes, window={k: v for k, v in res.items()
                                    if k in ("steps", "frames", "seconds", "refines",
                                             "chunk_s")})
    program = getattr(run, "recorded", None)
    info = run.free()
    del run
    gc.collect()

    metrics, breakdown = {}, None
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace:
        from perfbench.yardstick import trace as yt

        tr = export_trace(res["traced"]["prof"])
        del res["traced"]["prof"]
        tl = yt.timeline(tr, yt.DEVICE_CATEGORIES)
        device_block["busy_s"] = tl["busy_us"] * 1e-6
        device_block["window_s"] = res["traced"]["wall_s"]
        breakdown = {"device_ops": [[s.name, s.total_us * 1e-6] for s in
                                    yt.kernel_stats(tr, yt.DEVICE_CATEGORIES)[:10]],
                     "idle_gaps": yt.gap_causes(tr)}
        ctx = Context(cell_name, traffic, config, mix, seed, dev, res, info, tr)
        for m in per_layer_metrics(cell_name, bench):
            value = load_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del ctx, tr
    else:
        values = traffic.end_to_end(res)
        for name, quantity in cell["end_to_end"].items():
            if name in units:       # those of the cell's metrics BENCHMARK.json holds
                metrics[name] = {"value": values[quantity], "unit": units[name]}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    res.pop("traced", None)
    gc.collect()

    t_check = time.perf_counter()
    checks = traffic.check(config, mix, seed, dev, program, res)
    notes["check_s"] = time.perf_counter() - t_check
    limits = cell["limits"]
    lines = [f"notes: {json.dumps(notes)}"]
    lines += [f"check {name}: {value!r} limit {limits[name]!r}" for name, value in checks.items()]
    correct = all(v <= limits[n] for n, v in checks.items())
    attempted, failed = traffic.attempted(res)
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_block}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": limits[n]} for n, v in checks.items()}
    return out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from perfbench import harness

    cell = harness.load("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             cell=cell)
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
