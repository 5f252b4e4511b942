"""Timing helpers (port of `splat_tpu/utils/profiling.py`'s `StepTimer`, plus
the CUDA-event timer the kernel measurements use).

PyTorch returns from a CUDA call before the card has finished, so a host
clock measures the enqueue unless the timed region ends in a synchronise.
`StepTimer.stop(sync=True)` synchronises first; the trainer asks for that
only every `sync_every` steps, as the JAX trainer blocks, and the windows in
between aggregate into the percentiles. `time_cuda` times calls enqueued back
to back (a working set under the 50 MB L2 then stays cached between calls),
`time_cuda_cold` single calls after the cache has been overwritten.
"""
from __future__ import annotations

import statistics
import subprocess
import time

import numpy as np
import torch


class StepTimer:
    """Records per-step wall times; summary() gives mean/p50/p95 in ms."""

    def __init__(self, capacity: int = 10000, device: torch.device | None = None):
        self.times: list[float] = []
        self.capacity = capacity
        self.device = device
        self._t0: float | None = None

    def _synchronize(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync: bool = False) -> None:
        if self._t0 is None:
            return
        if sync:
            self._synchronize()
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None
        if len(self.times) > self.capacity:
            del self.times[: len(self.times) - self.capacity]

    def summary(self, last_n: int | None = None) -> dict:
        ts = np.asarray(self.times[-last_n:] if last_n else self.times)
        if len(ts) == 0:
            return {}
        return {
            "step_ms_mean": float(ts.mean() * 1e3),
            "step_ms_p50": float(np.percentile(ts, 50) * 1e3),
            "step_ms_p95": float(np.percentile(ts, 95) * 1e3),
            "steps_per_s": float(1.0 / ts.mean()),
        }


def time_cuda(fn, runs: int, reps: int = 1) -> float:
    """Median over `runs` of the ms per call of `reps` calls enqueued back to
    back between two CUDA events, after one warm-up. With reps > 1 the later
    calls queue up while the card runs the earlier ones (when the host
    enqueues faster than the card runs), so a short kernel's time carries the
    host's launch latency once in `reps` calls rather than in every one."""
    fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def time_cuda_cold(fn, runs: int, flush_bytes: int = 256 << 20) -> float:
    """Median over `runs` of the ms of one call between two CUDA events, each
    after a write over a buffer several times the L2's size, so the call finds
    its inputs in device memory and not in the cache an earlier call left.
    Carries the host's launch latency (a few microseconds) in every sample."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi(query: str) -> str:
    """The first card's answer to `nvidia-smi --query-gpu=<query>
    --format=csv,noheader` (name,power.limit names the card beside a number)."""
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]
