"""Timing helpers (port of `splat_tpu/utils/profiling.py`'s `StepTimer`, plus
the CUDA-event timer the kernel measurements use), the layer spans of the
training step and binning's counters.

PyTorch returns from a CUDA call before the card has finished, so a host
clock measures the enqueue unless the timed region ends in a synchronise.
`StepTimer.stop(sync=True)` synchronises first; the trainer asks for that
only every `sync_every` steps, as the JAX trainer blocks, so the timer keeps
one entry per synchronised window (sync to sync), and the windows' per-step
times are what the percentiles aggregate. `time_cuda` times calls enqueued
back to back (a working set under the 50 MB L2 then stays cached between
calls), `time_cuda_cold` single calls after the cache has been overwritten.

`span(name)` names a layer of the step in any `torch.profiler` trace (a
`user_annotation` event on the clock of the device's events); with no
profiler recording it is a shared null context and costs a flag check. The
names start with "splat.": `splat.train_step` and `splat.eval_camera_step`
hold one step's host enqueue, `splat.refine` the refine, and the layers
`splat.project`, `splat.bin`, `splat.fetch`, `splat.composite`,
`splat.loss`, `splat.optimizer` and `splat.exchange` the work of each. Backward work runs
outside them (autograd's own thread): a trace reader follows its forward
op's `fwdbwd` flow back to the span; the hand-written backwards open their
own.

`BinningCounters` counts the binnings of the steps a trainer runs with them
active (`counting`): the candidate (Gaussian, tile) entries, the entries that
survive the footprint and conic cull, those that land in a tile's list, and
the tiles the binning kernels sort on their long-segment path.
`SlabCounters` count, on a mesh that shards the Gaussians in depth slabs,
the rows of each slab trade and the refine's rows sent to another shard;
`splat.exchange` holds the mesh's exchanges (the slab trade, the slabs'
merge, the gradients' sum, the refine's rows).
"""
from __future__ import annotations

import contextlib
import contextvars
import statistics
import subprocess
import time

import numpy as np
import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """`torch.profiler.record_function(name)` while a profiler records, else
    one shared null context (building a record_function costs ~10 us even
    with no profiler running)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


class BinningCounters:
    """Binning's counts since the last `take`: `binnings` and `candidates`
    (N * M per binning) on the host; on the device the culled-in (`real`)
    and landed entries, and the tiles the binning kernels sort on their
    long-segment path (`long_tiles`, `ops/cuda/bin_tiles.py`; 0 on the plain
    route). A binning adds one reduction (the landed sum); the device numbers
    fold into one int64 tensor every `FOLD` binnings and when read. `read`
    and `take` wait for the device: call them where the host waits anyway."""

    FOLD = 64
    DEVICE_KEYS = ("real", "landed", "long_tiles")

    def __init__(self):
        self.restore({})

    def restore(self, counts: dict) -> None:
        """Start from `counts` (what `read` gave; {} for zero)."""
        self.binnings = int(counts.get("binnings", 0))
        self.candidates = int(counts.get("candidates", 0))
        self._host = [int(counts.get(k, 0)) for k in self.DEVICE_KEYS]
        self._pending: list[torch.Tensor] = []     # DEVICE_KEYS of each binning in turn
        self._acc: torch.Tensor | None = None      # (3,) int64: DEVICE_KEYS

    def add(self, candidates: int, real: torch.Tensor, counts: torch.Tensor,
            long_tiles: torch.Tensor | None = None) -> None:
        """One binning of `candidates` entries: `real` (an int32 scalar
        tensor) of them culled in, the capped per-tile `counts` landed, and
        `long_tiles` (an int32 scalar tensor; None: 0) sorted on the long
        path."""
        self.binnings += 1
        self.candidates += int(candidates)
        self._pending += [real, torch.sum(counts, dtype=torch.int32),
                          real.new_zeros(()) if long_tiles is None else long_tiles]
        if len(self._pending) >= len(self.DEVICE_KEYS) * self.FOLD:
            self._fold()

    def _fold(self) -> None:
        if self._pending:
            sums = (torch.stack(self._pending).view(-1, len(self.DEVICE_KEYS))
                    .sum(dim=0, dtype=torch.int64))
            self._acc = sums if self._acc is None else self._acc.add_(sums)
            self._pending = []

    def read(self) -> dict[str, int]:
        """{"binnings", "candidates", "real", "landed", "long_tiles"} so far."""
        self._fold()
        acc = self._acc.tolist() if self._acc is not None else [0] * len(self.DEVICE_KEYS)
        return {"binnings": self.binnings, "candidates": self.candidates,
                **{k: h + a for k, h, a in zip(self.DEVICE_KEYS, self._host, acc)}}

    def take(self) -> dict[str, int]:
        """`read`, then start again from zero."""
        out = self.read()
        self.restore({})
        return out


class SlabCounters:
    """The depth slabs' counts since the last `take` (`parallel/sharding.py`):
    `trades` on the host, and per trade on the device the rows this rank
    received from other ranks (`rows`) and sent to them (`sent`), the rows
    past a bucket's capacity over the gauss axis (`dropped`) and the fullest
    slab's rows over the mean (`fullest`, summed over the trades); `moved`
    (host) the new rows a refine sent to another shard. A trade adds one
    small kernel; `read` and `take` wait for the device."""

    DEVICE_KEYS = ("rows", "sent", "dropped", "fullest")

    def __init__(self):
        self.restore({})

    def restore(self, counts: dict) -> None:
        """Start from `counts` (what `read` gave; {} for zero)."""
        self.trades = int(counts.get("trades", 0))
        self.moved = int(counts.get("moved", 0))
        self._host = [float(counts.get(k, 0)) for k in self.DEVICE_KEYS]
        self._acc: torch.Tensor | None = None      # (4,) float64: DEVICE_KEYS

    def add(self, rows: torch.Tensor, sent: torch.Tensor, dropped: torch.Tensor,
            fullest: torch.Tensor) -> None:
        """One slab trade's 0-dim device counts (`DEVICE_KEYS`)."""
        self.trades += 1
        v = torch.stack([t.to(torch.float64) for t in (rows, sent, dropped, fullest)])
        self._acc = v if self._acc is None else self._acc.add_(v)

    def read(self) -> dict:
        """{"trades", "moved", "rows", "sent", "dropped", "fullest"} so far
        (`fullest` the sum over the trades)."""
        acc = self._acc.tolist() if self._acc is not None else [0.0] * 4
        out = {"trades": self.trades, "moved": self.moved}
        for k, h, a in zip(self.DEVICE_KEYS, self._host, acc):
            out[k] = h + a if k == "fullest" else int(round(h + a))
        return out

    def take(self) -> dict:
        """`read`, then start again from zero."""
        out = self.read()
        self.restore({})
        return out


_ACTIVE: contextvars.ContextVar[BinningCounters | None] = contextvars.ContextVar(
    "splat_binning_counters", default=None)
_ACTIVE_SLAB: contextvars.ContextVar[SlabCounters | None] = contextvars.ContextVar(
    "splat_slab_counters", default=None)


@contextlib.contextmanager
def counting(counters: BinningCounters | None, slab: SlabCounters | None = None):
    """Within: the binnings of this context count into `counters`, the depth
    slabs' trades and the refine's moved rows into `slab` (None: not)."""
    tokens = _ACTIVE.set(counters), _ACTIVE_SLAB.set(slab)
    try:
        yield
    finally:
        _ACTIVE.reset(tokens[0])
        _ACTIVE_SLAB.reset(tokens[1])


def active_counters() -> BinningCounters | None:
    """The counters binning adds to here, None where nothing counts."""
    return _ACTIVE.get()


def active_slab_counters() -> SlabCounters | None:
    """The counters the depth slabs add to here, None where nothing counts."""
    return _ACTIVE_SLAB.get()


class StepTimer:
    """Per-step wall times, one entry per synchronised window in `windows`:
    (seconds from the previous sync to this one, the window's steps).

    `start` opens a window (a no-op while one is open; `fresh` drops an open
    one, for a new run), `stop` ends a step and with sync=True synchronises
    and closes the window (`lap`), the next one opening at that moment. So the
    windows tile the run with whatever runs between the steps (eval-camera
    steps, refines); `finish` ends the chain, the time since the last sync
    joining the last window. summary() gives mean / p50 / p95 of the step
    time in ms (each window's steps at its mean) and steps per second."""

    def __init__(self, capacity: int = 10000, device: torch.device | None = None):
        self.windows: list[tuple[float, int]] = []
        self.capacity = capacity
        self.device = device
        self._t0: float | None = None
        self._steps = 0

    def _synchronize(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, fresh: bool = False) -> None:
        if fresh or self._t0 is None:
            self._t0, self._steps = time.perf_counter(), 0

    def stop(self, sync: bool = False) -> None:
        if self._t0 is None:
            return
        self._steps += 1
        if sync:
            self.lap()

    def lap(self) -> None:
        """Synchronise and close the open window if it holds a step (where
        the host waits anyway, as at a log record); the next opens now."""
        if self._t0 is None or self._steps == 0:
            return
        self._synchronize()
        now = time.perf_counter()
        self.windows.append((now - self._t0, self._steps))
        self._t0, self._steps = now, 0
        if len(self.windows) > self.capacity:
            del self.windows[: len(self.windows) - self.capacity]

    def finish(self) -> None:
        """End the chain. The time since the last sync joins the last window
        when no step has run since; steps never synchronised are dropped."""
        if self._t0 is not None and self._steps == 0 and self.windows:
            sec, n = self.windows[-1]
            self.windows[-1] = (sec + time.perf_counter() - self._t0, n)
        self._t0, self._steps = None, 0

    def summary(self, last_n: int | None = None) -> dict:
        """Over the last windows that hold `last_n` steps (all: None)."""
        picked, n = [], 0
        for sec, k in reversed(self.windows):
            if last_n and n >= last_n:
                break
            picked.append((sec, k))
            n += k
        if not picked:
            return {}
        total = sum(sec for sec, _ in picked)
        per_step = np.repeat([sec / k for sec, k in picked], [k for _, k in picked])
        return {
            "step_ms_mean": total / n * 1e3,
            "step_ms_p50": float(np.percentile(per_step, 50) * 1e3),
            "step_ms_p95": float(np.percentile(per_step, 95) * 1e3),
            "steps_per_s": n / total,
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
