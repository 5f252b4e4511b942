"""What the per-layer readers (perfbench/metrics/<name>.py) compute, kept
apart from the readers so that a later cell's metric of the same quantity
reads it the same way."""
from __future__ import annotations

from . import trace as yt
from .work import PEAK_FP32_FLOPS

# the compositors' kernels as the profiler names them (csrc/rasterize_fwd.cu,
# csrc/rasterize_bwd.cu)
COMPOSITORS = ("rasterize_fwd_kernel", "rasterize_bwd_kernel")


def train_mfu(ctx):
    """The model operations of the window's unprofiled steps (the count of
    `work.step_flops` on the traced stretch's state, the eval-camera step's
    share included) over their wall time and the float32 peak, in %. The
    time is that of the unprofiled chunks alone: the profiled stretch, and
    the profiler's own start and stop, stay out."""
    w = ctx.window
    steps, seconds = w["timed_steps"], w["timed_s"]
    if steps <= 0 or seconds <= 0:
        return None
    return 100.0 * ctx.work()["flops_per_step"] * steps / seconds / PEAK_FP32_FLOPS


def compositing_roofline(ctx):
    """The least time of the traced stretch's compositing (`work.py`'s
    count) over the device time of the compositing kernels, in %."""
    t = sum(s.total_us for s in yt.kernel_stats(ctx.trace)
            if any(k in s.name for k in COMPOSITORS)) * 1e-6
    if t <= 0:
        return None
    return 100.0 * ctx.work()["compositing_s"] / t


def launches_per(ctx, what: str):
    """Device kernel events in the traced stretch over its steps or frames."""
    n = len(yt.kernel_events(ctx.trace))
    return n / ctx.traced[what] if n else None


def device_idle(ctx):
    """1 - busy / span of the device's timeline in the traced stretch
    (kernels, copies and fills), in %."""
    tl = yt.timeline(ctx.trace, yt.DEVICE_CATEGORIES)
    if tl["span_us"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_us"] / tl["span_us"])
