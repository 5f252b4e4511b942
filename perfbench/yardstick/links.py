"""The mesh's exchanges in a traced stretch of a depth-slab mesh: the bytes
that the slabs' trade, the slabs' merge and the gradients' sum must move
into rank 0, counted from the program's slab counters and the leaves'
sizes, against the device time of the collectives' kernels in rank 0's
trace. It imports nothing of the program."""
from __future__ import annotations

import math

from . import trace as yt

# H100 SXM, NVLink 4: 900 GB/s both directions together, 450 GB/s each way
LINK_BYTES_PER_S = 450e9
# a traded row: the 16-float parameter table and the 2-float footprint
ROW_BYTES = 18 * 4
F32 = 4


def collective_us(trace: dict) -> float:
    """The device microseconds of the collectives' kernels (NCCL's)."""
    return sum(float(e["dur"]) for e in yt.kernel_events(trace)
               if "nccl" in e.get("name", "").lower())


def exchange_bytes(ctx) -> float | None:
    """The bytes into rank 0 over the traced stretch; None without the slab
    counts (a program without them, or a stretch without a trade).

    * the trade: each row rank 0 received from another rank (forward) and
      each row it sent, whose gradient comes back (backward);
    * the merge: each render (a train step, an eval-camera step) gathers
      every sample's (h, w, 3) colour and (h, w) transmittance of the d - 1
      other slabs, and its backward's reduce-scatter brings as many back;
    * the gradients' sum: a ring all-reduce over the world brings 2 (w - 1)
      / w of the replicated leaves' gradients (the eval leaves' in an
      eval-camera step) to each rank.
    The refine's rows, each binning's per-tile counts (the slabs' shares of
    a tile's K) and the small reductions are left out."""
    tr, info = ctx.traced, ctx.info
    slab = tr.get("slab")
    if not slab or not slab.get("trades") or "mesh" not in info:
        return None
    d = info["mesh"]["gauss"]
    world = math.prod(info["mesh"].values())
    s0, n = tr["start"], tr["steps"]
    evals = (sum(1 for s in range(s0, s0 + n) if s % info["eval_opt_every"] == 0)
             if info["eval_opt"] else 0)
    trade = (slab["rows"] + slab["sent"]) * ROW_BYTES
    image = info["blur_samples"] * info["height"] * info["width"] * (3 + 1) * F32
    merge = (n + evals) * 2 * (d - 1) * image
    grads = 2 * (world - 1) / world * (n * info["replicated_floats"]
                                       + evals * info["eval_floats"]) * F32
    return float(trade + merge + grads)


def link_roofline(ctx):
    """`exchange_bytes` over the collectives' device time at the link's
    rate, in %."""
    moved = exchange_bytes(ctx)
    t = collective_us(ctx.trace) * 1e-6
    if moved is None or t <= 0:
        return None
    return 100.0 * moved / (t * LINK_BYTES_PER_S)


def slab_imbalance(ctx):
    """The fullest depth slab's rows over the mean, averaged over the traced
    stretch's trades."""
    slab = ctx.traced.get("slab")
    if not slab or not slab.get("trades"):
        return None
    return slab["fullest"] / slab["trades"]
