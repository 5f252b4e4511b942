"""optimizer_ms.train (ms/step): device time of the traced stretch that the span
`splat.optimizer` owns (both Adams, the probe gradient's norm, the
densification statistics), per step; `perfbench/yardstick/spans.py`."""
from perfbench.yardstick import spans


def read(ctx):
    return spans.layer_ms(ctx, "splat.optimizer")
