"""fetch_ms.train (ms/step): device time of the traced stretch that the span
`splat.fetch` owns (the parameter table, the sorted stream, the per-tile blocks
and their backward gather), per step; `perfbench/yardstick/spans.py`."""
from perfbench.yardstick import spans


def read(ctx):
    return spans.layer_ms(ctx, "splat.fetch")
