"""binning_ms.train (ms/step): device time of the traced stretch that the span
`splat.bin` owns (the tile lists of every anchor, and the refine's probe), per
step; `perfbench/yardstick/spans.py`."""
from perfbench.yardstick import spans


def read(ctx):
    return spans.layer_ms(ctx, "splat.bin")
