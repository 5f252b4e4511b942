"""exchange_ms.mesh4 (ms/step): device time of the traced stretch that the span
`splat.exchange` owns (the depth slabs' trade, their merge, the gradients'
sum and the refine's rows, with their backward), per step, on rank 0;
`perfbench/yardstick/spans.py`."""
from perfbench.yardstick import spans


def read(ctx):
    return spans.layer_ms(ctx, "splat.exchange")
