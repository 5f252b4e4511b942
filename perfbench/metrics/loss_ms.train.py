"""loss_ms.train (ms/step): device time of the traced stretch that the span
`splat.loss` owns (gamma, L1, SSIM's convolutions, the scale regulariser, and
their backward), per step; `perfbench/yardstick/spans.py`."""
from perfbench.yardstick import spans


def read(ctx):
    return spans.layer_ms(ctx, "splat.loss")
