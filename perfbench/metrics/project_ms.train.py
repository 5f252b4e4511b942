"""project_ms.train (ms/step): device time of the traced stretch that the span
`splat.project` owns, forward and backward (camera corrections, projection,
covariances, SH, pixel velocities), per step; `perfbench/yardstick/spans.py`."""
from perfbench.yardstick import spans


def read(ctx):
    return spans.layer_ms(ctx, "splat.project")
