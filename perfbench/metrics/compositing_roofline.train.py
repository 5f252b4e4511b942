"""compositing_roofline.train (%): the least time of the traced stretch's
forward and backward compositing (operations over 67 TFLOP/s or bytes over
3.35 TB/s, counted on the hit pairs by `perfbench/yardstick/work.py`) over
the device time of `rasterize_fwd` and `rasterize_bwd` in the trace."""
from perfbench.yardstick import readers


def read(ctx):
    return readers.compositing_roofline(ctx)
