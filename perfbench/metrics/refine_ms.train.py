"""refine_ms.train (ms/refine): the host duration of a `splat.refine` span in
the traced stretch (cull and densify, growth, the tile probe, the opacity reset),
the mean over the stretch's refines; `perfbench/yardstick/spans.py`."""
from perfbench.yardstick import spans


def read(ctx):
    return spans.refine_ms(ctx)
