"""slab_imbalance.mesh4 (max/mean): the fullest depth slab's rows over the mean
slab's, averaged over the traced stretch's slab trades (the program's slab
counters); `perfbench/yardstick/links.py`."""
from perfbench.yardstick import links


def read(ctx):
    return links.slab_imbalance(ctx)
