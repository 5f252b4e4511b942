"""exchange_link_roofline.mesh4 (%): the bytes the depth slabs' trade, their
merge and the gradients' sum must move into rank 0 in the traced stretch
(counted from the slab counters and the leaves' sizes) over the device time of
the collectives' kernels at 450 GB/s, NVLink 4's rate each way;
`perfbench/yardstick/links.py`."""
from perfbench.yardstick import links


def read(ctx):
    return links.link_roofline(ctx)
