"""unattributed_device.train (%): the share of the traced stretch's device busy
time that no layer span owns (`perfbench/yardstick/spans.py`: under a step span
alone, under no span, or without a launch event)."""
from perfbench.yardstick import spans


def read(ctx):
    return spans.unattributed_share(ctx)
