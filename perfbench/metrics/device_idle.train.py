"""device_idle.train (%): 1 - busy / span of the device's timeline in the
traced stretch (`perfbench/yardstick/readers.py:device_idle`)."""
from perfbench.yardstick import readers


def read(ctx):
    return readers.device_idle(ctx)
