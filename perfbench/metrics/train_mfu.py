"""train_mfu (%): a training cell's model operations per unprofiled second over
the H100's float32 peak (67 TFLOP/s); `perfbench/yardstick/readers.py:train_mfu`."""
from perfbench.yardstick import readers


def read(ctx):
    return readers.train_mfu(ctx)
