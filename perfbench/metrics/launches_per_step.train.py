"""launches_per_step.train (launches/step): device kernel events in the
traced stretch over its steps (its eval-camera and refine steps included):
the host's dispatch work per step."""
from perfbench.yardstick import readers


def read(ctx):
    return readers.launches_per(ctx, "steps")
