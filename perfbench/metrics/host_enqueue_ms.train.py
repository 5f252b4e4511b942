"""host_enqueue_ms.train (ms/step): the host durations of the spans
`splat.train_step` and `splat.eval_camera_step` in the traced stretch, per step:
the host's enqueue of a step, read under the profiler (which slows the host, so
it reads high); `perfbench/yardstick/spans.py`."""
from perfbench.yardstick import spans


def read(ctx):
    return spans.host_ms_per_step(ctx, spans.STEP_SPANS)
