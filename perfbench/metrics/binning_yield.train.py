"""binning_yield.train (%): the entries binning keeps after the footprint and
conic cull over its candidate (Gaussian, tile) entries, summed over the
window's refine events (the program's binning counters)."""
from perfbench.yardstick import spans


def read(ctx):
    s = spans.binning_sums(ctx)
    return None if s is None else 100.0 * s["binning_real"] / s["binning_candidates"]
