"""landed_entries.train (M/binning): the entries that land in the tiles' lists
(capped at the tile capacity) per binning, in millions, summed over the
window's refine events (the program's binning counters)."""
from perfbench.yardstick import spans


def read(ctx):
    s = spans.binning_sums(ctx)
    return None if s is None else s["binning_landed"] / s["binnings"] * 1e-6
