"""The whole call's share of the chip's peak, in %: the least time of the
call's counted work (the covariance transforms' and split transforms'
float64 products and factorisations at the float64 tensor-core peak, or the
draws' bytes at the HBM rate, whichever is longer; ``benchmark/mm_work.py``)
over a traced call's wall.  The work is counted from the program's
counters of the lanes' passes and split lanes; a program without them
reads nothing."""

from benchmark.measure import traced
from benchmark.spans import counter_total


def read(ctx):
    t = traced(ctx)
    lane_passes = counter_total("mm_lane_passes") if t is not None else None
    if lane_passes is None:
        return None
    split_lanes = counter_total("mm_split_lanes") or 0.0
    least = ctx.case.work.least_seconds(lane_passes / t.calls, split_lanes / t.calls)
    return 100.0 * least / (t.window_us / 1e6 / t.calls)
