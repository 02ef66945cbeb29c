"""K2's share of its roofline: the least time of a round (roofline/k2.py)
over K2's device time a round, from the profiler or,
where it lost the launches, from K2's own clock."""

from portbench.roofline import k2


def read(ctx):
    n, secs = ctx.kernel_time("K2")
    if not n:
        return None
    return 100.0 * k2.round_seconds(ctx.conf, ctx.data) / (secs / ctx.rounds)
