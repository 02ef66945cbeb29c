"""Share of the traced window in which no operation ran on the card, from
the profiler's device records (their union), with the launches the
profiler lost made up from the kernels' own clocks (harness/cell.py)."""


def read(ctx):
    if ctx.busy_s is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
