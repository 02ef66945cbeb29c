"""K5's share of its roofline: the least time of the round's row writes
(roofline/k5.py: one write a sorted-dedup step, its 2B entries and the
step's distinct rows of factors, bias and counter) over the device time of
K5's launches, from the profiler."""

from portbench.roofline import k5
from portbench.roofline.steps import mf_steps


def read(ctx):
    n, secs = ctx.kernel_time("K5")
    if not n:
        return None
    W = int(ctx.conf["num_factor"]) + 2
    steps = mf_steps(ctx.conf, ctx.data["train"])
    least = sum(k5.write_seconds(2 * ex, W, nu + ni) for ex, nu, ni in steps) / len(steps)
    return 100.0 * least / (secs / n)
