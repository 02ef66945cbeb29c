"""The whole MF step's least work, a round at a time, from the cell's
shapes: each example's two ids and its label read once; each touched row's
factors and bias read once and written once; operations 8k an example
(the two gathered rows scaled, their dot, the two coef * p products and
their sums) and 2k a touched row (the add and the decay).  The counts of
the repository's ``chip_smoke.embed_bound`` for one global-free entry a
side, frozen here."""

from __future__ import annotations

from . import peaks
from .steps import mf_steps


def round_seconds(conf: dict, data: dict) -> float:
    k = int(conf["num_factor"])
    total = 0.0
    for ex, nu, ni in mf_steps(conf, data["train"]):
        rows = nu + ni
        total += peaks.least_seconds(ex * 8 * k + rows * 2 * k, 4 * (3 * ex + rows * 2 * (k + 1)))
    return total
