"""Per-step counts from the data: the rows each step of a round touches.

The steps are the configuration's batches worked out from the data alone
(the reference's own layout), not the program's packing."""

from __future__ import annotations

import numpy as np


def mf_steps(conf: dict, rows: dict):
    """(examples, distinct users, distinct items) of each batch of
    ``batch_size`` consecutive rows."""
    B = int(conf["batch_size"])
    out = []
    for a in range(0, len(rows["labels"]), B):
        u, i = rows["users"][a:a + B], rows["items"][a:a + B]
        out.append((len(u), len(np.unique(u)), len(np.unique(i))))
    return out
