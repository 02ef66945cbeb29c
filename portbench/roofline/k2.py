"""K2's least work for one round of SVD++ (``csrc/fused_svdpp.cu``).

Frozen copy of the repository's ``chip_smoke.svdpp_bound`` (one round, one
user plane), its inputs worked out from the groups by the reference's own
layout (``portbench/reference/svdpp.layout``): each input read once (the
live pool entries only), each output written once; operations per live
row (5 + 4 SI) k, per step 2 nnz(O[c]) (k + 1) for the overlap product
over the chunk's nonzero overlaps plus 6 (k + 1) a user, per touched row
2k, and per chunk start 4 (k + 2) a live pool entry (gather and flush)."""

from __future__ import annotations

import numpy as np

from ..reference.svdpp import hyper, layout
from . import peaks


def round_seconds(conf: dict, data: dict) -> float:
    split = data["train"]
    h = hyper(conf)
    k = int(conf["num_factor"])
    N = int(conf["num_ufeedback"]) + int(conf["num_user"]) + int(conf["num_item"]) + 1
    chunks, steps = layout(split["sizes"], h["G"], h["M"], h["sort"])
    G = len(chunks[0])
    GS, SI, T = G * h["M"], 1, len(steps)
    ptr = split["fb_ptr"]
    nnz, pool_live = [], []
    for ch in chunks:
        ids = [set(split["fb_idx"][ptr[b]:ptr[b + 1]].tolist()) for b in ch]
        nnz.append(sum(1 for a in ids for b in ids if a & b))
        pool_live.append(sum(len(x) for x in ids))
    live = sum(len(r) for _, r, _ in steps)
    touched = sum(len(np.unique(split["users"][r])) + len(np.unique(split["items"][r]))
                  for _, r, _ in steps)
    flops = (live * (5 + 4 * SI) * k
             + sum(2 * nnz[c] * (k + 1) + 6 * G * (k + 1) for c, _, _ in steps)
             + sum(pool_live) * 4 * (k + 2) + touched * 2 * k)
    moved = 4 * (2 * N * (k + 1) + T * GS * 2 + T * GS * (2 + 2 * SI) + 3 * sum(pool_live)
                 + len(chunks) * (G + 1) ** 2 + 2 * N + 3)
    return peaks.least_seconds(flops, moved)
