"""KDD-Cup-2011-scale synthetic ratings, numpy only, from the seed.

Rewritten in numpy from the repository's ``bench.py`` bigTable recipe
(``bench_big``) and ``chip_smoke.zipf_items``: a round is a shard of
``examples_per_round`` (user, item, rating) rows over the configuration's
whole user and item ranges.  Users are uniform; items follow a Zipf law
of ``item_zipf_exponent`` over a seeded permutation of the items (an
exponent of 0 makes them uniform); ratings are
``label_base`` plus a planted rank-``planted_rank`` product of factors drawn
with ``planted_scale``.  The probe is a further ``probe_examples`` rows of
the same law, trained by no one.

Every seed gives the same sizes: only the ids and the ratings change.
"""

from __future__ import annotations

import numpy as np


def _zipf_items(rng, n_items: int, size: int, exponent: float, perm: np.ndarray) -> np.ndarray:
    cdf = np.cumsum(np.arange(1, n_items + 1, dtype=np.float64) ** -exponent)
    ranks = np.searchsorted(cdf, rng.random(size) * cdf[-1])
    return perm[np.minimum(ranks, n_items - 1)].astype(np.int64)


def make(conf: dict, traffic: dict, seed: int) -> dict:
    """The cell's rows: ``train`` and ``probe``, each a dict of ``users``,
    ``items`` (int64 ids local to their ranges) and ``labels`` (float32)."""
    nu, ni = int(conf["num_user"]), int(conf["num_item"])
    n, n_probe = int(traffic["examples_per_round"]), int(traffic["probe_examples"])
    rank, scale = int(traffic["planted_rank"]), float(traffic["planted_scale"])
    ss = np.random.SeedSequence(int(seed))
    r_perm, r_fac, r_train, r_probe = (np.random.default_rng(s) for s in ss.spawn(4))
    perm = r_perm.permutation(ni)
    pu = r_fac.standard_normal((nu, rank), dtype=np.float32) * np.float32(scale)
    qi = r_fac.standard_normal((ni, rank), dtype=np.float32) * np.float32(scale)

    def rows(rng, size):
        users = rng.integers(0, nu, size, dtype=np.int64)
        items = _zipf_items(rng, ni, size, float(traffic["item_zipf_exponent"]), perm)
        labels = np.float32(traffic["label_base"]) + np.einsum("ek,ek->e", pu[users], qi[items])
        return dict(users=users, items=items, labels=labels.astype(np.float32))

    return dict(train=rows(r_train, n), probe=rows(r_probe, n_probe))
