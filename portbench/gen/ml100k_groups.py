"""MovieLens 100K in user groups with implicit feedback, from the files in
``portbench/data/`` (copies of the repository's ``tests/fixtures``
ML-100K user-grouped sets: the ``ua.base`` / ``ua.test`` split written by
SVDFeature's implicitFeedback demo).

A feature file has one rating a line, ``label ng nu ni id:val ...`` (here
``ng = 0`` and one user and one item, value 1); a feedback file has one
line a user group, ``rows nfb id:val ...``: the group's next ``rows``
ratings and its feedback ids with their values.  The seed reorders the
training groups (``group_order: seeded``), the same groups every seed.
"""

from __future__ import annotations

import gzip
import pathlib

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"


def _tokens(name: str):
    with gzip.open(DATA / name, "rt") as f:
        return [line.split() for line in f if line.strip()]


def load_groups(feature: str, feedback: str) -> dict:
    """One split: ``users``, ``items``, ``labels`` a rating, ``sizes`` the
    ratings of each group (consecutive in the file), and the groups'
    feedback as ``fb_ptr`` / ``fb_idx`` / ``fb_val``."""
    users, items, labels = [], [], []
    for tok in _tokens(feature):
        ng, nu, ni = int(tok[1]), int(tok[2]), int(tok[3])
        if (ng, nu, ni) != (0, 1, 1):
            raise ValueError("a rating of one user and one item expected")
        (u, uv), (i, iv) = (p.split(":") for p in tok[4:6])
        if float(uv) != 1.0 or float(iv) != 1.0:
            raise ValueError("feature values of 1 expected")
        users.append(int(u))
        items.append(int(i))
        labels.append(float(tok[0]))
    sizes, fb_ptr, fb_idx, fb_val = [], [0], [], []
    for tok in _tokens(feedback):
        sizes.append(int(tok[0]))
        nfb = int(tok[1])
        pairs = [p.split(":") for p in tok[2:2 + nfb]]
        fb_idx += [int(a) for a, _ in pairs]
        fb_val += [float(b) for _, b in pairs]
        fb_ptr.append(len(fb_idx))
    if sum(sizes) != len(labels):
        raise ValueError("feedback groups do not cover the ratings")
    return dict(users=np.array(users, np.int64), items=np.array(items, np.int64),
                labels=np.array(labels, np.float32), sizes=np.array(sizes, np.int64),
                fb_ptr=np.array(fb_ptr, np.int64), fb_idx=np.array(fb_idx, np.int64),
                fb_val=np.array(fb_val, np.float32))


def reorder(split: dict, order: np.ndarray) -> dict:
    """The split with its groups in ``order`` (each group's ratings and
    feedback move with it)."""
    starts = np.concatenate([[0], np.cumsum(split["sizes"])])
    rows = np.concatenate([np.arange(starts[g], starts[g + 1]) for g in order])
    fbp = split["fb_ptr"]
    fb = np.concatenate([np.arange(fbp[g], fbp[g + 1]) for g in order])
    nfb = (fbp[1:] - fbp[:-1])[order]
    return dict(users=split["users"][rows], items=split["items"][rows],
                labels=split["labels"][rows], sizes=split["sizes"][order],
                fb_ptr=np.concatenate([[0], np.cumsum(nfb)]), fb_idx=split["fb_idx"][fb],
                fb_val=split["fb_val"][fb])


def make(conf: dict, traffic: dict, seed: int) -> dict:
    train = load_groups(*traffic["train"])
    if traffic.get("group_order") == "seeded":
        order = np.random.default_rng(np.random.SeedSequence(int(seed))).permutation(
            len(train["sizes"]))
        train = reorder(train, order)
    return dict(train=train, probe=load_groups(*traffic["probe"]))
