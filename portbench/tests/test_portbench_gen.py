"""The traffic generators are deterministic by seed, and every seed gives
the same sizes."""

import numpy as np
import pytest

from portbench.gen import kdd_shard, ml100k_groups
from portbench.tests import tiny

BIG_SEED = 2**31 + 12345


def _same(a, b):
    for split in ("train", "probe"):
        for k in a[split]:
            np.testing.assert_array_equal(a[split][k], b[split][k])


@pytest.mark.parametrize("exponent", [0.0, 0.8])
def test_kdd_shard_by_seed(exponent):
    s = tiny.kdd()
    s.traffic.update(item_zipf_exponent=exponent)
    a = kdd_shard.make(s.cfg["conf"], s.traffic, BIG_SEED)
    _same(a, kdd_shard.make(s.cfg["conf"], s.traffic, BIG_SEED))
    c = kdd_shard.make(s.cfg["conf"], s.traffic, 7)
    assert len(c["train"]["labels"]) == len(a["train"]["labels"]) == 16384
    assert not np.array_equal(c["train"]["users"], a["train"]["users"])
    assert a["train"]["users"].max() < 6000 and a["train"]["items"].max() < 4000


def test_ml100k_groups_by_seed():
    s = tiny.svdpp()
    a = ml100k_groups.make(s.cfg["conf"], s.traffic, BIG_SEED)
    _same(a, ml100k_groups.make(s.cfg["conf"], s.traffic, BIG_SEED))
    c = ml100k_groups.make(s.cfg["conf"], s.traffic, 7)
    assert len(a["train"]["labels"]) == len(c["train"]["labels"]) == 90570
    assert sorted(a["train"]["sizes"]) == sorted(c["train"]["sizes"])
    assert len(a["train"]["sizes"]) == 943 and a["train"]["fb_idx"].max() < 1682
    assert not np.array_equal(a["train"]["users"], c["train"]["users"])
    np.testing.assert_array_equal(a["probe"]["labels"], c["probe"]["labels"])


def test_reorder_keeps_each_group_whole():
    s = tiny.svdpp()
    base = ml100k_groups.load_groups(*s.traffic["train"])
    order = np.arange(len(base["sizes"]))[::-1]
    r = ml100k_groups.reorder(base, order)
    assert r["users"][0] == base["users"][-1]
    assert r["fb_ptr"][-1] == base["fb_ptr"][-1]
    first = r["fb_idx"][r["fb_ptr"][0]:r["fb_ptr"][1]]
    np.testing.assert_array_equal(first, base["fb_idx"][base["fb_ptr"][-2]:base["fb_ptr"][-1]])
