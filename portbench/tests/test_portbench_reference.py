"""The plain references against hand-worked examples at a tiny size."""

import numpy as np
import pytest
import torch

from portbench.reference import mf, svdpp

CONF = {"learning_rate": "0.1", "base_score": "3", "wd_user": "0.5", "wd_item": "0.5",
        "batch_size": "3"}


def _leaves(user_w, item_w, **extra):
    L = dict(user_w=torch.tensor(user_w), item_w=torch.tensor(item_w),
             user_b=torch.zeros(len(user_w)), item_b=torch.zeros(len(item_w)), g=torch.zeros(0))
    L.update({k: torch.tensor(v) for k, v in extra.items()})
    return L


def test_mf_one_batch_by_hand():
    # errors 0.97, -1.04, -0.08; user 0 and item 1 touched twice: decay 0.95^2
    L = _leaves([[0.1], [0.2]], [[0.3], [0.4]])
    rows = dict(users=np.array([0, 0, 1]), items=np.array([0, 1, 1]),
                labels=np.array([4.0, 2.0, 3.0], np.float32))
    mf.train(L, {"train": rows}, CONF, 1)
    np.testing.assert_allclose(L["user_w"][:, 0], [0.0875 * 0.9025, 0.1968 * 0.95], rtol=1e-6)
    np.testing.assert_allclose(L["item_w"][:, 0], [0.3097 * 0.95, 0.388 * 0.9025], rtol=1e-6)
    np.testing.assert_allclose(L["user_b"], [-0.007, -0.008], rtol=1e-5)
    np.testing.assert_allclose(L["item_b"], [0.097, -0.112], rtol=1e-5)
    probe = dict(users=np.array([1]), items=np.array([0]), labels=np.zeros(1, np.float32))
    want = 3 - 0.008 + 0.097 + 0.18696 * 0.294215
    np.testing.assert_allclose(mf.predict(L, {"probe": probe}, CONF), [want], rtol=1e-6)


def test_mf_half_fault_drops_rows_and_doubles_the_rest():
    L = _leaves([[0.1], [0.2]], [[0.3], [0.4]])
    rows = dict(users=np.array([0, 1]), items=np.array([0, 1]),
                labels=np.array([4.0, 3.0], np.float32))
    mf.train(L, {"train": rows}, dict(CONF, batch_size="2"), 1, fault="half")
    assert float(L["user_b"][1]) == 0.0  # the left-out row moved nothing
    np.testing.assert_allclose(float(L["user_b"][0]), 0.1 * 2 * 0.97, rtol=1e-6)


def test_svdpp_layout():
    chunks, steps = svdpp.layout(np.array([3, 5, 1]), G=2, M=2, sort_blocks=True)
    assert [list(c) for c in chunks] == [[1, 0], [2]]
    got = [(c, list(r), list(s)) for c, r, s in steps]
    assert got == [(0, [3, 4, 0, 1], [0, 0, 1, 1]), (0, [5, 6, 2], [0, 0, 1]),
                   (0, [7], [0]), (1, [8], [0])]


def test_svdpp_one_step_by_hand():
    conf = {"learning_rate": "0.1", "base_score": "3", "rows_per_user": "2",
            "users_per_batch": "128", "sort_blocks": "1"}
    L = _leaves([[0.1]], [[0.3], [0.4]], fb_w=[[0.5]], fb_b=[0.0])
    split = dict(users=np.array([0, 0]), items=np.array([0, 1]),
                 labels=np.array([4.0, 2.0], np.float32), sizes=np.array([2]),
                 fb_ptr=np.array([0, 1]), fb_idx=np.array([0]), fb_val=np.array([1.0], np.float32))
    svdpp.train(L, {"train": split}, conf, 1)
    # errors 0.82 and -1.24 with p_u = 0.1 + 0.5
    np.testing.assert_allclose(float(L["user_w"][0, 0]), 0.075, rtol=1e-5)
    np.testing.assert_allclose(L["item_w"][:, 0], [0.3492, 0.3256], rtol=1e-5)
    np.testing.assert_allclose(float(L["user_b"][0]), -0.042, rtol=1e-5)
    np.testing.assert_allclose(L["item_b"], [0.082, -0.124], rtol=1e-5)
    # the two rows' feedback step, damped: e = -0.25 / 1.0125, eb = -0.42 / 1.1
    np.testing.assert_allclose(float(L["fb_w"][0, 0]), 0.5 + 0.1 * (-0.25 / 1.0125), rtol=1e-6)
    np.testing.assert_allclose(float(L["fb_b"][0]), 0.1 * (-0.42 / 1.1), rtol=1e-5)
    p = svdpp.predict(L, {"probe": split}, conf)
    s = float(L["fb_w"][0, 0])
    want = [3 + float(L["item_b"][j]) + float(L["user_b"][0]) + float(L["fb_b"][0])
            + (float(L["user_w"][0, 0]) + s) * float(L["item_w"][j, 0]) for j in (0, 1)]
    np.testing.assert_allclose(p, want, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_references_keep_the_tables_dtype(dtype):
    L = {k: v.to(dtype) for k, v in _leaves([[0.1], [0.2]], [[0.3], [0.4]]).items()}
    rows = dict(users=np.array([0, 1]), items=np.array([1, 0]),
                labels=np.array([4.0, 2.0], np.float32))
    mf.train(L, {"train": rows}, CONF, 2)
    assert all(v.dtype == dtype for v in L.values())
