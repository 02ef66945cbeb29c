"""The port's loss library (svdfeature_tpu_torch/losses.py) against the JAX
package's, for all 7 active types, on the same numpy inputs (atol 1e-6)."""

import numpy as np
import pytest
import torch

from svdfeature_tpu import losses as JL
from svdfeature_tpu_torch import losses as TL

ATOL = 1e-6


def _inputs(atype):
    rng = np.random.RandomState(atype)
    pred = rng.uniform(-3.0, 3.0, 64).astype(np.float32)
    if atype in (TL.SIGMOID_L2, TL.SIGMOID_LIKELIHOOD):
        pred = 1.0 / (1.0 + np.exp(-pred))  # activated outputs in (0, 1)
    label = (rng.rand(64) < 0.5).astype(np.float32)
    return label, pred.astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("atype", TL.ALL_TYPES)
def test_losses_match_jax(atype):
    assert TL.ALL_TYPES == JL.ALL_TYPES
    label, pred = _inputs(atype)
    r, p = torch.from_numpy(label), torch.from_numpy(pred)
    score = torch.from_numpy(np.linspace(-3, 3, 64, dtype=np.float32))
    _close(TL.map_active(score, atype), JL.map_active(score.numpy(), atype))
    _close(TL.cal_grad(r, p, atype), JL.cal_grad(label, pred, atype))
    _close(TL.calc_loss(r, p, atype), JL.calc_loss(label, pred, atype))
    if atype == TL.SIGMOID_L2:  # no second-order gradient in the reference
        with pytest.raises(ValueError):
            JL.cal_sgrad(label, pred, atype)
        with pytest.raises(ValueError):
            TL.cal_sgrad(r, p, atype)
    else:
        _close(TL.cal_sgrad(r, p, atype), JL.cal_sgrad(label, pred, atype))
    for base in (0.25, 0.5, 3.0):
        try:
            want = JL.calc_base_score(base, atype)
        except ValueError:
            with pytest.raises(ValueError):
                TL.calc_base_score(base, atype)
        else:
            assert TL.calc_base_score(base, atype) == pytest.approx(want, abs=ATOL)
    assert TL.is_sigmoid_output(atype) == JL.is_sigmoid_output(atype)


def test_unknown_active_type_raises():
    x = torch.zeros(3)
    for fn in (TL.map_active, lambda s, a: TL.cal_grad(s, s, a)):
        with pytest.raises(ValueError):
            fn(x, 4)
