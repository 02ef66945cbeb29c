"""Loss / activation library: 7 loss-link types with exact reference formulas.

PyTorch counterpart of svdfeature_tpu/losses.py (namespace active_type,
apex_svd_model.h:61-238).  ``atype`` is static model configuration, so the
dispatch is a Python branch.  Inputs are tensors; every result keeps the
input's device and dtype.
"""

from __future__ import annotations

import math

import torch

LINEAR = 0
SIGMOID_L2 = 1
SIGMOID_LIKELIHOOD = 2
SIGMOID_RANK = 3
HINGE_SMOOTH = 5
HINGE_L2 = 6
SIGMOID_QSGRAD = 7

ALL_TYPES = (
    LINEAR,
    SIGMOID_L2,
    SIGMOID_LIKELIHOOD,
    SIGMOID_RANK,
    HINGE_SMOOTH,
    HINGE_L2,
    SIGMOID_QSGRAD,
)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    # the reference's 1/(1+exp(-x)), not torch.sigmoid's rewritten form
    return 1.0 / (1.0 + torch.exp(-x))


def _smooth_hinge_grad(z: torch.Tensor) -> torch.Tensor:
    """apex_svd_model.h:90-94 (gradient of smoothed hinge at label=1)."""
    return torch.clamp(1.0 - z, 0.0, 1.0)


def _smooth_hinge_loss(z: torch.Tensor) -> torch.Tensor:
    """apex_svd_model.h:100-104."""
    return torch.where(
        z > 1.0,
        torch.zeros_like(z),
        torch.where(z < 0.0, 0.5 - z, 0.5 * (1.0 - z) ** 2),
    )


def map_active(s: torch.Tensor, atype: int) -> torch.Tensor:
    """Activation applied to the raw score (apex_svd_model.h:112-123)."""
    if atype in (SIGMOID_L2, SIGMOID_LIKELIHOOD):
        return _sigmoid(s)
    if atype in (LINEAR, SIGMOID_RANK, HINGE_SMOOTH, HINGE_L2, SIGMOID_QSGRAD):
        return s
    raise ValueError(f"unknown active type {atype}")


def cal_grad(r: torch.Tensor, pred: torch.Tensor, atype: int) -> torch.Tensor:
    """Gradient of the objective to *maximize* (apex_svd_model.h:132-156)."""
    if atype == LINEAR:
        return r - pred
    if atype == SIGMOID_L2:
        return (r - pred) * pred * (1.0 - pred)
    if atype == SIGMOID_LIKELIHOOD:
        return r - pred
    if atype in (SIGMOID_QSGRAD, SIGMOID_RANK):
        return r - _sigmoid(pred)
    if atype == HINGE_SMOOTH:
        return torch.where(
            r > 0.5, _smooth_hinge_grad(pred - 0.5), -_smooth_hinge_grad(0.5 - pred)
        )
    if atype == HINGE_L2:
        zero = torch.zeros_like(pred)
        return torch.where(
            r > 0.5,
            torch.where(pred > 1.0, zero, r - pred),
            torch.where(pred < 0.0, zero, r - pred),
        )
    raise ValueError(f"unknown active type {atype}")


def cal_sgrad(r: torch.Tensor, pred: torch.Tensor, atype: int) -> torch.Tensor:
    """Second-order gradient (apex_svd_model.h:200-213)."""
    if atype in (LINEAR, HINGE_SMOOTH, HINGE_L2):
        return torch.full_like(pred, -1.0)
    if atype == SIGMOID_LIKELIHOOD:
        return -pred * (1.0 - pred)
    if atype == SIGMOID_RANK:
        p = _sigmoid(pred)
        return -p * (1.0 - p)
    if atype == SIGMOID_QSGRAD:
        return torch.full_like(pred, -0.25)
    raise ValueError(f"unknown second order gradient for active type {atype}")


def calc_loss(r: torch.Tensor, pred: torch.Tensor, atype: int) -> torch.Tensor:
    """Loss value (apex_svd_model.h:164-190).

    The reference computes the log-likelihood loss as
    ``-r*log(p) - (1-r)*log(p)`` (apex_svd_model.h:170), i.e. ``-log(p)``
    whatever the label; replicated verbatim since it is only reported.
    """
    if atype in (LINEAR, SIGMOID_L2):
        return 0.5 * (r - pred) ** 2
    if atype in (SIGMOID_QSGRAD, SIGMOID_RANK, SIGMOID_LIKELIHOOD):
        p = _sigmoid(pred) if atype != SIGMOID_LIKELIHOOD else pred
        return -r * torch.log(p) - (1.0 - r) * torch.log(p)
    if atype == HINGE_SMOOTH:
        z = pred - 0.5
        return torch.where(r > 0.5, _smooth_hinge_loss(z), -_smooth_hinge_loss(-z))
    if atype == HINGE_L2:
        return torch.where(
            r > 0.5,
            0.5 * (1.0 - torch.clamp(pred, max=1.0)) ** 2,
            0.5 * torch.clamp(pred, min=0.0) ** 2,
        )
    raise ValueError(f"unknown active type {atype}")


def calc_base_score(base_score: float, atype: int) -> float:
    """Inverse-link transform of base_score (apex_svd_model.h:220-237);
    a Python scalar, applied once at model init."""
    if atype in (LINEAR, HINGE_L2, HINGE_SMOOTH):
        return float(base_score)
    if atype in (SIGMOID_L2, SIGMOID_LIKELIHOOD, SIGMOID_RANK, SIGMOID_QSGRAD):
        if not (0.0 < base_score < 1.0):
            raise ValueError("sigmoid range constrain")
        return float(-math.log(1.0 / base_score - 1.0))
    raise ValueError(f"unknown active type {atype}")


def is_sigmoid_output(atype: int) -> bool:
    """Whether prediction output goes through the sigmoid link."""
    return atype in (SIGMOID_L2, SIGMOID_LIKELIHOOD)
