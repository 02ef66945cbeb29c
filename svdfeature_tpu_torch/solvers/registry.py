"""Solver registry: extend_type/format_type -> trainer class.

Counterpart of svdfeature_tpu/solvers/registry.py (create_svd_trainer /
create_svd_ranker, apex_svd.cpp:32-47): the base solver on the
random-order format, the SVD++ solver (extend_type=1, or the user-group
format), multi-IMFB (extend_type=2), the bilinear solver (extend_type=15),
the GBRT solvers (30 APLambda, 31 Reg) and the ranker.  Custom solvers
register with ``register_trainer`` instead of relinking; a registered
``extend_type`` is looked up before the built-in ones
(svdfeature_tpu/solvers/registry.py:13-24; solvers/example.py registers
99 when imported).
"""

from __future__ import annotations

from typing import Callable, Dict

from ..params import SVDTypeParam, svd_type

_REGISTRY: Dict[int, Callable] = {}


def register_trainer(extend_type: int, factory: Callable) -> None:
    """Make ``create_svd_trainer`` build ``factory(mtype)`` for
    ``extend_type``, before any built-in solver of that type."""
    _REGISTRY[extend_type] = factory


def create_svd_trainer(mtype: SVDTypeParam):
    """apex_svd.cpp:32-44 dispatch."""
    from .base import SVDFeatureTrainer
    from .bilinear import SVDBiLinearTrainer
    from .gbrt import create_gbrt_trainer
    from .multi_imfb import SVDPPMultiIMFBTrainer
    from .svdpp import SVDPPFeatureTrainer

    et = mtype.extend_type
    if et in _REGISTRY:
        return _REGISTRY[et](mtype)
    if et == 2:
        return SVDPPMultiIMFBTrainer(mtype)
    if et == 15:
        return SVDBiLinearTrainer(mtype)
    if et in (30, 31):
        return create_gbrt_trainer(mtype)
    if et == 1 or (et == 0 and mtype.format_type == svd_type.USER_GROUP_FORMAT):
        return SVDPPFeatureTrainer(mtype)
    if et != 0:
        raise ValueError(f"unknown extension type {et}")
    return SVDFeatureTrainer(mtype)


def create_svd_ranker(mtype: SVDTypeParam):
    """apex_svd.cpp:45-47."""
    from .ranker import SVDFeatureRanker

    return SVDFeatureRanker(mtype)
