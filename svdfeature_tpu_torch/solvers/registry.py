"""Solver registry: extend_type/format_type -> trainer class.

Counterpart of svdfeature_tpu/solvers/registry.py (create_svd_trainer /
create_svd_ranker, apex_svd.cpp:32-47).  The port has the base solver on
the random-order format, the SVD++ solver (extend_type=1, or the
user-group format), multi-IMFB (extend_type=2), the bilinear solver
(extend_type=15) and the ranker so far; the GBRT solvers (30, 31) raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

from ..params import SVDTypeParam, svd_type

_NOT_PORTED = {
    30: "GBRT (extend_type=30) is ROADMAP Queue 1 item 10",
    31: "GBRT (extend_type=31) is ROADMAP Queue 1 item 10",
}


def create_svd_trainer(mtype: SVDTypeParam):
    """apex_svd.cpp:32-44 dispatch."""
    from .base import SVDFeatureTrainer
    from .bilinear import SVDBiLinearTrainer
    from .multi_imfb import SVDPPMultiIMFBTrainer
    from .svdpp import SVDPPFeatureTrainer

    et = mtype.extend_type
    if et in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[et])
    if et == 2:
        return SVDPPMultiIMFBTrainer(mtype)
    if et == 15:
        return SVDBiLinearTrainer(mtype)
    if et == 1 or (et == 0 and mtype.format_type == svd_type.USER_GROUP_FORMAT):
        return SVDPPFeatureTrainer(mtype)
    if et != 0:
        raise ValueError(f"unknown extension type {et}")
    return SVDFeatureTrainer(mtype)


def create_svd_ranker(mtype: SVDTypeParam):
    """apex_svd.cpp:45-47."""
    from .ranker import SVDFeatureRanker

    return SVDFeatureRanker(mtype)
