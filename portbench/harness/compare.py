"""The numbers that decide ``correct``: the program's trained leaves and
probe scores against the plain reference's, from the same initial leaves
and data.

* ``change_gap_r1`` / ``change_gap``: by the worst leaf, the gap between
  the norms of the program's and the reference's change of the leaf (after
  the first compared round, and after all of them), over the reference's
  change of that leaf or of the median leaf, whichever is larger.
* ``state_gap``: by the worst leaf, the norm of the difference of the two
  trained leaves over the same denominator.
* ``probe_gap``: the largest difference of a probe row's score.

A leaf whose reference change is under a thousandth of the median leaf's
moves by round-off alone and is left out of the leaf numbers (none of the
current cells has one).
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

NOUGHT = 1e-3


def norms(leaves: Dict[str, torch.Tensor], init: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each non-empty leaf's change from ``init``, as a norm."""
    return {n: float(torch.linalg.vector_norm(leaves[n].double() - init[n].double()))
            for n in leaves if leaves[n].numel()}


def _scale(ref: Dict[str, float]):
    med = statistics.median(ref.values())
    kept = {n: v for n, v in ref.items() if v >= NOUGHT * med}
    return {n: max(v, med) for n, v in kept.items()}


def change_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    return max(abs(prog[n] - ref[n]) / d for n, d in _scale(ref).items())


def state_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              ref_change: Dict[str, float]) -> float:
    return max(float(torch.linalg.vector_norm(prog[n].double() - ref[n].double())) / d
               for n, d in _scale(ref_change).items())


def probe_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return float((prog.double() - ref.double()).abs().max())
