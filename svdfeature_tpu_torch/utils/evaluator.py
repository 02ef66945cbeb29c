# Verbatim copy of svdfeature_tpu/utils/evaluator.py; tests/test_torch_data.py keeps the two identical.
"""Ranking evaluators: MAP, MAP@k, Precision@k, Recall@k (+ NDCG@k).

Port of EvaluatorMAP (apex-utils/apex_evaluator.h:33-215): metrics are
computed from per-user lists of positive-item rank positions (0-based).
Settings parse from strings like "MAP", "MAP@10", "PRE@5", "REC@10"
(comma-separated); NDCG@k is an addition beyond the reference.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np


def average_precision(ranks: Sequence[int], k: int = 0) -> float:
    """AP of one user from sorted positive rank positions (0-based).

    AP = mean over positives of (num positives at rank <= r) / (r+1),
    cut off at k when k > 0 (apex_evaluator.h:94-120).
    """
    r = np.sort(np.asarray(ranks))
    hits = np.arange(1, len(r) + 1, dtype=np.float64)
    prec = hits / (r + 1.0)
    if k > 0:
        prec = prec[r < k]
    if len(np.asarray(ranks)) == 0:
        return 0.0
    return float(prec.sum() / len(r))


def precision_at(ranks: Sequence[int], k: int) -> float:
    r = np.asarray(ranks)
    return float(np.sum(r < k) / k)


def recall_at(ranks: Sequence[int], k: int) -> float:
    r = np.asarray(ranks)
    if len(r) == 0:
        return 0.0
    return float(np.sum(r < k) / len(r))


def ndcg_at(ranks: Sequence[int], k: int) -> float:
    """Binary-relevance NDCG@k from positive rank positions."""
    r = np.asarray(ranks)
    gains = 1.0 / np.log2(r[r < k] + 2.0)
    n = min(len(r), k)
    if n == 0:
        return 0.0
    ideal = float(np.sum(1.0 / np.log2(np.arange(n) + 2.0)))
    return float(gains.sum() / ideal)


class EvaluatorMAP:
    """Accumulates per-user positive-rank lists and reports the configured
    metrics (apex_evaluator.h usage: settings string like "MAP@10,PRE@5")."""

    def __init__(self, setting: str = "MAP"):
        self.specs = []
        for tok in setting.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if "@" in tok:
                name, k = tok.split("@")
                self.specs.append((name.upper(), int(k)))
            else:
                self.specs.append((tok.upper(), 0))
        self.users: List[Sequence[int]] = []

    def add_user(self, pos_ranks: Iterable[int]) -> None:
        self.users.append(list(pos_ranks))

    def eval(self) -> dict:
        out = {}
        for name, k in self.specs:
            if name == "MAP":
                vals = [average_precision(u, k) for u in self.users]
            elif name == "PRE":
                vals = [precision_at(u, k) for u in self.users]
            elif name == "REC":
                vals = [recall_at(u, k) for u in self.users]
            elif name == "NDCG":
                vals = [ndcg_at(u, k) for u in self.users]
            else:
                raise ValueError(f"unknown evaluator {name}")
            key = f"{name}@{k}" if k else name
            out[key] = float(np.mean(vals)) if vals else 0.0
        return out
