"""Plain reference of biased matrix factorization: SVDFeature's batched SGD
step (apex_svd_base.h, update_no_decay with the L2 decay of
regularize(post), reg_method 0, linear loss) on whole tables, in plain
PyTorch, independent of the port.

Per batch of consecutive rows of a round, on the tables as the batch found
them: ``pred = base + b_u + b_i + w_u . w_i``, ``err = label - pred``; each
row gains ``lr * err`` times the other side's factors (its bias ``lr *
err``), summed over the batch's rows; then every row touched ``c`` times in
the batch decays by ``(1 - lr * wd) ** c`` (factors by ``wd_user`` /
``wd_item``, biases by ``wd_user_bias`` / ``wd_item_bias``).  The batch is
``batch_size`` rows, the last one shorter.

``fault`` plants the faults the benchmark's control test needs: ``"half"``
leaves out the second half of every batch and doubles the error of the
rest (the mean taken over what is left).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def _f(conf: dict, name: str, default: float = 0.0) -> float:
    return float(conf.get(name, default))


def hyper(conf: dict) -> dict:
    if int(conf.get("active_type", 0)) != 0:
        raise ValueError("the plain reference takes active_type 0 (the linear loss) only")
    return dict(lr=_f(conf, "learning_rate", 0.01), base=_f(conf, "base_score", 0.5),
                wd_u=_f(conf, "wd_user"), wd_i=_f(conf, "wd_item"),
                wd_ub=_f(conf, "wd_user_bias"), wd_ib=_f(conf, "wd_item_bias"))


def _rows_on(rows: dict, device, dtype):
    return (torch.as_tensor(rows["users"], device=device),
            torch.as_tensor(rows["items"], device=device),
            torch.as_tensor(rows["labels"], device=device).to(dtype))


def _decay(L: Dict[str, torch.Tensor], side: str, idx: torch.Tensor, lr: float, wd: float,
           wd_b: float) -> None:
    w, b = L[f"{side}_w"], L[f"{side}_b"]
    c = torch.bincount(idx, minlength=w.shape[0]).to(w.dtype)
    w.mul_(torch.pow(1.0 - lr * wd, c)[:, None])
    b.mul_(torch.pow(1.0 - lr * wd_b, c))


def step(L: Dict[str, torch.Tensor], u, i, y, h: dict, fault: Optional[str] = None) -> None:
    """One batch, in place."""
    if fault == "half":
        keep = (y.shape[0] + 1) // 2
        u, i, y = u[:keep], i[:keep], y[:keep]
    wu, wi = L["user_w"][u], L["item_w"][i]
    pred = h["base"] + L["user_b"][u] + L["item_b"][i] + (wu * wi).sum(dim=1)
    err = y - pred
    if fault == "half":
        err = err * 2.0
    c = h["lr"] * err
    L["user_w"].index_add_(0, u, c[:, None] * wi)
    L["item_w"].index_add_(0, i, c[:, None] * wu)
    L["user_b"].index_add_(0, u, c)
    L["item_b"].index_add_(0, i, c)
    _decay(L, "user", u, h["lr"], h["wd_u"], h["wd_ub"])
    _decay(L, "item", i, h["lr"], h["wd_i"], h["wd_ib"])


@torch.no_grad()
def train(L: Dict[str, torch.Tensor], data: dict, conf: dict, rounds: int,
          after_round: Optional[Callable[[int], None]] = None, fault: Optional[str] = None):
    """``rounds`` rounds over ``data["train"]`` in place; ``after_round(r)``
    after each."""
    h = hyper(conf)
    u, i, y = _rows_on(data["train"], L["user_w"].device, L["user_w"].dtype)
    B = int(conf["batch_size"])
    for r in range(rounds):
        for a in range(0, y.shape[0], B):
            step(L, u[a:a + B], i[a:a + B], y[a:a + B], h, fault)
        if after_round is not None:
            after_round(r)


@torch.no_grad()
def predict(L: Dict[str, torch.Tensor], data: dict, conf: dict) -> torch.Tensor:
    """Scores of ``data["probe"]``'s rows."""
    u, i, _ = _rows_on(data["probe"], L["user_w"].device, L["user_w"].dtype)
    return (hyper(conf)["base"] + L["user_b"][u] + L["item_b"][i]
            + (L["user_w"][u] * L["item_w"][i]).sum(dim=1))
