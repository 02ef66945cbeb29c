"""Plain reference of SVD++ with implicit user feedback on user-grouped
data, SVDFeature's SVDPPFeature (apex_svd_base.h:484-592) in the batched
layout the configuration's keys ask for, in plain PyTorch, independent of
the port.

Layout, worked out here from the groups alone: with ``sort_blocks`` the
groups go by size, largest first (ties in data order); they fall into
chunks of ``users_per_batch`` (G) consecutive groups; a chunk takes
``ceil(largest group / M)`` steps, step t of it holding rows ``[t*M,
t*M + M)`` of each of its groups (``M = rows_per_user``).

A step, on the tables as the step found them: each group's feedback sum
``s = sum_j v_j fb_w[j]``, bias sum ``sb = sum_j v_j fb_b[j]`` and norm
``n = sum_j v_j^2`` over its feedback pool; per row ``p_u = w_u + s``,
``pred = base + b_i + b_u + sb + p_u . w_i``, ``err = label - pred``; the
user and item rows gain ``lr * err`` times the other side's factor (``p_u``
for items), biases ``lr * err``; per group, with ``m`` rows in the step,
``e = sum err * w_i`` and ``eb = sum err`` (for M > 1 damped by ``1 + lr *
n * sum |w_i|^2 * (m - 1) / m`` and ``1 + lr * n * (m - 1)``, the implicit
form of the reference's row-by-row recurrence), the deltas ``(s * (d^m -
1) + lr * n * e) / n`` and ``(sb * (db^m - 1) + lr * n * eb) / n`` with
``d = 1 - lr * wd_ufeedback`` and ``db = 1 - lr * wd_ufeedback_bias``,
each pool row gaining ``v_j`` times its group's deltas; then the user and
item rows decay by ``(1 - lr * wd) ** touches`` as in the MF reference.

``fault="half"``: the second half of each step's rows left out and the
error of the rest doubled.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import mf


def layout(sizes: np.ndarray, G: int, M: int, sort_blocks: bool):
    """(chunks, steps): each chunk's group ids, and each step as (chunk,
    the step's row offsets within the split, each row's group slot)."""
    sizes = np.asarray(sizes, np.int64)
    order = np.argsort(-sizes, kind="stable") if sort_blocks else np.arange(len(sizes))
    G = max(1, min(G, len(sizes)))
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    chunks = [order[a:a + G] for a in range(0, len(order), G)]
    steps = []
    for c, ch in enumerate(chunks):
        for t in range(-(-int(sizes[ch].max()) // M)):
            rows: List[np.ndarray] = []
            slots: List[np.ndarray] = []
            for g, blk in enumerate(ch):
                lo, hi = t * M, min(t * M + M, int(sizes[blk]))
                if lo < hi:
                    rows.append(starts[blk] + np.arange(lo, hi))
                    slots.append(np.full(hi - lo, g))
            steps.append((c, np.concatenate(rows), np.concatenate(slots)))
    return chunks, steps


def _pools(split: dict, chunks, device, dtype):
    """Each chunk's pool: feedback row ids, values and group slots."""
    ptr = split["fb_ptr"]
    out = []
    for ch in chunks:
        ids = [split["fb_idx"][ptr[b]:ptr[b + 1]] for b in ch]
        vals = [split["fb_val"][ptr[b]:ptr[b + 1]] for b in ch]
        slots = [np.full(len(x), g) for g, x in enumerate(ids)]
        out.append((torch.as_tensor(np.concatenate(ids), device=device).long(),
                    torch.as_tensor(np.concatenate(vals), device=device).to(dtype),
                    torch.as_tensor(np.concatenate(slots), device=device).long()))
    return out


def _aggregates(L, pool, G):
    ids, vals, slots = pool
    w = L["fb_w"]
    s = torch.zeros((G, w.shape[1]), dtype=w.dtype, device=w.device)
    s.index_add_(0, slots, w[ids] * vals[:, None])
    sb = torch.zeros(G, dtype=w.dtype, device=w.device).index_add_(0, slots, L["fb_b"][ids] * vals)
    n = torch.zeros(G, dtype=w.dtype, device=w.device).index_add_(0, slots, vals * vals)
    return s, sb, n


def hyper(conf: dict) -> dict:
    h = mf.hyper(conf)
    lr_fb = h["lr"] * mf._f(conf, "scale_lr_ufeedback", 1.0)
    h.update(lr_fb=lr_fb, d=1.0 - lr_fb * mf._f(conf, "wd_ufeedback"),
             db=1.0 - lr_fb * mf._f(conf, "wd_ufeedback_bias"),
             G=int(conf.get("users_per_batch", 128)), M=int(conf.get("rows_per_user", 1)),
             sort=bool(int(conf.get("sort_blocks", 0))))
    return h


def step(L: Dict[str, torch.Tensor], rows, slots, pool, G: int, h: dict,
         fault: Optional[str] = None) -> None:
    """One step of a chunk, in place: ``rows`` (users, items, labels) of the
    step's rows, ``slots`` their groups in the chunk, ``pool`` the chunk's."""
    u, i, y = rows
    if fault == "half":
        keep = (y.shape[0] + 1) // 2
        u, i, y, slots = u[:keep], i[:keep], y[:keep], slots[:keep]
    s, sb, n = _aggregates(L, pool, G)
    wu, wi = L["user_w"][u], L["item_w"][i]
    p_u = wu + s[slots]
    pred = h["base"] + L["item_b"][i] + L["user_b"][u] + sb[slots] + (p_u * wi).sum(dim=1)
    err = y - pred
    if fault == "half":
        err = err * 2.0
    c = h["lr"] * err
    L["user_w"].index_add_(0, u, c[:, None] * wi)
    L["item_w"].index_add_(0, i, c[:, None] * p_u)
    L["user_b"].index_add_(0, u, c)
    L["item_b"].index_add_(0, i, c)

    zeros = torch.zeros(G, dtype=err.dtype, device=err.device)
    m = torch.bincount(slots, minlength=G).to(err.dtype)
    e = torch.zeros((G, wi.shape[1]), dtype=err.dtype, device=err.device)
    e.index_add_(0, slots, err[:, None] * wi)
    eb = zeros.clone().index_add_(0, slots, err)
    lr_fb = h["lr_fb"]
    if h["M"] > 1:
        frac = torch.where(m > 0, (m - 1.0) / torch.clamp(m, min=1.0), 0.0)
        pip2 = zeros.clone().index_add_(0, slots, (wi * wi).sum(dim=1))
        e = e / (1.0 + lr_fb * n * pip2 * frac)[:, None]
        eb = eb / (1.0 + lr_fb * n * (m - 1.0) * (m > 0))
    inv = torch.where(n > 0, 1.0 / torch.clamp(n, min=1e-30), 0.0)
    delta = (s * (torch.pow(torch.full_like(m, h["d"]), m) - 1.0)[:, None]
             + lr_fb * n[:, None] * e) * inv[:, None]
    delta_b = (sb * (torch.pow(torch.full_like(m, h["db"]), m) - 1.0) + lr_fb * n * eb) * inv
    ids, vals, pslots = pool
    L["fb_w"].index_add_(0, ids, delta[pslots] * vals[:, None])
    L["fb_b"].index_add_(0, ids, delta_b[pslots] * vals)

    mf._decay(L, "user", u, h["lr"], h["wd_u"], h["wd_ub"])
    mf._decay(L, "item", i, h["lr"], h["wd_i"], h["wd_ib"])


@torch.no_grad()
def train(L: Dict[str, torch.Tensor], data: dict, conf: dict, rounds: int,
          after_round: Optional[Callable[[int], None]] = None, fault: Optional[str] = None):
    """``rounds`` rounds over ``data["train"]``'s groups in place."""
    h = hyper(conf)
    split = data["train"]
    dev, dt = L["user_w"].device, L["user_w"].dtype
    chunks, steps = layout(split["sizes"], h["G"], h["M"], h["sort"])
    G = len(chunks[0])
    pools = _pools(split, chunks, dev, dt)
    u, i, y = mf._rows_on(split, dev, dt)
    plan = [(c, torch.as_tensor(r, device=dev), torch.as_tensor(s, device=dev))
            for c, r, s in steps]
    for r in range(rounds):
        for c, rws, slots in plan:
            step(L, (u[rws], i[rws], y[rws]), slots, pools[c], G, h, fault)
        if after_round is not None:
            after_round(r)


@torch.no_grad()
def predict(L: Dict[str, torch.Tensor], data: dict, conf: dict) -> torch.Tensor:
    """Scores of ``data["probe"]``'s rows, each group's feedback from the
    probe split's feedback file."""
    split = data["probe"]
    dev, dt = L["user_w"].device, L["user_w"].dtype
    ng = len(split["sizes"])
    (pool,) = _pools(split, [np.arange(ng)], dev, dt)
    s, sb, _ = _aggregates(L, pool, ng)
    slots = torch.as_tensor(np.repeat(np.arange(ng), split["sizes"]), device=dev)
    u, i, _ = mf._rows_on(split, dev, dt)
    return (mf.hyper(conf)["base"] + L["item_b"][i] + L["user_b"][u] + sb[slots]
            + ((L["user_w"][u] + s[slots]) * L["item_w"][i]).sum(dim=1))
