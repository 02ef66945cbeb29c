"""Train-step containers and the forward (predict) path.

PyTorch counterpart of the parts of svdfeature_tpu/ops/embed.py that the
base solver's kernel path needs: the static switches (``HyperParams``),
the per-row decay tables (``TrainConsts``), the training state
(``TrainState``) and ``predict_batches`` / ``forward_scores``
(embed.py:166-195,777-785), whose SVD++ arguments the user-group path
(ops/svdpp.py) uses.  The batched SGD update itself lives in
ops/cuda_embed.py (kernel + its plain version).

Tables carry one trailing dummy row (index N-1 of ``w``/``b``, G of
``g``) that packing points padded slots at, with value 0, so gathers need
no masks (data/batching.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import losses

# Tables of more than this many rows (dummy row included) take the
# big-table route (ops/big_embed.py, ops/tile_sweep.py): the JAX package's
# ONEHOT_THRESHOLD (ops/embed.py:273), kept so that the port picks the
# route, and so the trajectory, that the JAX CLI picks for the same conf.
BIG_TABLE_ROWS = 1 << 13


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Static switches of the train step."""

    active_type: int = 0
    no_user_bias: int = 0
    reg_method: int = 0
    reg_global: int = 0
    user_nonnegative: int = 0
    item_nonnegative: int = 0
    base_score: float = 0.0
    # plain (undamped) global-bias update — exact reference semantics
    # (apex_svd_base.h:384-387); selected at batch_size=1
    exact_global: bool = False
    # big-table route: the writes of the step go through the hand-written
    # kernels (K5 ops/cuda_scatter.row_writer, K4 ops/cuda_sweep.sweep_update)
    # on CUDA tensors; False (use_pallas=0) runs their plain versions
    row_dma: bool = False
    # route to the sorted-dedup big-table step (ops/big_embed.py), set by
    # the solver above BIG_TABLE_ROWS; num_factor carries k (the augmented
    # rows are wider than k)
    big_table: bool = False
    num_factor: int = 0
    # tile-sweep write path for dense big batches (ops/tile_sweep.py):
    # needs the pack-time sweep plan in the batch dict and the augmented
    # table padded to a multiple of sweep_tile
    sweep_table: bool = False
    sweep_tile: int = 2048
    sweep_ecap: int = 1024


@dataclasses.dataclass
class TrainConsts:
    """Per-row decay-rate tables, built once on the training device.

    wd_u_row applies to rows touched via the user segment, wd_i_row via the
    item segment (aliased under common_latent_space, as in the reference);
    the dummy row / slot has rate 0.
    """

    wd_u_row: torch.Tensor  # [N+1] f32
    wd_i_row: torch.Tensor  # [N+1] f32
    wd_g_row: torch.Tensor  # [G+1] f32 (0 for regfree-global and dummy)
    wd_user_bias: torch.Tensor  # 0-d f32
    wd_item_bias: torch.Tensor  # 0-d f32


@dataclasses.dataclass
class TrainState:
    w: torch.Tensor  # [N+1, k] f32 (last row = dummy, stays 0)
    b: torch.Tensor  # [N+1] f32
    g: torch.Tensor  # [G+1] f32
    step: torch.Tensor  # 0-d i32: examples processed (sample_counter)
    # lazy-decay last-touch counters of reg_method/reg_global >= 4 (the
    # general step, ROADMAP Queue 1 item 4); the eager-L2 kernel path
    # carries them through unchanged
    ref_ui: torch.Tensor  # [N+1] i32
    ref_g: torch.Tensor  # [G+1] i32


def _slot_sums(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``sum vals`` per slot of an ``n``-slot table -> [n] f32.  A table of
    one slot (no global features: only the dummy) is a plain reduction, not
    ``index_add_`` (on the card, B atomics on one address)."""
    if n == 1:
        return vals.sum().reshape(1)
    return torch.zeros(n, dtype=torch.float32, device=vals.device).index_add_(
        0, idx.reshape(-1).long(), vals.reshape(-1))


def _touch_counts(n: int, idx: torch.Tensor) -> torch.Tensor:
    """How often each of ``n`` slots occurs in ``idx`` -> [n] f32."""
    return _slot_sums(n, idx, torch.ones(idx.shape, dtype=torch.float32, device=idx.device))


def _update_global(g, g_idx, g_val, err, lr, exact: bool = False) -> torch.Tensor:
    """Global-bias update (embed.py:230-254): the reference's plain step
    ``g += lr*S`` with ``exact`` (batch_size=1), else the damped batched
    step ``g += lr*S / (1 + lr*C2)`` (S: sum err*v, C2: sum v^2 per slot)."""
    n_g = g.shape[0]
    S = _slot_sums(n_g, g_idx, err[:, None] * g_val)
    if exact:
        return g + lr * S
    return g + lr * S / (1.0 + lr * _slot_sums(n_g, g_idx, g_val * g_val))


def _gather_sum(tab: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """sum_s val[b,s] * tab[idx[b,s]] -> [B, k] (tab 2-D) or [B] (tab 1-D)."""
    B, S = idx.shape
    rows = tab.index_select(0, idx.reshape(-1).long())
    if tab.dim() == 2:
        return (val.unsqueeze(-1) * rows.reshape(B, S, -1)).sum(dim=1)
    return (val * rows.reshape(B, S)).sum(dim=1)


def forward_scores(
    w: torch.Tensor,
    b: torch.Tensor,
    g: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    hp: HyperParams,
    p_u_extra: Optional[torch.Tensor] = None,
    bias_extra: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Activated predictions ``[B]`` of one batch of ``[B, S]`` planes on the
    dummy-padded tables (pred, apex_svd_base.h:445-454).

    ``p_u_extra [B, k]`` / ``bias_extra [B]`` add the SVD++ feedback term
    to the user factor and, with user bias, to the score (prepare_svdpp /
    get_bias_svdpp, apex_svd_base.h:429-437)."""
    p_u = _gather_sum(w, batch["u_idx"], batch["u_val"])
    p_i = _gather_sum(w, batch["i_idx"], batch["i_val"])
    if p_u_extra is not None:
        p_u = p_u + p_u_extra
    score = hp.base_score + _gather_sum(g, batch["g_idx"], batch["g_val"])
    score = score + _gather_sum(b, batch["i_idx"], batch["i_val"])
    if not hp.no_user_bias:
        score = score + _gather_sum(b, batch["u_idx"], batch["u_val"])
        if bias_extra is not None:
            score = score + bias_extra
    score = score + (p_u * p_i).sum(dim=1)
    return losses.map_active(score, hp.active_type)


@torch.no_grad()
def predict_batches(
    state: TrainState, stacked: Dict[str, torch.Tensor], hp: HyperParams
) -> torch.Tensor:
    """Forward-only predictions for stacked ``[T, B, S]`` batches -> [T, B]."""
    T = stacked["label"].shape[0]
    planes = ("g_idx", "g_val", "u_idx", "u_val", "i_idx", "i_val")
    return torch.stack([
        forward_scores(
            state.w, state.b, state.g, {p: stacked[p][t] for p in planes}, hp
        )
        for t in range(T)
    ])
