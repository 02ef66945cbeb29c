"""Train-step containers, the general train step and the forward path.

PyTorch counterpart of svdfeature_tpu/ops/embed.py on the small-table
route: the static switches (``HyperParams``), the per-row decay tables
(``TrainConsts``), the training state (``TrainState``), the general
batched SGD step ``train_step`` (embed.py:534-621) with its pieces
(``_apply_factor_reg`` reg_method 0-3, ``_lazy_catchup`` modes 4/5, the
global update, the bias decay, the nonnegative clamps), ``train_rounds``
(R rounds x T steps, embed.py:753-775), and ``predict_batches`` /
``forward_scores`` (embed.py:166-195,777-785), whose SVD++ arguments the
user-group path (ops/svdpp.py) uses.  ``train_rounds`` runs every
configuration the JAX jnp path runs; the Hopper kernel K1
(ops/cuda_embed.py) takes the eager-L2 subset and has ``train_rounds`` as
its plain version.

Not ported, because they exist only for the TPU: the one-hot matmul,
fused and dense forms (``_use_onehot``, ``_onehot*``,
``_train_step_fused``, ``build_onehots``, ``_train_step_dense``; TPU
scatters serialize, ``index_add_`` does not), and the sparse touched-row
decays (``_sparse_decay_*``, ``_sparse_clamp_nonneg``), which the JAX step
takes only above ``SPARSE_DECAY_THRESHOLD`` = 2^18 rows.  The solvers send
tables of more than ``BIG_TABLE_ROWS`` = 8192 rows to the big-table route
(ops/big_embed.py, ops/tile_sweep.py, which carry reg 0-5 and the clamps
on touched rows themselves), exactly as the JAX solver does
(solvers/base.py:292-301, ONEHOT_THRESHOLD), so this step never sees a
table that large.

Tables carry one trailing dummy row (index N-1 of ``w``/``b``, G of
``g``) that packing points padded slots at, with value 0, so gathers need
no masks (data/batching.py).  The step updates ``w``, ``b``, ``g`` and the
lazy refs in place (the JAX package donates the state) and returns the
new TrainState.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

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
    # lazy-decay last-touch counters of reg_method/reg_global >= 4
    # (``_lazy_catchup``); the eager modes carry them through unchanged
    ref_ui: torch.Tensor  # [N+1] i32
    ref_g: torch.Tensor  # [G+1] i32


def _slot_sums(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``sum vals`` per slot of an ``n``-slot table -> [n] f32.  A table of
    one slot (no global features: only the dummy) is a plain reduction, not
    ``index_add_`` (on the card, B atomics on one address)."""
    if n == 1:
        return vals.sum().reshape(1)
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(
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


def _forward(w, b, g, batch, hp: HyperParams, p_u_extra=None, bias_extra=None,
             bias_plugin=None):
    """(pred [B], p_u [B, k], p_i [B, k]) of one batch of ``[B, S]`` planes
    (embed.py:166-195): ``p_u_extra [B, k]`` / ``bias_extra [B]`` add the
    SVD++ feedback term to the user factor and, with user bias, to the
    score (prepare_svdpp / get_bias_svdpp, apex_svd_base.h:429-437);
    ``bias_plugin [B]`` a solver's plugin bias (get_bias_plugin :436-438),
    right after the global term and outside the no_user_bias gate, in the
    JAX package's order (f32 sums depend on it)."""
    p_u = _gather_sum(w, batch["u_idx"], batch["u_val"])
    p_i = _gather_sum(w, batch["i_idx"], batch["i_val"])
    if p_u_extra is not None:
        p_u = p_u + p_u_extra
    score = hp.base_score + _gather_sum(g, batch["g_idx"], batch["g_val"])
    if bias_plugin is not None:
        score = score + bias_plugin
    score = score + _gather_sum(b, batch["i_idx"], batch["i_val"])
    if not hp.no_user_bias:
        score = score + _gather_sum(b, batch["u_idx"], batch["u_val"])
        if bias_extra is not None:
            score = score + bias_extra
    score = score + (p_u * p_i).sum(dim=1)
    return losses.map_active(score, hp.active_type), p_u, p_i


def forward_scores(
    w: torch.Tensor,
    b: torch.Tensor,
    g: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    hp: HyperParams,
    p_u_extra: Optional[torch.Tensor] = None,
    bias_extra: Optional[torch.Tensor] = None,
    bias_plugin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Activated predictions ``[B]`` of one batch of ``[B, S]`` planes on the
    dummy-padded tables (pred, apex_svd_base.h:445-454), with the SVD++
    feedback term and the plugin bias of ``_forward``."""
    return _forward(w, b, g, batch, hp, p_u_extra, bias_extra, bias_plugin)[0]


def _soft_threshold(w: torch.Tensor, lam) -> torch.Tensor:
    """regularize_L1 (apex-tensor func_decl_common.h): shrink toward 0."""
    return torch.sign(w) * torch.clamp(w.abs() - lam, min=0.0)


def _scatter_rows(tab: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor,
                  vecs: torch.Tensor) -> None:
    """In place: ``tab[idx[b,s]] += coef[b,s] * vecs[b]`` (2-D ``tab``)."""
    B, S = idx.shape
    upd = coef[..., None] * vecs[:, None, :]
    tab.index_add_(0, idx.reshape(-1).long(), upd.reshape(B * S, -1))


def _scatter_vals(tab: torch.Tensor, idx: torch.Tensor, coef: torch.Tensor) -> None:
    """In place: ``tab[idx[b,s]] += coef[b,s]`` (1-D ``tab``)."""
    tab.index_add_(0, idx.reshape(-1).long(), coef.reshape(-1))


def _apply_factor_reg(w: torch.Tensor, cu: torch.Tensor, ci: torch.Tensor, lr,
                      wd_u: torch.Tensor, wd_i: torch.Tensor, reg_method: int) -> torch.Tensor:
    """Eager latent-factor regularization (reg_method 0-3) of rows ``w``
    with touch counts ``cu`` / ``ci`` and decay rates ``wd_u`` / ``wd_i``
    (embed.py:344-390, the dense forms; ops/big_embed.apply_entries takes
    it on the touched rows alone), compounded with the touch counts;
    returns the new rows."""
    m = reg_method
    lam_u = lr * wd_u
    lam_i = lr * wd_i
    if m == 0:
        return w * (torch.pow(1.0 - lam_u, cu) * torch.pow(1.0 - lam_i, ci))[:, None]
    if m == 1:
        # L1 soft-threshold; the threshold compounds with the touch count
        return _soft_threshold(w, (lam_u * cu + lam_i * ci)[:, None])
    if m == 2:
        # project touched rows onto the L2 ball of radius sqrt(wd)
        # (apex_svd_base.h:181-186); idempotent, so multiplicity is moot
        touched = (cu + ci) > 0
        wd_row = torch.where(cu > 0, wd_u, wd_i)
        sq = torch.sum(w * w, dim=1)
        scale = torch.where(touched & (sq > wd_row),
                            torch.sqrt(wd_row / torch.clamp(sq, min=1e-30)), 1.0)
        return w * scale[:, None]
    if m == 3:
        # the reference's mode 3: L1 for user rows (falls through case 1 in
        # reg_user), L2 for item rows (falls through case 0 in reg_item)
        w = _soft_threshold(w, (lam_u * cu)[:, None])
        return w * torch.pow(1.0 - lam_i, ci)[:, None]
    raise ValueError(f"unknown reg_method {m}")


def _lazy_catchup(state: TrainState, cu, ci, cg, lr, consts: TrainConsts,
                  hp: HyperParams) -> None:
    """Lazy-decay catch-up (reg modes 4/5) of the touched rows and global
    slots BEFORE the gradient, in place (regularize(pre),
    apex_svd_base.h:457,188-310; embed.py:491-531): the decay of the
    ``step - ref`` examples since each was last touched, then ``ref =
    step``.  The reference computes ``ref - sample_counter`` on unsigned
    ints, which wraps and zeroes the row at its first catch-up; the JAX
    package implements the intended ``step - ref >= 0``, and so does this.
    The dummy row's ref stays 0.  Shared with the SVD++ row updates, which
    catch up the example's u/i/g ids only, never feedback pool rows."""
    step0 = state.step
    if hp.reg_method >= 4:
        touched = (cu + ci) > 0
        k_ui = torch.where(touched, (step0 - state.ref_ui).to(torch.float32), 0.0)
        lam = lr * torch.where(cu > 0, consts.wd_u_row, consts.wd_i_row)
        if hp.reg_method == 4:
            state.w.mul_(torch.pow(1.0 - lam, k_ui)[:, None])
        else:
            state.w.copy_(_soft_threshold(state.w, (lam * k_ui)[:, None]))
        state.ref_ui.copy_(torch.where(touched, step0, state.ref_ui))
        state.ref_ui[-1] = 0
    if hp.reg_global >= 4:
        kg = torch.where(cg > 0, (step0 - state.ref_g).to(torch.float32), 0.0)
        lam_g = lr * consts.wd_g_row
        if hp.reg_global == 4:
            state.g.mul_(torch.pow(1.0 - lam_g, kg))
        else:
            state.g.copy_(_soft_threshold(state.g, lam_g * kg))
        state.ref_g.copy_(torch.where(cg > 0, step0, state.ref_g))


def general_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    lr,
    consts: TrainConsts,
    hp: HyperParams,
    p_u_extra: Optional[torch.Tensor] = None,
    bias_extra: Optional[torch.Tensor] = None,
    bias_plugin: Optional[torch.Tensor] = None,
    after_scatter: Optional[Callable[[torch.Tensor, torch.Tensor], None]] = None,
) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
    """One batched SGD step in place, every configuration of the jnp path:
    JAX ``train_step`` (embed.py:534-621) with the SVD++ feedback term and
    the plugin bias of the JAX package's ``svdpp._row_update``
    (svdpp.py:225-296), which the SVD++, multi-IMFB and bilinear epochs
    call each step.  ``after_scatter(err, p_i)`` writes into the tables
    after the u/i scatters and before every decay and clamp: the per-batch
    refresh epochs write the feedback deltas back there (svdpp.py:192-194),
    so that under a shared feedback space the step's decay acts on the
    written pool rows.  Returns (state, err, p_i): the SVD++ recurrence
    reads the error and the item factors."""
    w, b, g = state.w, state.b, state.g
    u_idx, i_idx, g_idx = batch["u_idx"], batch["i_idx"], batch["g_idx"]
    cu = _touch_counts(w.shape[0], u_idx)
    ci = _touch_counts(w.shape[0], i_idx)
    cg = _touch_counts(g.shape[0], g_idx)
    _lazy_catchup(state, cu, ci, cg, lr, consts, hp)

    # forward on the pre-update (caught-up) parameters
    pred, p_u, p_i = _forward(w, b, g, batch, hp, p_u_extra, bias_extra, bias_plugin)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    lr_err = lr * err

    # scatter-add the gradient (update_no_decay, apex_svd_base.h:383-427)
    g.copy_(_update_global(g, g_idx, batch["g_val"], err, lr, hp.exact_global))
    coef_u = lr_err[:, None] * batch["u_val"]  # [B, Su]
    coef_i = lr_err[:, None] * batch["i_val"]
    _scatter_rows(w, u_idx, coef_u, p_i)
    _scatter_rows(w, i_idx, coef_i, p_u)
    _scatter_vals(b, i_idx, coef_i)
    if not hp.no_user_bias:
        _scatter_vals(b, u_idx, coef_u)
    if after_scatter is not None:
        after_scatter(err, p_i)

    # eager regularization (regularize(post)), compounded per touch
    if hp.reg_method < 4:
        w.copy_(_apply_factor_reg(w, cu, ci, lr, consts.wd_u_row, consts.wd_i_row,
                                  hp.reg_method))
    if hp.reg_global == 0:
        g.mul_(torch.pow(1.0 - lr * consts.wd_g_row, cg))
    elif hp.reg_global == 1:
        g.copy_(_soft_threshold(g, lr * consts.wd_g_row * cg))
    elif hp.reg_global < 4:
        raise ValueError(f"unknown global decay method {hp.reg_global}")
    # bias decay: always plain L2 per touch (apex_svd_base.h:246-249, 281-283)
    fac_b = torch.pow(1.0 - lr * consts.wd_item_bias, ci)
    if not hp.no_user_bias:
        fac_b = fac_b * torch.pow(1.0 - lr * consts.wd_user_bias, cu)
    b.mul_(fac_b)
    # nonnegativity clamp on touched rows (apex_svd_base.h:242-245)
    if hp.user_nonnegative:
        w.copy_(torch.where((cu > 0)[:, None], torch.clamp(w, min=0.0), w))
    if hp.item_nonnegative:
        w.copy_(torch.where((ci > 0)[:, None], torch.clamp(w, min=0.0), w))
    # the dummy rows stay clean (padding targets)
    w[-1] = 0.0
    b[-1] = 0.0
    g[-1] = 0.0
    nstep = state.step + (batch["weight"] > 0).sum().to(torch.int32)
    new = TrainState(w=w, b=b, g=g, step=nstep, ref_ui=state.ref_ui, ref_g=state.ref_g)
    return new, err, p_i


@torch.no_grad()
def train_step(state: TrainState, batch: Dict[str, torch.Tensor], lr, consts: TrainConsts,
               hp: HyperParams) -> TrainState:
    """One batched SGD step of the small-table route (random-order
    format), in place: ``general_step`` without the feedback term."""
    return general_step(state, batch, lr, consts, hp)[0]


_PLANES = ("g_idx", "g_val", "u_idx", "u_val", "i_idx", "i_val", "label", "weight")


def batches(stacked: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """The ``T`` batches (views) of stacked ``[T, B, ...]`` training planes."""
    return [{p: stacked[p][t] for p in _PLANES} for t in range(stacked["label"].shape[0])]


@torch.no_grad()
def train_rounds(
    state: TrainState,
    stacked: Dict[str, torch.Tensor],
    lrs: torch.Tensor,
    consts: TrainConsts,
    hp: HyperParams,
) -> TrainState:
    """R rounds over the T stacked batches, round r at lr ``lrs[r]``, one
    ``train_step`` per batch (embed.py:753-775).  The plain version of K1
    (ops/cuda_embed.train_rounds_kernel) and the route of every
    configuration K1 does not take."""
    bs = batches(stacked)
    for r in range(lrs.shape[0]):
        for batch in bs:
            state = train_step(state, batch, lrs[r], consts, hp)
    return state


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
