"""Stacked multi-IMFB (extend_type=2) on a ``(data, model)`` mesh.

PyTorch counterpart of svdfeature_tpu/parallel/imfb_mesh.py: the recipe of
parallel/svdpp_mesh.py with the chunk's local feedback CONTEXTS
(``fb_ctx`` slots) as the pool's segments in place of its users.

* The ``[T, G]`` slot planes (``G`` = units x rows_per_user, with
  ``ctx_slots [T, G, D]``) are sharded over ``data``, contiguously;
  ``pad_imfb_for_mesh`` pads G to a multiple of ``n_data * M`` so that no
  unit's M slots straddle a data shard.  ``ctx_slots`` are chunk-local
  context slots, valid on every rank.
* Per-context aggregates: each data rank reduces its slice of the
  replicated pool over its model slab, psum'd as in svdpp_mesh.
* A slot's feedback term is the sum of its D contexts' aggregates.
* The per-context reduction ``[err*p_i | present | err]`` (with
  ``[p_i.p_i | present / m_unit]`` for M > 1: the widened Jacobi step
  damps only the within-unit excess) is psum'd over ``data``; the deltas
  are gated by ``enabled`` (ufeedback_disable_level, the pad slot and
  contexts without feedback) and written back over the FULL pool, masked
  to the owned rows, by every data replica.
* As in the JAX mesh body, the decays and the nonnegative clamps are
  parallel/mesh.py's (the single-device refresh step applies no clamps;
  the JAX package keeps that difference and so does the port).

A training step makes the four collectives of svdpp_mesh (five in the
lazy modes), a prediction batch two; no kernel takes it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import losses
from ..ops.embed import HyperParams, TrainConsts, TrainState
from ..ops.svdpp import PlusHyper, _fb_writeback, _inv_norm
from .comm import Mesh, psum
from .mesh import (_apply_row_updates, _decay_clamp_scrub, _lazy_catchup_sharded,
                   _sharded_forward, activated_score, forward_partials, global_apply,
                   global_catchup, global_decay, global_sums)
from .svdpp_mesh import (_rounds, chunk_pool, local_pool, model_then_data, pool_partials,
                         reduce_pool_predict, seg_sum)


def context_partials(err, p_i, weight, ctx, nseg: int, M: int) -> torch.Tensor:
    """This rank's per-context reduction ``[nseg, k+2]`` (``k+4`` for
    M > 1): each slot's ``[err*p_i | present | err]`` summed into its D
    contexts, with ``[p_i.p_i | present / m_unit]`` for M > 1."""
    D = ctx.shape[1]
    rep = lambda x: x.repeat_interleave(D, dim=0)  # noqa: E731
    cols = [rep(err[:, None] * p_i), rep(weight)[:, None], rep(err)[:, None]]
    if M > 1:
        m_unit = weight.reshape(-1, M).sum(dim=1)
        ind = torch.where(m_unit > 0, 1.0 / torch.clamp(m_unit, min=1.0), 0.0)
        ind = ind.repeat_interleave(M) * weight
        cols += [rep((p_i * p_i).sum(dim=1))[:, None], rep(ind)[:, None]]
    return seg_sum(nseg, ctx.reshape(-1), torch.cat(cols, dim=1))


def context_deltas(red, fb_sum, fb_bias, norm, enabled, lr_fb, d, db, M: int, with_bias: bool):
    """The contexts' replicated deltas ``[nseg, k]`` (and ``[nseg]``) from
    the psum'd reduction (imfb_mesh.py:147-183), gated by ``enabled``."""
    k = fb_sum.shape[1]
    S, nrow, S_b = red[:, :k], red[:, k], red[:, k + 1]
    if M > 1:
        pip2, U = red[:, k + 2], red[:, k + 3]
        excess = torch.clamp(nrow - U, min=0.0)
        frac = torch.where(nrow > 0, excess / torch.clamp(nrow, min=1.0), 0.0)
        S = S / (1.0 + lr_fb * norm * pip2 * frac)[:, None]
        S_b = S_b / (1.0 + lr_fb * norm * excess)
    scale = _inv_norm(norm) * enabled * (norm > 0)
    delta = (fb_sum * (torch.pow(d, nrow) - 1.0)[:, None] + lr_fb * norm[:, None] * S) * \
        scale[:, None]
    if not with_bias:
        return delta, None
    return delta, (fb_bias * (torch.pow(db, nrow) - 1.0) + lr_fb * norm * S_b) * scale


@torch.no_grad()
def sharded_imfb_step(state: TrainState, batch: Dict[str, torch.Tensor],
                      cfb: Dict[str, torch.Tensor], enabled: torch.Tensor, lr, fb_hyper,
                      consts: TrainConsts, hp: HyperParams, mesh: Mesh, n_pad: int,
                      M: int = 1) -> TrainState:
    """One stacked step on this rank's slab and slots, the per-shard body
    of JAX ``_make_imfb_body`` (imfb_mesh.py:35-212); ``cfb`` is the
    chunk's replicated pool ``[F]`` keyed ``fb_ctx``, ``enabled [nseg]``
    its gate.  ``state.w`` / ``state.b`` change in place."""
    lr_fb, d, db = fb_hyper
    n_local = n_pad // mesh.n_model
    lo, dummy = mesh.m * n_local, n_local - 1
    with_bias = not hp.no_user_bias
    w, b, step0 = state.w, state.b, state.step
    nseg = enabled.shape[0]
    ctx = batch["ctx_slots"].long()

    agg = pool_partials(lambda i: (w[i], b[i]), cfb, "fb_ctx", nseg, lo, n_local, dummy, mesh)
    fwd, (cu, ci, cg, present, fb_sum, fb_bias, norm), _ = model_then_data(
        agg, w, b, batch, hp, mesh, state.g.shape[0], lo, n_local, dummy)
    w, ref_ui = _lazy_catchup_sharded(w, state.ref_ui, cu, ci, step0, lr, consts, hp)
    g, ref_g = global_catchup(state.g, state.ref_g, cg, step0, lr, consts, hp)
    # in the lazy modes the forward reads the caught-up rows
    p_u, p_i, bias = fwd or _sharded_forward(w, b, batch, hp, mesh, lo, n_local, dummy)
    p_u = p_u + fb_sum[ctx].sum(dim=1)
    if with_bias:
        bias = bias + fb_bias[ctx].sum(dim=1)
    pred = activated_score(p_u, p_i, bias, g, batch, hp)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

    _apply_row_updates(w, b, batch, lr * err, p_u, p_i, hp, mesh, lo, n_local, dummy)
    *gs, red = psum(mesh, "data", *global_sums(g, batch, err),
                    context_partials(err, p_i, batch["weight"], ctx, nseg, M))
    g = global_apply(g, gs, lr)
    delta, delta_b = context_deltas(red, fb_sum, fb_bias, norm, enabled, lr_fb, d, db, M,
                                    with_bias)
    _fb_writeback(w, b, local_pool(cfb, "fb_ctx", lo, n_local, dummy), delta, delta_b)

    g = global_decay(g, cg, lr, consts, hp)
    w, b = _decay_clamp_scrub(w, b, cu, ci, lr, consts, hp, lo, n_local, n_pad)
    return TrainState(w=w, b=b, g=g, step=step0 + present, ref_ui=ref_ui, ref_g=ref_g)


@torch.no_grad()
def sharded_imfb_rounds(state: TrainState, stacked: Dict[str, torch.Tensor],
                        chunk_id: np.ndarray, fb: Dict[str, torch.Tensor], enabled: torch.Tensor,
                        lrs, consts: TrainConsts, hp: HyperParams, ph: PlusHyper, mesh: Mesh,
                        n_pad: int) -> TrainState:
    """R rounds of stacked steps on this rank's slab (JAX
    ``sharded_imfb_rounds``, imfb_mesh.py:215-271): ``stacked`` holds this
    rank's ``[T, G / n_data]`` columns, ``fb`` the replicated ``[C, F]``
    pools, ``enabled`` the ``[C, nseg]`` gates."""
    def step(st, batch, cfb, en, lr, fbh):
        return sharded_imfb_step(st, batch, cfb, en, lr, fbh, consts, hp, mesh, n_pad,
                                 ph.rows_per_user)

    return _rounds(step, state, stacked, chunk_id, fb, lrs, ph, extra=enabled)


@torch.no_grad()
def sharded_imfb_predict(state: TrainState, stacked: Dict[str, torch.Tensor],
                         chunk_id: np.ndarray, fb: Dict[str, torch.Tensor], nseg: int,
                         hp: HyperParams, mesh: Mesh, n_pad: int) -> torch.Tensor:
    """Predictions ``[T, G / n_data]`` of this rank's columns on the
    row-sharded tables (JAX ``sharded_imfb_predict``, imfb_mesh.py:274-336)."""
    n_local = n_pad // mesh.n_model
    lo, dummy = mesh.m * n_local, n_local - 1
    w, b = state.w, state.b
    out = []
    for t, c in enumerate(np.asarray(chunk_id).tolist()):
        batch = {name: x[t] for name, x in stacked.items()}
        ctx = batch["ctx_slots"].long()
        fb_sum, fb_bias, p_u, p_i, bias = reduce_pool_predict(
            pool_partials(lambda i: (w[i], b[i]), chunk_pool(fb, c), "fb_ctx", nseg, lo, n_local,
                          dummy, mesh, with_norm=False), mesh,
            forward_partials(w, b, batch, hp, lo, n_local, dummy))
        p_u = p_u + fb_sum[ctx].sum(dim=1)
        if not hp.no_user_bias:
            bias = bias + fb_bias[ctx].sum(dim=1)
        out.append(activated_score(p_u, p_i, bias, state.g, batch, hp))
    return torch.stack(out)


# copied from svdfeature_tpu/parallel/imfb_mesh.py:339-378 (numpy only)
def pad_imfb_for_mesh(arrays, fb, G: int, n_data: int, dummy_row: int,
                      num_global: int, nseg: int, M: int = 1):
    """Pad packed imfb batches so G (slots) and F (pool) divide the data
    axis.  Padded row slots are absent rows (weight 0, dummy ids,
    ctx_slots = pad slot); pool padding targets the dummy row with value
    0 and the pad context slot.  M>1 (rows_per_user): slots are padded
    to a multiple of n_data*M so no unit's M consecutive slots straddle
    a data shard (the mesh bodies' damping groups slots by unit)."""
    T = arrays["label"].shape[0]
    Gp = -(-G // (n_data * M)) * (n_data * M)
    if Gp != G:
        out = {}
        for k, v in arrays.items():
            if k == "ctx_slots":
                fill = nseg - 1  # pad slot (gated off)
            elif k == "g_idx":
                fill = num_global
            elif k.endswith("_idx"):
                fill = dummy_row
            else:
                fill = 0
            pad = np.full((T, Gp - G) + v.shape[2:], fill, v.dtype)
            out[k] = np.concatenate([v, pad], axis=1)
        arrays = out
    F = fb["fb_idx"].shape[1]
    Fp = -(-F // n_data) * n_data
    if Fp != F:
        C = fb["fb_idx"].shape[0]
        fb = {
            "fb_idx": np.concatenate(
                [fb["fb_idx"], np.full((C, Fp - F), dummy_row, np.int32)], axis=1
            ),
            "fb_val": np.concatenate(
                [fb["fb_val"], np.zeros((C, Fp - F), np.float32)], axis=1
            ),
            "fb_ctx": np.concatenate(
                [fb["fb_ctx"], np.full((C, Fp - F), nseg - 1, np.int32)], axis=1
            ),
        }
    return arrays, fb, Gp, Fp
