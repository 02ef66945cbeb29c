"""Stacked multi-IMFB on a ``(data, model)`` mesh of big (augmented) slabs,
written through K5.

PyTorch counterpart of svdfeature_tpu/parallel/imfb_mesh_big.py: the step
of parallel/imfb_mesh.py on parallel/mesh_big.py's slabs, read and written
as parallel/svdpp_mesh_big.py does: the per-context aggregates gathered
from the local slab, the globals caught up first, the row update merged by
``apply_entries`` from the all-gathered entry stream, the gated context
deltas merged back over the FULL pool by ``ops/svdpp_big._fb_writeback_big``
keyed by ``fb_ctx``.  Both writes go through K5 with ``hp.row_dma`` on a
CUDA slab: two launches a step on every rank.  A step makes the four
collectives of svdpp_mesh_big, a prediction batch two.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import losses
from ..ops.embed import HyperParams, TrainConsts, TrainState
from ..ops.svdpp import PlusHyper
from ..ops.svdpp_big import _fb_writeback_big
from .comm import Mesh, psum
from .imfb_mesh import context_deltas, context_partials
from .mesh import activated_score, global_apply, global_catchup, global_decay, global_sums
from .mesh_big import fwd_big_partials, merge_gathered, predict_partials_big
from .svdpp_mesh import (_rounds, chunk_pool, local_pool, pool_partials, reduce_pool_predict,
                         reduce_pool_train)
from .svdpp_mesh_big import slab_rows


@torch.no_grad()
def sharded_imfb_step_big(state: TrainState, batch: Dict[str, torch.Tensor],
                          cfb: Dict[str, torch.Tensor], enabled: torch.Tensor, lr, fb_hyper,
                          consts: TrainConsts, hp: HyperParams, mesh: Mesh, n_real: int,
                          M: int = 1) -> TrainState:
    """One stacked step on this rank's augmented slab, written in place
    (through K5 twice with ``hp.row_dma`` on a CUDA slab): the per-shard
    body of JAX ``_make_imfb_body_big`` (imfb_mesh_big.py:51-285)."""
    k = hp.num_factor
    if k <= 0:
        raise ValueError("the mesh big path requires hp.num_factor")
    lr_fb, d, db = fb_hyper
    w, step0 = state.w, state.step
    lo, scratch = mesh.m * n_real, n_real
    with_bias = not hp.no_user_bias
    nseg = enabled.shape[0]
    ctx = batch["ctx_slots"].long()

    agg = pool_partials(slab_rows(w, k), cfb, "fb_ctx", nseg, lo, n_real, scratch, mesh)
    parts, u_ent, i_ent = fwd_big_partials(w, batch, hp, lr, consts, step0, lo, n_real)
    cg, present, fb_sum, fb_bias, norm, p_u, p_i, bias = reduce_pool_train(
        agg, batch, mesh, state.g.shape[0], with_model=parts)
    g, ref_g = global_catchup(state.g, state.ref_g, cg, step0, lr, consts, hp)
    p_u = p_u + fb_sum[ctx].sum(dim=1)
    if with_bias:
        bias = bias + fb_bias[ctx].sum(dim=1)
    pred = activated_score(p_u, p_i, bias, g, batch, hp)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

    *gs, red = psum(mesh, "data", *global_sums(g, batch, err),
                    context_partials(err, p_i, batch["weight"], ctx, nseg, M))
    g = global_decay(global_apply(g, gs, lr), cg, lr, consts, hp)
    w, _ = merge_gathered(w, step0, u_ent, i_ent, lr * err, p_u, p_i, lr, consts, hp, mesh,
                          n_real)
    delta, delta_b = context_deltas(red, fb_sum, fb_bias, norm, enabled, lr_fb, d, db, M,
                                    with_bias)
    w = _fb_writeback_big(w, local_pool(cfb, "fb_ctx", lo, n_real, scratch), delta, delta_b, k,
                          hp.row_dma)
    return TrainState(w=w, b=state.b, g=g, step=step0 + present, ref_ui=state.ref_ui,
                      ref_g=ref_g)


@torch.no_grad()
def sharded_imfb_rounds_big(state: TrainState, stacked: Dict[str, torch.Tensor],
                            chunk_id: np.ndarray, fb: Dict[str, torch.Tensor],
                            enabled: torch.Tensor, lrs, consts: TrainConsts, hp: HyperParams,
                            ph: PlusHyper, mesh: Mesh, n_real: int) -> TrainState:
    """R rounds of big-slab stacked steps (JAX ``sharded_imfb_rounds_big``,
    imfb_mesh_big.py:288-341), the arguments of imfb_mesh.sharded_imfb_rounds
    with the slab's ``n_real``."""
    def step(st, batch, cfb, en, lr, fbh):
        return sharded_imfb_step_big(st, batch, cfb, en, lr, fbh, consts, hp, mesh, n_real,
                                     ph.rows_per_user)

    return _rounds(step, state, stacked, chunk_id, fb, lrs, ph, extra=enabled)


@torch.no_grad()
def sharded_imfb_predict_big(state: TrainState, stacked: Dict[str, torch.Tensor],
                             chunk_id: np.ndarray, fb: Dict[str, torch.Tensor], nseg: int,
                             hp: HyperParams, mesh: Mesh, n_real: int) -> torch.Tensor:
    """Predictions ``[T, G / n_data]`` of this rank's columns on the
    augmented slabs (JAX ``sharded_imfb_predict_big``,
    imfb_mesh_big.py:344-405)."""
    k = hp.num_factor
    lo = mesh.m * n_real
    out = []
    for t, c in enumerate(np.asarray(chunk_id).tolist()):
        batch = {name: x[t] for name, x in stacked.items()}
        ctx = batch["ctx_slots"].long()
        fb_sum, fb_bias, p_u, p_i, bias = reduce_pool_predict(
            pool_partials(slab_rows(state.w, k), chunk_pool(fb, c), "fb_ctx", nseg, lo, n_real,
                          n_real, mesh, with_norm=False), mesh,
            predict_partials_big(state, batch, hp, mesh, n_real))
        if not hp.no_user_bias:
            bias = bias + fb_bias[ctx].sum(dim=1)
        out.append(activated_score(p_u + fb_sum[ctx].sum(dim=1), p_i, bias, state.g, batch, hp))
    return torch.stack(out)
