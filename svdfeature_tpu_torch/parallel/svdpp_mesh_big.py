"""SVD++ on a ``(data, model)`` mesh of big (augmented) slabs, written
through K5.

PyTorch counterpart of svdfeature_tpu/parallel/svdpp_mesh_big.py: the step
of parallel/svdpp_mesh.py with every table-sized read and write on
parallel/mesh_big.py's augmented slabs ``[n_real + 1, W]`` (the scratch row
last, where the ids a rank does not own are sent):

* the aggregates gather this data rank's pool slice from the local slab
  (``ops/big_embed.gather_rows``), psum'd as in svdpp_mesh (``fb_sum`` /
  ``fb_bias`` over ``model`` and ``data``, ``norm`` over ``data``); pool
  rows never decay, so no catch-up there;
* the lazy catch-up of the globals runs first (``regularize(pre)``
  order), the rows' at gather time in ``mesh_big.fwd_big_partials`` and at merge
  time in ``apply_entries``;
* the row update is mesh_big's: the entry stream all-gathered over
  ``data`` and merged into every replica's slab by ``apply_entries``;
* the users' replicated deltas go back over the FULL pool, masked to the
  owned rows, merged by ``ops/svdpp_big._fb_writeback_big``.

Both writes are one unique-row write each: the hand-written kernel K5
(``ops/cuda_scatter.row_writer``) on a CUDA slab with ``hp.row_dma``
(``use_pallas``), so a step launches K5 twice on every rank.  A step makes
the four collectives of svdpp_mesh (the forward's partials, caught up at
gather time, always ride the aggregates' model call), a prediction batch
two.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import losses
from ..ops.big_embed import gather_rows
from ..ops.embed import HyperParams, TrainConsts, TrainState
from ..ops.svdpp import PlusHyper, _pool
from ..ops.svdpp_big import _fb_writeback_big
from .comm import Mesh, psum
from .mesh import activated_score, global_apply, global_catchup, global_decay, global_sums
from .mesh_big import fwd_big_partials, merge_gathered, predict_partials_big
from .svdpp_mesh import (_rounds, local_pool, pool_partials, reduce_pool_predict,
                         reduce_pool_train, user_deltas, user_partials, user_slots, users_of)


def slab_rows(w: torch.Tensor, k: int):
    """``rows_of`` for pool_partials on an augmented slab: (factors, bias)."""
    def rows_of(idx):
        rows = gather_rows(w, idx)
        return rows[:, :k], rows[:, k]
    return rows_of


@torch.no_grad()
def sharded_svdpp_step_big(state: TrainState, batch: Dict[str, torch.Tensor],
                           cfb: Dict[str, torch.Tensor], lr, fb_hyper, consts: TrainConsts,
                           hp: HyperParams, mesh: Mesh, n_real: int, G: int,
                           M: int = 1) -> TrainState:
    """One SVD++ step on this rank's augmented slab, written in place
    (through K5 twice with ``hp.row_dma`` on a CUDA slab): the per-shard
    body of JAX ``_make_svdpp_body_big`` (svdpp_mesh_big.py:55-245)."""
    k = hp.num_factor
    if k <= 0:
        raise ValueError("the mesh big path requires hp.num_factor")
    lr_fb, d, db = fb_hyper
    w, step0 = state.w, state.step
    lo, scratch = mesh.m * n_real, n_real
    with_bias = not hp.no_user_bias
    nseg = G + 1
    slot = user_slots(G, M, mesh, w.device)

    agg = pool_partials(slab_rows(w, k), cfb, "fb_block", nseg, lo, n_real, scratch, mesh)
    parts, u_ent, i_ent = fwd_big_partials(w, batch, hp, lr, consts, step0, lo, n_real)
    cg, present, fb_sum, fb_bias, norm, p_u, p_i, bias = reduce_pool_train(
        agg, batch, mesh, state.g.shape[0], with_model=parts)
    g, ref_g = global_catchup(state.g, state.ref_g, cg, step0, lr, consts, hp)
    p_u = p_u + fb_sum[slot]
    if with_bias:
        bias = bias + fb_bias[slot]
    pred = activated_score(p_u, p_i, bias, g, batch, hp)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]

    *gs, red = psum(mesh, "data", *global_sums(g, batch, err),
                    user_partials(err, p_i, batch["weight"], slot, nseg))
    g = global_decay(global_apply(g, gs, lr), cg, lr, consts, hp)
    w, _ = merge_gathered(w, step0, u_ent, i_ent, lr * err, p_u, p_i, lr, consts, hp, mesh,
                          n_real)
    delta, delta_b = user_deltas(red, fb_sum, fb_bias, norm, lr_fb, d, db, M, with_bias)
    w = _fb_writeback_big(w, local_pool(cfb, "fb_block", lo, n_real, scratch), delta, delta_b, k,
                          hp.row_dma)
    return TrainState(w=w, b=state.b, g=g, step=step0 + present, ref_ui=state.ref_ui,
                      ref_g=ref_g)


@torch.no_grad()
def sharded_svdpp_rounds_big(state: TrainState, stacked: Dict[str, torch.Tensor],
                             chunk_id: np.ndarray, fb: Dict[str, torch.Tensor], lrs,
                             consts: TrainConsts, hp: HyperParams, ph: PlusHyper, mesh: Mesh,
                             n_real: int) -> TrainState:
    """R rounds of big-slab SVD++ steps (JAX ``sharded_svdpp_rounds_big``,
    svdpp_mesh_big.py:264-314), the arguments of
    svdpp_mesh.sharded_svdpp_rounds with the slab's ``n_real``."""
    M = ph.rows_per_user
    G = users_of(stacked, mesh, M)

    def step(st, batch, cfb, lr, fbh):
        return sharded_svdpp_step_big(st, batch, cfb, lr, fbh, consts, hp, mesh, n_real, G, M)

    return _rounds(step, state, stacked, chunk_id, fb, lrs, ph)


@torch.no_grad()
def sharded_svdpp_predict_big(state: TrainState, stacked: Dict[str, torch.Tensor],
                              chunk_id: np.ndarray, fb: Dict[str, torch.Tensor], hp: HyperParams,
                              mesh: Mesh, n_real: int, M: int = 1) -> torch.Tensor:
    """Predictions ``[T, G*M / n_data]`` of this rank's columns on the
    augmented slabs (JAX ``sharded_svdpp_predict_big``,
    svdpp_mesh_big.py:317-381)."""
    k = hp.num_factor
    lo = mesh.m * n_real
    G = users_of(stacked, mesh, M)
    slot = user_slots(G, M, mesh, state.w.device)
    out = []
    for t, c in enumerate(np.asarray(chunk_id).tolist()):
        batch = {name: x[t] for name, x in stacked.items()}
        fb_sum, fb_bias, p_u, p_i, bias = reduce_pool_predict(
            pool_partials(slab_rows(state.w, k), _pool(fb, c), "fb_block", G + 1, lo, n_real,
                          n_real, mesh, with_norm=False), mesh,
            predict_partials_big(state, batch, hp, mesh, n_real))
        if not hp.no_user_bias:
            bias = bias + fb_bias[slot]
        out.append(activated_score(p_u + fb_sum[slot], p_i, bias, state.g, batch, hp))
    return torch.stack(out)
