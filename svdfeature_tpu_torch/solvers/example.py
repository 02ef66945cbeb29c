"""Didactic minimal solver: the customization recipe.

Counterpart of svdfeature_tpu/solvers/example.py (solvers/example,
apex_svd_lite.h:35-194 + apex_svd_lite.cpp:24-33): the reference shows
how to write a custom solver by restating the base algorithm without
plugins or lazy regularization and re-defining create_svd_trainer.  Here
the recipe is ``register_trainer``: define a trainer class and register it
under an extend_type, no relinking.

``SVDFeatureLiteTrainer`` restates the L2-only SGD update in plain torch
(one batch at a time through ``lite_step``: the forward of ops/embed.py,
``index_add_`` scatters and ``pow`` decays; no kernel, no lazy modes),
slower than the base solver's route but easy to read, and a template for
experiments.  Importing this module registers it under extend_type=99,
as the JAX module does.

The mesh keys are taken as the JAX lite trainer takes them: its step runs
on the global arrays of its mesh, so a mesh trains what one device trains
at the batch rounded up to a multiple of ``mesh_data``
(svdfeature_tpu/solvers/base.py:243-244).  Here each rank of the torchrun
world (joined before the first tensor, as the base solver joins it) holds
the whole table and trains the whole batch; rank 0 alone writes
checkpoints, logs and predictions (train/loop.py, infer/task.py), and every
rank ends a prediction with every row.  ``mesh_big=1`` raises: the JAX
lite step cannot read the augmented slabs (its gather fails); under
``mesh_big=-1`` the whole table is trained, as on JAX's CPU mesh, which
never takes slabs.
"""

from __future__ import annotations

import torch

from .. import losses
from ..ops.embed import HyperParams, TrainState, _forward, _touch_counts, batches
from .base import SVDFeatureTrainer
from .registry import register_trainer


class SVDFeatureLiteTrainer(SVDFeatureTrainer):
    """Same model and checkpoints as the base solver; the simplified update
    below, on the whole table on every rank of a mesh."""

    def _join_mesh(self) -> None:
        if self.mesh_data * self.mesh_model > 1 and self.mesh_big == 1:
            raise ValueError("mesh_big=1: the lite example solver trains the whole table on "
                             "every rank and has no augmented slabs (use mesh_big=-1 or 0)")
        super()._join_mesh()

    def _init_mesh(self) -> None:
        """No shards: the batch grows to a multiple of mesh_data, as on the
        JAX mesh, and the table stays whole on this rank."""
        if self.batch_size % self.mesh_data:
            self.batch_size += self.mesh_data - self.batch_size % self.mesh_data

    def update_all(self, ds) -> None:
        stacked, _ = self._pack(ds)
        tp = self.tparam
        # f32 scalars, as the JAX step takes them
        lr, *wds = (torch.tensor(x, dtype=torch.float32, device=self.state.w.device) for x in (
            self.learning_rate, tp.wd_user, tp.wd_item, tp.wd_user_bias, tp.wd_item_bias,
            tp.wd_global))
        for batch in batches(stacked):
            self.state = lite_step(self.state, batch, lr, self.hp, *wds)


@torch.no_grad()
def lite_step(state: TrainState, batch, lr, hp: HyperParams, wd_u, wd_i, wd_bu, wd_bi,
              wd_g) -> TrainState:
    """One batch of plain L2 SGD (apex_svd_lite.h:118-152 semantics; JAX
    ``_lite_step``, example.py:46-86), the tables updated in place."""
    pred, p_u, p_i = _forward(state.w, state.b, state.g, batch, hp)
    err = losses.cal_grad(batch["label"], pred, hp.active_type) * batch["weight"]
    lr_err = lr * err
    w, b, g = state.w, state.b, state.g
    u = batch["u_idx"].reshape(-1).long()
    i = batch["i_idx"].reshape(-1).long()
    gi = batch["g_idx"].reshape(-1).long()

    cu, ci = _touch_counts(w.shape[0], u), _touch_counts(w.shape[0], i)
    cg = _touch_counts(g.shape[0], gi)
    coef_u = lr_err[:, None] * batch["u_val"]
    coef_i = lr_err[:, None] * batch["i_val"]
    k = w.shape[1]
    w.index_add_(0, u, (coef_u[..., None] * p_i[:, None, :]).reshape(-1, k))
    w.index_add_(0, i, (coef_i[..., None] * p_u[:, None, :]).reshape(-1, k))
    b.index_add_(0, u, coef_u.reshape(-1))
    b.index_add_(0, i, coef_i.reshape(-1))
    g.index_add_(0, gi, (lr_err[:, None] * batch["g_val"]).reshape(-1))
    w.mul_(torch.pow(1.0 - lr * wd_u, cu)[:, None]).mul_(torch.pow(1.0 - lr * wd_i, ci)[:, None])
    b.mul_(torch.pow(1.0 - lr * wd_bu, cu)).mul_(torch.pow(1.0 - lr * wd_bi, ci))
    g.mul_(torch.pow(1.0 - lr * wd_g, cg))
    w[-1] = 0.0
    b[-1] = 0.0
    g[-1] = 0.0
    step = state.step + (batch["weight"] > 0).sum().to(torch.int32)
    return TrainState(w=w, b=b, g=g, step=step, ref_ui=state.ref_ui, ref_g=state.ref_g)


register_trainer(99, SVDFeatureLiteTrainer)
