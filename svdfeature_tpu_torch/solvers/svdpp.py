"""SVD++ trainer: user-grouped training with implicit feedback.

Counterpart of the small-table, single-device part of
svdfeature_tpu/solvers/svdpp.py (SVDPPFeature, apex_svd_base.h:484-592).
Config keys beside the base solver's: ``users_per_batch`` (G, default
128) users trained side by side, ``rows_per_user`` (M, default 1) rows of
each per step, and ``sort_blocks`` (default 0) to pack users by block size
(less padding, a small early-convergence cost).  Every round goes through
``ops.cuda_svdpp.train_rounds_svdpp_kernel`` (the Hopper kernel K2 on a
CUDA device, its plain version on the CPU) where K2's gate takes the
configuration, else through the plain rounds (reg modes 1-5, the clamps,
the hinge losses, multi-entry user segments, global features);
``use_pallas=0`` selects the plain rounds on the device.  A random-order
dataset (``extend_type=1`` on the random-order format) trains and
predicts on the base solver, as in the JAX package
(svdfeature_tpu/solvers/svdpp.py:520-521, 1238-1239, 1313-1316).

Tables over 8192 rows (dummy included) take the big-table route of the
JAX solver (solvers/svdpp.py:318-335, 618-636): the state moves to the
augmented row layout and each round is ops/svdpp_big.train_epoch_plus_big,
a host loop of sorted-dedup steps that writes through K5 (``use_pallas``,
as on the base solver's big route), never the tile sweep.  The pack then
takes the factored feedback overlap and, where every unit's user segment
is one constant id distinct within its chunk and reg_method < 4
(``_carry_users_plan``), the user-carry plan and the items' static
sorted-dedup layout.  With common_feedback_space=1 a big table keeps the
standard layout, which the port does not train yet (item 7b).

Not ported yet, each raising NotImplementedError naming its ROADMAP item:
common_feedback_space=1 (item 7b) and ``mesh_*`` > 1 (item 12);
pairwise-rank sources (item 8) and streaming buffers (item 11) are refused
where they are loaded (data/registry.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..convert import pool_from_numpy, stacked_from_numpy
from ..data.batching_plus import pack_plus
from ..data.csr import PlusDataset
from ..ops.big_embed import make_dedup_layout
from ..ops.cuda_svdpp import (gate_failure, semantic_failure, train_rounds_svdpp_kernel,
                              train_rounds_svdpp_reference)
from ..ops.embed import HyperParams
from ..ops.svdpp import PlusHyper, predict_batches_plus
from ..ops.svdpp_big import LAYOUT_PLANES, train_epoch_plus_big
from .base import SVDFeatureTrainer


@dataclasses.dataclass
class PlusEntry:
    """One packed user-group dataset, staged on the training device."""

    stacked: Dict[str, torch.Tensor]  # [T, G*M(, S)] planes
    chunk_id: np.ndarray  # [T] on the host: the launch loop reads it
    # fb_idx / fb_val / fb_block [C, F]; chunk_users [C, G] with the carry plan
    fb: Dict[str, torch.Tensor]
    # [C, G+1, G+1], or {"diag", "dup"} factored on big tables
    fb_overlap: Union[torch.Tensor, Dict[str, torch.Tensor]]
    perm: np.ndarray  # dataset row -> packed slot


def _chunk_users_from_slots(uid_slots: np.ndarray, cid: np.ndarray, dummy: int):
    """The user-carry plan ``[C, G]`` int32 (dummy where a unit never names
    a user) from the user-row id of each slot ``uid_slots [T, G, M]``
    (dummy where a slot carries no user), or None where it does not hold:
    mixed ids within one unit's slots of a step, an id that changes across
    a chunk's steps, or one user in two units of a chunk
    (svdfeature_tpu/solvers/svdpp.py:27-66)."""
    arr = np.where(uid_slots == dummy, -1, uid_slots)
    per_t_max = arr.max(axis=2)  # [T, G]
    big = np.where(arr < 0, np.iinfo(np.int64).max, arr)
    per_t_min = np.where(per_t_max < 0, -1, big.min(axis=2))
    if (per_t_min != per_t_max).any():
        return None
    cid = np.asarray(cid)
    G = per_t_max.shape[1]
    C = int(cid.max()) + 1 if len(cid) else 1
    chunk_users = np.full((C, G), dummy, np.int64)
    for c in range(C):
        rows = per_t_max[cid == c]  # [Tc, G]
        if not len(rows):
            continue
        cu = rows.max(axis=0)
        if (np.where(rows < 0, cu, rows) != cu[None]).any():
            return None
        real = cu[cu >= 0]
        if len(np.unique(real)) != len(real):
            return None
        chunk_users[c] = np.where(cu < 0, dummy, cu)
    return chunk_users.astype(np.int32)


class SVDPPFeatureTrainer(SVDFeatureTrainer):

    def __init__(self, mtype):
        super().__init__(mtype)
        self.users_per_batch = 128
        self.sort_blocks = 0
        self.rows_per_user = 1
        self._plus_cache: Dict[int, PlusEntry] = {}
        # host seconds spent packing and staging datasets (paid once each)
        self.pack_seconds = 0.0

    def set_param(self, name: str, val: str) -> None:
        if name == "users_per_batch":
            self.users_per_batch = int(val)
        if name == "sort_blocks":
            self.sort_blocks = int(val)
        if name == "rows_per_user":
            self.rows_per_user = int(val)
        super().set_param(name, val)

    def _plus_hyper(self) -> PlusHyper:
        return PlusHyper(
            rows_per_user=self.rows_per_user,
            off_user=self.model.off_user,
            scale_lr_ufeedback=self.tparam.scale_lr_ufeedback,
            wd_ufeedback=self.tparam.wd_ufeedback,
            wd_ufeedback_bias=self.tparam.wd_ufeedback_bias,
        )

    def _build_hp(self) -> HyperParams:
        hp = super()._build_hp()
        if not hp.big_table:
            return hp
        if self.model.param.common_feedback_space:
            # feedback rows alias user rows: the chunk closed form does not
            # hold and the refresh epoch drives the standard layout, so a
            # big table keeps it (the JAX solver's rule, svdpp.py:318-335)
            return dataclasses.replace(hp, big_table=False, sweep_table=False, row_dma=False,
                                       num_factor=0)
        # SVD++ steps (G users x M rows) are far too sparse for the tile
        # sweep: the sorted-dedup write path is the big one
        return dataclasses.replace(hp, sweep_table=False)

    def _carry_users_plan(self, packed) -> Optional[np.ndarray]:
        """``[C, G]`` user-row ids per chunk where the packed layout takes
        the user-carry epoch (ops/svdpp_big ``carry_users``): every unit's
        user segment is one constant id (Su == 1), distinct across the
        chunk's units; else None (the entry-stream body runs it)."""
        u_idx = packed.u_idx  # [T, GS, Su]
        if u_idx.shape[2] != 1:
            return None
        T, GS, _ = u_idx.shape
        M = packed.rows_per_user
        ids = u_idx[:, :, 0].reshape(T, GS // M, M).astype(np.int64)
        return _chunk_users_from_slots(ids, packed.chunk_id, self.model.num_rows)

    def _pack_plus(self, ds: PlusDataset) -> PlusEntry:
        key = id(ds)
        if key not in self._plus_cache:
            t0 = time.perf_counter()
            m = self.model
            packed = pack_plus(
                ds,
                self.users_per_batch,
                m.num_rows,
                m.param.num_global,
                m.off_user,
                m.off_item,
                m.off_ufeedback,
                feat_user=self.feat_user,
                feat_item=self.feat_item,
                num_user=m.param.num_user,
                num_item=m.param.num_item,
                num_ufeedback=m.param.num_ufeedback,
                sort_blocks=bool(self.sort_blocks),
                rows_per_user=self.rows_per_user,
                # the dense O is O(G^2) per chunk: big tables take the
                # exact factored form (ops/svdpp_big._ov_mul)
                factored_overlap=self.hp.big_table,
            )
            dev = self.state.w.device
            arrays = packed.device_arrays()
            chunk_id = arrays.pop("chunk_id")
            fbd = packed.fb_arrays()
            plan = (self._carry_users_plan(packed)
                    if self.hp.big_table and self.hp.reg_method < 4 else None)
            if plan is not None:
                fbd["chunk_users"] = plan
                # the item entries' schedule is the same every round: their
                # sorted-dedup layout is made here, once
                T = packed.i_idx.shape[0]
                layout = make_dedup_layout(packed.i_idx.reshape(T, -1).astype(np.int64))
                arrays.update(zip(LAYOUT_PLANES, layout))
            fb, overlap = pool_from_numpy(fbd, packed.fb_overlap, dev)
            self._plus_cache[key] = PlusEntry(
                stacked=stacked_from_numpy(arrays, dev),
                chunk_id=chunk_id,
                fb=fb,
                fb_overlap=overlap,
                perm=packed.perm,
            )
            self.pack_seconds += time.perf_counter() - t0
        return self._plus_cache[key]

    def _train(self, entry: Union[PlusEntry, Dict[str, torch.Tensor]], lrs: List[float]) -> None:
        if not isinstance(entry, PlusEntry):  # a random-order pack: the base solver
            return super()._train(entry, lrs)
        ph = self._plus_hyper()
        reason = semantic_failure(self.hp, self.state, entry.stacked, ph)
        if reason is not None:
            raise NotImplementedError(reason)
        if self.hp.big_table:
            # a host loop of steps per round, writing through K5 with
            # use_pallas (hp.row_dma); with the carry plan, the user-carry body
            carry = "chunk_users" in entry.fb
            for lr in self._staged_lrs(lrs):
                self.state = train_epoch_plus_big(
                    self.state, entry.stacked, entry.chunk_id, entry.fb, entry.fb_overlap, lr,
                    self.consts, self.hp, ph, carry_users=carry)
            return
        # K2 where use_pallas is set and its gate passes, else the plain
        # rounds (the JAX solver's Pallas-or-jnp choice)
        use_kernel = self.use_pallas and gate_failure(
            self.hp, self.state, entry.stacked, entry.fb, ph) is None
        fn = train_rounds_svdpp_kernel if use_kernel else train_rounds_svdpp_reference
        self.state = fn(
            self.state, entry.stacked, entry.chunk_id, entry.fb, entry.fb_overlap,
            self._staged_lrs(lrs), self.consts, self.hp, ph,
        )

    def update_all(self, ds) -> None:
        """One pass over the dataset (one round); a random-order dataset
        takes the base solver's pass."""
        if not isinstance(ds, PlusDataset):
            return super().update_all(ds)
        self._train(self._pack_plus(ds), [self.learning_rate])

    def update_rounds(self, ds, num_rounds: int) -> None:
        """num_rounds passes in one wrapper call, with the per-round lr
        decay schedule (set_round semantics) built on the host; a
        random-order dataset takes the base solver's passes."""
        if not isinstance(ds, PlusDataset):
            return super().update_rounds(ds, num_rounds)
        entry = self._pack_plus(ds)
        lrs = []
        for _ in range(num_rounds):
            lrs.append(self.learning_rate)
            if self.tparam.decay_learning_rate:
                self.learning_rate *= self.tparam.decay_rate
                self.round_counter += 1
        self._train(entry, lrs)

    def predict_all(self, ds) -> np.ndarray:
        if not isinstance(ds, PlusDataset):  # random order: the base solver's forward
            return super().predict_all(ds)
        state = self.state_or_model()
        entry = self._pack_plus(ds)
        preds = predict_batches_plus(
            state, entry.stacked, entry.chunk_id, entry.fb, self.hp, self.rows_per_user
        )
        # perm maps dataset row -> packed slot (t*G*M + g*M + m)
        return preds.reshape(-1).cpu().numpy()[entry.perm]
