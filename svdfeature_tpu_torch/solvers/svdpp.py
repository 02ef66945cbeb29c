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

Not ported yet, each raising NotImplementedError naming its ROADMAP item:
common_feedback_space=1 (item 7b), tables over 8192 rows (big-table
SVD++, item 9) and ``mesh_*`` > 1 (item 12); pairwise-rank sources (item
8) and streaming buffers (item 11) are refused where they are loaded
(data/registry.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Union

import numpy as np
import torch

from ..convert import pool_from_numpy, stacked_from_numpy
from ..data.batching_plus import pack_plus
from ..data.csr import PlusDataset
from ..ops.cuda_svdpp import (gate_failure, semantic_failure, train_rounds_svdpp_kernel,
                              train_rounds_svdpp_reference)
from ..ops.svdpp import PlusHyper, predict_batches_plus
from .base import SVDFeatureTrainer


@dataclasses.dataclass
class PlusEntry:
    """One packed user-group dataset, staged on the training device."""

    stacked: Dict[str, torch.Tensor]  # [T, G*M(, S)] planes
    chunk_id: np.ndarray  # [T] on the host: the launch loop reads it
    fb: Dict[str, torch.Tensor]  # fb_idx / fb_val / fb_block [C, F]
    fb_overlap: torch.Tensor  # [C, G+1, G+1]
    perm: np.ndarray  # dataset row -> packed slot


class SVDPPFeatureTrainer(SVDFeatureTrainer):
    # big-table SVD++ (ops/svdpp_big.py) is the next slice: the state keeps
    # the standard layout and the kernel gate names it for big tables
    SUPPORTS_BIG_TABLE = False

    def __init__(self, mtype):
        super().__init__(mtype)
        self.users_per_batch = 128
        self.sort_blocks = 0
        self.rows_per_user = 1
        self._plus_cache: Dict[int, PlusEntry] = {}

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

    def _pack_plus(self, ds: PlusDataset) -> PlusEntry:
        key = id(ds)
        if key not in self._plus_cache:
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
            )
            dev = self.state.w.device
            arrays = packed.device_arrays()
            chunk_id = arrays.pop("chunk_id")
            fb, overlap = pool_from_numpy(packed.fb_arrays(), packed.fb_overlap, dev)
            self._plus_cache[key] = PlusEntry(
                stacked=stacked_from_numpy(arrays, dev),
                chunk_id=chunk_id,
                fb=fb,
                fb_overlap=overlap,
                perm=packed.perm,
            )
        return self._plus_cache[key]

    def _train(self, entry: Union[PlusEntry, Dict[str, torch.Tensor]], lrs: List[float]) -> None:
        if not isinstance(entry, PlusEntry):  # a random-order pack: the base solver
            return super()._train(entry, lrs)
        ph = self._plus_hyper()
        reason = semantic_failure(self.hp, self.state, entry.stacked, ph)
        if reason is not None:
            raise NotImplementedError(reason)
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
