"""Bilinear solver (extend_type=15): per-item x user-property interactions.

Counterpart of the single-device part of svdfeature_tpu/solvers/bilinear.py
(SVDBiLinearTrainer, apex_svd_bilinear.h:28-212) on the SVD++ trainer: a
dense matrix ``W_bi [num_item, num_bi_feedback]`` adds sum_items sum_props
W_bi[iid, pid] * ival * pval to the score, where a user's properties are
its block's feedback entries with id < num_bi_feedback, and the feedback
factor sum starts at ``start_ufeedback`` (prepare_ufeedback's start_fid
filter, :170-181).  As in the JAX package, the intended filter is applied
(the shipped reference binary never binds it, so the two part only where
start_ufeedback > 0).  Config keys: ``num_bi_feedback``,
``start_ufeedback`` (BParam, fixed once the model is allocated),
``reg_bi_feedback``, ``wd_bi_feedback``, ``slr_bi_feedback``.

Routes (ops/svdpp_bilinear.py), as in the JAX solver (:364-415):
common_feedback_space=1 trains the per-batch refresh epoch; a table over
8192 rows the big-table epoch (the augmented layout, the entry-stream
step, W_bi's touched rows written through K5 with ``use_pallas``); any
other the overlap-carried epoch.  No route reaches K2 or K3, whatever
``use_pallas`` says: neither kernel has the W_bi terms (the JAX solver's
``_pallas_plus_ok`` is False, :110-113).  Random-order data trains and
predicts on the base solver.

The staged pack is the JAX solver's (:191-257): ``pack_plus`` in file
order (it passes no ``sort_blocks``), the pool's values zeroed below
start_ufeedback with the overlap recomputed from them, and the per-slot
user properties ``up [C, G+1, num_bi_feedback]`` from the raw values.  On
a big table the overlap is the factored form the port's big SVD++ pack
stages.  The checkpoint appends BParam (136 bytes) and W_bi after the
SVDModel section (apex_svd_bilinear.h:63-72), byte-compatible with the
JAX package's.

A streaming buffer trains a chunk at a time through the SVD++ trainer's
hooks, each chunk packed with these extras (JAX :260-318): at the stream's
caps, sorted within the chunk with ``sort_blocks`` (the JAX chunk pack
passes it), and evaluated a chunk at a time in file order (:476-548).

Not ported yet: ``mesh_*`` > 1 (ROADMAP item 12d), refused by
``init_trainer``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, List, Optional

import numpy as np
import torch

from ..convert import bilinear_from_numpy, pool_from_numpy, stacked_from_numpy
from ..data.batching_plus import compute_fb_overlap, compute_fb_overlap_factored, pack_plus
from ..data.csr import PlusDataset
from ..model import _read_t2d, _write_t2d
from ..ops.svdpp_bilinear import (BiHyper, predict_batches_bi, train_epoch_bi,
                                  train_epoch_bi_big, train_epoch_bi_refresh)
from .svdpp import PlusEntry, SVDPPFeatureTrainer


class BParam:
    """The bilinear section's parameters (apex_svd_bilinear.h:37-61)."""

    NBYTES = 4 * (2 + 32)

    def __init__(self) -> None:
        self.num_bi_feedback = 0
        self.start_ufeedback = 0

    def set_param(self, name: str, val: str) -> None:
        if name == "num_bi_feedback":
            self.num_bi_feedback = int(val)
        if name == "start_ufeedback":
            self.start_ufeedback = int(val)

    def to_bytes(self) -> bytes:
        return struct.pack("<ii", self.num_bi_feedback, self.start_ufeedback) + b"\0" * 128

    def load(self, f: BinaryIO) -> None:
        raw = f.read(self.NBYTES)
        self.num_bi_feedback, self.start_ufeedback = struct.unpack("<ii", raw[:8])


@dataclasses.dataclass
class BiEntry(PlusEntry):
    """A packed user-group dataset with the bilinear extras, staged."""

    up: torch.Tensor = None  # [C, G+1, nbf] per-slot user properties


class SVDBiLinearTrainer(SVDPPFeatureTrainer):
    MESH_ITEM = "12d (bilinear_mesh, bilinear_mesh_big)"

    def __init__(self, mtype):
        super().__init__(mtype)
        self.bparam = BParam()
        self.reg_bi_feedback = 0
        self.wd_bi_feedback = 0.0
        self.slr_bi_feedback = 1.0
        self.W_bi = None  # [num_item + 1, nbf] on the device, dummy row last
        self._bi_allocated = False

    def set_param(self, name: str, val: str) -> None:
        super().set_param(name, val)
        if name == "reg_bi_feedback":
            self.reg_bi_feedback = int(val)
        if name == "slr_bi_feedback":
            self.slr_bi_feedback = float(val)
        if name == "wd_bi_feedback":
            self.wd_bi_feedback = float(val)
        if not self._bi_allocated:
            self.bparam.set_param(name, val)

    # ---- model lifecycle ----------------------------------------------------
    def init_model(self) -> None:
        super().init_model()
        nbf = self.bparam.num_bi_feedback
        self.W_bi = bilinear_from_numpy(np.zeros((self.mparam.num_item, nbf), np.float32), None,
                                        self.device)[0]
        self._bi_allocated = True

    def load_model(self, f: BinaryIO) -> None:
        super().load_model(f)
        self.bparam.load(f)
        self.W_bi = bilinear_from_numpy(_read_t2d(f), None, self.device)[0]
        self._bi_allocated = True

    def save_model(self, f: BinaryIO) -> None:
        super().save_model(f)
        f.write(self.bparam.to_bytes())
        _write_t2d(f, self.W_bi[:-1].cpu().numpy())

    # ---- routes -------------------------------------------------------------
    def _kernel_ok(self, stacked, fb) -> bool:
        # K2 is plain SVD++: it lacks the W_bi terms
        return False

    def _bi_hyper(self) -> BiHyper:
        return BiHyper(slr_bi=self.slr_bi_feedback, wd_bi=self.wd_bi_feedback,
                       reg_bi=self.reg_bi_feedback, off_item=self.model.off_item)

    # ---- packing: the filtered pool and the user-property matrix -------------
    def _pack_numpy(self, ds: PlusDataset, caps: Optional[dict] = None,
                    sort_blocks: Optional[bool] = None):
        """``pack_plus`` at the JAX bilinear solver's layout: file order
        (its staged pack passes no ``sort_blocks``) unless a streamed chunk
        asks otherwise, the factored overlap on big tables."""
        m = self.model
        return pack_plus(
            ds, self.users_per_batch, m.num_rows, m.param.num_global, m.off_user, m.off_item,
            m.off_ufeedback, feat_user=self.feat_user, feat_item=self.feat_item,
            num_user=m.param.num_user, num_item=m.param.num_item,
            num_ufeedback=m.param.num_ufeedback, rows_per_user=self.rows_per_user,
            sort_blocks=bool(sort_blocks), factored_overlap=self.hp.big_table, **(caps or {}))

    def _bi_extras(self, packed):
        """(filtered pool, up, overlap) of a packing (JAX :156-189): the
        entries below start_ufeedback keep their place with value 0 (they
        neither add to the factor sum nor receive a writeback), the overlap
        recomputed from the filtered values in the packing's form; ``up``
        from the raw values."""
        m = self.model
        fb = packed.fb_arrays()
        start = self.bparam.start_ufeedback
        overlap = packed.fb_overlap
        G = packed.num_blocks_local
        if start > 0:
            keep = fb["fb_idx"] - m.off_ufeedback >= start
            fb = dict(fb, fb_val=np.where(keep, fb["fb_val"], 0.0).astype(np.float32))
            args = (fb["fb_idx"], fb["fb_val"], fb["fb_block"], G)
            fac = compute_fb_overlap_factored(*args) if isinstance(overlap, dict) else None
            overlap = (dict(diag=fac[0], dup=fac[1]) if fac is not None
                       else compute_fb_overlap(*args))
        nbf = self.bparam.num_bi_feedback
        raw = packed.fb_arrays()
        C = raw["fb_idx"].shape[0]
        up = np.zeros((C, G + 1, nbf), np.float32)
        local = raw["fb_idx"].astype(np.int64) - m.off_ufeedback
        for c in range(C):
            mask = (local[c] >= 0) & (local[c] < nbf) & (raw["fb_block"][c] < G)
            if mask.any():
                up[c, raw["fb_block"][c][mask], local[c][mask]] = raw["fb_val"][c][mask]
        return fb, up, overlap

    def _entry(self, packed, dev: torch.device, plan: bool = True) -> BiEntry:
        """A packed dataset's entry with the bilinear extras on ``dev``
        (no carry plan: the big bilinear epoch is the entry-stream one)."""
        arrays = packed.device_arrays()
        chunk_id = arrays.pop("chunk_id")
        fbd, up, overlap = self._bi_extras(packed)
        fb, overlap = pool_from_numpy(fbd, overlap, dev)
        return BiEntry(stacked=stacked_from_numpy(arrays, dev), chunk_id=chunk_id, fb=fb,
                       fb_overlap=overlap, perm=packed.perm,
                       up=bilinear_from_numpy(None, up, dev)[1])

    # ---- training / prediction ----------------------------------------------------
    def _train(self, entry, lrs: List[float]) -> None:
        if not isinstance(entry, BiEntry):  # random order (base), pair skeleton (SVD++)
            return super()._train(entry, lrs)
        ph, bh = self._plus_hyper(), self._bi_hyper()
        for lr in self._staged_lrs(lrs):
            common = (entry.stacked, entry.chunk_id, entry.fb)
            if self.model.param.common_feedback_space:
                # pool rows alias user rows: refresh per step
                self.state = train_epoch_bi_refresh(self.state, self.W_bi, *common, entry.up, lr,
                                                    self.consts, self.hp, ph, bh)
            else:
                epoch = train_epoch_bi_big if self.hp.big_table else train_epoch_bi
                self.state = epoch(self.state, self.W_bi, *common, entry.fb_overlap, entry.up, lr,
                                   self.consts, self.hp, ph, bh)

    def _predict_entry(self, state, entry: BiEntry) -> np.ndarray:
        preds = predict_batches_bi(state, self.W_bi, entry.stacked, entry.chunk_id, entry.fb,
                                   entry.up, self.hp, self.model.off_item, self.rows_per_user)
        return preds.reshape(-1).cpu().numpy()[entry.perm]
