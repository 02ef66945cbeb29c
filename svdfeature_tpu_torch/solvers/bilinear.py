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
start_ufeedback, and the per-slot user properties ``up [C, G+1,
num_bi_feedback]`` from the raw values; the SVD++ trainer builds the
overlap from the filtered pool on the device.  The checkpoint appends
BParam (136 bytes) and W_bi after the SVDModel section
(apex_svd_bilinear.h:63-72), byte-compatible with the JAX package's.

A streaming buffer trains a chunk at a time through the SVD++ trainer's
hooks, each chunk packed with these extras (JAX :260-318): at the stream's
caps, sorted within the chunk with ``sort_blocks`` (the JAX chunk pack
passes it), and evaluated a chunk at a time in file order (:476-548).

On a ``(data, model)`` mesh (``mesh_data`` x ``mesh_model`` > 1, one rank a
position, solvers/base.py) W_bi is row-sharded over ``model`` beside the
table (JAX :76-108): on small slabs in the JAX layout of
parallel/bilinear_mesh.pad_bi_rows (the dummy row last in the last slab),
on big ones (``mesh_big``, the base solver's rule) in
parallel/bilinear_mesh_big's scratch-interleaved slabs.  The pack pads the
users of a step and the pool to the data axis (``pad_plus_for_mesh``),
widens ``up`` to the padded users and keeps this rank's columns, with no
overlap (JAX :212-240, 286-316; a streamed chunk the same way); every
round is parallel/bilinear_mesh's rounds or, on big slabs,
bilinear_mesh_big's (K5 writes), before the shared-space route (JAX :322-362);
the predictions, staged or streamed, score this rank's columns on its
slabs and are gathered over ``data`` (JAX :417-548).  A checkpoint
gathers W_bi over ``model`` on the ranks of data row 0 (JAX :97-108,
149-154); a resumed model loads W_bi, then shards it.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, List, Optional

import numpy as np
import torch

from ..convert import bilinear_from_numpy, pool_from_numpy, stacked_from_numpy
from ..data.csr import PlusDataset
from ..model import _read_t2d, _write_t2d
from ..ops.svdpp_bilinear import (BiHyper, predict_batches_bi, train_epoch_bi,
                                  train_epoch_bi_big, train_epoch_bi_refresh)
from ..parallel import bilinear_mesh, bilinear_mesh_big
from ..parallel import mesh as pmesh
from ..parallel.svdpp_mesh import pad_plus_for_mesh
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
    def __init__(self, mtype):
        super().__init__(mtype)
        self.bparam = BParam()
        self.reg_bi_feedback = 0
        self.wd_bi_feedback = 0.0
        self.slr_bi_feedback = 1.0
        # [num_item + 1, nbf] on the device, dummy row last; on a mesh this
        # rank's slab
        self.W_bi = None
        self._bi_allocated = False
        self._bi_rows = 0  # on a mesh: the padded rows (small slabs) or nb_real (big)

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

    def save_model(self, f: Optional[BinaryIO]) -> None:
        """The base checkpoint, then BParam and W_bi; on a mesh every rank
        calls it and the ranks of data row 0 gather W_bi over ``model``
        (rank 0, given the file, writes)."""
        if self.mesh is not None and self.mesh.d:
            return
        super().save_model(f)
        W = self._wbi_host()
        if f is not None:
            f.write(self.bparam.to_bytes())
            _write_t2d(f, W[:-1].cpu().numpy())

    def _init_mesh(self) -> None:
        """The base solver's sharding, then W_bi's slab beside the table's:
        small slabs in pad_bi_rows' layout, big ones scratch-interleaved
        (JAX :76-95)."""
        super()._init_mesh()
        shard = bilinear_mesh_big.shard_bi_big if self._mesh_big else bilinear_mesh.shard_bi
        self.W_bi, self._bi_rows = shard(self.W_bi, self.mesh)

    def _wbi_host(self) -> torch.Tensor:
        """W_bi ``[num_item + 1, nbf]`` in the single-device layout whatever
        the device layout; on a mesh gathered over ``model`` (a collective
        of this rank's model group)."""
        if self.mesh is None:
            return self.W_bi
        ni = self.mparam.num_item
        if self._mesh_big:
            return bilinear_mesh_big.unshard_bi_big(self.W_bi, self.mesh, self._bi_rows, ni)
        return bilinear_mesh.unshard_bi(self.W_bi, self.mesh, ni)

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
        """The SVD++ trainer's pack in file order (the JAX bilinear solver's
        staged pack passes no ``sort_blocks``) unless a chunk asks otherwise."""
        return super()._pack_numpy(ds, caps, sort_blocks=bool(sort_blocks))

    def _bi_extras(self, packed):
        """(filtered pool, up) of a packing (JAX :156-189): the entries
        below start_ufeedback keep their place with value 0 (they neither
        add to the factor sum nor receive a writeback, and the overlap is
        built from the filtered values); ``up`` from the raw values."""
        m = self.model
        fb = packed.fb_arrays()
        start = self.bparam.start_ufeedback
        G = packed.num_blocks_local
        if start > 0:
            keep = fb["fb_idx"] - m.off_ufeedback >= start
            fb = dict(fb, fb_val=np.where(keep, fb["fb_val"], 0.0).astype(np.float32))
        nbf = self.bparam.num_bi_feedback
        raw = packed.fb_arrays()
        C = raw["fb_idx"].shape[0]
        up = np.zeros((C, G + 1, nbf), np.float32)
        local = raw["fb_idx"].astype(np.int64) - m.off_ufeedback
        for c in range(C):
            mask = (local[c] >= 0) & (local[c] < nbf) & (raw["fb_block"][c] < G)
            if mask.any():
                up[c, raw["fb_block"][c][mask], local[c][mask]] = raw["fb_val"][c][mask]
        return fb, up

    def _entry(self, packed, dev: torch.device, plan: bool = True) -> BiEntry:
        """A packed dataset's entry with the bilinear extras on ``dev``
        (no carry plan: the big bilinear epoch is the entry-stream one).  On
        a mesh (JAX :212-240): the users of a step and the pool padded to
        the data axis, ``up`` widened to the padded users, this rank's
        columns, the row permutation remapped."""
        arrays = packed.device_arrays()
        chunk_id = arrays.pop("chunk_id")
        fbd, up = self._bi_extras(packed)
        perm = packed.perm
        if self.mesh is not None:
            m = self.model
            G, M = packed.num_blocks_local, packed.rows_per_user
            arrays, fbd, Gp, _ = pad_plus_for_mesh(arrays, fbd, G, self.mesh_data, m.num_rows,
                                                   m.param.num_global, M=M)
            if Gp != G:  # [C, G+1, nbf] -> [C, Gp+1, nbf], the empty segment last
                pad = np.zeros((up.shape[0], Gp - G, up.shape[2]), np.float32)
                up = np.concatenate([up[:, :G], pad, up[:, G:]], axis=1)
            arrays = pmesh.put_process_sharded(arrays, self.mesh)
            perm = (perm // (G * M)) * (Gp * M) + perm % (G * M)
        fb, _ = pool_from_numpy(fbd, None, dev)
        return BiEntry(stacked=stacked_from_numpy(arrays, dev), chunk_id=chunk_id, fb=fb,
                       fb_overlap=None, perm=perm, up=bilinear_from_numpy(None, up, dev)[1])

    # ---- training / prediction ----------------------------------------------------
    def _train(self, entry, lrs: List[float]) -> None:
        if not isinstance(entry, BiEntry):  # random order (base), pair skeleton (SVD++)
            return super()._train(entry, lrs)
        ph, bh = self._plus_hyper(), self._bi_hyper()
        if self.mesh is not None:
            # every rank runs the same per-shard steps on its slabs and user
            # slots, before the shared-space route (JAX :322-362); big slabs
            # write through K5 (hp.row_dma)
            common = (self.state, self.W_bi, entry.stacked, entry.chunk_id, entry.fb, entry.up,
                      self._staged_lrs(lrs), self.consts, self.hp, ph, bh, self.mesh,
                      self._mesh_rows, self._bi_rows)
            if self._mesh_big:
                self.state = bilinear_mesh_big.sharded_bilinear_rounds_big(
                    *common, self.mparam.num_item)
            else:
                self.state = bilinear_mesh.sharded_bilinear_rounds(*common)
            return
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
        """Scores of a staged entry in dataset-row order; on a mesh each rank
        scores its columns on its slabs and the scores are gathered over
        ``data``, so every rank returns all of them (JAX :417-548)."""
        args = (state, self.W_bi, entry.stacked, entry.chunk_id, entry.fb, entry.up, self.hp)
        off, M = self.model.off_item, self.rows_per_user
        if self.mesh is None:
            preds = predict_batches_bi(*args, off, M)
        elif self._mesh_big:
            preds = pmesh.gather_predictions(bilinear_mesh_big.sharded_bilinear_predict_big(
                *args, self.mesh, self._mesh_rows, self._bi_rows, off, self.mparam.num_item, M),
                self.mesh)
        else:
            preds = pmesh.gather_predictions(bilinear_mesh.sharded_bilinear_predict(
                *args, self.mesh, self._mesh_rows, self._bi_rows, off, M), self.mesh)
        return preds.reshape(-1).cpu().numpy()[entry.perm]
