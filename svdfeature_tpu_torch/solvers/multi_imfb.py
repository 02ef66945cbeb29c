"""Multi-IMFB trainer (extend_type=2): stacked local implicit feedback.

Counterpart of the small-table, single-device part of
svdfeature_tpu/solvers/multi_imfb.py (SVDPPMultiIMFB,
apex_multi_imfb.h:31-194).  Blocks push and pop a stack of feedback
contexts through their extend tags (data/batching_imfb.py); a row's
feedback term is the sum of its block's active contexts'.  Config key
``ufeedback_disable_level`` (repeatable) disables feedback updates at the
given stack depth (:54-63).  The SVD++ keys apply: ``users_per_batch``
units (blocks with rows) side by side, ``rows_per_user`` rows of each per
step, ``sort_blocks``.

Every round of stacked data goes through
``ops.cuda_imfb.train_rounds_imfb_kernel`` (K3 on a CUDA device, its
plain version on the CPU) where K3's gate takes the configuration, else
through the plain rounds; ``use_pallas=0`` selects the plain rounds on
the device.  An all-DEFAULT tag stream degenerates to plain SVD++ and
takes the SVD++ trainer's whole path (K2), unless depth 0 is disabled.  A
random-order dataset trains and predicts on the base solver (K1), as in
the JAX package (svdfeature_tpu/solvers/multi_imfb.py:472-473 and the
SVD++ solver's routes it inherits).

Tables over 8192 rows take the augmented layout (the SVD++ trainer's
``_build_hp``) and the stacked epoch on it, ops/imfb.train_epoch_imfb_big
(the per-step refresh form, writing through K5 with ``use_pallas``),
before K3's gate (JAX solvers/multi_imfb.py:405-415); that epoch reads no
context overlap, so none is staged for it.  All-DEFAULT data on a big
table takes the big SVD++ epoch.

With common_feedback_space=1 (the pool rows are user rows) every round of
stacked data is the per-batch refresh epoch ops/imfb.train_epoch_imfb, at
any table size, and no context overlap is built, as in the JAX
solver (solvers/multi_imfb.py:197, 341, 397-404).

A streaming buffer of stacked data trains a chunk of ``stream_chunk``
units (blocks with rows) at a time (svdfeature_tpu/solvers/multi_imfb.py:
100-260): the contexts still open at a chunk's boundary carry into the next
chunk's pack (``pack_imfb_chunk``, pack_imfb's ``initial_stack``), every
chunk is packed to the stream's stable caps and trains as staged data does
(K3, or the big or refresh epochs); an all-DEFAULT stream takes the SVD++
trainer's streaming path.  Its evaluation packs and scores a chunk at a
time.

On a ``(data, model)`` mesh every round of stacked data goes through the
stacked mesh step (svdfeature_tpu/solvers/multi_imfb.py:179-216, 243,
308-330, 374-400, 448-480): the pack pads the slots of a step to a
multiple of ``n_data * rows_per_user`` and the pool to the data axis
(``pad_imfb_for_mesh``) and keeps this rank's slots, the pool and the
gates replicated, no overlap; each round is parallel/imfb_mesh's rounds on
small slabs or parallel/imfb_mesh_big's on big ones (``mesh_big``, K5
writes), before K3's gate, the big and the shared-space routes; the
predictions are scored sharded and gathered over ``data``.  All-DEFAULT
data takes the SVD++ trainer's mesh path.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .. import tracing
from ..convert import gate_from_numpy, pool_from_numpy, stacked_from_numpy
from ..data.batching_imfb import pack_imfb
from ..data.csr import TAG_DEFAULT, PlusDataset
from ..ops.cuda_imfb import gate_failure, train_rounds_imfb_kernel, train_rounds_imfb_reference
from ..ops.imfb import predict_batches_imfb, train_epoch_imfb, train_epoch_imfb_big
from ..parallel import imfb_mesh, imfb_mesh_big
from ..parallel import mesh as pmesh
from .base import SVDFeatureTrainer
from .svdpp import CPU, PlusEntry, SVDPPFeatureTrainer


@dataclasses.dataclass
class ImfbEntry:
    """One packed stacked dataset, staged on the training device."""

    stacked: Dict[str, torch.Tensor]  # [T, G*RM(, S)] planes, ctx_slots [T, G*RM, D]
    chunk_id: np.ndarray  # [T] on the host: the launch loop reads it
    # fb_idx / fb_val / fb_ctx [C, F], ctx_depth [C, nseg-1] (not on a mesh)
    fb: Dict[str, torch.Tensor]
    # [C, nseg, nseg], or None where no epoch reads it (SVDPPFeatureTrainer._overlap)
    fb_overlap: Optional[torch.Tensor]
    enabled: torch.Tensor  # [C, nseg] update gate
    perm: np.ndarray  # dataset row -> packed slot (on a mesh, of the padded layout)


class SVDPPMultiIMFBTrainer(SVDPPFeatureTrainer):

    def __init__(self, mtype):
        super().__init__(mtype)
        self.disable_levels = set()
        self._imfb_cache: Dict[int, ImfbEntry] = {}

    def set_param(self, name: str, val: str) -> None:
        if name == "ufeedback_disable_level":
            self.disable_levels.add(int(val))
        super().set_param(name, val)

    def _plain_svdpp(self, ds) -> bool:
        """An all-DEFAULT tag stream degenerates to plain SVD++: every block
        pushes its own feedback, trains its rows and pops, at depth 0
        throughout (apex_multi_imfb.h:31-194 reduces to
        apex_svd_base.h:484-592).  Such datasets, and streams whose
        pre-scan saw only DEFAULT tags, take the SVD++ path unless depth-0
        updates are disabled."""
        if 0 in self.disable_levels:
            return False
        if isinstance(ds, PlusDataset):
            return bool((ds.extend_tag == TAG_DEFAULT).all())
        if hasattr(ds, "phys"):  # StreamingPlusBuffer
            return all(tag == TAG_DEFAULT for _, _, tag in ds.phys)
        return False

    def _imfb_enabled(self, ctx_depth: np.ndarray) -> np.ndarray:
        """Per-(chunk, local-context) update gate from the stack depths
        (ufeedback_disable_level, apex_multi_imfb.h:54-63); the extra last
        column is the always-off pad slot."""
        enabled = np.ones((ctx_depth.shape[0], ctx_depth.shape[1] + 1), np.float32)
        enabled[:, -1] = 0.0  # pad slot
        for lvl in self.disable_levels:
            enabled[:, :-1][ctx_depth == lvl] = 0.0
        enabled[:, :-1][ctx_depth < 0] = 0.0  # unused slots
        return enabled

    def _warn_sorted_stacked(self) -> None:
        if self.sort_blocks and self.rows_per_user > 2:
            warnings.warn(
                "sort_blocks=1 with rows_per_user>2 on STACKED data is measured "
                "divergent (sorted heavy-unit chunks double the context-coupling "
                "gain; PERF.md 'stacked scan frontier') - keep file order or "
                "reduce rows_per_user"
            )

    def _pack_imfb(self, ds: PlusDataset, **kw):
        """``pack_imfb`` of ``ds`` at the trainer's layout (numpy only); a
        streamed chunk passes its carried contexts and the stream's caps."""
        m = self.model
        return pack_imfb(
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
            rows_per_user=self.rows_per_user,
            sort_blocks=bool(self.sort_blocks),
            **kw,
        )

    def _imfb_entry(self, packed, dev: torch.device) -> ImfbEntry:
        """A stacked packing's entry on ``dev``, its context overlap left to
        ``_with_overlap``; on a mesh, the slots and the pool padded to the
        data axis and this rank's columns, the pool and the gates
        replicated (JAX multi_imfb.py:179-193, 301-330)."""
        arrays = packed.device_arrays()
        chunk_id = arrays.pop("chunk_id")
        enabled = gate_from_numpy(self._imfb_enabled(packed.ctx_depth), dev)
        if self.mesh is not None:
            m = self.model
            G = packed.label.shape[1]
            fbd = {k: getattr(packed, k) for k in ("fb_idx", "fb_val", "fb_ctx")}
            arrays, fbd, Gp, _ = imfb_mesh.pad_imfb_for_mesh(
                arrays, fbd, G, self.mesh_data, m.num_rows, m.param.num_global,
                packed.ctx_depth.shape[1] + 1, M=packed.rows_per_user)
            fb, _ = pool_from_numpy(fbd, None, dev)
            return ImfbEntry(
                stacked=stacked_from_numpy(pmesh.put_process_sharded(arrays, self.mesh), dev),
                chunk_id=chunk_id, fb=fb, fb_overlap=None, enabled=enabled,
                perm=(packed.perm // G) * Gp + packed.perm % G)
        fb, _ = pool_from_numpy(packed.fb_arrays(), None, dev)
        return ImfbEntry(stacked=stacked_from_numpy(arrays, dev), chunk_id=chunk_id, fb=fb,
                         fb_overlap=None, enabled=enabled, perm=packed.perm)

    def _with_overlap(self, entry):
        """A stacked entry with the context overlaps (over its contexts and
        the pad slot) that K3 and the plain rounds read; the big-table
        epoch reads none.  An all-DEFAULT entry takes the SVD++ one."""
        if not isinstance(entry, ImfbEntry):
            return super()._with_overlap(entry)
        if not self.hp.big_table:
            entry.fb_overlap = self._overlap(entry.fb, entry.enabled.shape[1] - 1, slots="fb_ctx")
        return entry

    def _pack_plus(self, ds: PlusDataset) -> Union[PlusEntry, ImfbEntry]:
        if self._plain_svdpp(ds):
            return super()._pack_plus(ds)
        self._warn_sorted_stacked()
        key = id(ds)
        if key not in self._imfb_cache:
            if tracing.on:
                tracing.begin("pack")
            entry = self._with_overlap(self._imfb_entry(self._pack_imfb(ds), self.state.w.device))
            self._imfb_cache[key] = entry
            self._plan_ids.add(id(entry.stacked["label"]))
            if tracing.on:
                tracing.end()
        return self._imfb_cache[key]

    # ---- streaming (out-of-core stacked sources) -----------------------------
    def pack_imfb_chunk(self, chunk: PlusDataset, carry, caps: dict) -> ImfbEntry:
        """One streamed stacked chunk packed to the stream's stable caps,
        the contexts still open at its start (``carry``) seeding the tag
        walk, as an entry of CPU tensors (the producer thread runs it)."""
        return self._imfb_entry(self._pack_imfb(chunk, initial_stack=carry,
                                                **self._stream_caps(caps)), CPU)

    stage_chunk_imfb = SVDPPFeatureTrainer.stage_chunk_plus
    train_chunk_imfb = SVDFeatureTrainer.train_chunk

    def _stream_round_plus(self, ds) -> None:
        if self._plain_svdpp(ds):
            return super()._stream_round_plus(ds)
        from ..data.streaming import stream_train_round_imfb

        # sort_blocks sorts units within each chunk (each keeps its context
        # snapshot, so the tag walk's meaning does not change), and the
        # stream's caps are planned for that order (plan_caps_imfb)
        self._warn_sorted_stacked()
        self._round_blocks_per_chunk(ds)
        self._stream_round(stream_train_round_imfb, ds)

    def _predict_entry(self, state, entry) -> np.ndarray:
        if isinstance(entry, PlusEntry):  # all-DEFAULT data: the SVD++ forward
            return super()._predict_entry(state, entry)
        if self.mesh is not None:
            fn = (imfb_mesh_big.sharded_imfb_predict_big if self._mesh_big
                  else imfb_mesh.sharded_imfb_predict)
            preds = pmesh.gather_predictions(
                fn(state, entry.stacked, entry.chunk_id, entry.fb, entry.enabled.shape[1],
                   self.hp, self.mesh, self._mesh_rows), self.mesh)
        else:
            preds = predict_batches_imfb(state, entry.stacked, entry.chunk_id, entry.fb, self.hp)
        # perm maps dataset row -> packed slot (t*G*RM + g*RM + m)
        return preds.reshape(-1).cpu().numpy()[entry.perm]

    def _train(self, entry, lrs: List[float]) -> None:
        if not isinstance(entry, ImfbEntry):  # all-DEFAULT (SVD++) or random order (base)
            return super()._train(entry, lrs)
        ph = self._plus_hyper()
        if self.mesh is not None:
            # the stacked mesh step on every rank, before every other route
            # (JAX multi_imfb.py:374-400); big slabs write through K5
            fn = (imfb_mesh_big.sharded_imfb_rounds_big if self._mesh_big
                  else imfb_mesh.sharded_imfb_rounds)
            self.state = fn(self.state, entry.stacked, entry.chunk_id, entry.fb, entry.enabled,
                            self._staged_lrs(lrs), self.consts, self.hp, ph, self.mesh,
                            self._mesh_rows)
            return
        if self.model.param.common_feedback_space or self.hp.big_table:
            # the refresh epochs: the shared space's (pool rows alias user
            # rows) at any table size, else the big table's
            epoch = (train_epoch_imfb if self.model.param.common_feedback_space
                     else train_epoch_imfb_big)
            for lr in self._staged_lrs(lrs):
                self.state = epoch(
                    self.state, entry.stacked, entry.chunk_id, entry.fb, entry.enabled, lr,
                    self.consts, self.hp, ph)
            return
        # K3 where use_pallas is set and its gate passes, else the plain rounds
        use_kernel = self.use_pallas and gate_failure(self.hp, self.state, entry.stacked, ph) is None
        fn = train_rounds_imfb_kernel if use_kernel else train_rounds_imfb_reference
        self.state = fn(
            self.state, entry.stacked, entry.chunk_id, entry.fb, entry.fb_overlap,
            entry.enabled, self._staged_lrs(lrs), self.consts, self.hp, ph,
        )

    def predict_all(self, ds) -> np.ndarray:
        if hasattr(ds, "plan_caps") and not self._plain_svdpp(ds):
            # a stacked stream: bounded memory, a chunk at a time, its caps
            # planned for the chunks' own order
            caps = ds.plan_caps_imfb(self.users_per_batch, self.rows_per_user,
                                     sort_local=bool(self.sort_blocks))
            state = self._scoring_state()
            out = [self._predict_entry(state, self._imfb_entry(
                self._pack_imfb(chunk, initial_stack=carry, **self._stream_caps(caps)),
                state.w.device)) for chunk, carry in ds.chunks_imfb()]
            return np.concatenate(out) if out else np.zeros(0, np.float32)
        if not isinstance(ds, PlusDataset):  # random order, all-DEFAULT streams, pair sources
            return super().predict_all(ds)
        return self._predict_entry(self._scoring_state(), self._pack_plus(ds))
