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
as on the base solver's big route), never the tile sweep.  The entry then
takes the factored feedback overlap where it is smaller and, where every
unit's user segment is one constant id distinct within its chunk and
reg_method < 4 (``_carry_users_plan``), the user-carry plan and the items'
static sorted-dedup layout.  On the card, a staged pack's first big-table
round runs eagerly, its second is captured whole as one CUDA graph and
each later round is one replay of it (solvers/round_graph.py, as the base
solver's big rounds); streamed chunks, pair epochs and every other route
stay eager.

``pack_plus`` runs with its host overlap deferred (``_pack_numpy``):
ops/fb_overlap.build makes it from the staged pool where a pack, the pair
skeleton or a streamed chunk is staged for training (``_with_overlap``),
never on a mesh, under a shared feedback space or for a prediction alone.

With common_feedback_space=1 the feedback pool rows are user rows, so a
step's row updates move the pool and the chunk closed form of the
carried epoch (and of K2) does not hold: every round is
ops/svdpp.train_epoch_plus_refresh, which gathers each step's pool and
writes its deltas straight back, at any table size (a big table keeps the
standard layout there), as the JAX solver does (solvers/svdpp.py:318-335,
600-615).  Pair sources under a shared space train through it too.

A PairSource (pairwise rank, input_type 2/3, data/rank.py) trains a
freshly sampled pair epoch every round (svdfeature_tpu/solvers/svdpp.py:
742-1237), on the dense pair layout (``rank_sort_pairs``,
``rank_rows_per_user`` 8 and ``rank_users_per_batch`` 64 fill in the
layout keys the conf left unset).  Where every source row is one (user,
item) pair, the layout is built once from a throwaway epoch (the pair
skeleton) and a round only gathers its sampled rows' entries from per-row
tables on the device: ``update_all`` samples with PairSource's own stream
(one round ahead, on a producer thread that runs numpy only) and trains
one K2 call (or, on a big table, one big epoch); ``update_rounds`` takes
the multi-round host sampler (data/rank.sample_offsets, blocks of
PAIR_BLOCK_ROUNDS rounds, one K2 call on a block's per-round planes, on a
big table the user-carry epoch from the candidate plan) where
``use_pallas`` is set, or with ``rank_device_sample=1`` the device sampler
(ops/pair_sample.py, every round in one K2 call).  What the skeleton
refuses (pointwise rows, rank-difference labels, feature hierarchies,
global features, rows of several entries) packs each epoch afresh.

A streaming user-group buffer (``streaming=1``,
data/streaming.StreamingPlusBuffer) trains a round a chunk of
``stream_chunk`` user blocks at a time (svdfeature_tpu/solvers/svdpp.py:
653-740, 1196-1238): the producer thread packs each chunk to the stream's
stable caps (``pack_plus_chunk``; ``sort_blocks`` sorts within the chunk;
on a big table with the chunk's carry plan and dedup layout) and stages it
(solvers/streamed.py), and each chunk trains as a staged dataset does (K2,
the big epoch through K5, or the refresh epoch under a shared space).
Its evaluation packs and scores one chunk at a time.

On a ``(data, model)`` mesh (``mesh_data`` x ``mesh_model`` > 1, one rank a
position, solvers/base.py) every round goes through the SVD++ mesh step
(svdfeature_tpu/solvers/svdpp.py:354-410, 538-596, 653-737, 1242-1330):
the pack pads the users of a step and the pool to the data axis
(``pad_plus_for_mesh``) and keeps this rank's user slots, the pool
replicated and no overlap; each round is parallel/svdpp_mesh's rounds on
small slabs, or parallel/svdpp_mesh_big's on big ones (``mesh_big``, K5
writes), a shared feedback space included (the mesh step gathers its
aggregates every step); the predictions score this rank's columns on its
slab and are gathered over ``data``.  K2, the pair skeleton and both
multi-round pair samplers refuse a mesh, as in the JAX package, so a
PairSource trains a freshly packed pair epoch a round through the mesh
step; a streamed chunk is padded and sliced the same way before staging.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import tracing
from ..convert import pool_from_numpy, stacked_from_numpy
from ..data.batching_plus import pack_plus
from ..data.csr import PlusDataset
from ..ops import fb_overlap
from ..ops.big_embed import make_dedup_layout
from ..ops.cuda_svdpp import (gate_failure, round_planes, train_rounds_svdpp_kernel,
                              train_rounds_svdpp_reference)
from ..ops.embed import HyperParams, TrainState
from ..ops.svdpp import PlusHyper, predict_batches_plus, train_epoch_plus_refresh
from ..ops.svdpp_big import LAYOUT_PLANES, epoch_counts, train_epoch_plus_big
from ..parallel import mesh as pmesh
from ..parallel import svdpp_mesh, svdpp_mesh_big
from .base import SVDFeatureTrainer
from .round_graph import RoundGraph
from .streamed import Staged

CPU = torch.device("cpu")


@dataclasses.dataclass
class PlusEntry:
    """One packed user-group dataset, staged on the training device."""

    stacked: Dict[str, torch.Tensor]  # [T, G*M(, S)] planes
    chunk_id: np.ndarray  # [T] on the host: the launch loop reads it
    # fb_idx / fb_val / fb_block [C, F]; chunk_users [C, G] with the carry plan
    fb: Dict[str, torch.Tensor]
    # [C, G+1, G+1], {"diag", "dup"} factored on big tables, or None
    fb_overlap: Optional[Union[torch.Tensor, Dict[str, torch.Tensor]]]
    perm: np.ndarray  # dataset row -> packed slot (on a mesh, of the padded layout)


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
        # pairwise rank (a PairSource): the dense pair-epoch layout, which
        # fills in sort_blocks / rows_per_user / users_per_batch where the
        # conf left them unset (_apply_pair_layout): pair counts per user
        # are skewed (ML-100K: max 1113, median 100), and the pairs are a
        # fresh random sample every epoch, so the order carries no signal
        self.rank_sort_pairs = 1
        self.rank_rows_per_user = 8
        self.rank_users_per_batch = 64
        # rank_device_sample=1: the rounds' pairs drawn on the device
        # (ops/pair_sample.py, same law, another stream), seeded by
        # rank_device_seed, which also seeds the multi-round host sampler
        self.rank_device_sample = 0
        self.rank_device_seed = 10
        self._explicit = set()
        self._pair_layout_applied = False
        # the pair paths' state: the source the skeleton was built for, the
        # skeleton, and the one-ahead sampling thread (numpy only) with its
        # pending result
        self._pair_src = None
        self._pair_sk: Optional[dict] = None
        self._pair_pool = None
        self._pair_future = None

    def set_param(self, name: str, val: str) -> None:
        if name in ("users_per_batch", "sort_blocks", "rows_per_user"):
            setattr(self, name, int(val))
            self._explicit.add(name)
        if name in ("rank_users_per_batch", "rank_sort_pairs", "rank_rows_per_user",
                    "rank_device_sample", "rank_device_seed"):
            setattr(self, name, int(val))
        super().set_param(name, val)

    def _apply_pair_layout(self) -> None:
        """The dense pair-epoch layout, on first use of a PairSource:
        explicit sort_blocks= / rows_per_user= / users_per_batch= keys win
        (svdfeature_tpu/solvers/svdpp.py:304-316)."""
        if self._pair_layout_applied:
            return
        self._pair_layout_applied = True
        if "sort_blocks" not in self._explicit and self.rank_sort_pairs:
            self.sort_blocks = 1
        if "rows_per_user" not in self._explicit and self.rank_rows_per_user:
            self.rows_per_user = self.rank_rows_per_user
        if "users_per_batch" not in self._explicit and self.rank_users_per_batch:
            self.users_per_batch = self.rank_users_per_batch

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

    def _pack_numpy(self, ds: PlusDataset, caps: Optional[dict] = None,
                    sort_blocks: Optional[bool] = None):
        """``pack_plus`` of ``ds`` at the trainer's layout without its
        overlap (numpy only, so a producer thread may run it); a streamed
        chunk passes the stream's ``caps`` and its own ordering."""
        m = self.model
        with fb_overlap.deferred():
            return pack_plus(
                ds, self.users_per_batch, m.num_rows, m.param.num_global, m.off_user,
                m.off_item, m.off_ufeedback, feat_user=self.feat_user, feat_item=self.feat_item,
                num_user=m.param.num_user, num_item=m.param.num_item,
                num_ufeedback=m.param.num_ufeedback, rows_per_user=self.rows_per_user,
                sort_blocks=bool(self.sort_blocks) if sort_blocks is None else sort_blocks,
                **(caps or {}))

    def _overlap(self, fb: Dict[str, torch.Tensor], G: int, slots: str = "fb_block"):
        """The overlap of the staged pool ``fb`` that this route's epochs
        read, built on its device: dense on small tables (K2, K3, the plain
        epochs), the copy's rule on big ones; None on a mesh and under a
        shared feedback space (their epochs gather the pool every step)."""
        if self.mesh is not None or self.model.param.common_feedback_space:
            return None
        return fb_overlap.build(fb, G, factored=self.hp.big_table, slots=slots)

    def _with_overlap(self, entry: PlusEntry) -> PlusEntry:
        """``entry``, staged for training, with its overlap (``_overlap``;
        its planes are ``[T, G*M]``)."""
        G = entry.stacked["label"].shape[1] // self.rows_per_user
        entry.fb_overlap = self._overlap(entry.fb, G)
        return entry

    def _mesh_entry(self, packed, dev: torch.device) -> PlusEntry:
        """A packed dataset's entry on a mesh (svdfeature_tpu/solvers/
        svdpp.py:377-406): the users of a step and the pool padded to the
        data axis, this rank's columns of the planes, the pool replicated,
        no overlap (the mesh step gathers its aggregates every step), and
        the row permutation remapped to the padded layout."""
        m = self.model
        arrays = packed.device_arrays()
        chunk_id = arrays.pop("chunk_id")
        M = packed.rows_per_user
        G = packed.num_blocks_local
        arrays, fbd, Gp, _ = svdpp_mesh.pad_plus_for_mesh(
            arrays, packed.fb_arrays(), G, self.mesh_data, m.num_rows, m.param.num_global, M=M)
        perm = (packed.perm // (G * M)) * (Gp * M) + packed.perm % (G * M)
        fb, _ = pool_from_numpy(fbd, None, dev)
        return PlusEntry(stacked=stacked_from_numpy(pmesh.put_process_sharded(arrays, self.mesh),
                                                    dev),
                         chunk_id=chunk_id, fb=fb, fb_overlap=None, perm=perm)

    def _entry(self, packed, dev: torch.device, plan: bool = True) -> PlusEntry:
        """A packed dataset's entry on ``dev``; for training (``plan``),
        with the carry plan, padded to the pool's chunk rows (a streamed
        chunk's reserved all-padding chunk: JAX svdpp.py:687-700), and the
        items' static dedup layout where the big route takes them; on a
        mesh, ``_mesh_entry``."""
        if self.mesh is not None:
            return self._mesh_entry(packed, dev)
        arrays = packed.device_arrays()
        chunk_id = arrays.pop("chunk_id")
        fbd = packed.fb_arrays()
        carry = (self._carry_users_plan(packed)
                 if plan and self.hp.big_table and self.hp.reg_method < 4 else None)
        if carry is not None:
            full = np.full((fbd["fb_idx"].shape[0], carry.shape[1]), self.model.num_rows, np.int32)
            full[: carry.shape[0]] = carry
            fbd["chunk_users"] = full
            # the item entries' schedule is the same every round: their
            # sorted-dedup layout is made here, once
            T = packed.i_idx.shape[0]
            layout = make_dedup_layout(packed.i_idx.reshape(T, -1).astype(np.int64))
            arrays.update(zip(LAYOUT_PLANES, layout))
        fb, _ = pool_from_numpy(fbd, None, dev)
        return PlusEntry(stacked=stacked_from_numpy(arrays, dev), chunk_id=chunk_id, fb=fb,
                         fb_overlap=None, perm=packed.perm)

    def _stage_packed(self, packed) -> PlusEntry:
        """A packed dataset staged for training, with its overlap."""
        entry = self._with_overlap(self._entry(packed, self.state.w.device))
        self._plan_ids.add(id(entry.stacked["label"]))
        return entry

    def _pack_plus(self, ds: PlusDataset) -> PlusEntry:
        """The staged pack of a dataset the caller keeps, made once (cached
        by the dataset's id); pair epochs, made afresh every round, go
        through ``_stage_packed`` uncached."""
        key = id(ds)
        if key not in self._plus_cache:
            if tracing.on:
                tracing.begin("pack")
            packed = self._pack_numpy(ds)
            if tracing.on:
                tracing.count("slots", packed.weight.size)
                tracing.count("slots.live", int(np.count_nonzero(packed.weight)))
            self._plus_cache[key] = self._stage_packed(packed)
            if tracing.on:
                tracing.end()
        return self._plus_cache[key]

    # ---- streaming (out-of-core user-group buffers) -----------------------------
    def _stream_caps(self, caps: dict) -> dict:
        """The stream's pack caps with the segment caps widened by the
        feature hierarchies' expansion."""
        return dict(caps, seg_caps=self._stream_seg_caps(caps["seg_caps"]))

    def pack_plus_chunk(self, chunk: PlusDataset, caps: dict) -> PlusEntry:
        """One streamed chunk packed to the stream's stable caps in file
        order, or with ``sort_blocks`` sorted within the chunk (the stream
        never holds the whole dataset), as an entry of CPU tensors (the
        producer thread runs it)."""
        packed = self._pack_numpy(chunk, self._stream_caps(caps), sort_blocks=bool(self.sort_blocks))
        return self._entry(packed, CPU)

    def stage_chunk_plus(self, entry: PlusEntry) -> Staged:
        """A packed chunk on the training device, its overlap built there
        after the copies (producer thread; on a mesh ``_entry`` has kept
        this rank's columns already)."""
        return self.chunk_stream.stage(entry, self.state.w.device, then=self._with_overlap)

    train_chunk_plus = SVDFeatureTrainer.train_chunk

    def _round_blocks_per_chunk(self, ds) -> None:
        """Round blocks_per_chunk down to a users_per_batch multiple (up
        for tiny values): a streamed round equals the staged run on the
        same (chunk-locally ordered) blocks only when every chunk splits
        into whole user batches."""
        bpc = ds.blocks_per_chunk
        if bpc % self.users_per_batch:
            new = max(self.users_per_batch, bpc - bpc % self.users_per_batch)
            warnings.warn(
                f"streaming: blocks_per_chunk={bpc} is not a multiple of "
                f"users_per_batch={self.users_per_batch}; rounding to {new} "
                "to keep the staged-run trajectory guarantee"
            )
            ds.blocks_per_chunk = new

    def _stream_round_plus(self, ds) -> None:
        from ..data.streaming import stream_train_round_plus

        self._round_blocks_per_chunk(ds)
        self._stream_round(stream_train_round_plus, ds)

    def _scoring_state(self):
        """The state predictions read: on a mesh this rank's slab (the
        scores are computed sharded), else the whole table in the standard
        layout."""
        return self.state if self.mesh is not None else self.state_or_model()

    def _predict_entry(self, state, entry: PlusEntry) -> np.ndarray:
        """Scores of a staged entry in dataset-row order (perm maps a
        dataset row to its packed slot t*G*M + g*M + m); on a mesh each
        rank scores its columns on its slab and the scores are gathered
        over ``data``, so every rank returns all of them."""
        if self.mesh is not None:
            fn = (svdpp_mesh_big.sharded_svdpp_predict_big if self._mesh_big
                  else svdpp_mesh.sharded_svdpp_predict)
            preds = pmesh.gather_predictions(
                fn(state, entry.stacked, entry.chunk_id, entry.fb, self.hp, self.mesh,
                   self._mesh_rows, self.rows_per_user), self.mesh)
        else:
            preds = predict_batches_plus(state, entry.stacked, entry.chunk_id, entry.fb, self.hp,
                                         self.rows_per_user)
        return preds.reshape(-1).cpu().numpy()[entry.perm]

    def _predict_stream(self, ds) -> np.ndarray:
        """Bounded-memory scores of a streaming source, one chunk at a time
        in file order."""
        caps = self._stream_caps(ds.plan_caps(self.users_per_batch, self.rows_per_user))
        state = self._scoring_state()
        out = [self._predict_entry(state, self._entry(
            self._pack_numpy(chunk, caps, sort_blocks=False), state.w.device, plan=False))
            for chunk in ds.chunks()]
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def _round_graph(self, entry) -> Optional[RoundGraph]:
        """The CUDA graph of the big-table SVD++ rounds on ``entry``, or None
        where they run eagerly: an entry that is not a staged pack of the
        pack cache (a streamed chunk, a freshly packed pair epoch) and a
        table off the card (``_keyed_graph``).  Planes of a random-order
        pack take the base solver's rule."""
        if not isinstance(entry, PlusEntry):
            return super()._round_graph(entry)
        if not any(entry is e for e in self._plus_cache.values()):
            return None
        extra = (self._plus_hyper(), "chunk_users" in entry.fb)
        return self._keyed_graph(entry, extra, epoch_counts(entry.chunk_id))

    def _kernel_ok(self, stacked: Dict[str, torch.Tensor], fb: Dict[str, torch.Tensor]) -> bool:
        """Whether a round goes through K2: use_pallas is set, no mesh, and
        K2's gate takes the configuration (the JAX solver's
        ``_pallas_plus_ok``, svdpp.py:441-455)."""
        return bool(self.use_pallas and self.mesh is None
                    and gate_failure(self.hp, self.state, stacked, fb, self._plus_hyper()) is None)

    def _train(self, entry: Union[PlusEntry, Dict[str, torch.Tensor]], lrs: List[float]) -> None:
        if not isinstance(entry, PlusEntry):  # a random-order pack: the base solver
            return super()._train(entry, lrs)
        ph = self._plus_hyper()
        if self.mesh is not None:
            # every rank runs the same per-shard steps on its slab and user
            # slots, before the shared-space route (JAX svdpp.py:562-597);
            # the big slabs write through K5 (hp.row_dma)
            fn = (svdpp_mesh_big.sharded_svdpp_rounds_big if self._mesh_big
                  else svdpp_mesh.sharded_svdpp_rounds)
            self.state = fn(self.state, entry.stacked, entry.chunk_id, entry.fb,
                            self._staged_lrs(lrs), self.consts, self.hp, ph, self.mesh,
                            self._mesh_rows)
            return
        if self.model.param.common_feedback_space:
            # pool rows alias user rows: the per-batch refresh epoch
            for lr in self._staged_lrs(lrs):
                self.state = train_epoch_plus_refresh(
                    self.state, entry.stacked, entry.chunk_id, entry.fb, lr, self.consts, self.hp,
                    ph)
            return
        if self.hp.big_table:
            # a host loop of steps per round, writing through K5 with
            # use_pallas (hp.row_dma); with the carry plan, the user-carry
            # body.  On a staged pack on the card a round after the first is
            # one CUDA graph of the whole epoch (solvers/round_graph.py)
            carry = "chunk_users" in entry.fb

            def run(state: TrainState, lr) -> TrainState:
                return train_epoch_plus_big(
                    state, entry.stacked, entry.chunk_id, entry.fb, entry.fb_overlap, lr,
                    self.consts, self.hp, ph, carry_users=carry)

            graph = self._round_graph(entry)
            for lr in self._staged_lrs(lrs):
                self.state = run(self.state, lr) if graph is None else graph.round(self.state, lr, run)
            return
        # K2 where use_pallas is set and its gate passes, else the plain
        # rounds (the JAX solver's Pallas-or-jnp choice)
        use_kernel = self._kernel_ok(entry.stacked, entry.fb)
        fn = train_rounds_svdpp_kernel if use_kernel else train_rounds_svdpp_reference
        self.state = fn(
            self.state, entry.stacked, entry.chunk_id, entry.fb, entry.fb_overlap,
            self._staged_lrs(lrs), self.consts, self.hp, ph,
        )

    # ---- pairwise rank: the pair epochs of a PairSource -------------------------
    # Pair counts per user are deterministic, so the whole packed layout of a
    # pair epoch except the sampled rows is the same every epoch: labels,
    # weights, slot -> user geometry, pools, overlaps, chunk ids and the slot
    # of every pair.  Where each source row is one (user, item) entry pair
    # (the pairwise-rank shape: apex_svd_data.cpp:812-860 merges two
    # single-item rows into a [pos, neg] difference), a round needs only the
    # sampled (pos_row, neg_row) ids; its u/i planes are gathered on the
    # device from per-row tables (svdfeature_tpu/solvers/svdpp.py:742-895).
    def _pair_skeleton_ok(self, ds) -> bool:
        """Whether a PairSource takes the skeleton: not on a mesh (JAX
        svdpp.py:754-768), nor under a shared feedback space, feature
        hierarchies, rank-difference labels or pointwise rows, and only
        where every source row is one (user, item) pair."""
        if (
            self.mesh is not None
            or self.model.param.common_feedback_space
            or self.feat_user is not None
            or self.feat_item is not None
            or getattr(ds, "cfg", None) is None
            or ds.cfg.rank_sample_pointwise
            or ds.cfg.rank_sample_method // 10 != 0  # labels epoch-static
            or "_gen_rows" in ds.__dict__
        ):
            return False
        rows = getattr(ds, "_rows_cat", None)
        if rows is None or rows.num_row == 0:
            return False
        ng, nu, ni = rows.seg_counts()
        return int(ng.max()) == 0 and int(nu.max()) <= 1 and int(ni.max()) == 1 \
            and int(ni.min()) == 1

    def _pair_skeleton(self, ds) -> dict:
        """The skeleton of ``ds``, built on its first use."""
        if self._pair_src is not ds or self._pair_sk is None:
            self._pair_sk = self._build_pair_skeleton(ds)
            self._pair_src = ds
            self._pair_future = None
        return self._pair_sk

    def _build_pair_skeleton(self, ds) -> dict:
        """Pack one throwaway epoch (the rng rewound) for the static layout,
        and build the per-row gather tables."""
        m = self.model
        rng_state = ds.rng.get_state()
        eds = ds.epoch_dataset()
        ds.rng.set_state(rng_state)  # round 1 samples the same stream
        # the SVD++ layout whatever a subclass packs (the JAX skeleton calls
        # pack_plus itself, svdpp.py:788)
        packed = SVDPPFeatureTrainer._pack_numpy(self, eds)
        T, GS = packed.label.shape
        rows = ds._rows_cat
        Rr = rows.num_row
        rp = rows.row_ptr.astype(np.int64)
        ar = np.arange(Rr, dtype=np.int64)
        _, nu, _ = rows.seg_counts()
        dummy = m.num_rows

        ipos = rp[3 * ar + 2]
        i_row_idx = m.off_item + rows.index[ipos].astype(np.int64)
        i_row_val = rows.value[ipos].astype(np.float32)
        if len(i_row_idx) and rows.index[ipos].max() >= m.param.num_item:
            raise ValueError("item feature index exceed bound")
        upos = rp[3 * ar + 1]
        has_u = nu.astype(bool)
        u_ids = rows.index[np.where(has_u, upos, 0)].astype(np.int64)
        u_vals = rows.value[np.where(has_u, upos, 0)].astype(np.float32)
        # the pair row keeps only |v| > 1e-6 user entries
        # (apex_svd_data.cpp:869-875): dead entries point at the dummy row
        # with value 0, so they are neither read nor decayed
        live_u = has_u & (np.abs(u_vals) > 1e-6)
        if u_ids[live_u].size and u_ids[live_u].max() >= m.param.num_user:
            raise ValueError("user feature index exceed bound")
        host_rows = (
            np.where(live_u, m.off_user + u_ids, dummy).astype(np.int32),
            np.where(live_u, u_vals, 0.0).astype(np.float32),
            i_row_idx.astype(np.int32),
            i_row_val,
        )
        dev = self.state.w.device
        # per-row tables with a trailing padding row Rr (padded slots)
        tables = [torch.from_numpy(np.append(a, np.array(pad, a.dtype))).to(dev)
                  for a, pad in zip(host_rows, (dummy, 0.0, dummy, 0.0))]
        static = stacked_from_numpy({name: getattr(packed, name)
                                     for name in ("label", "weight", "g_idx", "g_val")}, dev)
        fb, _ = pool_from_numpy(packed.fb_arrays(), None, dev)
        self._plan_ids.add(id(static["label"]))
        G = packed.num_blocks_local
        sk = dict(static=static, tables=tables, chunk_id=packed.chunk_id, fb=fb,
                  overlap=self._overlap(fb, G), slot=packed.perm, T=T, GS=GS, TGS=T * GS, Rr=Rr,
                  host_rows=host_rows, dummy=dummy, G=G, M=packed.rows_per_user)
        # K2 where use_pallas is set and its gate passes on the pair planes
        # (item width 2), else the plain rounds; big tables take the big epoch
        probe = dict(static, u_idx=torch.empty((T, GS, 1)), i_idx=torch.empty((T, GS, 2)))
        sk["use_kernel"] = not self.hp.big_table and self._kernel_ok(probe, fb)
        return sk

    def _pair_pool_started(self):
        if self._pair_pool is None:
            import concurrent.futures

            self._pair_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pairgen")
        return self._pair_pool

    @staticmethod
    def _pair_flats(ds, sk: dict) -> Tuple[np.ndarray, np.ndarray]:
        """Sample one epoch and place the pair rows at their static slots,
        ``[T, GS]`` int32 each; padded slots point at the padding row Rr
        (weight 0).  numpy only: the producer thread runs it."""
        pr, nr, _ = ds.epoch_pairs()
        fp = np.full(sk["TGS"], sk["Rr"], np.int32)
        fn = np.full(sk["TGS"], sk["Rr"], np.int32)
        fp[sk["slot"]] = pr
        fn[sk["slot"]] = nr
        return fp.reshape(sk["T"], sk["GS"]), fn.reshape(sk["T"], sk["GS"])

    @staticmethod
    def _pair_stacked(sk: dict, fp: torch.Tensor, fn: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A pair epoch's planes from the static per-row tables and the
        sampled (pos_row, neg_row) planes ``[T, GS]``, or ``[R*T, GS]`` for
        per-round planes (svdfeature_tpu/solvers/svdpp.py:63-75)."""
        uri, urv, iri, irv = sk["tables"]
        fp, fn = fp.long(), fn.long()
        return dict(
            sk["static"],
            u_idx=uri[fp][..., None],
            u_val=urv[fp][..., None],
            i_idx=torch.stack([iri[fp], iri[fn]], dim=-1),
            i_val=torch.stack([irv[fp], -irv[fn]], dim=-1),
        )

    def _train_pair_epochs(self, sk: dict, stacked: Dict[str, torch.Tensor],
                           lrs: List[float]) -> None:
        """Train the epochs of ``stacked`` (one per round where its u/i
        planes are per-round): one K2 launch for all of them where the
        skeleton takes the kernel, else the plain rounds; on a big table one
        big epoch a round, with the user-carry body where the skeleton
        holds a carry plan (the multi path's), never with layout planes:
        the sampled items change every round."""
        ph = self._plus_hyper()
        lr_t = self._staged_lrs(lrs)
        if self.hp.big_table:
            carry = "chunk_users" in sk["fb"]
            for r in range(len(lrs)):
                self.state = train_epoch_plus_big(
                    self.state, round_planes(stacked, r), sk["chunk_id"], sk["fb"],
                    sk["overlap"], lr_t[r], self.consts, self.hp, ph, carry_users=carry)
            return
        fn = train_rounds_svdpp_kernel if sk["use_kernel"] else train_rounds_svdpp_reference
        self.state = fn(self.state, stacked, sk["chunk_id"], sk["fb"], sk["overlap"], lr_t,
                        self.consts, self.hp, ph)

    def _train_pair_round(self, ds) -> None:
        """One round on the skeleton, the next round's sample drawn one
        ahead on the producer thread (svdfeature_tpu/solvers/svdpp.py:
        1130-1165)."""
        pool = self._pair_pool_started()
        if self._pair_src is ds and self._pair_future is not None:
            flats = self._pair_future.result()
            sk = self._pair_sk
        else:
            sk = self._pair_skeleton(ds)
            flats = self._pair_flats(ds, sk)
        self._pair_future = pool.submit(self._pair_flats, ds, sk)
        dev = self.state.w.device
        fp, fn = (torch.from_numpy(a).to(dev) for a in flats)
        self._train_pair_epochs(sk, self._pair_stacked(sk, fp, fn), [self.learning_rate])

    def _pair_entry(self, ds) -> PlusEntry:
        """A fresh pair epoch packed and staged, for what the skeleton
        refuses (rank_sample_method=1, rank_sample_pointwise, feature
        hierarchies); the next epoch is sampled and packed one ahead on the
        producer thread, and staged here.  Never through the pack cache:
        every epoch is a new dataset."""
        pool = self._pair_pool_started()
        if self._pair_src is ds and self._pair_future is not None:
            packed = self._pair_future.result()
        else:
            packed = self._pack_numpy(ds.epoch_dataset())
        self._pair_src = ds
        self._pair_future = pool.submit(lambda: self._pack_numpy(ds.epoch_dataset()))
        return self._stage_packed(packed)

    # the multi-round paths: every round's planes of a block in one K2 launch
    PAIR_BLOCK_ROUNDS = 8

    def _pair_device_ok(self, ds) -> bool:
        """The device sampler (rank_device_sample=1): the method-0 law on
        a skeleton that K2 takes."""
        if not (self.rank_device_sample and self.use_pallas and self._pair_skeleton_ok(ds)
                and ds.cfg.rank_sample_method == 0):
            return False
        return self._pair_skeleton(ds)["use_kernel"]

    def _train_pair_rounds_device(self, ds, lrs: List[float]) -> None:
        """The rounds of ``lrs`` in one K2 launch on planes sampled on the
        device (svdfeature_tpu/solvers/svdpp.py:978-1010)."""
        from ..ops.pair_sample import build_pair_sampler_statics, sample_pair_flats, stage_statics

        if not lrs:
            return
        sk = self._pair_sk
        if "sampler" not in sk:
            sk["sampler"] = stage_statics(
                build_pair_sampler_statics(ds, sk["slot"], sk["TGS"]), self.state.w.device)
            sk["key_round"] = 0
        R = len(lrs)
        fp, fn = sample_pair_flats(self.rank_device_seed, sk["key_round"], sk["sampler"], R)
        sk["key_round"] += R
        T, GS = sk["T"], sk["GS"]
        self._train_pair_epochs(
            sk, self._pair_stacked(sk, fp.reshape(R * T, GS), fn.reshape(R * T, GS)), lrs)

    def _pair_host_multi_ok(self, ds) -> bool:
        """The multi-round host sampler: the method-0 law on a skeleton that
        K2 takes, or on a big table (the JAX package's gate without its TPU
        condition).  The per-round path keeps the exact sequential numpy
        stream for round-at-a-time callers (the CLI, per-round saves)."""
        if not (self.use_pallas and self._pair_skeleton_ok(ds)
                and ds.cfg.rank_sample_method == 0):
            return False
        return self._pair_skeleton(ds)["use_kernel"] or self.hp.big_table

    def _pair_chunk_users(self, jp_slot: np.ndarray, pstart_elem: np.ndarray,
                          uid_cand: np.ndarray, sk: dict) -> Optional[np.ndarray]:
        """The ``[C, G]`` carry plan of the big-table multi path, from the
        epoch-invariant candidate geometry (every candidate row's user id
        per block, placed through jp_slot), so it holds for every epoch's
        sample; None where the layout breaks the carry precondition or it
        does not apply (svdfeature_tpu/solvers/svdpp.py:904-944)."""
        if not (self.hp.big_table and self.hp.reg_method < 4):
            return None
        dummy = sk["dummy"]
        # pstart_elem is per candidate: the start of its block, so block
        # boundaries are where consecutive starts change
        starts = np.asarray(pstart_elem, np.int64)
        P = len(starts)
        if P == 0:
            return None
        u = np.where(uid_cand == dummy, -1, uid_cand).astype(np.int64)
        newblk = np.concatenate([[True], starts[1:] != starts[:-1]])
        bnd = np.flatnonzero(newblk)
        segmax = np.maximum.reduceat(u, bnd)
        segmin = np.minimum.reduceat(np.where(u < 0, np.iinfo(np.int64).max, u), bnd)
        live = segmax >= 0
        if (segmin[live] != segmax[live]).any():
            return None  # two user ids among one block's candidates
        cand_uid = np.where(live, segmax, dummy)[np.cumsum(newblk) - 1]  # [P]
        # slot s -> candidate jp_slot[s] (a block-local permutation keeps the
        # sample inside the block); pad slots (== P) -> dummy
        j = np.asarray(jp_slot, np.int64)
        uid_slot = np.where(j >= P, dummy, cand_uid[np.minimum(j, P - 1)])
        return _chunk_users_from_slots(uid_slot.reshape(sk["T"], sk["G"], sk["M"]),
                                       sk["chunk_id"], dummy)

    def _pair_geometry(self, ds, sk: dict) -> dict:
        """The multi path's device tables, built once: the candidate rows
        packed with their values' bits, ``pos_tbl [P+1, 4]`` (u_idx, u_val,
        i_idx, i_val) and ``neg_tbl [N+1, 2]`` (i_idx, i_val), their last
        row padding, each candidate's block start, and the grid position ->
        candidate position maps ``jp_slot`` / ``jn_slot [TGS]``."""
        geo = ds.pair_geometry()
        S = len(geo["jp"])
        slot_inv = np.full(sk["TGS"], S, np.int64)
        slot_inv[sk["slot"]] = np.arange(S)
        uri, urv, iri, irv = sk["host_rows"]
        bits = lambda f: f.view(np.int32)  # noqa: E731
        dummy = sk["dummy"]
        pr, nr = geo["pos_rows"], geo["neg_rows"]
        pos_tbl = np.concatenate([np.stack([uri[pr], bits(urv[pr]), iri[pr], bits(irv[pr])], 1),
                                  np.array([[dummy, 0, dummy, 0]], np.int32)]).astype(np.int32)
        neg_tbl = np.concatenate([np.stack([iri[nr], bits(irv[nr])], 1),
                                  np.array([[dummy, 0]], np.int32)]).astype(np.int32)

        def jslot(jmap, P):
            j = np.take(jmap, np.minimum(slot_inv, S - 1))
            return np.where(slot_inv == S, P, j)

        jp_slot = jslot(geo["jp"], len(pr))
        plan = self._pair_chunk_users(jp_slot, geo["pstart_elem"], uri[pr], sk)
        if plan is not None:
            # the user-carry body on the assembled planes of every epoch
            sk["fb"] = dict(sk["fb"], chunk_users=torch.from_numpy(plan).to(self.state.w.device))
        dev = self.state.w.device
        as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        return dict(pos_tbl=as_dev(pos_tbl), neg_tbl=as_dev(neg_tbl),
                    pstart=as_dev(geo["pstart_elem"].astype(np.int64)),
                    nstart=as_dev(geo["nstart_elem"].astype(np.int64)),
                    jp_slot=as_dev(jp_slot), jn_slot=as_dev(jslot(geo["jn"], len(nr))))

    def _pair_multi_stacked(self, sk: dict, opl: np.ndarray,
                            onl: np.ndarray) -> Dict[str, torch.Tensor]:
        """K rounds' planes ``[K*T, GS]`` from the block-local permutation
        offsets ``[K, P]`` / ``[K, N]`` that sample_offsets drew: one gather
        of packed candidate rows per set, placed through the slot maps
        (svdfeature_tpu/solvers/svdpp.py:122-159), as torch gathers on the
        training device."""
        geo = sk["geo"]
        dev = self.state.w.device
        K = opl.shape[0]

        def offsets(a):
            # uint8 / uint16 / int32 on the host; uint16 crosses as int16
            if a.dtype == np.uint16:
                return torch.from_numpy(a.view(np.int16)).to(dev).long() & 0xFFFF
            return torch.from_numpy(a).to(dev).long()

        def plane(offs, tbl, base, jslot):
            P = tbl.shape[0] - 1
            perm = tbl[:P][base[None, :] + offsets(offs)]  # [K, P, W]
            pad = tbl[P].expand(K, 1, tbl.shape[1])
            return torch.cat([perm, pad], dim=1)[:, jslot]  # [K, TGS, W]

        T, GS = sk["T"], sk["GS"]
        gp = plane(opl, geo["pos_tbl"], geo["pstart"], geo["jp_slot"]).reshape(K * T, GS, 4)
        gn = plane(onl, geo["neg_tbl"], geo["nstart"], geo["jn_slot"]).reshape(K * T, GS, 2)
        f32 = lambda a: a.contiguous().view(torch.float32)  # noqa: E731
        return dict(
            sk["static"],
            u_idx=gp[..., 0:1].contiguous(),
            u_val=f32(gp[..., 1:2]),
            i_idx=torch.stack([gp[..., 2], gn[..., 0]], dim=-1),
            i_val=torch.stack([f32(gp[..., 3]), -f32(gn[..., 1])], dim=-1),
        )

    def _train_pair_rounds_host(self, ds, lrs: List[float]) -> None:
        """The rounds of ``lrs`` in blocks of PAIR_BLOCK_ROUNDS, one K2
        launch (or, on a big table, one big epoch a round) a block; block
        j+1's sampling (data/rank.sample_offsets, numpy) runs on the
        producer thread while block j trains
        (svdfeature_tpu/solvers/svdpp.py:1040-1128)."""
        sk = self._pair_sk
        if "geo" not in sk:
            sk["geo"] = self._pair_geometry(ds, sk)
            sk["multi_rng"] = np.random.default_rng(self.rank_device_seed)
        K = self.PAIR_BLOCK_ROUNDS
        blocks = [lrs[i: i + K] for i in range(0, len(lrs), K)]
        if not blocks:
            return
        pool = self._pair_pool_started()
        fut = pool.submit(ds.sample_offsets, len(blocks[0]), sk["multi_rng"])
        for j, blk in enumerate(blocks):
            opl, onl = fut.result()
            if j + 1 < len(blocks):
                fut = pool.submit(ds.sample_offsets, len(blocks[j + 1]), sk["multi_rng"])
            self._train_pair_epochs(sk, self._pair_multi_stacked(sk, opl, onl), blk)

    # ---- training / prediction ------------------------------------------------------
    def update_all(self, ds) -> None:
        """One pass over the dataset (one round); a PairSource trains a
        freshly sampled pair epoch; a streaming source a chunk at a time; a
        random-order dataset takes the base solver's pass."""
        if hasattr(ds, "plan_caps"):  # StreamingPlusBuffer
            self._stream_round_plus(ds)
            return
        if hasattr(ds, "epoch_dataset"):  # PairSource
            self._apply_pair_layout()
            if self._pair_device_ok(ds):
                self._train_pair_rounds_device(ds, [self.learning_rate])
            elif self._pair_skeleton_ok(ds):
                self._train_pair_round(ds)
            else:
                self._train(self._pair_entry(ds), [self.learning_rate])
            return
        if not isinstance(ds, PlusDataset):
            return super().update_all(ds)
        self._train(self._pack_plus(ds), [self.learning_rate])

    def update_rounds(self, ds, num_rounds: int) -> None:
        """num_rounds passes in one wrapper call, with the per-round lr
        decay schedule (set_round semantics) built on the host; a
        PairSource takes the device sampler, the multi-round host sampler
        or a round at a time, in that order of preference; a random-order
        dataset or a streaming source takes the base solver's passes (a
        streamed round at a time)."""
        if not isinstance(ds, PlusDataset) and not hasattr(ds, "epoch_dataset"):
            return super().update_rounds(ds, num_rounds)
        lrs = []
        for _ in range(num_rounds):
            lrs.append(self.learning_rate)
            if self.tparam.decay_learning_rate:
                self.learning_rate *= self.tparam.decay_rate
                self.round_counter += 1
        if isinstance(ds, PlusDataset):
            self._train(self._pack_plus(ds), lrs)
            return
        self._apply_pair_layout()
        if self._pair_device_ok(ds):
            self._train_pair_rounds_device(ds, lrs)
            return
        if self._pair_host_multi_ok(ds):
            self._train_pair_rounds_host(ds, lrs)
            return
        saved = self.learning_rate
        for lr in lrs:
            self.learning_rate = lr
            if self._pair_skeleton_ok(ds):
                self._train_pair_round(ds)
            else:
                self._train(self._pair_entry(ds), [lr])
        self.learning_rate = saved

    def predict_all(self, ds) -> np.ndarray:
        if hasattr(ds, "plan_caps"):  # StreamingPlusBuffer
            return self._predict_stream(ds)
        if hasattr(ds, "epoch_dataset"):  # PairSource: one fresh pair epoch
            self._apply_pair_layout()
            if self._pair_src is ds and self._pair_future is not None:
                self._pair_future.result()  # its draw first: one thread on the rng at a time
            entry = self._entry(self._pack_numpy(ds.epoch_dataset()), self.state.w.device,
                                plan=False)
        elif isinstance(ds, PlusDataset):
            entry = self._pack_plus(ds)
        else:  # random order: the base solver's forward
            return super().predict_all(ds)
        return self._predict_entry(self._scoring_state(), entry)
