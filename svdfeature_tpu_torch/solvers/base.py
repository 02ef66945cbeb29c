"""Base SGD solver: the random-order-format trainer on PyTorch.

Counterpart of svdfeature_tpu/solvers/base.py (class SVDFeature,
apex_svd_base.h:79-479).  The trainer owns the model, appends the dummy
padding rows, packs a dataset into fixed-shape stacked batches once,
stages them on its device, and trains every round through
``ops.cuda_embed.train_rounds_kernel`` (the Hopper kernel K1 on a CUDA
device, its plain version on the CPU) where K1's gate takes the
configuration, else through the general plain rounds
``ops.embed.train_rounds`` (reg modes 1-5, the clamps, the hinge losses,
multi-entry segments, wide global segments).

Tables of more than ``BIG_TABLE_ROWS`` rows (dummy included) take the
big-table route of the JAX solver (solvers/base.py:293-331): the state
moves to the augmented row layout (ops/big_embed.augment_state) and each
round runs a host loop of steps, ``train_step_sweep`` (kernel K4) for
batches dense enough that most table tiles are touched, else
``train_step_big`` (sorted dedup, kernel K5).  Config key ``big_sweep``
overrides the auto rule: -1 auto, 0 off, 1 on; the route does not look
at ``num_factor``, since K4 takes every k the augmented layout holds (a
row of more than 256 factors in passes).  Checkpoints and prediction
read the de-augmented state.

A streaming source (``streaming=1``, data/streaming.StreamingCSRBuffer)
trains a round a chunk at a time, as the JAX solver does
(solvers/base.py:411-505): a producer thread reads and packs the next chunk
to the stream's stable shapes (``pack_chunk``) and stages it on the device
(``stage_chunk``, solvers/streamed.py) while the caller's thread trains the
last (``train_chunk``: the round's route on the chunk, K1, K4 or K5); its
evaluation packs and scores one chunk at a time.

With ``mesh_data`` x ``mesh_model`` > 1 the trainer runs on a mesh of as
many processes, launched by torchrun (solvers/base.py:223-291 and
parallel/*): each rank holds the row slab of its ``model`` position and
trains on the batch columns of its ``data`` position
(parallel/mesh.py), a slab of more than ``BIG_TABLE_ROWS`` rows on the
card in the augmented layout with the sorted-dedup step through K5
(parallel/mesh_big.py; config key ``mesh_big``: -1 auto, 0 off, 1 on).
The ranks of data row 0 unshard the table for a checkpoint and rank 0
writes it; every rank ends a prediction with all of them.  The derived
solvers train their own mesh steps (parallel/svdpp_mesh*, imfb_mesh*,
bilinear_mesh*).  The lite example solver (solvers/example.py) keeps
the whole table on every rank, and GBRT reads no mesh key, as in the JAX
package.

The device is explicit: config key ``device`` (default ``cuda``).  With
``device=cuda`` and no card the trainer raises instead of running on the
CPU.  ``use_pallas=0`` selects the plain PyTorch rounds on the device,
as it selects the jnp path in the JAX package.
"""

from __future__ import annotations

import dataclasses
import warnings
import weakref
from typing import BinaryIO, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from .. import tracing
from ..convert import consts_from_numpy, stacked_from_numpy
from ..data.batching import pack_csr
from ..data.csr import CSRDataset
from ..model import SVDModel
from ..ops import big_embed, tile_sweep
from ..ops._plans import release_plans
from ..ops.cuda_embed import kernel_supported, train_rounds_kernel
from ..ops.embed import (BIG_TABLE_ROWS, HyperParams, TrainConsts, TrainState, predict_batches,
                         train_rounds)
from ..parallel import comm
from ..parallel import mesh as pmesh
from ..parallel import mesh_big as pbig
from ..params import ParameterSet, SVDModelParam, SVDTrainParam, SVDTypeParam
from ..utils.sparse_feature_array import SparseFeatureArray
from .streamed import ChunkStream, Staged

DEFAULT_BATCH_SIZE = 1024


def resolve_device(name: str) -> torch.device:
    """The training device named by config key ``device``; a CUDA device
    without a card is an error, never a silent CPU run."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name} but no CUDA device is available (pass device=cpu to train on the CPU)"
        )
    return dev


class SVDFeatureTrainer:
    """Random-order-format trainer (ISVDTrainer contract, apex_svd.h:33-107)."""

    # large tables take the augmented-row big-table route; a derived solver
    # whose epoch drives the state itself opts out until its route is ported
    SUPPORTS_BIG_TABLE = True

    def __init__(self, mtype: SVDTypeParam):
        self.mtype = mtype
        self.mparam = SVDModelParam()
        self.tparam = SVDTrainParam()
        self.u_param = ParameterSet("up:", "uip:")
        self.i_param = ParameterSet("ip:", "uip:")
        self.g_param = ParameterSet("gp:", "gp:")
        self.name_feat_user: Optional[str] = None
        self.name_feat_item: Optional[str] = None
        self.feat_user: Optional[SparseFeatureArray] = None
        self.feat_item: Optional[SparseFeatureArray] = None
        self.batch_size = DEFAULT_BATCH_SIZE
        # the hand-written kernel (ops/cuda_embed.py); use_pallas=0 runs
        # its plain PyTorch version on the same device
        self.use_pallas = True
        self.seed = 10
        # exact_rng=1: init draws from the bit-exact apex_random port
        self.exact_rng = False
        self.device_name = "cuda"
        # big_sweep: tile-sweep write path of the big-table step
        # (ops/tile_sweep.py).  -1 = auto (on for batches dense enough that
        # most tiles are touched anyway), 0 = off, 1 = force on
        self.big_sweep = -1
        # the device mesh (parallel/comm.py): mesh_data x mesh_model ranks;
        # 1x1 is the single-device trainer
        self.mesh_data = 1
        self.mesh_model = 1
        # mesh_big: the augmented big-slab mesh step (parallel/mesh_big.py).
        # -1 = auto (on when a shard's slab exceeds BIG_TABLE_ROWS rows on
        # the card), 0 = off, 1 = force on
        self.mesh_big = -1
        self.mesh: Optional[comm.Mesh] = None  # this rank's mesh, once sharded
        self._mesh_big = False
        self._mesh_rows = 0  # padded table rows (small slabs) or n_real (big)
        self._tbl_rows = 0  # table rows, dummy included, before sharding
        self.round_counter = 0
        self.learning_rate: float = 0.01
        self.model: Optional[SVDModel] = None
        self.state: Optional[TrainState] = None
        self.consts: Optional[TrainConsts] = None
        self.hp: Optional[HyperParams] = None
        self._space_allocated = False
        self._pack_cache: Dict[int, Tuple[Dict[str, torch.Tensor], int]] = {}
        # the last round schedule on the device: a constant learning rate
        # is staged once, not before every round's launch
        self._lrs_staged = (None, None)
        # ids of the staged planes that the kernel wrappers' kept plans may
        # hold: those plans go with the trainer
        self._plan_ids: Set[int] = set()
        weakref.finalize(self, release_plans, self._plan_ids)
        # the staging of streamed chunks (solvers/streamed.py), with the
        # last streamed round's measurements in .stats
        self.chunk_stream = ChunkStream()

    # ---- configuration -----------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        if name == "feature_user":
            self.name_feat_user = val
        if name == "feature_item":
            self.name_feat_item = val
        if name == "batch_size":
            self.batch_size = int(val)
        if name == "use_pallas":
            self.use_pallas = bool(int(val))
        if name == "mesh_data":
            self.mesh_data = int(val)
        if name == "mesh_model":
            self.mesh_model = int(val)
        if name == "mesh_big":
            self.mesh_big = int(val)
        if name == "seed":
            self.seed = int(val)
        if name == "exact_rng":
            self.exact_rng = bool(int(val))
        if name == "device":
            self.device_name = val
        if name == "big_sweep":
            self.big_sweep = int(val)
        self.tparam.set_param(name, val)
        self.u_param.set_param(name, val)
        self.i_param.set_param(name, val)
        self.g_param.set_param(name, val)
        if not self._space_allocated:
            self.mparam.set_param(name, val)

    @property
    def device(self) -> torch.device:
        return resolve_device(self.device_name)

    # ---- model lifecycle ----------------------------------------------------
    def init_model(self) -> None:
        self._join_mesh()
        self.model = SVDModel.rand_init(
            self.mparam, self.mtype, device=self.device, seed=self.seed,
            exact_rng=self.exact_rng,
        )
        self.mparam = self.model.param  # base_score transformed
        self._space_allocated = True

    def load_model(self, f: BinaryIO) -> None:
        self._join_mesh()
        self.model = SVDModel.load(f, self.mtype, device=self.device)
        self.mparam = self.model.param
        self._space_allocated = True

    def save_model(self, f: Optional[BinaryIO]) -> None:
        """Write the model to ``f``.  On a mesh every rank calls it: the
        ranks of data row 0 unshard the table (an all-gather over
        ``model``), and only the one given a file (rank 0) writes."""
        if self.mesh is not None and self.mesh.d:
            return
        self._sync_model_from_state()
        if f is not None:
            self.model.save(f)

    def _std_state(self) -> TrainState:
        """The state in the standard (w, b, ref) layout whatever the
        big-table packing (views of the augmented table); on a mesh the
        whole table, gathered over ``model`` (a collective)."""
        if self.mesh is not None:
            if self._mesh_big:
                return pbig.unshard_big(self.state, self.mesh, self.hp.num_factor, self._tbl_rows)
            return pmesh.unshard_state(self.state, self.mesh, self._tbl_rows)
        if self.hp is not None and self.hp.big_table:
            return big_embed.deaugment_state(
                self.state, self.hp.num_factor, n_rows=self.model.num_rows + 1
            )
        return self.state

    def _sync_model_from_state(self) -> None:
        if self.state is not None:
            st = self._std_state()
            n = self.model.num_rows  # excludes the dummy row
            # contiguous copies: training goes on updating the state in place
            copy = dict(memory_format=torch.contiguous_format)
            self.model.w = st.w[:n].clone(**copy)
            self.model.b = st.b[:n].clone(**copy)
            self.model.g = st.g[:-1].clone(**copy)

    # ---- trainer lifecycle ---------------------------------------------------
    def _join_mesh(self) -> None:
        """On a mesh of more than one position, before the first tensor:
        check the world's size and join it, so that each rank's card is the
        current device when the model is made (a no-op once joined, as
        after ``distributed=1``)."""
        if self.mesh_data * self.mesh_model == 1:
            return
        comm.check_world(self.mesh_data * self.mesh_model)
        comm.init_distributed(self.device_name)

    def init_trainer(self) -> None:
        self._join_mesh()
        if self.name_feat_user and self.name_feat_user != "NULL":
            self.feat_user = SparseFeatureArray.load(self.name_feat_user)
        if self.name_feat_item and self.name_feat_item != "NULL":
            self.feat_item = SparseFeatureArray.load(self.name_feat_item)
        m = self.model
        dev = m.w.device
        n = m.num_rows
        k = m.num_factor
        # dummy row appended for padding targets
        self.state = TrainState(
            w=torch.cat([m.w, torch.zeros((1, k), dtype=torch.float32, device=dev)]),
            b=torch.cat([m.b, torch.zeros((1,), dtype=torch.float32, device=dev)]),
            g=torch.cat([m.g, torch.zeros((1,), dtype=torch.float32, device=dev)]),
            step=torch.zeros((), dtype=torch.int32, device=dev),
            ref_ui=torch.zeros((n + 1,), dtype=torch.int32, device=dev),
            ref_g=torch.zeros((m.param.num_global + 1,), dtype=torch.int32, device=dev),
        )
        self.consts = self._build_consts()
        self.hp = self._build_hp()
        self.learning_rate = self.tparam.learning_rate
        self.round_counter = 0
        if self.mesh_data * self.mesh_model > 1:
            self._init_mesh()
        elif self.hp.big_table:
            # the sweep needs whole tiles; the decay-rate row tables are
            # padded to match (pad rows decay by 0 and are never addressed)
            tile = self.hp.sweep_tile if self.hp.sweep_table else 0
            self.state = big_embed.augment_state(self.state, k, pad_rows_to=tile)
            pad = (0, self.state.w.shape[0] - self.consts.wd_u_row.shape[0])
            self.consts.wd_u_row = torch.nn.functional.pad(self.consts.wd_u_row, pad)
            self.consts.wd_i_row = torch.nn.functional.pad(self.consts.wd_i_row, pad)

    def _init_mesh(self) -> None:
        """Shard the trainer over the (mesh_data x mesh_model) mesh of this
        process's torchrun world (solvers/base.py:223-291), joined by
        ``_join_mesh``: the batch grows to a multiple of mesh_data, and
        this rank keeps its row slab, in the augmented big-slab layout
        where mesh_big says so (with K5 writes where use_pallas is set)."""
        dev = self.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.mesh = comm.make_mesh(self.mesh_data, self.mesh_model, dev)
        # the batch's columns split over the data ranks
        if self.batch_size % self.mesh_data:
            self.batch_size += self.mesh_data - self.batch_size % self.mesh_data
        self._tbl_rows = int(self.state.w.shape[0])
        slab = -(-self._tbl_rows // self.mesh_model)
        self._mesh_big = self.mesh_big == 1 or (
            self.mesh_big == -1 and slab > BIG_TABLE_ROWS and dev.type == "cuda")
        if self._mesh_big:
            k = self.model.num_factor
            self.hp = dataclasses.replace(self.hp, num_factor=k, row_dma=self.use_pallas,
                                          big_table=False, sweep_table=False)
            self.state, self._mesh_rows = pbig.shard_state_big(self.state, self.mesh, k)
            self.consts = pbig.shard_consts_big(self.consts, self.mesh, self._mesh_rows)
        else:
            self.state, self._mesh_rows = pmesh.shard_state(self.state, self.mesh)
            self.consts = pmesh.shard_consts(self.consts, self.mesh, self._mesh_rows)

    def _build_hp(self) -> HyperParams:
        p = self.model.param
        n_tbl = self.model.num_rows + 1
        # the single-device big route only off a mesh: a mesh shards the
        # table into slabs instead (solvers/base.py:297-303)
        big = (self.SUPPORTS_BIG_TABLE and n_tbl > BIG_TABLE_ROWS
               and self.mesh_data * self.mesh_model == 1)
        # tile-sweep auto rule: worthwhile once the batch's entries would
        # touch most tiles anyway (>= ~ECAP/2 entries per tile on average
        # at the minimum 2 entries/example); sparse batches keep the
        # sorted-dedup step, which touches only its rows
        n_tiles = -(-n_tbl // tile_sweep.SWEEP_TILE)
        sweep_auto = 2 * self.batch_size >= n_tiles * tile_sweep.SWEEP_ECAP // 2
        sweep = big and (self.big_sweep == 1 or (self.big_sweep == -1 and sweep_auto))
        return HyperParams(
            big_table=big,
            num_factor=p.num_factor if big else 0,
            sweep_table=sweep,
            row_dma=big and self.use_pallas,
            active_type=self.mtype.active_type,
            no_user_bias=p.no_user_bias,
            reg_method=self.tparam.reg_method,
            reg_global=self.tparam.reg_global,
            user_nonnegative=p.user_nonnegative,
            item_nonnegative=p.item_nonnegative,
            base_score=float(p.base_score),
            # batch_size=1 selects the reference's plain global update
            # (apex_svd_base.h:384-387); larger batches use the damped one
            exact_global=(self.batch_size == 1),
        )

    def _build_consts(self) -> TrainConsts:
        """Densify per-row weight-decay tables (ParameterSet ranges override
        the scalar wd over id ranges; apex_svd_base.h:33-75,188-283)."""
        m = self.model
        p = m.param
        n = m.num_rows
        wd_u = np.zeros(n + 1, np.float32)
        wd_i = np.zeros(n + 1, np.float32)
        # ids reaching reg_user are user-local ids; table rows off_user+id
        wd_u[m.off_user : m.off_user + p.num_user] = self.u_param.wd_table(
            p.num_user, self.tparam.wd_user
        )
        wd_i[m.off_item : m.off_item + p.num_item] = self.i_param.wd_table(
            p.num_item, self.tparam.wd_item
        )
        wd_g = np.zeros(p.num_global + 1, np.float32)
        if p.num_global:
            wd_g[: p.num_global] = self.g_param.wd_table(
                p.num_global, self.tparam.wd_global
            )
            wd_g[: self.tparam.num_regfree_global] = 0.0
        return consts_from_numpy(
            wd_u, wd_i, wd_g, self.tparam.wd_user_bias, self.tparam.wd_item_bias,
            device=self.model.w.device,
        )

    def set_round(self, nround: int) -> None:
        """Learning-rate decay schedule (apex_svd_base.h:470-478); the
        tracer's spans from here on belong to round ``nround``."""
        if tracing.on:
            tracing.set_round(nround)
        if self.tparam.decay_learning_rate:
            if self.round_counter > nround:
                raise ValueError("round counter restriction")
            while self.round_counter < nround:
                self.learning_rate *= self.tparam.decay_rate
                self.round_counter += 1

    def finish_round(self) -> None:
        pass

    def synchronize(self) -> None:
        """Wait for the training device: a host clock read after this
        call covers the work enqueued before it."""
        if self.state is not None and self.state.w.is_cuda:
            if tracing.on:
                tracing.begin("sync.wait")
            torch.cuda.synchronize(self.state.w.device)
            if tracing.on:
                tracing.end()

    # ---- data packing ---------------------------------------------------------
    def _pack(self, ds: CSRDataset) -> Tuple[Dict[str, torch.Tensor], int]:
        key = id(ds)
        if key not in self._pack_cache:
            if tracing.on:
                tracing.begin("pack")
            m = self.model
            packed = pack_csr(
                ds,
                self.batch_size,
                m.num_rows,
                m.param.num_global,
                m.off_user,
                m.off_item,
                feat_user=self.feat_user,
                feat_item=self.feat_item,
                num_user=m.param.num_user,
                num_item=m.param.num_item,
            )
            arrays = packed.arrays()
            if self.hp is not None and self.hp.sweep_table:
                hp = self.hp
                arrays = tile_sweep.attach_sweep_plans(
                    arrays, int(self.state.w.shape[0]), hp.sweep_tile, hp.sweep_ecap
                )
                arrays = tile_sweep.attach_sweep_runs(
                    arrays, hp.sweep_tile, hp.sweep_ecap, num_factor=hp.num_factor
                )
            if self.mesh is not None:
                arrays = pmesh.put_process_sharded(arrays, self.mesh)
            arrays = stacked_from_numpy(arrays, self.state.w.device)
            self._plan_ids.add(id(arrays["label"]))
            self._pack_cache[key] = (arrays, ds.num_row)
            if tracing.on:
                tracing.end()
        return self._pack_cache[key]

    # ---- streaming (out-of-core) ------------------------------------------------
    def _stream_seg_caps(self, raw_caps) -> Tuple[int, int, int]:
        """Stable per-row segment caps for streamed chunks: the stream's
        pre-scan measures raw widths, and a feature hierarchy expands each
        id by its parent list at pack time, so a cap grows by the worst
        expansion factor (1 + most parents of an id)."""
        caps = list(raw_caps)
        for seg, feat in ((1, self.feat_user), (2, self.feat_item)):
            if feat is not None and feat.num_row:
                mp = int(np.diff(feat.row_ptr).max(initial=0))
                caps[seg] = int(raw_caps[seg]) * (1 + mp)
        return tuple(caps)

    def pack_chunk(self, chunk: CSRDataset, min_batches: int, max_nnz):
        """One streamed chunk packed to the stream's stable shapes, its
        planes as CPU tensors (numpy work: the producer thread runs it);
        on a sweep table with its sweep plans and runs, as ``_pack``."""
        m = self.model
        packed = pack_csr(
            chunk,
            self.batch_size,
            m.num_rows,
            m.param.num_global,
            m.off_user,
            m.off_item,
            feat_user=self.feat_user,
            feat_item=self.feat_item,
            num_user=m.param.num_user,
            num_item=m.param.num_item,
            seg_caps=self._stream_seg_caps(max_nnz),
            min_batches=min_batches,
        )
        arrays = packed.arrays()
        if self.hp.sweep_table:
            hp = self.hp
            arrays = tile_sweep.attach_sweep_plans(
                arrays, int(self.state.w.shape[0]), hp.sweep_tile, hp.sweep_ecap
            )
            arrays = tile_sweep.attach_sweep_runs(
                arrays, hp.sweep_tile, hp.sweep_ecap, num_factor=hp.num_factor
            )
        return stacked_from_numpy(arrays, torch.device("cpu")), chunk.num_row

    def stage_chunk(self, entry) -> Staged:
        """A packed chunk on the training device (producer thread; pinned
        memory, side stream: solvers/streamed.py); on a mesh this rank's
        data columns of it."""
        if self.mesh is not None:
            entry = pmesh.put_process_sharded(entry, self.mesh)
        return self.chunk_stream.stage(entry, self.state.w.device)

    def train_chunk(self, staged: Staged) -> None:
        """One pass of the round's route over a staged chunk (caller's
        thread): the training stream waits for the chunk's copy, and the
        chunk's kernel plans go when its launches are enqueued."""
        with self.chunk_stream.training(staged) as entry:
            self._train(entry, [self.learning_rate])

    def _stream_round(self, run, ds) -> None:
        """One streamed round: ``run`` is one of data/streaming.py's
        round functions."""
        self.chunk_stream.begin_round(self.state.w.device)
        run(self, ds)

    def _round_stream_chunk(self, ds) -> None:
        """Round examples_per_chunk down to a batch_size multiple (up for
        tiny values): the streamed trajectory equals the staged run only
        when every chunk splits into whole batches."""
        epc = ds.examples_per_chunk
        if epc % self.batch_size:
            new = max(self.batch_size, epc - epc % self.batch_size)
            warnings.warn(
                f"streaming: examples_per_chunk={epc} is not a multiple of "
                f"batch_size={self.batch_size}; rounding to {new} to keep "
                "the staged-run trajectory guarantee"
            )
            ds.examples_per_chunk = new

    # ---- training / prediction --------------------------------------------------
    def _staged_lrs(self, lrs: List[float]) -> torch.Tensor:
        """The round schedule ``lrs`` as an f32 tensor on the training
        device, staged once per schedule."""
        key = (tuple(lrs), self.state.w.device)
        if self._lrs_staged[0] != key:
            self._lrs_staged = (key, torch.tensor(lrs, dtype=torch.float32, device=key[1]))
        return self._lrs_staged[1]

    def _train(self, stacked: Dict[str, torch.Tensor], lrs: List[float]) -> None:
        lr_t = self._staged_lrs(lrs)
        if self.mesh is not None:
            # every rank runs the same per-shard steps on its slab and
            # columns; the big slabs write through K5 (hp.row_dma)
            fn = pbig.sharded_train_rounds_big if self._mesh_big else pmesh.sharded_train_rounds
            self.state = fn(self.state, stacked, lr_t, self.consts, self.hp, self.mesh,
                            self._mesh_rows)
            return
        if self.hp.big_table:
            # a host loop of R x T steps (the JAX solver scans the same
            # step, solvers/base.py:245-251); hp.row_dma (use_pallas) sends
            # their writes through the kernels K4 / K5
            step = tile_sweep.train_step_sweep if self.hp.sweep_table else big_embed.train_step_big
            T = stacked["label"].shape[0]
            if tracing.on:
                tracing.begin("batches")
            batches = [{name: x[t] for name, x in stacked.items()} for t in range(T)]
            if tracing.on:
                tracing.end()
            for lr in lr_t:
                for batch in batches:
                    if tracing.on:
                        tracing.count("steps")
                        tracing.begin("step")
                    self.state = step(self.state, batch, lr, self.consts, self.hp)
                    if tracing.on:
                        tracing.end()
            return
        # the route is chosen from the configuration, as the JAX solver
        # chooses its Pallas kernel or its jnp path (solvers/base.py:546-555):
        # K1 where use_pallas is set and its gate passes, else the general
        # plain rounds, on the trainer's device
        use_kernel = self.use_pallas and kernel_supported(self.hp, self.state, stacked)
        fn = train_rounds_kernel if use_kernel else train_rounds
        self.state = fn(self.state, stacked, lr_t, self.consts, self.hp)

    def update_all(self, ds: CSRDataset) -> None:
        """One pass over the dataset (one round); a streaming source a chunk
        at a time."""
        if hasattr(ds, "chunks"):
            from ..data.streaming import stream_train_round

            self._round_stream_chunk(ds)
            self._stream_round(stream_train_round, ds)
            return
        stacked, _ = self._pack(ds)
        self._train(stacked, [self.learning_rate])

    def _stream_rounds(self, ds, num_rounds: int) -> None:
        """update_rounds on a streaming source: a streamed round at a time,
        the lr decay schedule applied between them on the host."""
        for _ in range(num_rounds):
            self.update_all(ds)
            if self.tparam.decay_learning_rate:
                self.learning_rate *= self.tparam.decay_rate
                self.round_counter += 1

    def update_rounds(self, ds: CSRDataset, num_rounds: int) -> None:
        """Run num_rounds full passes, applying the per-round lr decay
        schedule (set_round semantics) on the host."""
        if hasattr(ds, "chunks"):
            return self._stream_rounds(ds, num_rounds)
        stacked, _ = self._pack(ds)
        lrs = []
        for _ in range(num_rounds):
            lrs.append(self.learning_rate)
            if self.tparam.decay_learning_rate:
                self.learning_rate *= self.tparam.decay_rate
                self.round_counter += 1
        self._train(stacked, lrs)

    def _predict_stacked(self, stacked: Dict[str, torch.Tensor], nrow: int) -> np.ndarray:
        """The first ``nrow`` predictions of staged ``[T, B]`` planes; on a
        mesh each rank scores its columns on its slab and the predictions
        are gathered over ``data`` in single-device order, on every rank."""
        if self.mesh is not None:
            fn = pbig.sharded_predict_big if self._mesh_big else pmesh.sharded_predict
            preds = pmesh.gather_predictions(
                fn(self.state, stacked, self.hp, self.mesh, self._mesh_rows), self.mesh)
        else:
            preds = predict_batches(self._std_state(), stacked, self.hp)
        return preds.reshape(-1)[:nrow].cpu().numpy()

    def predict_all(self, ds: CSRDataset) -> np.ndarray:
        if self.state is None:
            self.init_trainer()
        if hasattr(ds, "chunks"):
            # a streaming source: bounded memory, one chunk at a time (the
            # reference's task_eval reads its iterator so,
            # svd_feature_infer.cpp:243-277)
            Tc = -(-min(ds.examples_per_chunk, ds.num_row) // self.batch_size)
            dev = self.state.w.device
            out = []
            for chunk in ds.chunks():
                planes, nrow = self.pack_chunk(chunk, Tc, ds.max_nnz)
                if self.mesh is not None:
                    planes = pmesh.put_process_sharded(planes, self.mesh)
                out.append(self._predict_stacked({n: x.to(dev) for n, x in planes.items()}, nrow))
            return np.concatenate(out) if out else np.zeros(0, np.float32)
        return self._predict_stacked(*self._pack(ds))

    def state_or_model(self) -> TrainState:
        if self.state is None:
            self.init_trainer()
        return self._std_state()
