"""GBRT wrapper solvers (extend_type 30/31) on PyTorch.

Counterpart of svdfeature_tpu/solvers/gbrt/trainer.py, a port of
GBRTTrainer / RegGBRTTrainer / LambdaGBRTTrainer / APLambdaGBRTTrainer
(solvers/gbrt/apex_gbrt.h:451-1117): each round accumulates (grad, hess,
features) over the whole epoch, finish_round fits one regression tree on
them (the exact-greedy fit of tree.py, numpy, on the host).  Everything
that is numpy in the JAX trainer is kept as it is: the epoch assembly,
the incremental forward cache, update_all / finish_round / _restrict,
the ``RandomState(10)`` pair sampler and the checkpoint (GBRTModelParam,
152 B, + trees + optional root_type/weight_type arrays,
apex_gbrt.h:149-184).  So the trees and checkpoints equal the JAX
package's.  Three places differ:

(a) the losses are ``np_losses``, numpy that rounds as the jnp ``losses``
    do when the JAX trainers call them on numpy inputs (float32 where a
    jnp function is reached, the input's dtype elsewhere); APLambda's pair
    terms are computed per block as arrays, not per pair;
(b) ``device_forward`` (-1 auto, 0 host walk, 1 the torch walk on the
    trainer's device) keeps the JAX rule with CUDA in place of the TPU:
    auto walks a full-model forward (start 0, more than one tree) with
    ``ops.gbrt_forward`` when the trainer's device is CUDA; training
    rounds walk only the newest tree, on the host;
(c) config key ``device`` (default ``cuda``; ``device=cuda`` without a card
    raises), a dataset's lookup keys staged on it once, and
    ``synchronize()`` for the train task's round clock.

``mesh_data`` / ``mesh_model`` are read and ignored, as by the JAX trainer:
without a world the run is the one without them, byte for byte; inside a
torchrun world (``distributed=1``, or the mesh keys) every rank fits the
same trees and rank 0 alone writes.
"""

from __future__ import annotations

import os
from typing import BinaryIO, List, Optional

import numpy as np
import torch

from ...config import ConfigSaver
from ...data.batching_plus import merge_split_blocks
from ...data.csr import PlusDataset
from ...ops import gbrt_forward
from ...parallel import comm
from ...params import SVDTypeParam
from ..base import resolve_device
from . import np_losses as losses
from .schedulers import GBRTParamScheduler, GBRTScheduler, ItemTaxonomy
from .tree import RTreeTrainer, SparseRows

_GBRT_PARAM_DT = np.dtype(
    [
        ("num_trees", "<i4"),
        ("baseline_mode", "<i4"),
        ("tree_type", "<i4"),
        ("num_item", "<i4"),
        ("num_global", "<i4"),
        ("num_ufeedback", "<i4"),
        ("num_spec_sparse", "<i4"),
        ("use_tax_root", "<i4"),
        ("item_feature_mode", "<i4"),
        ("num_root_weight", "<i4"),
        ("reserved", "<i4", (28,)),
    ]
)
assert _GBRT_PARAM_DT.itemsize == 152


class GBRTModelParam:
    FIELDS = [
        "num_trees", "baseline_mode", "tree_type", "num_item", "num_global",
        "num_ufeedback", "num_spec_sparse", "use_tax_root",
        "item_feature_mode", "num_root_weight",
    ]

    def __init__(self) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)

    def set_param(self, name: str, val: str) -> None:
        key = {
            "rt_baseline": "baseline_mode",
            "rt_type": "tree_type",
        }.get(name, name)
        if key in self.FIELDS and key != "num_trees":
            setattr(self, key, int(val))

    def to_bytes(self) -> bytes:
        rec = np.zeros((), _GBRT_PARAM_DT)
        for f in self.FIELDS:
            rec[f] = getattr(self, f)
        return rec.tobytes()

    def from_bytes(self, b: bytes) -> None:
        rec = np.frombuffer(b, _GBRT_PARAM_DT)[0]
        for f in self.FIELDS:
            setattr(self, f, int(rec[f]))


class GBRTTrainer:
    """Base GBRT trainer; subclasses implement update_stats."""

    def __init__(self, mtype: SVDTypeParam):
        self.mtype = mtype
        self.mparam = GBRTModelParam()
        self.trees: List[RTreeTrainer] = []
        self.root_type: List[int] = []
        self.weight_type: List[int] = []
        self.cfg = ConfigSaver()
        self.tax = ItemTaxonomy()
        self.tax_name: Optional[str] = None
        self.rt_loss_type = 1
        self.chg_baseline_mode = -1
        self.scale_baseline = 1.0
        self.base_score = 0.0
        self.pred_tree_leaf = -1
        # device_forward: -1 auto (the torch walk on a CUDA device for
        # full-model evals), 0 host numpy walk, 1 force the torch walk on
        # the trainer's device (ops/gbrt_forward.py)
        self.device_forward = -1
        self.device_name = "cuda"
        self.device: Optional[torch.device] = None
        # read and ignored, as by the JAX trainer: the trees are fitted on
        # the host, and no mesh shards them (``_join_world``)
        self.mesh_data = 1
        self.mesh_model = 1
        # GBRTTrainParam (lr schedule with min clamp, apex_gbrt.h:36-81)
        self.learning_rate = 0.01
        self.decay_learning_rate = 0
        self.decay_rate = 1.0
        self.min_learning_rate = 0.001
        self._round_counter = 0
        self.rscheduler = GBRTScheduler("r")
        self.wscheduler = GBRTScheduler("w")
        self.pscheduler = GBRTParamScheduler()
        self.rng = np.random.RandomState(10)
        # epoch accumulators
        self._acc_grad: List[np.ndarray] = []
        self._acc_sgrad: List[np.ndarray] = []
        self._acc_weight: List[np.ndarray] = []
        self._acc_keep: List[np.ndarray] = []
        # forward cache: dataset id -> (pred_base [R], num_trees covered)
        self._fwd_cache = {}
        self._epoch_cache = {}
        # dataset id -> its lookup keys on the device (ops/gbrt_forward.stage_rows)
        self._dev_rows = {}

    # ---- config -----------------------------------------------------------
    def set_param(self, name: str, val: str) -> None:
        if name == "rt_loss_type":
            self.rt_loss_type = int(val)
        if name == "pred_tree_leaf":
            self.pred_tree_leaf = int(val)
        if name == "device_forward":
            self.device_forward = int(val)
        if name == "device":
            self.device_name = val
        if name == "mesh_data":
            self.mesh_data = int(val)
        if name == "mesh_model":
            self.mesh_model = int(val)
        if name == "chg_baseline_mode":
            self.chg_baseline_mode = int(val)
        if name == "feature_item":
            self.tax_name = val
        if name == "scale_baseline":
            self.scale_baseline = float(val)
        if name == "base_score":
            self.base_score = float(val)
        if name == "learning_rate":
            self.learning_rate = float(val)
        if name == "decay_learning_rate":
            self.decay_learning_rate = int(val)
        if name == "decay_rate":
            self.decay_rate = float(val)
        if name == "min_learning_rate":
            self.min_learning_rate = float(val)
        if not self.trees:
            self.mparam.set_param(name, val)
        self.pscheduler.set_param(name, val)
        self.rscheduler.set_param(name, val)
        self.wscheduler.set_param(name, val)
        self.cfg.push_back(name, val)

    # ---- model lifecycle ----------------------------------------------------
    def _join_world(self) -> None:
        """Before the first tensor: given the mesh keys inside a torchrun
        world, join it (as ``distributed=1`` does), so that every rank fits
        the same trees and rank 0 alone writes; outside a world the keys
        change nothing."""
        if self.mesh_data * self.mesh_model > 1 and "WORLD_SIZE" in os.environ:
            comm.init_distributed(self.device_name)

    def init_model(self) -> None:
        assert not self.trees, "bug: GBRT model inconsistent"
        self._join_world()
        self.device = resolve_device(self.device_name)

    def init_trainer(self) -> None:
        self._join_world()
        self.device = resolve_device(self.device_name)
        if self.tax_name and self.tax_name != "NULL":
            if self.mparam.use_tax_root:
                self.tax.load(self.tax_name)
        else:
            assert self.mparam.use_tax_root == 0, (
                "no taxonomy information available for tax root"
            )

    def load_model(self, f: BinaryIO) -> None:
        self._join_world()
        self.mparam.from_bytes(f.read(_GBRT_PARAM_DT.itemsize))
        if self.chg_baseline_mode >= 0:
            self.mparam.baseline_mode = self.chg_baseline_mode
        self.trees = []
        for _ in range(self.mparam.num_trees):
            t = RTreeTrainer()
            t.load_model(f)
            self.trees.append(t)
        n = self.mparam.num_trees
        if self.mparam.use_tax_root and n:
            self.root_type = list(np.frombuffer(f.read(4 * n), "<i4"))
        if self.mparam.num_root_weight and n:
            self.weight_type = list(np.frombuffer(f.read(4 * n), "<i4"))
        self._fwd_cache.clear()

    def save_model(self, f: BinaryIO) -> None:
        self.mparam.num_trees = len(self.trees)
        f.write(self.mparam.to_bytes())
        for t in self.trees:
            t.save_model(f)
        if self.mparam.use_tax_root and self.trees:
            f.write(np.asarray(self.root_type, "<i4").tobytes())
        if self.mparam.num_root_weight and self.trees:
            f.write(np.asarray(self.weight_type, "<i4").tobytes())

    # ---- epoch data assembly -------------------------------------------------
    def _assemble(self, ds: PlusDataset):
        """Build per-row sparse features, group ids, baselines, weights."""
        key = id(ds)
        if key in self._epoch_cache:
            return self._epoch_cache[key]
        p = self.mparam
        blocks = merge_split_blocks(ds)
        nfb, nspec, ng = p.num_ufeedback, p.num_spec_sparse, p.num_global
        nfeat = nfb + nspec + ng
        base = 0 if p.baseline_mode == 0 else 1
        if p.num_root_weight:
            base = p.num_root_weight + 1

        fi_parts, fv_parts, ptr = [], [], [0]
        labels, gids, base_preds, wvals = [], [], [], []
        blk_of_row = []
        for bi, blk in enumerate(blocks):
            fb_i = blk.fb_index.astype(np.int64)
            assert (fb_i < nfb).all() if len(fb_i) else True, "ufeedback index exceed bound"
            fb_order = np.argsort(fb_i, kind="stable")
            fb_i, fb_v = fb_i[fb_order], blk.fb_value[fb_order]
            d = blk.data
            for r in range(d.num_row):
                label, g, u, i = d.row(r)
                gi = g[0].astype(np.int64)
                gv = g[1]
                # dense part with base-offset rule (build_dense)
                if p.num_root_weight:
                    assert len(gi) >= base and gi[base - 1] == base - 1, (
                        "not sufficient weight provided in global feature"
                    )
                dm = gi >= base
                dg_i = gi[dm] - base + nfb + nspec
                dg_v = gv[dm]
                assert (dg_i < nfeat).all() if len(dg_i) else True, "global index exceed bound"
                # spec sparse part (user segment)
                sp_i = u[0].astype(np.int64)
                if len(sp_i):
                    assert (sp_i < nspec).all(), "spec_sparse index exceed bound"
                row_i = np.concatenate([fb_i, sp_i + nfb, dg_i])
                row_v = np.concatenate([fb_v, u[1], dg_v]).astype(np.float32)
                order = np.argsort(row_i, kind="stable")
                fi_parts.append(row_i[order])
                fv_parts.append(row_v[order])
                ptr.append(ptr[-1] + len(row_i))
                labels.append(label)
                blk_of_row.append(bi)
                if p.num_item:
                    assert len(i[0]) == 1, "need exact 1 item id to specify item"
                    gids.append(int(i[0][0]))
                else:
                    gids.append(0)
                base_preds.append(
                    gv[0] * self.scale_baseline if p.baseline_mode == 1 else self.base_score
                )
                if base > 0:
                    wv = np.zeros(base, np.float32)
                    wv[: min(base, len(gv))] = gv[:base]
                    wvals.append(wv)
        smat = SparseRows(
            np.asarray(ptr, np.int64),
            np.concatenate(fi_parts) if fi_parts else np.zeros(0, np.int64),
            np.concatenate(fv_parts) if fv_parts else np.zeros(0, np.float32),
            nfeat,
        )
        entry = dict(
            smat=smat,
            labels=np.asarray(labels, np.float32),
            gids=np.asarray(gids, np.int64),
            base_pred=np.asarray(base_preds, np.float64),
            blk_of_row=np.asarray(blk_of_row, np.int64),
            nblocks=len(blocks),
            # per-row global-value prefix (for weight types): [R, base]
            wvals=np.stack(wvals) if (base > 0 and wvals) else None,
            extra_info=np.asarray(
                [b.extra_info for b in blocks], np.int8
            ),
        )
        self._epoch_cache[key] = entry
        return entry

    def _tree_weights(self, entry, ti: int) -> np.ndarray:
        if self.mparam.num_root_weight and self.weight_type[ti] != 0:
            return entry["wvals"][:, self.weight_type[ti]].astype(np.float64)
        return np.ones(len(entry["labels"]), np.float64)

    def _tree_gids(self, entry, ti: int) -> np.ndarray:
        if self.mparam.use_tax_root:
            return self.tax.map(entry["gids"], self.root_type[ti])
        return entry["gids"]

    def _use_device_forward(self, entry, start: int) -> bool:
        if self.device_forward == 0 or start >= len(self.trees):
            return False
        if not gbrt_forward.device_forward_ok(entry["smat"]):
            return False
        if self.device_forward == 1:
            return True
        # auto: full-model evals on a CUDA device (incremental training
        # rounds walk only the newest tree: the host path is cheaper)
        return start == 0 and len(self.trees) > 1 and self.device.type == "cuda"

    def synchronize(self) -> None:
        """Wait for the training device (the walks end in a host copy, so
        nothing is left queued; kept for the train task's round clock)."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forward_all(self, ds: PlusDataset) -> np.ndarray:
        """Raw scores: baseline + sum over trees (cached incrementally)."""
        entry = self._assemble(ds)
        key = id(ds)
        cache = self._fwd_cache.get(key)
        if cache is None or cache[1] > len(self.trees):
            pred = entry["base_pred"].copy()
            start = 0
        else:
            pred, start = cache[0], cache[1]
        if self._use_device_forward(entry, start):
            if key not in self._dev_rows:
                self._dev_rows[key] = gbrt_forward.stage_rows(entry["smat"], self.device)
            rng = range(start, len(self.trees))
            pred = gbrt_forward.forward_trees(
                [self.trees[ti].tree for ti in rng],
                entry["smat"],
                [self._tree_gids(entry, ti) for ti in rng],
                [self._tree_weights(entry, ti) for ti in rng],
                pred,
                self.device,
                self._dev_rows[key],
            )
        else:
            for ti in range(start, len(self.trees)):
                t = self.trees[ti]
                w = self._tree_weights(entry, ti)
                pred = pred + t.predict_rows(
                    entry["smat"], self._tree_gids(entry, ti)
                ) * w
        self._fwd_cache[key] = (pred, len(self.trees))
        return pred.copy()

    # ---- training ------------------------------------------------------------
    def update_stats(self, pred: np.ndarray, entry) -> tuple:
        raise NotImplementedError

    def update_all(self, ds: PlusDataset) -> None:
        entry = self._assemble(ds)
        pred = self.forward_all(ds)
        grad, sgrad, weight = self.update_stats(pred, entry)
        # root-weight scaling (add_batch, apex_gbrt.h:728-736)
        if self.mparam.num_root_weight:
            wt = self.wscheduler.curr_type()
            if wt != 0:
                v = entry["wvals"][:, wt].astype(np.float64)
                grad = grad * v
                sgrad = sgrad * v * v
                weight = weight * v * v
        keep = weight > 1e-5
        self._acc_grad.append(-grad[keep])
        self._acc_sgrad.append(-sgrad[keep])
        self._acc_weight.append(weight[keep])
        self._acc_rows = (entry, keep)

    def set_round(self, nround: int) -> None:
        self._acc_grad, self._acc_sgrad, self._acc_weight = [], [], []
        self.rscheduler.set_round(nround)
        self.pscheduler.set_round(nround)
        self.wscheduler.set_round(nround)
        if self.decay_learning_rate:
            while self._round_counter < nround:
                self.learning_rate *= self.decay_rate
                self._round_counter += 1
            self.learning_rate = max(self.learning_rate, self.min_learning_rate)

    def finish_round(self) -> None:
        if not self._acc_grad:
            return
        entry, keep = self._acc_rows
        grad = np.concatenate(self._acc_grad)
        sgrad = np.concatenate(self._acc_sgrad)
        weight = np.concatenate(self._acc_weight)
        # restrict features by the param scheduler's current range
        pe = self.pscheduler.curr_type()
        smat: SparseRows = entry["smat"]
        rows = np.nonzero(keep)[0]
        sub = self._restrict(smat, rows, pe)
        rt = RTreeTrainer()
        for n, v in self.cfg:
            rt.set_param(n, v)
        rt.set_param("learning_rate", repr(self.learning_rate))
        rt.set_param("rt_num_group_sparse", str(self.mparam.num_ufeedback))
        rt.set_param("rt_num_spec_sparse", str(self.mparam.num_spec_sparse))
        if self.mparam.use_tax_root == 0:
            rt.set_param(
                "rt_num_group",
                str(self.mparam.num_item if self.mparam.num_item else 1),
            )
        else:
            rt.set_param("rt_num_group", str(self.tax.size(self.rscheduler.curr_type())))
        rt.init_trainer()
        gids = self._tree_gids_next(entry)[rows] if self.mparam.num_item else None
        rt.do_boost(
            grad, sgrad, sub, gids,
            weight if self.rt_loss_type == 0 else None,
        )
        self.trees.append(rt)
        self.root_type.append(
            self.rscheduler.curr_type() if self.mparam.use_tax_root else -1
        )
        self.weight_type.append(
            self.wscheduler.curr_type() if self.mparam.num_root_weight else -1
        )
        self._acc_grad, self._acc_sgrad, self._acc_weight = [], [], []

    def _tree_gids_next(self, entry) -> np.ndarray:
        if self.mparam.use_tax_root:
            return self.tax.map(entry["gids"], self.rscheduler.curr_type())
        return entry["gids"]

    def _restrict(self, smat: SparseRows, rows: np.ndarray, pe) -> SparseRows:
        """Row subset + feature-range mask of the sparse feature matrix.

        pe masks the feedback ids by [fstart, fend) and the dense global
        positions by [gstart, gend) (add_spart/build_dense bounds)."""
        full_range = (
            pe.fstart == 0 and pe.fend >= (1 << 32) - 1
            and pe.gstart == 0 and pe.gend >= (1 << 32) - 1
        )
        if full_range and len(rows) == smat.num_row:
            return smat  # common case: no pset mask, no dropped rows
        fi, fv, ridx = smat.gather_entries(rows)
        nfb, nspec = self.mparam.num_ufeedback, self.mparam.num_spec_sparse
        keep = np.ones(len(fi), bool)
        is_fb = fi < nfb
        keep[is_fb] &= (fi[is_fb] >= pe.fstart) & (fi[is_fb] < pe.fend)
        is_g = fi >= nfb + nspec
        gpos = fi - nfb - nspec
        keep[is_g] &= (gpos[is_g] >= pe.gstart) & (gpos[is_g] < pe.gend)
        fi, fv, ridx = fi[keep], fv[keep], ridx[keep]
        # renumber rows to 0..len(rows)
        remap = np.full(int(rows.max(initial=-1)) + 1, -1, np.int64)
        remap[rows] = np.arange(len(rows))
        rloc = remap[ridx]
        counts = np.bincount(rloc, minlength=len(rows))
        row_ptr = np.concatenate(([0], np.cumsum(counts)))
        order = np.argsort(rloc, kind="stable")
        return SparseRows(row_ptr, fi[order], fv[order], smat.nfeat)

    # ---- prediction ------------------------------------------------------------
    def predict_all(self, ds: PlusDataset) -> np.ndarray:
        if self.pred_tree_leaf != -1:
            entry = self._assemble(ds)
            t = self.trees[self.pred_tree_leaf]
            return t.leaf_ids(
                entry["smat"], self._tree_gids(entry, self.pred_tree_leaf)
            ).astype(np.float32)
        raw = self.forward_all(ds)
        return np.asarray(
            losses.map_active(raw.astype(np.float32), self.mtype.active_type)
        )


class RegGBRTTrainer(GBRTTrainer):
    """Pointwise regression/classification boosting (apex_gbrt.h:840-867)."""

    def __init__(self, mtype):
        super().__init__(mtype)
        self.keep_prob = 1.0

    def set_param(self, name, val):
        if name == "subsample_prob":
            self.keep_prob = float(val)
        super().set_param(name, val)

    def update_stats(self, pred, entry):
        labels = entry["labels"].astype(np.float64)
        p = np.asarray(losses.map_active(pred.astype(np.float32), self.mtype.active_type), np.float64)
        grad = np.asarray(losses.cal_grad(labels, p, self.mtype.active_type), np.float64)
        sgrad = np.asarray(losses.cal_sgrad(labels, p, self.mtype.active_type), np.float64)
        weight = np.ones(len(labels), np.float64)
        if self.keep_prob < 1.0 - 1e-6:
            # reference drops whole blocks with prob 1-keep_prob
            drop = self.rng.rand(entry["nblocks"]) >= self.keep_prob
            weight[drop[entry["blk_of_row"]]] = 0.0
        return grad, sgrad, weight


class APLambdaGBRTTrainer(GBRTTrainer):
    """Pairwise lambda-rank boosting with AP-weighted pair sampling
    (LambdaGBRTTrainer + APLambdaGBRTTrainer, apex_gbrt.h:871-1117)."""

    def __init__(self, mtype):
        super().__init__(mtype)
        self.lambda_weight_mode = 1
        self.sample_pointwise = 0
        self.sample_num = -1
        self.attach_sample_num = 0
        self.ap_maxn = 1 << 30
        self.ap_method = 0
        self.ap_alpha = 0.0
        self.reject_method = 0
        self.ap_start_round = 0
        self.keep_prob = 1.0
        self.nround = 0

    def set_param(self, name, val):
        if name == "lambda_weight_mode":
            self.lambda_weight_mode = int(val)
        if name == "rank_sample_pointwise":
            self.sample_pointwise = int(val)
        if name == "rank_sample_num":
            self.sample_num = int(val)
        if name == "attach:rank_sample_num":
            self.attach_sample_num = int(val)
        if name == "lambda_ap_maxn":
            self.ap_maxn = int(val)
        if name == "lambda_ap_method":
            self.ap_method = int(val)
        if name == "lambda_ap_alpha":
            self.ap_alpha = float(val)
        if name == "lambda_ap_reject":
            self.reject_method = int(val)
        if name == "lambda_ap_rstart":
            self.ap_start_round = int(val)
        if name in ("lambda_keep_prob", "subsample_prob"):
            self.keep_prob = float(val)
        super().set_param(name, val)

    def set_round(self, nround):
        super().set_round(nround)
        self.nround = nround

    def update_stats(self, pred, entry):
        R = len(pred)
        grad = np.zeros(R, np.float64)
        sgrad = np.zeros(R, np.float64)
        weight = np.zeros(R, np.float64)
        labels = entry["labels"]
        blk = entry["blk_of_row"]
        at = self.mtype.active_type
        for b in range(entry["nblocks"]):
            rows = np.nonzero(blk == b)[0]
            if len(rows) == 0:
                continue
            if self.keep_prob < 1.0 - 1e-6 and self.rng.rand() >= self.keep_prob:
                continue
            order = rows[np.argsort(-pred[rows], kind="stable")]
            is_attach = bool(entry["extra_info"][b])
            # the block's pairs as arrays, in sampling order: a row is a
            # positive or a negative of its block, never both, so adding a
            # column at a time (np.add.at, in order) sums each row's terms
            # in the order of the JAX trainer's loop over pairs
            pairs = [s for s in self._gen_samples(labels[order], is_attach) if s[2] >= 1e-5]
            if not pairs:
                continue
            pi, ni, wt = (np.asarray(c) for c in zip(*pairs))
            p_idx, n_idx, wt = order[pi], order[ni], wt.astype(np.float64)
            if self.sample_pointwise == 0:
                pp = np.asarray(losses.map_active(pred[p_idx] - pred[n_idx], at), np.float64)
                err = np.asarray(losses.cal_grad(1.0, pp, at), np.float64) * wt
                sg = np.asarray(losses.cal_sgrad(1.0, pp, at), np.float64) * wt
                np.add.at(grad, p_idx, err)
                np.add.at(grad, n_idx, -err)
                np.add.at(sgrad, p_idx, sg)
                np.add.at(sgrad, n_idx, sg)
            else:
                for idx, r in ((p_idx, 1.0), (n_idx, 0.0)):
                    pv = np.asarray(losses.map_active(pred[idx], at), np.float64)
                    np.add.at(grad, idx, np.asarray(losses.cal_grad(r, pv, at), np.float64) * wt)
                    np.add.at(sgrad, idx, np.asarray(losses.cal_sgrad(r, pv, at), np.float64) * wt)
            inc = np.ones_like(wt) if self.lambda_weight_mode == 0 else wt
            np.add.at(weight, p_idx, inc)
            np.add.at(weight, n_idx, inc)
        return grad, sgrad, weight

    def _gen_samples(self, sorted_labels, is_attach):
        """AP-weighted pair sampling (gen_sweight, apex_gbrt.h:1012-1090).
        Positions are ranks in score-sorted order."""
        pos = np.nonzero(sorted_labels > 0.5)[0]
        neg = np.nonzero(sorted_labels <= 0.5)[0]
        if len(pos) == 0 or len(neg) == 0:
            return []
        pos_top = pos[pos < self.ap_maxn]
        pos = self.rng.permutation(pos)
        neg = self.rng.permutation(neg)
        if self.sample_num > 0:
            snum = self.attach_sample_num if is_attach else self.sample_num
        elif self.sample_num == -1:
            snum = len(neg)
        elif self.sample_num == -2:
            snum = len(pos)
        else:
            snum = len(neg)
        out = []
        nsample = 0
        i = 0
        while nsample < snum:
            pos_idx = int(pos[i % len(pos)])
            neg_idx = int(neg[i % len(neg)])
            if self.nround >= self.ap_start_round:
                a, b = (pos_idx, neg_idx) if pos_idx >= neg_idx else (neg_idx, pos_idx)
                delta_ap = 0.0
                if b < self.ap_maxn:
                    pos_cnt = 0
                    for j, pt in enumerate(pos_top):
                        if pt >= a:
                            delta_ap -= (j + 1.0) / (a + 1.0)
                            break
                        if pt > b:
                            delta_ap += 1.0 / (pt + 1.0)
                        elif pt != b:
                            pos_cnt += 1
                    delta_ap += (pos_cnt + 1.0) / (b + 1.0)
                    delta_ap /= len(pos)
                wt = self.ap_alpha * delta_ap + 1.0 - self.ap_alpha
            else:
                wt = 1.0
            if self.reject_method == 0:
                out.append((pos_idx, neg_idx, wt))
                nsample += 1
            elif self.reject_method == 1:
                if self.rng.rand() < wt:
                    out.append((pos_idx, neg_idx, 1.0))
                nsample += 1
            elif self.reject_method == 2:
                if self.rng.rand() < wt:
                    out.append((pos_idx, neg_idx, 1.0))
                    nsample += 1
            else:
                raise ValueError("reject method unknown")
            i += 1
            if i > 100 * (snum + 1):  # safety against reject starvation
                break
        return out


def create_gbrt_trainer(mtype: SVDTypeParam):
    """apex_svd.cpp:32-44: 30 -> APLambdaGBRT, 31 -> RegGBRT."""
    if mtype.extend_type == 30:
        return APLambdaGBRTTrainer(mtype)
    return RegGBRTTrainer(mtype)
