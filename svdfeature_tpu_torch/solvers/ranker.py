"""Ranker: the tag-driven rank engine of ``use_ranker=1``.

Counterpart of svdfeature_tpu/solvers/ranker.py (SVDFeatureRanker,
apex_svd_base.h:597-813).  The reference is a per-row state machine (tags
in the label field: ITEM=0 defines a candidate, USER=2 starts a user
section, POS=1 / BAN=-1 tag candidates, SPEC=3 adds a pair-specific score,
PROCESS=4 ranks and emits).  The protocol is parsed on the host, as in the
JAX package, into one candidate matrix ``[NI, k]`` with its biases and the
user sections' vectors; the scoring ``U @ ifactors^T + ibias``, the ban
mask, the rank positions and the top-k run as torch ops on the ranker's
device (config key ``device``, default ``cuda``).  The JAX package
computes that product outside any Pallas kernel, so it is a plain
``torch.matmul`` here.

The ranker reads no mesh key: ``mesh_data`` / ``mesh_model`` are accepted
and ignored, as by the JAX ranker (svdfeature_tpu/solvers/ranker.py:39-46),
and it ranks with the whole model on its rank's device whatever they say.
Inside a torchrun world (``distributed=1``) every rank ranks and rank 0
alone writes the pred file (infer/task.task_pred_rank).
"""

from __future__ import annotations

from typing import BinaryIO, List, Optional

import numpy as np
import torch

from ..data.batching_plus import merge_split_blocks
from ..data.csr import PlusBlock, PlusDataset
from ..model import SVDModel
from ..params import SVDTypeParam, svd_type, svdranker_tag as tag
from ..utils.sparse_feature_array import SparseFeatureArray
from .base import resolve_device


def _require(cond: bool, message: str) -> None:
    """The reference's protocol checks (apex_svd_base.h:741-782) on the
    rank input, which comes from outside the program."""
    if not cond:
        raise ValueError(message)


class SVDFeatureRanker:
    def __init__(self, mtype: SVDTypeParam):
        self.mtype = mtype
        self.top_k = 0
        self.num_item_set = 0
        self.device_name = "cuda"
        self.name_feat_user: Optional[str] = None
        self.name_feat_item: Optional[str] = None
        self.feat_user: Optional[SparseFeatureArray] = None
        self.feat_item: Optional[SparseFeatureArray] = None
        self.model: Optional[SVDModel] = None

    def set_param(self, name: str, val: str) -> None:
        if name == "feature_user":
            self.name_feat_user = val
        if name == "feature_item":
            self.name_feat_item = val
        if name == "top_k":
            self.top_k = int(val)
        if name == "device":
            self.device_name = val

    def load_model(self, f: BinaryIO) -> None:
        self.model = SVDModel.load(f, self.mtype, device=resolve_device(self.device_name))

    def init_ranker(self, num_item_set: int) -> None:
        self.num_item_set = num_item_set
        if self.name_feat_user and self.name_feat_user != "NULL":
            self.feat_user = SparseFeatureArray.load(self.name_feat_user)
        if self.name_feat_item and self.name_feat_item != "NULL":
            self.feat_item = SparseFeatureArray.load(self.name_feat_item)

    # ------------------------------------------------------------------
    def _expand(self, idx, val, feat, scale_by_parent):
        if feat is None or feat.num_row == 0:
            return idx, val
        ei, ev, _ = feat.expand(idx, val, np.zeros(len(idx), np.int64), scale_by_parent)
        return np.concatenate([idx, ei]), np.concatenate([val, ev])

    def _ifactor_bias(self, tables, g, i):
        """prepare_ifactor (apex_svd_base.h:687-710): item-feature factor
        sum, and item bias plus the global bias contribution."""
        m = self.model
        w, b, gb = tables
        ii, iv = self._expand(i[0].astype(np.int64), i[1], self.feat_item, True)
        vec = (w[m.off_item + ii] * iv[:, None]).sum(0)
        bias = float((b[m.off_item + ii] * iv).sum())
        if len(g[0]):
            bias += float((gb[g[0].astype(np.int64)] * g[1]).sum())
        return vec, bias

    def process_dataset(self, ds) -> np.ndarray:
        """Run the whole protocol; returns the flat emission list (top-k
        item ids, or the rank positions of the positives)."""
        m = self.model
        k = m.num_factor
        dev = m.w.device
        # the host parse reads the tables as the JAX package does
        tables = tuple(t.detach().cpu().numpy() for t in (m.w, m.b, m.g))
        w = tables[0]
        usergroup = self.mtype.format_type == svd_type.USER_GROUP_FORMAT
        if isinstance(ds, PlusDataset):
            blocks = merge_split_blocks(ds)
        else:
            blocks = [PlusBlock(fb_index=np.zeros(0, np.uint32),
                                fb_value=np.zeros(0, np.float32), data=ds)]

        NI = self.num_item_set
        ifactors = np.zeros((max(NI, 1), k), np.float32)
        ibias = np.zeros(max(NI, 1), np.float32)
        n_item = 0
        users: List[dict] = []
        cur = None
        for blk in blocks:
            fb = None
            if usergroup and blk.num_ufeedback:
                fb = (w[m.off_ufeedback + blk.fb_index.astype(np.int64)]
                      * blk.fb_value[:, None]).sum(0)
            d = blk.data
            for r in range(d.num_row):
                label, g, u, i = d.row(r)
                t = int(label)
                if t == tag.ITEM_TAG:
                    _require(n_item < NI, "item instance exceed specified item set size")
                    ifactors[n_item], ibias[n_item] = self._ifactor_bias(tables, g, i)
                    n_item += 1
                elif t == tag.USER_TAG:
                    uvec = fb.copy() if fb is not None else np.zeros(k, np.float32)
                    ui, uv = self._expand(u[0].astype(np.int64), u[1], self.feat_user, False)
                    uvec += (w[m.off_user + ui] * uv[:, None]).sum(0)
                    cur = dict(u=uvec, pos=[], ban=[], spec=[], spec_score=[])
                elif t in (tag.POS_SAMPLE, tag.BAN_SAMPLE):
                    for idx in u[0]:
                        idx = int(idx)
                        _require(idx < n_item, "sample item index exceed bound")
                        # an item carries at most one tag per user section
                        # (proc_tag, apex_svd_base.h:741-749)
                        _require(idx not in cur["pos"] and idx not in cur["ban"],
                                 "each pos sample item can not occur in baned sample list")
                        (cur["pos"] if t == tag.POS_SAMPLE else cur["ban"]).append(idx)
                elif t == tag.SPEC_SAMPLE:
                    _require(len(u[0]) == 1, "must specify item index of sample")
                    vec, bias = self._ifactor_bias(tables, g, i)
                    cur["spec"].append(int(u[0][0]))
                    cur["spec_score"].append(bias + float(vec @ cur["u"]))
                elif t == tag.PROCESS_TAG:
                    users.append(cur)
                    cur = None
        if not users:
            return np.zeros(0, np.int32)

        nU = len(users)
        U = torch.from_numpy(np.stack([usr["u"] for usr in users])).to(dev)
        item_f = torch.from_numpy(ifactors[:n_item]).to(dev)
        item_b = torch.from_numpy(ibias[:n_item]).to(dev)
        scores = torch.matmul(U, item_f.T) + item_b[None, :]  # [nU, NI]
        rows_of = lambda key: np.repeat(np.arange(nU), [len(usr[key]) for usr in users])  # noqa: E731
        flat = lambda key: np.asarray([x for usr in users for x in usr[key]])  # noqa: E731
        if any(usr["spec"] for usr in users):
            # the reference adds each spec score to its item in order
            for ui_, usr in enumerate(users):
                for idx, s in zip(usr["spec"], usr["spec_score"]):
                    scores[ui_, idx] += s
        nonban = torch.ones((nU, n_item), dtype=torch.bool, device=dev)
        if any(usr["ban"] for usr in users):
            nonban[torch.from_numpy(rows_of("ban")).to(dev),
                   torch.from_numpy(flat("ban").astype(np.int64)).to(dev)] = False
        if self.top_k > 0:
            _require(int(nonban.sum(1).min()) >= self.top_k, "k can not exceed candidate size")
            # descending score among the non-banned, ties in item order
            masked = torch.where(nonban, scores, torch.tensor(float("-inf"), device=dev))
            order = torch.sort(masked, dim=1, descending=True, stable=True).indices
            return order[:, : self.top_k].reshape(-1).to(torch.int32).cpu().numpy()
        if not any(usr["pos"] for usr in users):
            return np.zeros(0, np.int32)
        # rank position of each positive: the non-banned candidates scored
        # above it (proc_rank, apex_svd_base.h:759-782)
        ur = torch.from_numpy(rows_of("pos")).to(dev)
        pi = torch.from_numpy(flat("pos").astype(np.int64)).to(dev)
        above = (scores[ur] > scores[ur, pi][:, None]) & nonban[ur]
        return above.sum(1).to(torch.int32).cpu().numpy()
