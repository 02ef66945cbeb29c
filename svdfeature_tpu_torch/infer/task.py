"""Inference task: RMSE eval over a model sequence, prediction, ranking.

Counterpart of svdfeature_tpu/infer/task.py (SVDInferTask,
svd_feature_infer.cpp:35-398, with the dispatch the fork commented out
restored: pred>=0 -> task_pred / task_pred_rank (``use_ranker=1``), else
task_eval).  ``test:``-prefixed keys route to the test iterator
(:198-220).

On a mesh (``mesh_data`` x ``mesh_model`` > 1, a torchrun world; the
``distributed=1`` key joins it first) every rank loads each model and
shards it, predicts its data columns on its slab, and ends with all the
predictions in single-device row order; rank 0 alone writes ``log_eval``
and the pred file.
"""

from __future__ import annotations

import math
import os
import sys
from typing import List, Optional

import numpy as np

from ..config import ConfigSaver
from ..data.registry import IteratorConfig, load_csr_source, load_plus_source
from ..parallel import comm
from ..params import SVDTypeParam, input_type, svd_type
from ..solvers.registry import create_svd_ranker, create_svd_trainer


class SVDInferTask:
    def __init__(self) -> None:
        self.cfg = ConfigSaver()
        self.mtype = SVDTypeParam()
        self.input_type = input_type.BINARY_BUFFER
        self.scale_score = 1.0
        self.name_pred = "pred.txt"
        self.name_eval: Optional[str] = None
        self.name_model_in_folder = "models"
        self.start = 0
        self.end = 1 << 30
        self.step = 1
        self.pred_model = -1
        self.pred_binary = 0
        self.use_ranker = 0
        self.num_item_set = 0
        self.silent = 0
        self.distributed = 0
        self.device_name = "cuda"
        self.inferencer = None
        self.ranker = None
        self.dataset = None
        self._stream_labels: Optional[np.ndarray] = None  # a streaming source's, read once

    def set_param_inner(self, name: str, val: str) -> None:
        if name == "model_out_folder":
            self.name_model_in_folder = val
        if name == "log_eval":
            self.name_eval = val
        if name == "name_pred":
            self.name_pred = val
        if name == "start":
            self.start = int(val)
        if name == "end":
            self.end = int(val)
        if name == "focus":
            self.start = int(val)
            self.end = self.start + 1
        if name == "pred":
            self.pred_model = int(val)
            self.start = int(val)
            self.end = self.start + 1
        if name == "pred_binary":
            self.pred_binary = int(val)
        if name == "step":
            self.step = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "scale_score":
            self.scale_score = float(val)
        if name == "test:input_type":
            self.input_type = int(val)
        if name == "use_ranker":
            self.use_ranker = int(val)
        if name == "num_item_set":
            self.num_item_set = int(val)
        if name == "distributed":
            self.distributed = int(val)
        if name == "device":
            self.device_name = val

    def configure(self, conf_path: str, cli_args: List[str]) -> None:
        self.cfg.load_file(conf_path)
        self.cfg.load_cli(cli_args)
        for name, val in self.cfg:
            self.set_param_inner(name, val)
        self.mtype.decide_format(
            svd_type.USER_GROUP_FORMAT if self.input_type == 2 else svd_type.AUTO_DETECT
        )
        if self.distributed:
            comm.init_distributed(self.device_name)

    def _model_path(self, i: int) -> str:
        return os.path.join(self.name_model_in_folder, "%04d.model" % i)

    def _init_model(self, i: int) -> None:
        path = self._model_path(i)
        if not os.path.exists(path):
            raise SystemExit(f'can not open file "{path}"')
        with open(path, "rb") as f:
            self.mtype = SVDTypeParam.from_bytes(f.read(4))
            if self.use_ranker:
                self.ranker = solver = create_svd_ranker(self.mtype)
            else:
                self.inferencer = solver = create_svd_trainer(self.mtype)
            for name, val in self.cfg:
                solver.set_param(name, val)
            solver.load_model(f)

    def _load_model(self, i: int) -> bool:
        path = self._model_path(i)
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            f.read(4)
            if self.ranker is not None:
                self.ranker.load_model(f)
            else:
                self.inferencer.load_model(f)
                self.inferencer.init_trainer()
        return True

    def _configure_iterator(self) -> None:
        icfg = IteratorConfig()
        for name, val in self.cfg:
            # only accept test:-prefixed keys + compat keys (svd_feature_infer.cpp:198-220)
            if name.startswith("test:"):
                icfg.set_param(name[5:], val)
            if name == "data_test":
                icfg.set_param("data_in", val)
            if name in ("scale_score", "silent"):
                icfg.set_param(name, val)
        if self.mtype.format_type == svd_type.USER_GROUP_FORMAT:
            self.dataset = load_plus_source(self.input_type, icfg)
        else:
            self.dataset = load_csr_source(self.input_type, icfg)

    def init(self) -> None:
        self._init_model(self.start)
        if self.inferencer is not None:
            self.inferencer.init_trainer()
        if self.ranker is not None:
            self.ranker.init_ranker(self.num_item_set)
        self._configure_iterator()

    # ---- tasks ----------------------------------------------------------------
    def _labels(self) -> np.ndarray:
        """Labels in dataset-row order (a user-group dataset keeps its rows
        in ``rows``); a streaming source's read a chunk at a time, once."""
        ds = self.dataset
        if hasattr(ds, "chunks"):
            if self._stream_labels is None:
                parts = [c.rows.labels if hasattr(c, "rows") else c.labels for c in ds.chunks()]
                self._stream_labels = np.concatenate(parts) if parts else np.zeros(0, np.float32)
            return self._stream_labels
        return ds.rows.labels if hasattr(ds, "rows") else ds.labels

    def task_eval(self) -> None:
        writer = comm.rank() == 0
        fo = (open(self.name_eval, "a") if self.name_eval else sys.stdout) if writer else None
        try:
            i = self.start
            while i < self.end and self._load_model(i):
                p = self.inferencer.predict_all(self.dataset)
                diff = (p - self._labels()) * self.scale_score
                rmse = math.sqrt(float(np.mean(diff * diff)))
                if writer:
                    fo.write("%d\t%f\n" % (i, rmse))
                i += self.step
        finally:
            if fo is not None and fo is not sys.stdout:
                fo.close()

    def task_pred(self) -> None:
        if not self._load_model(self.pred_model):
            raise RuntimeError(f"fail to load model {self.pred_model}")
        p = self.inferencer.predict_all(self.dataset) * self.scale_score
        if comm.rank():
            return
        with open(self.name_pred, "wb" if self.pred_binary else "w") as fo:
            if self.pred_binary:
                fo.write(np.asarray(p, "<f4").tobytes())
            else:
                for v in p:
                    fo.write("%f\n" % v)
        if not self.silent:
            print(f"prediction end, results stored to {self.name_pred}")

    def task_pred_rank(self) -> None:
        if not self._load_model(self.pred_model):
            raise RuntimeError(f"fail to load model {self.pred_model}")
        results = self.ranker.process_dataset(self.dataset)
        if comm.rank():
            return
        with open(self.name_pred, "wb" if self.pred_binary else "w") as fo:
            if self.pred_binary:
                fo.write(np.asarray(results, "<i4").tobytes())
            else:
                for v in results:
                    fo.write("%d\n" % v)
        if not self.silent:
            print(f"prediction end, results stored to {self.name_pred}")

    def run(self, conf_path: str, cli_args: List[str]) -> None:
        self.configure(conf_path, cli_args)
        self.init()
        if comm.rank():  # the world is joined by now, by distributed=1 or the mesh
            self.silent = 1
        if self.pred_model >= 0:
            if self.use_ranker:
                self.task_pred_rank()
            else:
                self.task_pred()
        else:
            if self.inferencer is None:
                raise RuntimeError("can only use ranker for rank prediction")
            self.task_eval()
