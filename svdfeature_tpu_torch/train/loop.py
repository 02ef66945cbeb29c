"""Training task: the round loop with per-round checkpoints.

Counterpart of svdfeature_tpu/train/loop.py (SVDTrainTask,
svd_feature.cpp:34-296): configure from .conf + CLI overlay, create the
solver via the port's registry, continue-from-latest (scanning
models/%04d.model), run num_round rounds saving one model per round, with
a progress/throughput line per round.  The JAX package's observability
keys (``log_jsonl``, ``profile_dir``, ``debug_checks``) and ``distributed``
are not ported yet.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List

from ..config import ConfigSaver
from ..data.registry import IteratorConfig, load_csr_source, load_plus_source
from ..params import SVDTypeParam, input_type, svd_type
from ..solvers.registry import create_svd_trainer


class SVDTrainTask:
    def __init__(self) -> None:
        self.cfg = ConfigSaver()
        self.mtype = SVDTypeParam()
        self.task = 0
        self.continue_training = 0
        self.max_round = 1 << 30
        self.start_counter = 0
        self.name_model_in = ""
        self.name_model_out_folder = "models"
        self.num_round = 10
        self.train_repeat = 1
        self.silent = 0
        self.input_type = input_type.BINARY_BUFFER
        self.trainer = None
        self.dataset = None
        # seconds of each round's training, device work included and the
        # model save excluded
        self.round_seconds: List[float] = []

    def set_param_inner(self, name: str, val: str) -> None:
        if name == "task":
            self.task = int(val)
        if name == "continue":
            self.continue_training = int(val)
        if name == "max_round":
            self.max_round = int(val)
        if name == "start_counter":
            self.start_counter = int(val)
        if name == "model_in":
            self.name_model_in = val
        if name == "model_out_folder":
            self.name_model_out_folder = val
        if name == "num_round":
            self.num_round = int(val)
        if name == "train_repeat":
            self.train_repeat = int(val)
        if name == "silent":
            self.silent = int(val)
        if name == "input_type":
            self.input_type = int(val)
        self.mtype.set_param(name, val)

    def configure(self, conf_path: str, cli_args: List[str]) -> None:
        self.cfg.load_file(conf_path)
        self.cfg.load_cli(cli_args)
        for name, val in self.cfg:
            self.set_param_inner(name, val)
        self.mtype.decide_format(
            svd_type.USER_GROUP_FORMAT if self.input_type == 2 else svd_type.AUTO_DETECT
        )

    def _model_path(self, counter: int) -> str:
        return os.path.join(self.name_model_out_folder, "%04d.model" % counter)

    def sync_latest_model(self) -> bool:
        """Find newest models/%04d.model >= start_counter (svd_feature.cpp:153-174);
        training resumes after the loaded snapshot."""
        s = self.start_counter
        last = None
        while os.path.exists(self._model_path(s)):
            last = self._model_path(s)
            s += 1
        if last is None:
            return False
        with open(last, "rb") as f:
            self.mtype = SVDTypeParam.from_bytes(f.read(4))
            self.trainer = create_svd_trainer(self.mtype)
            self._configure_trainer()
            self.trainer.load_model(f)
        self.start_counter = s
        return True

    def _configure_trainer(self) -> None:
        for name, val in self.cfg:
            self.trainer.set_param(name, val)

    def _configure_iterator(self) -> None:
        icfg = IteratorConfig()
        for name, val in self.cfg:
            icfg.set_param(name, val)
        if self.mtype.format_type == svd_type.USER_GROUP_FORMAT:
            self.dataset = load_plus_source(self.input_type, icfg)
        else:
            self.dataset = load_csr_source(self.input_type, icfg)

    def dataset_rows(self) -> int:
        """Training rows of the dataset (a user-group dataset keeps them in
        ``rows``)."""
        ds = self.dataset
        return ds.rows.num_row if hasattr(ds, "rows") else ds.num_row

    def save_model(self) -> None:
        os.makedirs(self.name_model_out_folder or ".", exist_ok=True)
        with open(self._model_path(self.start_counter), "wb") as f:
            f.write(self.mtype.to_bytes())
            self.trainer.save_model(f)
        self.start_counter += 1

    def init(self) -> None:
        if self.continue_training and self.sync_latest_model():
            pass
        else:
            self.continue_training = 0
            if self.task == 0:
                self.trainer = create_svd_trainer(self.mtype)
                self._configure_trainer()
                self.trainer.init_model()
            elif self.task == 1:
                with open(self.name_model_in, "rb") as f:
                    self.mtype = SVDTypeParam.from_bytes(f.read(4))
                    self.trainer = create_svd_trainer(self.mtype)
                    self._configure_trainer()
                    self.trainer.load_model(f)
            else:
                raise ValueError("unknown task")
        self._configure_iterator()
        self.trainer.init_trainer()

    def run(self, conf_path: str, cli_args: List[str]) -> None:
        self.configure(conf_path, cli_args)
        self.init()
        if not self.silent:
            print("initializing end, start updating")
        start = time.time()
        if self.continue_training == 0:
            self.save_model()
        cc = self.max_round
        total_examples = 0
        while self.start_counter <= self.num_round and cc > 0:
            cc -= 1
            r = self.start_counter - 1
            self.trainer.set_round(r)
            round_t0 = time.perf_counter()
            for _ in range(self.train_repeat):
                self.trainer.update_all(self.dataset)
                self.trainer.finish_round()
            self.trainer.synchronize()
            self.round_seconds.append(time.perf_counter() - round_t0)
            total_examples += self.dataset_rows() * self.train_repeat
            if not self.silent:
                eps = total_examples / max(sum(self.round_seconds), 1e-9)
                print(
                    f"round {r:8d} done, {time.time() - start:.1f} sec elapsed, "
                    f"{eps:,.0f} examples/sec (training only)"
                )
                sys.stdout.flush()
            self.save_model()
        if not self.silent:
            print(f"updating end, {time.time()-start:.1f} sec in all")
