"""Training task: the round loop with per-round checkpoints.

Counterpart of svdfeature_tpu/train/loop.py (SVDTrainTask,
svd_feature.cpp:34-296): configure from .conf + CLI overlay, create the
solver via the port's registry, continue-from-latest (scanning
models/%04d.model), run num_round rounds saving one model per round, with
a progress/throughput line per round.

The JAX loop's keys (train/loop.py:42-44, 65-79, 166-235): ``log_jsonl``
appends one JSON line a round (``round``, ``elapsed_s``, ``round_s``,
``examples``, ``learning_rate``); ``debug_checks=1`` checks after each
round that w, b and g are finite and raises FloatingPointError;
``profile_dir`` traces the first trained round with torch.profiler and
writes a Chrome trace there (``round<r>.rank<k>.pt.trace.json``);
``print_ratio`` is parsed and read nowhere, as in JAX; ``trace=1`` turns
the port's tracer on (``tracing.py``) for the rounds and, with
``log_jsonl``, adds to each round's line the self milliseconds of its
spans by name (``span_self_ms``) and its counts (``counters``: steps, host
syncs, kernel launches); ``distributed=1``
joins the torchrun world (parallel/comm.init_distributed) before any
tensor is made, on the rank's card.  In a world of several ranks, rank 0
alone prints, writes the checkpoints and the JSON lines; the other ranks
of a mesh take part in each checkpoint's unshard.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Optional

from .. import tracing
from ..config import ConfigSaver
from ..data.registry import IteratorConfig, load_csr_source, load_plus_source
from ..parallel import comm
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
        self.print_ratio = 0.05
        self.input_type = input_type.BINARY_BUFFER
        self.trainer = None
        self.dataset = None
        # seconds of each round's training, device work included and the
        # model save excluded
        self.round_seconds: List[float] = []
        # observability: the per-round JSON log, the profiler trace of the
        # first trained round, the finite checks
        self.log_jsonl: Optional[str] = None
        self.profile_dir: Optional[str] = None
        self.debug_checks = 0
        self.trace = 0
        self.distributed = 0
        self.device_name = "cuda"

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
        if name == "print_ratio":
            self.print_ratio = float(val)
        if name == "input_type":
            self.input_type = int(val)
        if name == "log_jsonl":
            self.log_jsonl = val
        if name == "profile_dir":
            self.profile_dir = val
        if name == "debug_checks":
            self.debug_checks = int(val)
        if name == "trace":
            self.trace = int(val)
        if name == "distributed":
            self.distributed = int(val)
        if name == "device":
            self.device_name = val
        self.mtype.set_param(name, val)

    def configure(self, conf_path: str, cli_args: List[str]) -> None:
        self.cfg.load_file(conf_path)
        self.cfg.load_cli(cli_args)
        for name, val in self.cfg:
            self.set_param_inner(name, val)
        self.mtype.decide_format(
            svd_type.USER_GROUP_FORMAT if self.input_type == 2 else svd_type.AUTO_DETECT
        )
        if self.distributed:
            # before the trainer makes any tensor: each rank on its card
            comm.init_distributed(self.device_name)

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
        if comm.rank() == 0:
            os.makedirs(self.name_model_out_folder or ".", exist_ok=True)
            with open(self._model_path(self.start_counter), "wb") as f:
                f.write(self.mtype.to_bytes())
                self.trainer.save_model(f)
        elif getattr(self.trainer, "mesh", None) is not None:
            self.trainer.save_model(None)  # its part of the unshard, nothing written
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
        if comm.rank():  # the world is joined by now, by distributed=1 or the mesh
            self.silent = 1
        if not self.silent:
            print("initializing end, start updating")
        start = time.time()
        if self.continue_training == 0:
            self.save_model()
        cc = self.max_round
        total_examples = 0
        log_f = open(self.log_jsonl, "a") if self.log_jsonl and comm.rank() == 0 else None
        profiling = bool(self.profile_dir)
        if self.trace:
            tracing.enable()
        try:
            while self.start_counter <= self.num_round and cc > 0:
                cc -= 1
                r = self.start_counter - 1
                self.trainer.set_round(r)
                prof = self._start_profile() if profiling else None
                round_t0 = time.perf_counter()
                for _ in range(self.train_repeat):
                    self.trainer.update_all(self.dataset)
                    self.trainer.finish_round()
                self.trainer.synchronize()
                self.round_seconds.append(time.perf_counter() - round_t0)
                if prof is not None:
                    self._stop_profile(prof, r)
                    profiling = False
                if self.debug_checks:
                    self._check_state(r)
                total_examples += self.dataset_rows() * self.train_repeat
                elapsed = time.time() - start
                if not self.silent:
                    eps = total_examples / max(sum(self.round_seconds), 1e-9)
                    print(
                        f"round {r:8d} done, {elapsed:.1f} sec elapsed, "
                        f"{eps:,.0f} examples/sec (training only)"
                    )
                    sys.stdout.flush()
                line = dict(
                    round=r, elapsed_s=round(elapsed, 3),
                    round_s=round(self.round_seconds[-1], 3), examples=total_examples,
                    learning_rate=getattr(self.trainer, "learning_rate", None))
                if self.trace:
                    spans, counters = tracing.drain()
                    line.update(span_self_ms={n: round(ns / 1e6, 3) for n, ns in
                                              sorted(tracing.self_ns(spans).items())},
                                counters=counters)
                if log_f:
                    log_f.write(json.dumps(line) + "\n")
                    log_f.flush()
                self.save_model()
        finally:
            if self.trace:
                tracing.disable()
            if log_f:
                log_f.close()
        comm.barrier()  # rank 0's checkpoints are on disk for every rank
        if not self.silent:
            print(f"updating end, {time.time()-start:.1f} sec in all")

    def _start_profile(self):
        """torch.profiler over the first trained round (the CPU, and the
        card when the trainer is on one)."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        state = getattr(self.trainer, "state", None)
        if state is not None and state.w.is_cuda:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, r: int) -> None:
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.profile_dir, f"round{r}.rank{comm.rank()}.pt.trace.json"))

    def _check_state(self, r: int) -> None:
        """debug_checks=1: the parameters stay finite after each round (the
        device-side analogue of the reference's assert_true bound checks;
        index bounds are checked at pack time).  Each rank counts the
        non-finite values of its own slab and the counts are summed over the
        world, so that every rank raises in the same round."""
        import torch

        st = getattr(self.trainer, "state", None)
        if st is None:
            return
        names = ("w", "b", "g")
        bad = comm.world_sum(torch.stack([(~torch.isfinite(getattr(st, n))).sum() for n in names]))
        for name, count in zip(names, bad.tolist()):
            if count:
                raise FloatingPointError(f"non-finite values in model.{name} after round {r}")
