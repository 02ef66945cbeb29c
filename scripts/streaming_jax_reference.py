#!/usr/bin/env python3
"""The JAX package's streamed runs of chip_smoke.py's phase 18 on the CPU.

Writes the data of the phase that run ``--run`` streams (b: the
implicitFeedback buffers of phase 5; d: bigSvdpp's of phase 11; e: the
depth-2 stacked set of phase 9) with the JAX package's own writers, trains
it with streaming=1 at the phase's conf keys and chunks
(chip_smoke.STREAM_RUNS) through the JAX CLI's SVDTrainTask, and evaluates
the test set (b, e: after the last round) or the probe (d: rounds 0 and R),
read a chunk at a time too, with SVDInferTask.  chip_smoke.py holds the
port's runs on the card to the last figure this prints (its
JAX_STREAM_RMSE constants).

    JAX_PLATFORMS=cpu python scripts/streaming_jax_reference.py --run b   # SVD++, 40 rounds
    JAX_PLATFORMS=cpu python scripts/streaming_jax_reference.py --run d   # bigSvdpp, 2 rounds
    JAX_PLATFORMS=cpu python scripts/streaming_jax_reference.py --run e   # stacked, 8 rounds

Runs (a) and (c) stream bigTable in chunks of whole batches, so they are
held to the staged figures of scripts/bigtable_jax_reference.py.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (numpy only at import)


def write_data(tag, d):
    """The buffers of run ``tag`` in ``d``, written with the JAX package."""
    from svdfeature_tpu.cli import make_ugroup_buffer
    from svdfeature_tpu.data import csr
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.text import load_plus_text

    if tag == "b":
        chip_smoke.write_implicit(d, make_ugroup_buffer.main)
    elif tag == "d":
        chip_smoke.write_big_plus(d, csr, write_plus_buffer, *chip_smoke.big_plus_arrays())
    else:
        chip_smoke.write_imfb(d, load_plus_text, csr, write_plus_buffer, make_ugroup_buffer.main)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", choices=["b", "d", "e"], required=True)
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()
    R = chip_smoke.STREAM_RUNS[args.run]["rounds"]

    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        t0 = time.perf_counter()
        write_data(args.run, work)
        t_data = time.perf_counter() - t0
        conf, keys = chip_smoke.stream_task_args(args.run, work)
        common = [*keys, f"model_out_folder={work}/models", "silent=1"]
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(str(conf), common + [f"num_round={R}"])
        t_train = time.perf_counter() - t0
        assert hasattr(task.dataset, "plan_caps"), "the run did not stream"
        log = work / "rmse.tsv"
        SVDInferTask().run(str(conf), common + [*chip_smoke.stream_evals(args.run),
                                                f"log_eval={log}"])
        rmse = " ".join("round {} {}".format(*line.split())
                        for line in log.read_text().splitlines())
        print(f"streamed JAX CPU: run ({args.run}) {' '.join(keys)} trainer "
              f"{type(task.trainer).__name__} big_table={task.trainer.hp.big_table} "
              f"rounds={R}: {rmse} (data {t_data:.1f} s, SVDTrainTask {t_train:.1f} s "
              f"with its saves)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
