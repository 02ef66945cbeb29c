#!/usr/bin/env python3
"""The JAX package's test RMSE on chip_smoke.py's bigTable phase (phase 7).

Writes the same data (chip_smoke.bigtable_arrays: bench.py's bigTable
recipe) with the JAX package's buffer writer, trains it through the JAX
CLI's SVDTrainTask on the CPU and evaluates the probe (the first 4096
training rows) with SVDInferTask, for rounds 0 and ``--rounds``.
chip_smoke.py holds the port's runs on the card to the figures this
prints (its JAX_BIG_RMSE constants).

    JAX_PLATFORMS=cpu python scripts/bigtable_jax_reference.py --batch-size 1048576 --big-sweep 0
    JAX_PLATFORMS=cpu python scripts/bigtable_jax_reference.py --batch-size 4096
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, required=True)
    ap.add_argument("--big-sweep", type=int, default=-1)
    ap.add_argument("--rounds", type=int, default=chip_smoke.BIG_ROUNDS)
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()

    from svdfeature_tpu.data.buffer import write_csr_buffer
    from svdfeature_tpu.data.csr import CSRDataset
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        t0 = time.perf_counter()
        conf, _ = chip_smoke.write_bigtable(CSRDataset, write_csr_buffer, work,
                                            chip_smoke.bigtable_arrays())
        t_data = time.perf_counter() - t0
        common = [f"model_out_folder={work}/models"]
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(str(conf), common + [f"num_round={args.rounds}",
                                      f"batch_size={args.batch_size}",
                                      f"big_sweep={args.big_sweep}"])
        t_train = time.perf_counter() - t0
        hp = task.trainer.hp
        log = work / "rmse.tsv"
        SVDInferTask().run(str(conf), common + ["start=0", f"end={args.rounds + 1}",
                                                f"step={args.rounds}", f"log_eval={log}"])
        rmse = dict(line.split() for line in log.read_text().splitlines())
        print(f"bigTable JAX CPU: batch_size={args.batch_size} big_sweep={args.big_sweep} "
              f"route={'sweep' if hp.sweep_table else 'dedup'} rounds={args.rounds} "
              f"rmse round 0 {rmse['0']} round {args.rounds} {rmse[str(args.rounds)]} "
              f"(data {t_data:.1f} s, SVDTrainTask {t_train:.1f} s with its saves)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
