#!/usr/bin/env python3
"""The JAX package's probe RMSE on chip_smoke.py's bigSvdpp phase (phase 11).

Writes the same data (chip_smoke.big_plus_arrays: bench.py's bigSvdpp
recipe) with the JAX package's classes and buffer writer, trains it through
the JAX CLI's SVDTrainTask on the CPU and evaluates the probe (the first
2000 user blocks) with SVDInferTask, for rounds 0 and ``--rounds``.
chip_smoke.py holds the port's runs on the card to the figures this prints
(its JAX_BIG_PLUS_RMSE constants).

    JAX_PLATFORMS=cpu python scripts/bigsvdpp_jax_reference.py --run a   # user-carry epoch, 3 rounds
    JAX_PLATFORMS=cpu python scripts/bigsvdpp_jax_reference.py --run c   # reg_method=4, 1 round
    JAX_PLATFORMS=cpu python scripts/bigsvdpp_jax_reference.py --run d   # stacked, 2 rounds

Run (b) of the phase is (a) on the port's plain writer, so it shares (a)'s
figure.
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
    ap.add_argument("--run", choices=["a", "c", "d"], required=True)
    ap.add_argument("--rounds", type=int, default=None, help="default: the phase's own")
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()
    run = chip_smoke.BIG_PLUS_RUNS[args.run]
    rounds = args.rounds or run["rounds"]

    from svdfeature_tpu.data import csr
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        t0 = time.perf_counter()
        conf = chip_smoke.write_big_plus(work, csr, write_plus_buffer,
                                         *chip_smoke.big_plus_arrays())
        t_data = time.perf_counter() - t0
        common = [f"buffer_feature={work}/{run['buffer']}", f"model_out_folder={work}/models",
                  *run["keys"]]
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(str(conf), common + [f"num_round={rounds}"])
        t_train = time.perf_counter() - t0
        hp = task.trainer.hp
        log = work / "rmse.tsv"
        SVDInferTask().run(str(conf), common + ["start=0", f"end={rounds + 1}",
                                                f"step={rounds}", f"log_eval={log}"])
        rmse = dict(line.split() for line in log.read_text().splitlines())
        print(f"bigSvdpp JAX CPU: run ({args.run}) {' '.join(run['keys'])} "
              f"big_table={hp.big_table} rounds={rounds} rmse round 0 {rmse['0']} round "
              f"{rounds} {rmse[str(rounds)]} (data {t_data:.1f} s, SVDTrainTask {t_train:.1f} s "
              f"with its saves)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
