#!/usr/bin/env python3
"""The JAX package's test (or probe) RMSE on chip_smoke.py's bilinear phase
(phase 16, extend_type=15).

Writes the data of each run of chip_smoke.BI_RUNS with the JAX package's
own tools: the implicitFeedback demo's buffers (make_ugroup_buffer -fd,
runs a and b), the follow data of phase 15 (chip_smoke.write_follow, run
c), or bigSvdpp's geometry cut to its first 20,000 users with two
property ids each (chip_smoke.write_big_bilinear, run d); trains it
through the JAX CLI's SVDTrainTask on the CPU and evaluates every round
(run d: rounds 0 and the last, on the probe) with SVDInferTask.
chip_smoke.py holds the port's runs on the card to the last round's
figure (its JAX_BILINEAR_RMSE constants); run a prints the trajectory that
phase 16 (a) holds to golden/bilinear.rmse.tsv.

    JAX_PLATFORMS=cpu python scripts/bilinear_jax_reference.py --run a   # num_bi_feedback=0, 3 rounds
    JAX_PLATFORMS=cpu python scripts/bilinear_jax_reference.py --run b   # item-item W_bi, 2 rounds
    JAX_PLATFORMS=cpu python scripts/bilinear_jax_reference.py --run c   # follow data, 3 rounds
    JAX_PLATFORMS=cpu python scripts/bilinear_jax_reference.py --run d   # big table, 2 rounds
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
    ap.add_argument("--run", choices=sorted(chip_smoke.BI_RUNS), required=True)
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()
    run = chip_smoke.BI_RUNS[args.run]
    R = run["rounds"]

    from svdfeature_tpu.cli import make_ugroup_buffer
    from svdfeature_tpu.data import csr
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.text import load_plus_text
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        t0 = time.perf_counter()
        common = [f"buffer_feature={work}/train.buffer", f"model_out_folder={work}/models",
                  "silent=1", *run["keys"]]
        if run["data"] == "bigBilinear":
            conf = str(chip_smoke.write_big_bilinear(work, csr, write_plus_buffer,
                                                     *chip_smoke.big_plus_arrays()))
            evals = ["start=0", f"end={R + 1}", f"step={R}"]
        else:
            if run["data"] == "follow":
                chip_smoke.write_follow(work, load_plus_text, csr, write_plus_buffer)
            else:
                chip_smoke.write_implicit(work, make_ugroup_buffer.main)
            conf = str(ROOT / "demo" / "implicitFeedback" / "implicitFeedback.conf")
            common.append(f"test:buffer_feature={work}/test.buffer")
            evals = ["start=1", f"end={R + 1}"]
        t_data = time.perf_counter() - t0
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(conf, common + [f"num_round={R}"])
        t_train = time.perf_counter() - t0
        log = work / "rmse.tsv"
        SVDInferTask().run(conf, common + evals + [f"log_eval={log}"])
        traj = " ".join(f"{r}:{v}" for r, v in (line.split() for line in log.read_text().splitlines()))
        print(f"bilinear JAX CPU: run ({args.run}) {' '.join(run['keys'])} "
              f"{type(task.trainer).__name__} big_table={task.trainer.hp.big_table} RMSE by round "
              f"{traj} (data {t_data:.1f} s, SVDTrainTask {t_train:.1f} s with its saves)",
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
