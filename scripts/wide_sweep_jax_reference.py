#!/usr/bin/env python3
"""The JAX package's probe RMSE on chip_smoke.py's wide-row table (phase 7 (e)).

Writes the data of chip_smoke.WIDE_CONF (bench.py's bigTable recipe,
chip_smoke.bigtable_arrays, cut to WIDE_NU users, WIDE_NI items and
WIDE_EX examples, k = WIDE_K = 300) with the JAX package's buffer writer,
trains it WIDE_ROUNDS rounds at batch WIDE_BATCH with big_sweep=1 (the
tile sweep, its Pallas kernel in interpret mode) through the JAX CLI's
SVDTrainTask on the CPU and evaluates the probe (the first 4096 training
rows) with SVDInferTask at rounds 0 and WIDE_ROUNDS.  chip_smoke.py holds
the port's run on the card to the figure this prints (JAX_WIDE_RMSE).

    JAX_PLATFORMS=cpu python scripts/wide_sweep_jax_reference.py
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
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()

    from svdfeature_tpu.data.buffer import write_csr_buffer
    from svdfeature_tpu.data.csr import CSRDataset
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    cs = chip_smoke
    R = cs.WIDE_ROUNDS
    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        conf, _ = cs.write_bigtable(CSRDataset, write_csr_buffer, work,
                                    cs.bigtable_arrays(cs.WIDE_NU, cs.WIDE_NI, cs.WIDE_EX),
                                    cs.WIDE_CONF)
        common = [f"model_out_folder={work}/models"]
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(str(conf), common + [f"num_round={R}", f"batch_size={cs.WIDE_BATCH}",
                                      "big_sweep=1"])
        t_train = time.perf_counter() - t0
        assert task.trainer.hp.sweep_table
        log = work / "rmse.tsv"
        SVDInferTask().run(str(conf), common + ["start=0", f"end={R + 1}", f"step={R}",
                                                f"log_eval={log}"])
        rmse = dict(line.split() for line in log.read_text().splitlines())
        print(f"wide rows JAX CPU: k={cs.WIDE_K} rows={cs.WIDE_NU + cs.WIDE_NI + 1} "
              f"batch_size={cs.WIDE_BATCH} big_sweep=1 rmse round 0 {rmse['0']} round {R} "
              f"{rmse[str(R)]} (SVDTrainTask {t_train:.1f} s with its saves)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
