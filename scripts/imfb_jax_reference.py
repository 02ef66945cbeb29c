#!/usr/bin/env python3
"""The JAX package's test RMSE trajectory on chip_smoke.py's stacked slice
(phase 9).

Writes the same buffers (chip_smoke.write_imfb: the depth-2 transform of
the implicitFeedback train set, the stock test set) with the JAX package's
parser and writers, trains extend_type=2 on the implicitFeedback conf
through the JAX CLI's SVDTrainTask on the CPU (file order, 128 units per
step, ``--rows-per-user`` rows of each) and evaluates every round with
SVDInferTask.  chip_smoke.py holds the port's run on the card to the
last round's figure (its JAX_IMFB_RMSE constant).

    JAX_PLATFORMS=cpu python scripts/imfb_jax_reference.py --rows-per-user 8
    JAX_PLATFORMS=cpu python scripts/imfb_jax_reference.py --rows-per-user 1
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
    ap.add_argument("--rows-per-user", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=chip_smoke.IMFB_ROUNDS)
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()

    from svdfeature_tpu.cli import make_ugroup_buffer
    from svdfeature_tpu.data import csr
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.text import load_plus_text
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        chip_smoke.write_imfb(work, load_plus_text, csr, write_plus_buffer, make_ugroup_buffer.main)
        conf = str(ROOT / "demo" / "implicitFeedback" / "implicitFeedback.conf")
        common = [f"buffer_feature={work}/train.buffer", f"test:buffer_feature={work}/test.buffer",
                  f"model_out_folder={work}/models", "extend_type=2",
                  f"rows_per_user={args.rows_per_user}", "silent=1"]
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(conf, common + [f"num_round={args.rounds}"])
        t_train = time.perf_counter() - t0
        log = work / "rmse.tsv"
        SVDInferTask().run(conf, common + ["start=1", f"end={args.rounds + 1}", f"log_eval={log}"])
        traj = [line.split()[1] for line in log.read_text().splitlines()]
        print(f"stacked multi-IMFB JAX CPU: rows_per_user={args.rows_per_user} "
              f"rounds={args.rounds} test RMSE by round {' '.join(traj)} "
              f"(SVDTrainTask {t_train:.1f} s with its saves)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
