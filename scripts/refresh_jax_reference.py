#!/usr/bin/env python3
"""The JAX package's test RMSE on chip_smoke.py's shared-feedback-space phase
(phase 15: the per-batch refresh epochs).

Writes the same buffers (chip_smoke.write_follow: the implicitFeedback
train and test sets with user-space follow feedback, and the depth-2
stacked transform of the train set) with the JAX package's parser,
classes and writer, trains each run of chip_smoke.REFRESH_RUNS through the
JAX CLI's SVDTrainTask on the CPU (implicitFeedback.conf with
common_feedback_space=1) and evaluates every round with SVDInferTask.
chip_smoke.py holds the port's runs on the card to the last round's
figure (its JAX_REFRESH_RMSE constants).

    JAX_PLATFORMS=cpu python scripts/refresh_jax_reference.py --run a   # SVD++, 5 rounds
    JAX_PLATFORMS=cpu python scripts/refresh_jax_reference.py --run b   # stacked, 2 rounds
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
    ap.add_argument("--run", choices=sorted(chip_smoke.REFRESH_RUNS), required=True)
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()
    run = chip_smoke.REFRESH_RUNS[args.run]

    from svdfeature_tpu.data import csr
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.text import load_plus_text
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        chip_smoke.write_follow(work, load_plus_text, csr, write_plus_buffer)
        conf = str(ROOT / "demo" / "implicitFeedback" / "implicitFeedback.conf")
        common = [f"buffer_feature={work}/{run['buffer']}", f"test:buffer_feature={work}/test.buffer",
                  f"model_out_folder={work}/models", "silent=1", *run["keys"]]
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(conf, common + [f"num_round={run['rounds']}"])
        t_train = time.perf_counter() - t0
        log = work / "rmse.tsv"
        SVDInferTask().run(conf, common + ["start=1", f"end={run['rounds'] + 1}",
                                           f"log_eval={log}"])
        traj = [line.split()[1] for line in log.read_text().splitlines()]
        print(f"refresh JAX CPU: run ({args.run}) {' '.join(run['keys'])} "
              f"{type(task.trainer).__name__} test RMSE by round {' '.join(traj)} "
              f"(SVDTrainTask {t_train:.1f} s with its saves)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
