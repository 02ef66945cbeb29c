#!/usr/bin/env python3
"""The JAX package's APLambda GBRT scores on chip_smoke.py's GBRT phase
(phase 17 (c)).

Writes the pairwiseRank buffers (chip_smoke.write_rank) with the JAX
package's make_ugroup_buffer, trains APLambda (extend_type=30,
chip_smoke.APLAMBDA_KEYS beside pairwiseRank.conf: the training set read
as plain user-group data) for chip_smoke.APLAMBDA_ROUNDS rounds through the
JAX CLI's SVDTrainTask on the CPU, predicts the implicitFeedback test set
(chip_smoke.write_implicit) with SVDInferTask (pred, binary f32) and prints
the summary that chip_smoke.py holds the port's run on the card to (its
JAX_APLAMBDA constant).

    JAX_PLATFORMS=cpu python scripts/gbrt_jax_reference.py
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (numpy only at import)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()

    from svdfeature_tpu.cli import make_ugroup_buffer
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        keys = chip_smoke.write_rank(work, make_ugroup_buffer.main)
        (work / "implicit").mkdir()
        chip_smoke.write_implicit(work / "implicit", make_ugroup_buffer.main)
        conf = str(ROOT / "demo" / "pairwiseRank" / "pairwiseRank.conf")
        R = chip_smoke.APLAMBDA_ROUNDS
        common = [*keys, f"model_out_folder={work}/models", *chip_smoke.APLAMBDA_KEYS,
                  f"test:buffer_feature={work}/implicit/test.buffer"]
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(conf, common + [f"num_round={R}"])
        t_train = time.perf_counter() - t0
        pred = work / "pred.bin"
        SVDInferTask().run(conf, common + [f"pred={R}", "pred_binary=1", f"name_pred={pred}"])
        summary = chip_smoke.score_summary(np.fromfile(pred, "<f4"))
        print(f"APLambda JAX CPU: {type(task.trainer).__name__}, {R} rounds on "
              f"{task.dataset.rows.num_row:,} training rows (SVDTrainTask {t_train:.1f} s with its "
              f"saves), scores of {summary['n']:,} test rows:", flush=True)
        print(json.dumps(summary))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
