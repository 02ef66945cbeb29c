#!/usr/bin/env python3
"""The JAX lite trainer's 2x2 CPU mesh figures for chip_smoke.py's phase 19 (d).

Writes basicMF's train and test buffers from the ML-100K fixtures with the
JAX package's make_feature_buffer (as chip_smoke.py phase 3 writes them
with the port's), trains the lite example solver (extend_type 99,
chip_smoke.LITE_KEYS: batch_size 4095, which the mesh rounds up to 4096)
LITE_ROUNDS rounds with mesh_data=2 mesh_model=2 on 4 of 8 CPU devices
through the JAX CLI's SVDTrainTask, and evaluates the last round with its
SVDInferTask on the same keys: the test RMSE and the mean |w| of the last
checkpoint.  chip_smoke.py holds the port's run in its torchrun world to
these figures (JAX_LITE_MESH).

    python scripts/lite_mesh_jax_reference.py
"""

from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# before the first import of jax: eight CPU devices, no accelerator
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_NUM_CPU_DEVICES"] = "8"

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402  (numpy only at import)

MESH_KEYS = ["mesh_data=2", "mesh_model=2", "silent=1"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()

    import jax

    import svdfeature_tpu.solvers.example  # noqa: F401  (registers extend_type 99)
    from svdfeature_tpu import model as jmodel
    from svdfeature_tpu.cli import make_feature_buffer
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.train.loop import SVDTrainTask

    assert len(jax.devices("cpu")) >= 4, "the 2x2 mesh needs 4 CPU devices"
    R = chip_smoke.LITE_ROUNDS
    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        mf = work / "basicMF"
        mf.mkdir()
        for fx, split in zip(chip_smoke.DEMOS["basicMF"], ("train", "test")):
            chip_smoke.unzip_fixture(fx, mf / f"{split}.feature")
            make_feature_buffer.main([str(mf / f"{split}.feature"), str(mf / f"{split}.buffer")])
        train, infer = chip_smoke.lite_args(mf)
        models = f"model_out_folder={work}/models"
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(str(train[0]), [*map(str, train[1:]), *MESH_KEYS, models])
        t_train = time.perf_counter() - t0
        tr = task.trainer
        assert type(tr).__name__ == "SVDFeatureLiteTrainer" and tr._mesh is not None
        log = work / "eval.tsv"
        SVDInferTask().run(str(infer[0]), [*map(str, infer[1:]), *MESH_KEYS, models,
                                           f"log_eval={log}"])
        with open(work / "models" / f"{R:04d}.model", "rb") as f:
            m = jmodel.SVDModel.load(f, SVDTypeParam.from_bytes(f.read(4)))
        mean_w = float(np.abs(np.asarray(m.w, np.float64)).mean())
        print(f"lite mesh JAX CPU: {' '.join(map(str, train[1:]))} {' '.join(MESH_KEYS)}: batch "
              f"{tr.batch_size}, RMSE round {' '.join(log.read_text().split())}, mean |w| "
              f"{mean_w:.9f} (SVDTrainTask {t_train:.1f} s with its saves)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
