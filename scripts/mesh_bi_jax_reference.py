#!/usr/bin/env python3
"""The JAX package's 2x2 mesh figures for chip_smoke.py's phase 21 on the CPU.

Writes the data of run ``--run`` with the JAX package's own writers (phase
16's buffers: the implicitFeedback demo's for (a), bigSvdpp's geometry cut
to its first 20,000 users with two property ids each for (b)), trains it
with extend_type=15 and mesh_data=2 mesh_model=2 on 4 of the 8 CPU devices
through the JAX CLI's SVDTrainTask and evaluates it with its SVDInferTask
on the same mesh keys: the test RMSE after the last round (a) or the
probe's (b; big slabs, mesh_big=1).  For (a) it also writes the last round's
checkpoint's ``w`` and the rows chip_smoke.mesh_bi_wbi_rows() of its W_bi
to scripts/mesh_bi_jax_a.npz (what the port's checkpoint is held to on the
card).  chip_smoke.py holds the port's runs to the figures this prints
(JAX_MESH_BI).

    python scripts/mesh_bi_jax_reference.py --run a   # item-item W_bi, 2 rounds
    python scripts/mesh_bi_jax_reference.py --run b   # big bilinear, 2 rounds (GBs, minutes)
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

CHECKPOINT = pathlib.Path(__file__).resolve().parent / "mesh_bi_jax_a.npz"
MESH_KEYS = ["mesh_data=2", "mesh_model=2"]


def read_checkpoint(path):
    """(w, W_bi) of a bilinear checkpoint, read with the JAX package."""
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.bilinear import SVDBiLinearTrainer

    with open(path, "rb") as f:
        tr = SVDBiLinearTrainer(SVDTypeParam.from_bytes(f.read(4)))
        tr.load_model(f)
    return np.asarray(tr.model.w, np.float32), np.asarray(tr.W_bi, np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", choices=sorted(chip_smoke.MESH_BI_RUNS), required=True)
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()
    tag = args.run
    run = chip_smoke.MESH_BI_RUNS[tag]
    R = run["rounds"]

    import jax

    from svdfeature_tpu.cli import make_ugroup_buffer
    from svdfeature_tpu.data import csr
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    assert len(jax.devices("cpu")) >= 4, "the 2x2 mesh needs 4 CPU devices"
    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        t0 = time.perf_counter()
        if run["big"]:
            chip_smoke.write_big_bilinear(work, csr, write_plus_buffer,
                                          *chip_smoke.big_plus_arrays())
        else:
            chip_smoke.write_implicit(work, make_ugroup_buffer.main)
        t_data = time.perf_counter() - t0
        train, infer = chip_smoke.mesh_bi_args(tag, work, work)
        keys = MESH_KEYS + (["mesh_big=1"] if run["big"] else [])
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(str(train[0]), [*map(str, train[1:]), *keys])
        t_train = time.perf_counter() - t0
        tr = task.trainer
        assert tr._mesh is not None, "the run did not take the mesh"
        SVDInferTask().run(str(infer[0]), [*map(str, infer[1:]), *keys])
        figure = "RMSE round {} {}".format(*(work / "eval.tsv").read_text().split())
        if tag == "a":
            w, wbi = read_checkpoint(work / "models" / f"{R:04d}.model")
            rows = chip_smoke.mesh_bi_wbi_rows(wbi.shape[0])
            np.savez(CHECKPOINT, w=w, rows=rows, W_bi=wbi[rows])
            figure += f" (w {w.shape} and W_bi rows {len(rows)} of {wbi.shape} to {CHECKPOINT})"
        print(f"mesh JAX CPU: run ({tag}) {' '.join(map(str, train[1:]))} {' '.join(keys)}: "
              f"trainer {type(tr).__name__} mesh_big={bool(tr._mesh_big)}: {figure} "
              f"(data {t_data:.1f} s, SVDTrainTask {t_train:.1f} s with its saves)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
