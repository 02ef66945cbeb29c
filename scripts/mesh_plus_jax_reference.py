#!/usr/bin/env python3
"""The JAX package's 2x2 mesh figures for chip_smoke.py's phase 20 on the CPU.

Writes the data of run ``--run`` with the JAX package's own writers (the
buffers of the phase that chip_smoke.MESH_PLUS_RUNS names), trains it with
mesh_data=2 mesh_model=2 on 4 of the 8 CPU devices through the JAX CLI's
SVDTrainTask and evaluates it with its SVDInferTask on the same mesh keys:
the test RMSE after the last round (a, d), the probe's (b, e, f; big slabs,
mesh_big=1), or P@20 of the ranker's pred file (c), whose last-round
checkpoint's ``w`` it also writes to scripts/mesh_plus_jax_rank_w.npy
(what the port's checkpoint is held to on the card).  chip_smoke.py holds
the port's runs to the figures this prints (JAX_MESH_PLUS).

    python scripts/mesh_plus_jax_reference.py --run a   # implicitFeedback, 2 rounds
    python scripts/mesh_plus_jax_reference.py --run c   # pairwiseRank, 2 rounds
    python scripts/mesh_plus_jax_reference.py --run d   # depth-2 stacked, 1 round
    python scripts/mesh_plus_jax_reference.py --run b   # bigSvdpp, 2 rounds (GBs, minutes)
    python scripts/mesh_plus_jax_reference.py --run e   # big multi-IMFB, 1 round
    python scripts/mesh_plus_jax_reference.py --run f   # bigSvdpp streamed, 1 round
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

RANK_W = pathlib.Path(__file__).resolve().parent / "mesh_plus_jax_rank_w.npy"
MESH_KEYS = ["mesh_data=2", "mesh_model=2"]


def write_data(tag, d):
    """The buffers of run ``tag`` in ``d``, written with the JAX package."""
    from svdfeature_tpu.cli import make_ugroup_buffer
    from svdfeature_tpu.data import csr
    from svdfeature_tpu.data.buffer import write_plus_buffer
    from svdfeature_tpu.data.text import load_plus_text

    data = chip_smoke.MESH_PLUS_RUNS[tag]["data"]
    if data == "implicitFeedback":
        chip_smoke.write_implicit(d, make_ugroup_buffer.main)
    elif data == "pairwiseRank":
        chip_smoke.write_rank(d, make_ugroup_buffer.main)
    elif data == "multiIMFBStacked":
        chip_smoke.write_imfb(d, load_plus_text, csr, write_plus_buffer, make_ugroup_buffer.main)
    else:
        chip_smoke.write_big_plus(d, csr, write_plus_buffer, *chip_smoke.big_plus_arrays())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", choices=sorted(chip_smoke.MESH_PLUS_RUNS), required=True)
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()
    tag = args.run
    R = chip_smoke.MESH_PLUS_RUNS[tag]["rounds"]

    import jax

    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    assert len(jax.devices("cpu")) >= 4, "the 2x2 mesh needs 4 CPU devices"
    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        t0 = time.perf_counter()
        write_data(tag, work)
        t_data = time.perf_counter() - t0
        train, infer = chip_smoke.mesh_plus_args(tag, work, work)
        keys = MESH_KEYS + (["mesh_big=1"] if chip_smoke.MESH_PLUS_RUNS[tag]["big"]
                            else [])
        task = SVDTrainTask()
        t0 = time.perf_counter()
        task.run(str(train[0]), [*map(str, train[1:]), *keys])
        t_train = time.perf_counter() - t0
        tr = task.trainer
        assert tr._mesh is not None, "the run did not take the mesh"
        SVDInferTask().run(str(infer[0]), [*map(str, infer[1:]), *keys])
        if tag == "c":
            from svdfeature_tpu import model as jmodel
            from svdfeature_tpu.params import SVDTypeParam

            with open(work / "models" / f"{R:04d}.model", "rb") as f:
                m = jmodel.SVDModel.load(f, SVDTypeParam.from_bytes(f.read(4)))
            np.save(RANK_W, np.asarray(m.w, np.float32))
            figure = f"P@20 {chip_smoke.rank_p20(work / 'pred.txt'):.6f} (w written to {RANK_W})"
        else:
            figure = "RMSE round {} {}".format(*(work / "eval.tsv").read_text().split())
        print(f"mesh JAX CPU: run ({tag}) {' '.join(map(str, train[1:]))} {' '.join(keys)}: "
              f"trainer {type(tr).__name__} mesh_big={bool(tr._mesh_big)}: {figure} "
              f"(data {t_data:.1f} s, SVDTrainTask {t_train:.1f} s with its saves)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
