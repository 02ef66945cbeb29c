#!/usr/bin/env python3
"""The JAX package's test RMSE on chip_smoke.py's general-route cells
(phase 10): configurations that no kernel of the port takes.

Writes the demos' buffers from the ML-100K fixtures with the JAX
package's own buffer tools (as chip_smoke.py phases 3 and 5 write them
with the port's), trains each cell of ``chip_smoke.GENERAL`` (basicMF at
reg_method=1, binaryClassification at active_type=5, implicitFeedback at
reg_method=4) for ``chip_smoke.GENERAL_ROUNDS`` rounds through the JAX
CLI's SVDTrainTask on the CPU (its jnp path) and evaluates the last round
with SVDInferTask.  chip_smoke.py holds the port's runs on the card to
these figures (its JAX_GENERAL_RMSE constant).

    JAX_PLATFORMS=cpu python scripts/general_jax_reference.py
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

FEEDBACK = {  # the implicitFeedback demo's fixtures (chip_smoke.phase_svdpp_slice)
    "train": ("ml100k.base.group.feature.gz", "ml100k.base.feedback.gz"),
    "test": ("ml100k.test.ug.feature.gz", "ml100k.test.feedback.gz"),
}


def write_buffers(d: pathlib.Path, demo: str) -> None:
    """The train and test buffers of ``demo`` in directory ``d``."""
    from svdfeature_tpu.cli import make_feature_buffer, make_ugroup_buffer

    d.mkdir(parents=True)
    if demo == "implicitFeedback":
        for split, (fx, fb_fx) in FEEDBACK.items():
            chip_smoke.unzip_fixture(fx, d / f"{split}.feature")
            chip_smoke.unzip_fixture(fb_fx, d / f"{split}.feedback")
            make_ugroup_buffer.main([str(d / f"{split}.feature"), str(d / f"{split}.buffer"),
                                     "-fd", str(d / f"{split}.feedback")])
        return
    for fx, split in zip(chip_smoke.DEMOS[demo], ("train", "test")):
        chip_smoke.unzip_fixture(fx, d / f"{split}.feature")
        make_feature_buffer.main([str(d / f"{split}.feature"), str(d / f"{split}.buffer")])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=chip_smoke.GENERAL_ROUNDS)
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()

    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    work = pathlib.Path(tempfile.mkdtemp(dir=args.workdir))
    try:
        for name, (demo, extra) in chip_smoke.GENERAL.items():
            d = work / demo
            if not d.exists():
                write_buffers(d, demo)
            conf = str(ROOT / "demo" / demo / f"{demo}.conf")
            common = [f"buffer_feature={d}/train.buffer", f"test:buffer_feature={d}/test.buffer",
                      f"model_out_folder={d}/models_{len(extra)}_{abs(hash(name))}",
                      "silent=1", *extra]
            t0 = time.perf_counter()
            SVDTrainTask().run(conf, common + [f"num_round={args.rounds}"])
            t_train = time.perf_counter() - t0
            log = d / "rmse.tsv"
            SVDInferTask().run(conf, common + [f"start={args.rounds}", f"end={args.rounds + 1}",
                                               f"log_eval={log}"])
            rmse = log.read_text().split()[-1]
            print(f"general route JAX CPU: {name} test RMSE after {args.rounds} rounds {rmse} "
                  f"(SVDTrainTask {t_train:.1f} s with its saves)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
