#!/usr/bin/env python3
"""The JAX package's figures for chip_smoke.py's pairwise-rank phases (13, 14).

Default: pairwiseRank (demo/pairwiseRank) through the JAX CLI on the CPU,
as demo/pairwiseRank/run.sh runs it: make_ugroup_buffer on the ML-100K
rank fixtures, SVDTrainTask for 40 rounds (the per-round pair path, with
PairSource's sampling stream), SVDInferTask pred=40 with the ranker, and
P@20 as demo/pairwiseRank/eval.py computes it (chip_smoke.JAX_RANK_P20).

``--big``: bigRank run (a), bench.py's KDD-Cup-geometry rank data
(chip_smoke.big_rank_arrays, numpy) on the trainer at bench.py's conf,
two rounds of update_all (the per-round path: on the CPU the JAX package
takes it for update_rounds too), then the raw-margin order accuracy of a
fresh seed-77 epoch's first 2000 user blocks, and their mean raw margin
(chip_smoke.JAX_BIG_RANK).

    JAX_PLATFORMS=cpu python scripts/rank_jax_reference.py            # about 1 minute
    JAX_PLATFORMS=cpu python scripts/rank_jax_reference.py --big      # a few minutes, several GB
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


def pairwise_rank(workdir) -> None:
    from svdfeature_tpu.cli.make_ugroup_buffer import main as make_ugroup_main
    from svdfeature_tpu.infer.task import SVDInferTask
    from svdfeature_tpu.train.loop import SVDTrainTask

    d = pathlib.Path(tempfile.mkdtemp(dir=workdir))
    try:
        keys = chip_smoke.write_rank(d, make_ugroup_main) + [f"model_out_folder={d}/models"]
        conf = str(ROOT / "demo" / "pairwiseRank" / "pairwiseRank.conf")
        R = chip_smoke.RANK_ROUNDS
        t0 = time.perf_counter()
        SVDTrainTask().run(conf, keys + [f"num_round={R}"])
        t_train = time.perf_counter() - t0
        SVDInferTask().run(conf, keys + [f"pred={R}", f"name_pred={d}/pred.txt"])
        p20 = chip_smoke.rank_p20(d / "pred.txt")
        print(f"pairwiseRank JAX CPU: {R} rounds, P@20 {p20:.6f} (hits {round(p20 * 943 * 20)}; "
              f"SVDTrainTask {t_train:.1f} s with its saves)", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def big_rank() -> None:
    from svdfeature_tpu.data import csr, rank, registry
    from svdfeature_tpu.params import SVDTypeParam
    from svdfeature_tpu.solvers.svdpp import SVDPPFeatureTrainer

    t0 = time.perf_counter()
    arrays, dims = chip_smoke.big_rank_arrays()
    tr = chip_smoke.big_rank_trainer(SVDPPFeatureTrainer, SVDTypeParam, dims)
    src = rank.PairSource(chip_smoke.plus_dataset(csr, arrays), registry.IteratorConfig(), seed=10)
    t_setup = time.perf_counter() - t0
    R = chip_smoke.BIG_RANK_RUNS["a"]["rounds"]
    t0 = time.perf_counter()
    for _ in range(R):
        tr.update_all(src)
    int(tr.state.step)
    t_train = time.perf_counter() - t0
    head, pairs = chip_smoke.big_rank_probe_set(csr, rank, registry, arrays)
    acc, margin = chip_smoke.big_rank_probe(tr, head)
    print(f"bigRank JAX CPU: run (a) per-round path, big_table={tr.hp.big_table}, {R} rounds of "
          f"{pairs:,} pairs: probe order accuracy {acc:.6f}, mean margin {margin:.6f} (set-up "
          f"{t_setup:.1f} s, training {t_train:.1f} s)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--big", action="store_true", help="bigRank run (a) instead of pairwiseRank")
    ap.add_argument("--workdir", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()
    if args.big:
        big_rank()
    else:
        pairwise_rank(args.workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
