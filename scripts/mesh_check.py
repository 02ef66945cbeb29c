#!/usr/bin/env python3
"""Phases 19-21 of chip_smoke.py alone: the port's meshes on the node's GPUs.

Usage, from the repository root:

    python3 scripts/mesh_check.py

Builds the kernels and writes the data of the mesh runs as the earlier
phases do (basicMF and bigTable for phase 19; implicitFeedback, the rank
demo, the depth-2 stacked set and bigSvdpp for phase 20; implicitFeedback
and big bilinear for phase 21), then runs them in one torchrun call of 4
ranks (chip_smoke.mesh_call_all) and checks them with
``chip_smoke.phase_mesh``, ``phase_mesh_plus`` and ``phase_mesh_bi``: the
base solver (and the lite example solver, which keeps the whole table on
every rank), the SVD++ and multi-IMFB trainers and the bilinear trainer,
small and big slabs, K5 on the big ones.  With one card the ranks share it
through gloo; with four (one a rank) they take NCCL.  Unlike chip_smoke.py,
which holds the mesh runs to the single-card phases measured in the same
run, this script holds them to figures copied from earlier whole runs
(``PRIOR``); the K5 timings that need a single-card run's tensors (phase
20's pool writeback, phase 21's W_bi slab write) and the comparisons with
phase 16 (b) are left out.  Exits 1 if a check fails.
"""

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# copied from docs/chip_smoke_pr14_final.log: basicMF after 40 rounds
# (phase 3), bigTable (c) (phase 7, the JAX CPU figure too), bigSvdpp (a) at
# round 2 and its steps a round (phase 11 (a), 20 (b)), big multi-IMFB's steps
# a round (phase 20 (e)), big bilinear's probe at round 2 (phase 16 (d), the
# JAX CPU figure too) and the steps a round of phase 16 (b) and (d)
PHASE3_RMSE = 0.933293
PHASE7C_RMSE = 0.170851
PRIOR_PLUS = dict(rmse={2: 0.170734}, T={"b": 138, "e": 32}, pool=None)
PRIOR_BI = dict(rmse={"b": 0.167179}, T={"a": 515, "b": 50}, ckpt=None, wbi_call=None)


def write_data(work, cs):
    """The buffers of every mesh run, with the port's own tools."""
    from svdfeature_tpu_torch.cli import make_feature_buffer, make_ugroup_buffer
    from svdfeature_tpu_torch.data import csr
    from svdfeature_tpu_torch.data.buffer import write_csr_buffer, write_plus_buffer
    from svdfeature_tpu_torch.data.text import load_plus_text

    dirs = {name: work / name for name in ("basicMF", "bigTable", "implicitFeedback",
                                           "pairwiseRank", "multiIMFBStacked", "bigSvdpp",
                                           "bigBilinear")}
    for d in dirs.values():
        d.mkdir()
    for fx, split in zip(cs.DEMOS["basicMF"], ("train", "test")):
        cs.unzip_fixture(fx, dirs["basicMF"] / f"{split}.feature")
        make_feature_buffer.main([str(dirs["basicMF"] / f"{split}.feature"),
                                  str(dirs["basicMF"] / f"{split}.buffer")])
    big = cs.bigtable_arrays()
    cs.write_bigtable(csr.CSRDataset, write_csr_buffer, dirs["bigTable"], big)
    cs.write_implicit(dirs["implicitFeedback"], make_ugroup_buffer.main)
    cs.write_rank(dirs["pairwiseRank"], make_ugroup_buffer.main)
    cs.write_imfb(dirs["multiIMFBStacked"], load_plus_text, csr, write_plus_buffer,
                  make_ugroup_buffer.main)
    arrays, dims = cs.big_plus_arrays()
    cs.write_big_plus(dirs["bigSvdpp"], csr, write_plus_buffer, arrays, dims)
    cs.write_big_bilinear(dirs["bigBilinear"], csr, write_plus_buffer, arrays, dims)
    return big


def mesh_check() -> int:
    import tempfile

    import torch

    import chip_smoke as cs
    from svdfeature_tpu_torch.ops import _build

    card = cs.card_line()
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    _build.load_library()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = pathlib.Path(tmp)
        t0 = time.perf_counter()
        big = write_data(work, cs)
        print(f"data written in {time.perf_counter() - t0:.1f} s", flush=True)
        failures = []
        t0 = time.perf_counter()
        call = cs.mesh_call_all(torch, work)
        cs.phase_mesh(torch, work, big, dict(c=dict(rmse=PHASE7C_RMSE), phase3=PHASE3_RMSE),
                      card, failures, call)
        cs.phase_mesh_plus(torch, work, PRIOR_PLUS, card, failures, call)
        cs.phase_mesh_bi(torch, work, PRIOR_BI, card, failures, call)
    print(f"phases 19-21 took {time.perf_counter() - t0:.1f} s; failures {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(mesh_check())
