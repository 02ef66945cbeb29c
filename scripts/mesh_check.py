#!/usr/bin/env python3
"""Phase 19 of chip_smoke.py alone: the port's mesh on the node's GPUs.

Usage, from the repository root:

    python3 scripts/mesh_check.py

Builds the kernels, writes the basicMF buffers (the ML-100K fixtures) and
bigTable's synthetic buffers as phases 3 and 7 do, then runs
``chip_smoke.phase_mesh`` (one torchrun call of 4 ranks: basicMF streamed,
basicMF, bigTable on mesh_big slabs with K5; then K5 at the
slab's shape).  With one card the ranks share it through gloo; with four
(one a rank) they take NCCL.  Unlike chip_smoke.py, which holds phase 19
to phase 3's and phase 7 (c)'s RMSE measured in the same run, this script
holds it to those figures copied from an earlier whole run
(``PHASE3_RMSE``, ``PHASE7C_RMSE``).  Exits 1 if a check fails.
"""

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PHASE3_RMSE = 0.933293  # basicMF after 40 rounds, docs/chip_smoke_pr12_final.log
PHASE7C_RMSE = 0.170851  # bigTable (c), the JAX CPU figure too


def phase19() -> int:
    import tempfile

    import torch

    import chip_smoke as cs
    from svdfeature_tpu_torch.cli import make_feature_buffer
    from svdfeature_tpu_torch.data.buffer import write_csr_buffer
    from svdfeature_tpu_torch.data.csr import CSRDataset
    from svdfeature_tpu_torch.ops import _build

    card = cs.card_line()
    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    _build.load_library()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = pathlib.Path(tmp)
        mf = work / "basicMF"
        mf.mkdir()
        for fx, split in zip(cs.DEMOS["basicMF"], ("train", "test")):
            cs.unzip_fixture(fx, mf / f"{split}.feature")
            make_feature_buffer.main([str(mf / f"{split}.feature"), str(mf / f"{split}.buffer")])
        big = cs.bigtable_arrays()
        (work / "bigTable").mkdir()
        cs.write_bigtable(CSRDataset, write_csr_buffer, work / "bigTable", big)
        failures = []
        t0 = time.perf_counter()
        cs.phase_mesh(torch, work, big, dict(c=dict(rmse=PHASE7C_RMSE), phase3=PHASE3_RMSE),
                      card, failures)
    print(f"phase 19 took {time.perf_counter() - t0:.1f} s; failures {failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(phase19())
