"""The port runs without JAX: in a fresh interpreter whose import system
refuses ``jax`` and ``svdfeature_tpu``, every module of
svdfeature_tpu_torch imports and one plain train step runs."""

import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, sys

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "svdfeature_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    import torch
    import svdfeature_tpu_torch as pkg

    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    assert "svdfeature_tpu_torch.ops.svdpp_big" in names
    for new in ("data.rank", "utils.evaluator", "ops.pair_sample", "solvers.ranker",
                "ops.svdpp_bilinear", "solvers.bilinear", "solvers.gbrt.trainer",
                "solvers.gbrt.tree", "solvers.gbrt.schedulers", "solvers.gbrt.np_losses",
                "ops.gbrt_forward", "data.combinators", "cli.line_shuffle",
                "cli.line_reorder", "cli.svdpp_randorder", "cli.combine_ugroup",
                "utils.csr_builder", "data.streaming", "data.pages", "solvers.streamed",
                "parallel.comm", "parallel.mesh", "parallel.mesh_big", "solvers.example",
                "parallel.svdpp_mesh", "parallel.svdpp_mesh_big", "parallel.imfb_mesh",
                "parallel.imfb_mesh_big", "parallel.bilinear_mesh", "parallel.bilinear_mesh_big",
                "multichip"):
        assert "svdfeature_tpu_torch." + new in names

    from svdfeature_tpu_torch import convert
    from svdfeature_tpu_torch.ops.cuda_embed import train_rounds_kernel
    from svdfeature_tpu_torch.ops.embed import HyperParams

    cpu = torch.device("cpu")
    rng = np.random.RandomState(0)
    N, k, T, B = 17, 4, 1, 8
    state = convert.state_from_numpy(
        rng.normal(0, 0.1, (N, k)), np.zeros(N), np.zeros(1), 0,
        np.zeros(N), np.zeros(1), device=cpu)
    consts = convert.consts_from_numpy(
        np.full(N, 0.01), np.full(N, 0.01), np.zeros(1), 0.0, 0.0, device=cpu)
    stacked = convert.stacked_from_numpy(dict(
        label=rng.randint(1, 6, (T, B)), weight=np.ones((T, B)),
        g_idx=np.zeros((T, B, 1)), g_val=np.zeros((T, B, 1)),
        u_idx=rng.randint(0, 8, (T, B, 1)), u_val=np.ones((T, B, 1)),
        i_idx=8 + rng.randint(0, 8, (T, B, 1)), i_val=np.ones((T, B, 1)),
    ), cpu)
    w0 = state.w.clone()
    out = train_rounds_kernel(state, stacked, torch.tensor([0.05]), consts,
                              HyperParams(base_score=3.0))
    assert int(out.step) == B and torch.isfinite(out.w).all()
    assert not torch.equal(out.w, w0)
    assert not any(m.split(".")[0] in ("jax", "svdfeature_tpu") for m in sys.modules)
    print("imported", len(names), "modules")
    """
)


def test_port_imports_and_trains_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout
