"""The port's multi-card dry run and weak-scaling report
(svdfeature_tpu_torch/multichip.py) on the CPU: ``dryrun_multichip(4)``
through its command line (a 4-rank gloo world for the dry run, then the
report's worlds of 1, 2 and 4 ranks), and the report's comm-bytes model
against the bytes that the ranks of a 4-rank world pass to the
collectives of one base step, counted here (this file run as a script is
that world's rank program: it wraps the names parallel/mesh.py calls,
``psum`` and ``all_gather``, and counts the tensors a call hands to a group
of more than one rank)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
B, K = 256, 16  # the report's defaults: examples a rank a step, factors


@pytest.fixture(scope="module")
def dryrun():
    """``python -m svdfeature_tpu_torch.multichip 4 --device cpu``: its exit
    code and output."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-m", "svdfeature_tpu_torch.multichip", str(WORLD),
                           "--device", "cpu"], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    return proc


def _report(proc) -> dict:
    lines = [x for x in proc.stdout.splitlines() if x.startswith("scaling_report ")]
    assert len(lines) == 1, proc.stdout[-3000:]
    return json.loads(lines[0].split(" ", 1)[1])


def test_dryrun_prints_ok_and_exits_0(dryrun):
    """The dry run walks every mesh path on a 2x2 gloo world of CPU ranks
    and ends with its OK line."""
    assert dryrun.returncode == 0, dryrun.stdout[-3000:] + dryrun.stderr[-6000:]
    last = dryrun.stdout.strip().splitlines()[-1]
    assert last.startswith("dryrun_multichip OK: mesh data=2 x model=2 (gloo)")
    for path in ("bilinear mesh rounds OK", "big-slab dedup path OK", "checkpoint-resume OK",
                 "pairwiseRank mesh rounds OK", "multirow (M=2) bilinear"):
        assert path in last


def test_scaling_report_sizes(dryrun):
    """Sizes 1, 2 and 4, the examples a step growing as the ranks, a step
    time each, the bytes received 0 on one rank and growing with D, and a
    ``_meta`` that makes no performance claim on the CPU."""
    rep = _report(dryrun)
    assert sorted(k for k in rep if k != "_meta") == ["1", "2", "4"]
    for D in (1, 2, 4):
        row = rep[str(D)]
        assert row["examples_per_step"] == B * D
        assert row["step_ms"] > 0 and row["backend"] == "gloo"
        assert row["efficiency_vs_1"] == pytest.approx(rep["1"]["step_ms"] / row["step_ms"])
    assert rep["1"]["comm_bytes_per_step"] == 0
    assert 0 < rep["2"]["comm_bytes_per_step"] < rep["4"]["comm_bytes_per_step"]
    meta = rep["_meta"]
    assert meta["platform"] == "cpu" and meta["cards"] == 0
    assert meta["wall_times_are_perf_claim"] is False


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """The bytes each rank of a 4-rank world passed to the collectives of
    one base step on data-only meshes of 4, 2 and 1 ranks."""
    d = tmp_path_factory.mktemp("multichip_counts")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={WORLD}", str(pathlib.Path(__file__).resolve()), str(d)]
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(WORLD)]


def test_comm_model_equals_counted_bytes(counted, dryrun):
    """``multichip.step_comm`` (the report's model) gives the bytes every
    rank passed to ``comm.psum`` and ``comm.all_gather`` in one step, for
    D = 4, 2 and 1, and the report's ``comm_bytes_per_step`` is its bytes
    received from those."""
    from svdfeature_tpu_torch.multichip import step_comm

    rep = _report(dryrun)
    for D in (4, 2, 1):
        for r in range(D):
            got = counted[r][str(D)]
            want = step_comm(D, B, K, got["n_local"])
            assert got["psum"] == want["psum"] and got["all_gather"] == want["all_gather"], D
            assert got["calls"] == (0 if D == 1 else 2)
        assert rep[str(D)]["comm_bytes_per_step"] == int(step_comm(
            D, B, K, counted[0][str(D)]["n_local"])["received"])


def worker(d: pathlib.Path) -> None:
    """A rank: one base step of multichip's toy on data-only meshes of 4, 2
    and 1 ranks, counting what it hands to the collectives."""
    import torch

    from svdfeature_tpu_torch import multichip
    from svdfeature_tpu_torch.ops.embed import HyperParams
    from svdfeature_tpu_torch.parallel import comm
    from svdfeature_tpu_torch.parallel import mesh as pmesh

    comm.init_distributed("cpu")
    counts = {}

    def counting(real, kind):
        def call(mesh, axis, *tensors):
            if mesh.groups[axis] is not None:
                counts[kind] += sum(t.numel() * t.element_size() for t in tensors)
                counts["calls"] += 1
            return real(mesh, axis, *tensors)
        return call

    pmesh.psum = counting(comm.psum, "psum")
    pmesh.all_gather = counting(comm.all_gather, "all_gather")
    cpu = torch.device("cpu")
    out = {}
    for D in (4, 2, 1):
        mesh = comm.make_mesh(D, 1, cpu, ranks=range(D))
        if mesh is None:
            continue
        state, batch, consts = multichip.toy_setup(B * D, k=K)
        st, stacked, cs = multichip.staged_toy(state, batch, consts, mesh, 1, cpu)
        st, n_pad = pmesh.shard_state(st, mesh)
        cs = pmesh.shard_consts(cs, mesh, n_pad)
        counts.update(psum=0, all_gather=0, calls=0)
        pmesh.sharded_train_step(st, {k: v[0] for k, v in stacked.items()},
                                 torch.tensor(0.005), cs, HyperParams(base_score=3.0), mesh, n_pad)
        out[str(D)] = dict(counts, n_local=n_pad)
    (d / f"rank{comm.rank()}.json").write_text(json.dumps(out))


if __name__ == "__main__":
    worker(pathlib.Path(sys.argv[1]))
