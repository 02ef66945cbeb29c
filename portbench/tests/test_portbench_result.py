"""A run's last line has the contract's keys; the run refuses a machine
without a card, and a directory that holds only the benchmark."""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from portbench.harness import cell, spec
from portbench.tests import tiny

RUN = spec.ROOT / "portbench" / "run.py"


@pytest.mark.parametrize("traced", [False, True])
def test_result_keys(traced):
    s = tiny.kdd()
    r = cell.run(s, 2**31 + 99, 0.05, traced, time.perf_counter(), device_name="cpu")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = s.per_layer if traced else s.end_to_end
    # on the CPU no device trace is taken: its readers find nothing to read
    got = set(r["metrics"])
    assert got <= {m["name"] for m in want}
    if not traced:
        assert got == {m["name"] for m in want} and len(got) == 3
    else:
        assert {"trainer_host_ms_per_round", "warm_round_s", "train_mfu_pct"} <= {
            spec.reader(m) for m in want if m["name"] in got}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r, allow_nan=False)


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    p = _run([str(RUN), "--workload", "ml100k_svdpp.demo", "--seed", "1", "--seconds", "1",
              "--trace", "0"], spec.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["portbench/run.py", "--workload", "ml100k_svdpp.demo", "--seed", "1",
              "--seconds", "1", "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert pathlib.Path(tmp_path / "portbench" / "run.py").exists()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark's runs measure the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["kdd11_mf.b4k_zipf", "ml100k_svdpp.demo"])
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(card, cell_name, trace):
    p = subprocess.run([sys.executable, str(RUN), "--workload", cell_name, "--seed",
                        str(2**31 + 7), "--seconds", "2", "--trace", trace], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert p.stderr.strip().splitlines()[-1].startswith("check probe_gap")
    if trace == "1":
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert {m["name"] for m in spec.load(cell_name).per_layer} == set(r["metrics"])
