"""Every cell of BENCHMARK.json loads from its own files, and the file keeps
to the benchmark's contract."""

import importlib
import json
import re

import pytest
import torch

from portbench.harness import leaves, program, spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_from_its_files(cell):
    s = spec.load(cell)
    assert s.name == cell
    importlib.import_module(f"portbench.gen.{s.traffic['generator']}")
    importlib.import_module(f"portbench.reference.{s.cfg['model']}")
    importlib.import_module(f"portbench.feed.{s.cfg['format']}")
    importlib.import_module(f"portbench.roofline.step_{s.cfg['model']}")
    for m in s.per_layer:
        assert callable(importlib.import_module(f"portbench.metrics.{spec.reader(m)}").read)
        # the end-to-end metric it moves is one the cell reports
        assert m["moves"] in {e["name"] for e in s.end_to_end}
    assert {spec.reader(m) for m in s.end_to_end} <= {"examples_per_s", "round_ms_p95", "setup_s"}
    assert {m["name"] for m in s.end_to_end} >= {"setup_s"}
    assert len(s.end_to_end) >= 2 and s.per_layer
    for n in ("change_gap_r1", "change_gap", "state_gap", "probe_gap"):
        assert s.limits[n]["limit"] > 0


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


def test_shares_of_a_roofline_are_named_so():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("path", sorted((spec.HERE / "metrics").glob("[!_]*.py")),
                         ids=lambda p: p.stem)
def test_every_metric_reader_reads(path):
    assert callable(importlib.import_module(f"portbench.metrics.{path.stem}").read)


@pytest.mark.parametrize("path", sorted((spec.HERE / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_traffic_mix_names_its_generator(path):
    t = json.loads(path.read_text())
    assert callable(importlib.import_module(f"portbench.gen.{t['generator']}").make)
    assert int(t["compared_rounds"]) >= 1


@pytest.mark.parametrize("path", sorted((spec.HERE / "limits").glob("*.json")),
                         ids=lambda p: p.stem)
def test_every_limit_lies_between_its_readings(path):
    for n, lim in json.loads(path.read_text()).items():
        assert 3 * lim["lower"] <= lim["upper"] and lim["lower"] < lim["limit"] < lim["upper"], n


@pytest.mark.parametrize("kid", sorted(program.kernels()))
def test_every_kernel_file_names_a_counted_wrapper(kid):
    k = program.kernels()[kid]
    assert k.NAMES and (k.CLOCK is None or 0 < k.CLOCK[1] <= k.CLOCK[0])
    assert isinstance(program.wrapper(k).launches, int)


@pytest.mark.parametrize("cfg_file", sorted({c["file"] for c in BENCH["configs"]}))
def test_every_configuration_has_a_leaf_layout(cfg_file):
    cfg = json.loads((spec.ROOT / cfg_file).read_text())
    cfg["conf"].update(num_user="5", num_item="4", num_factor="3", num_ufeedback="6")
    init = leaves.initial(cfg, 2**31 + 5, torch.device("cpu"))
    layout = leaves.layout(cfg)
    assert set(init) == set(layout.SECTIONS) and set(layout.FACTORS) <= set(init)
    back = leaves.read_checkpoint(cfg, leaves.write_checkpoint(cfg, init).getvalue(), "cpu")
    for n, t in init.items():
        assert torch.equal(back[n], t), n
