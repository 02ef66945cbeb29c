"""A cell's parts, found by the names in ``BENCHMARK.json``: its
configuration file, its traffic file (``traffic/<mix>.json``), its limits
(``limits/<cell>.json``) and the metrics it reports (those without a
``workloads`` key and those that list it)."""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import List

HERE = pathlib.Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent


@dataclasses.dataclass
class Spec:
    workload: dict
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(metric: dict) -> str:
    """What a metric reads: the part of its name before the first dot
    (``examples_per_s.host_paced`` is ``examples_per_s``, held to a bound of
    its own in the cells it lists), found as ``metrics/<reader>.py`` for a
    per-layer metric."""
    return metric["name"].split(".", 1)[0]


def load(cell: str, root: pathlib.Path = ROOT) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == cell]
    if not found:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    w = found[0]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    return Spec(
        workload=w,
        cfg=json.loads((root / c["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{cell}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, cell)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, cell)],
    )
