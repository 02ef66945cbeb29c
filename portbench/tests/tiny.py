"""Cells cut to a size a CPU test holds: the MF cell at 10,000 table rows
and k=8, in batches of 1024 (still the big-table route's sorted-dedup
step); the SVD++ cell as it is."""

from __future__ import annotations

import copy

from portbench.harness import spec


def kdd(workload: str = "kdd11_mf.b4k_zipf") -> spec.Spec:
    s = spec.load(workload)
    s.cfg = copy.deepcopy(s.cfg)
    s.traffic = copy.deepcopy(s.traffic)
    s.cfg["conf"].update(num_user="6000", num_item="4000", num_factor="8")
    s.traffic.update(examples_per_round=16384, probe_examples=512)
    s.traffic["conf"] = {"batch_size": "1024"}
    return s


def svdpp(workload: str = "ml100k_svdpp.demo") -> spec.Spec:
    return spec.load(workload)

