# Verbatim copy of svdfeature_tpu/solvers/gbrt/schedulers.py; tests/test_torch_data.py keeps the two identical.
"""GBRT per-round schedulers and item taxonomy.

Ports of GBRTScheduler (apex_gbrt.h:250-380: per-round root/weight-type
cycling, forced rounds via ``typef[...]``, random choice via ``typew[...]``),
GBRTParamScheduler (:383-414: per-round feature-range masks ``pset``),
and ItemTaxonomy (:211-247).
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np


class GBRTScheduler:
    def __init__(self, prefix: str, rng: Optional[np.random.RandomState] = None):
        self.prefix = prefix
        self.type_current = 0
        self.type_default = 0
        self.type_chg_cycle = 1
        self.type_start_cycle = 0
        self.type_start_default = 1 << 30
        self.type_start_random = 1 << 30
        self.type_set: List[int] = []
        self.type_round: List[int] = []
        self.type_weight: List[float] = []
        self.rng = rng or np.random.RandomState(10)

    def set_round(self, nround: int) -> None:
        if nround < len(self.type_round) and self.type_round[nround] != -1:
            self.type_current = self.type_round[nround]
            return
        if nround >= self.type_start_default or nround < self.type_start_cycle:
            self.type_current = self.type_default
            return
        idx = nround % self.type_chg_cycle
        if nround >= self.type_start_random:
            assert self.type_weight, "must have specific typew"
            w = np.cumsum(self.type_weight)
            idx = int(np.searchsorted(w, self.rng.rand() * w[-1]))
            idx = min(idx, len(w) - 1)
        if idx < len(self.type_set):
            self.type_current = self.type_set[idx]
        else:
            self.type_current = self.type_default

    def set_param(self, name: str, val: str) -> None:
        if not name.startswith(self.prefix):
            return
        name = name[len(self.prefix):]
        if name == "type_chg_cycle":
            self.type_chg_cycle = int(val)
        if name == "type_start_cycle":
            self.type_start_cycle = int(val)
        if name == "type_start_default":
            self.type_start_default = int(val)
        if name == "type_start_random":
            self.type_start_random = int(val)
        if name == "type_default":
            self.type_default = int(val)
        if name.startswith("type["):
            m = re.match(r"type\[(\d+)-(\d+)\)", name)
            if m and val == "same":
                start, end = int(m.group(1)), int(m.group(2))
                while len(self.type_set) < end:
                    self.type_set.append(self.type_default)
                for i in range(start, end):
                    self.type_set[i] = i
                return
            m = re.match(r"type\[(\d+)\]", name)
            assert m, "unknown type id"
            i = int(m.group(1))
            while len(self.type_set) <= i:
                self.type_set.append(self.type_default)
            self.type_set[i] = int(val)
        if name.startswith("typef["):
            m = re.match(r"typef\[(\d+)-(\d+)\)", name)
            if m:
                start, end = int(m.group(1)), int(m.group(2))
            else:
                m = re.match(r"typef\[(\d+)\]", name)
                assert m, "unknown type id"
                start = int(m.group(1))
                end = start + 1
            while len(self.type_round) < end:
                self.type_round.append(-1)
            for i in range(start, end):
                self.type_round[i] = int(val)
        if name.startswith("typew["):
            m = re.match(r"typew\[(\d+)-(\d+)\)", name)
            if m:
                start, end = int(m.group(1)), int(m.group(2))
            else:
                m = re.match(r"typew\[(\d+)\]", name)
                assert m, "unknown type id"
                start = int(m.group(1))
                end = start + 1
            while len(self.type_weight) < end:
                self.type_weight.append(1.0)
            for i in range(start, end):
                self.type_weight[i] = float(val)

    def curr_type(self) -> int:
        return self.type_current


class GBRTParamScheduler:
    class Entry:
        def __init__(self, fstart=0, fend=(1 << 32) - 1, gstart=0, gend=(1 << 32) - 1):
            self.fstart, self.fend = fstart, fend
            self.gstart, self.gend = gstart, gend

    def __init__(self) -> None:
        self.entries = [self.Entry()]
        self.ps = GBRTScheduler("p")

    def set_round(self, nround: int) -> None:
        self.ps.set_round(nround)

    def set_param(self, name: str, val: str) -> None:
        self.ps.set_param(name, val)
        if name == "pset":
            m = re.match(r"(\d+)-(\d+)\.(\d+)-(\d+)", val)
            assert m, "error loading pset"
            self.entries.append(
                self.Entry(int(m.group(1)), int(m.group(2)), int(m.group(3)), int(m.group(4)))
            )

    def curr_type(self) -> "GBRTParamScheduler.Entry":
        return self.entries[self.ps.curr_type()]


class ItemTaxonomy:
    """Item -> taxonomy-label table (apex_gbrt.h:211-247); text format:
    ``num_item num_label  sizes...  rows of num_label labels``."""

    def __init__(self) -> None:
        self.num_item = 0
        self.num_label = 0
        self.sizes: List[int] = []
        self.data: Optional[np.ndarray] = None

    def load(self, path: str) -> None:
        toks = open(path).read().split()
        self.num_item, self.num_label = int(toks[0]), int(toks[1])
        self.sizes = [int(t) for t in toks[2 : 2 + self.num_label]]
        vals = np.asarray(toks[2 + self.num_label :], dtype=np.int64)
        self.data = vals.reshape(self.num_item, self.num_label)
        assert (self.data < np.asarray(self.sizes)[None, :]).all(), "load tax"

    def size(self, rtype: int) -> int:
        return self.sizes[rtype]

    def map(self, iids: np.ndarray, rtype: int) -> np.ndarray:
        return self.data[iids, rtype]
