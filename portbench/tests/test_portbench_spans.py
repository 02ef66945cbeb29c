"""The readings of the program's own spans (harness/program_spans.py) on the
tiny CPU cells, and the idle attribution down to the program's innermost
span on synthetic device records."""

import time
from collections import namedtuple

import pytest

from portbench.harness import cell, program_spans, trace
from portbench.tests import tiny

Span = namedtuple("Span", "name start end id parent round")


@pytest.fixture
def traced_run(monkeypatch):
    """``run(spec)``: a CPU run of the cell with the port's tracer on from
    the set-up's start, drained when the window starts -> (set-up spans,
    window spans, window counters, rounds)."""
    from svdfeature_tpu_torch import tracing

    got = {}

    class Spans(trace.Spans):
        def __init__(self):
            super().__init__()
            got["setup"] = tracing.drain()[0]
            got["spans"] = self

    monkeypatch.setattr(trace, "Spans", Spans)

    def run(spec):
        tracing.enable()
        try:
            r = cell.run(spec, 2**31 + 99, 0.2, True, time.perf_counter(), device_name="cpu")
        finally:
            tracing.disable()
        assert r["correct"] is True
        window, counters = tracing.drain()
        return got["setup"], window, counters, got["spans"].names.count("update_all")

    return run


def test_mf_readings_on_the_cpu(traced_run):
    setup, window, counters, rounds = traced_run(tiny.kdd())
    steps = 16 * rounds  # 16,384 ratings a round in batches of 1024
    assert counters["steps"] == steps
    assert program_spans.step_host_ms(window, counters) > 0
    assert program_spans.pack_s(setup) > 0
    split = program_spans.step_split(window, counters, rounds)
    assert set(split) == {"forward", "payload", "merge", "write", "step", "batches_per_round"}
    assert all(v > 0 for v in split.values())
    # off the card: no device records, no K2
    assert program_spans.step_launches(0, counters) is None
    assert program_spans.k2_host_us(window, counters) is None


def test_svdpp_readings_on_the_cpu(traced_run):
    setup, window, counters, _ = traced_run(tiny.svdpp())
    assert program_spans.pack_s(setup) > 0
    assert program_spans.step_host_ms(window, counters) is None
    assert program_spans.k2_host_us(window, counters) is None


def _harness(*spans):
    s = trace.Spans()
    for name, a, b in spans:
        s.add(name, a, b)
    return s


def test_idle_split_by_program_span():
    # host clock = profiler clock - 1000
    off = 1000
    hs = _harness(("set_round", 0, 10), ("update_all", 10, 100), ("finish_round", 100, 105),
                  ("synchronize", 105, 200))
    program = [Span("forward", 20, 40, 1, 0, 0), Span("payload", 40, 50, 2, 0, 0),
               Span("step", 15, 90, 0, -1, 0), Span("k2.prepare", 95, 98, 4, 3, 0),
               Span("k2", 92, 99, 3, -1, 0), Span("sync.wait", 110, 190, 5, -1, 0)]
    busy = [(1030, 1045), (1060, 1070), (1150, 1200)]  # idle on the host clock: [0, 30),
    lo, hi = 1000, 1200  # [45, 60), [70, 150)
    got = program_spans.idle_by_program_span(busy, lo, hi, hs, program, off)
    want = {"set_round": 10, "update_all": 5 + 2 + 1, "update_all/step": 5 + 10 + 20,
            "update_all/forward": 10, "update_all/payload": 5, "update_all/k2": 3 + 1,
            "update_all/k2.prepare": 3, "finish_round": 5, "synchronize": 5,
            "synchronize/sync.wait": 40}
    want = {k: v / 1e9 for k, v in want.items()}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-15), k
    old = trace.idle_by_span(busy, lo, hi, hs, off)
    assert sum(got.values()) == pytest.approx(sum(old.values()), abs=1e-15)
    # without program spans, the harness's names alone (instant by instant)
    alone = program_spans.idle_by_program_span(busy, lo, hi, hs, [], off)
    assert set(alone) == {"set_round", "update_all", "finish_round", "synchronize"}
    assert sum(alone.values()) == pytest.approx(sum(old.values()), abs=1e-15)


def test_idle_split_between_harness_spans_is_loop():
    hs = _harness(("update_all", 10, 20), ("synchronize", 30, 40))
    got = program_spans.idle_by_program_span([], 0, 50, hs, [], 0)
    assert got == pytest.approx({"loop": 30e-9, "update_all": 10e-9, "synchronize": 10e-9})


def test_innermost_segments():
    program = [Span("a", 0, 10, 0, -1, 0), Span("b", 2, 4, 1, 0, 0), Span("c", 4, 6, 2, 0, 0),
               Span("d", 12, 14, 3, -1, 0)]
    assert program_spans.innermost(program) == [
        (0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a"), (12, 14, "d")]
