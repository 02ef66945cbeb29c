"""The comparison that decides ``correct`` fails what it has to: the
control (the reference in bfloat16 in the program's place) and the faults
a training cell can have, planted underneath a run whose look for a chip
is skipped (the run on the CPU, the kernels' plain versions).  One chip
does not exchange anything between chips, so that fault does not apply."""

import math
import time

import pytest
import torch

from portbench import control
from portbench.harness import cell
from portbench.tests import tiny

CELLS = {"kdd11_mf.b4k_zipf": tiny.kdd, "ml100k_svdpp.demo": tiny.svdpp}


def _fails(row, limits):
    return any(not math.isfinite(row[n]) or row[n] > limits[n]["limit"] for n in cell.NUMBERS)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_and_fault_fail_sound_runs_pass(name):
    s = CELLS[name]()
    rows = control.readings(None, [5], [6], "cpu", spec=s)
    kinds = {r["kind"]: r for r in rows}
    assert not _fails(kinds["program"], s.limits)
    assert _fails(kinds["control_bf16"], s.limits)
    assert _fails(kinds["fault_half"], s.limits)


def _unchanged(trainer):
    trainer.update_all = lambda ds: None


def _half_batch(trainer):
    """Half of every batch left out, the mean taken over the rest: the
    batch's weight plane 2 on its first half, 0 on the rest."""
    train = trainer._train

    def broken(entry, lrs):
        stacked = getattr(entry, "stacked", entry)
        w = stacked["weight"].clone()
        half = w.shape[-1] // 2
        w[..., :half] *= 2.0
        w[..., half:] = 0.0
        new = dict(stacked, weight=w)
        if hasattr(entry, "stacked"):
            entry = entry._replace(stacked=new) if hasattr(entry, "_replace") else \
                type(entry)(**{**entry.__dict__, "stacked": new})
        else:
            entry = new
        return train(entry, lrs)

    trainer._train = broken


def _altered_answer(trainer):
    predict = trainer.predict_all

    def broken(ds):
        out = predict(ds).copy()
        out[len(out) // 2] += 0.05
        return out

    trainer.predict_all = broken


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_broken_program_is_not_correct(name, fault):
    r = cell.run(CELLS[name](), 11, 0.02, False, time.perf_counter(), device_name="cpu",
                 break_program=fault)
    assert r["correct"] is False, r["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cells' own size runs on the chip")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_at_the_cells_own_size(card, name):
    from portbench.harness import spec

    s = spec.load(name)
    rows = control.readings(None, [], [7, 8, 9], "cuda", spec=s)
    assert all(_fails(r, s.limits) for r in rows if r["kind"] == "control_bf16")
