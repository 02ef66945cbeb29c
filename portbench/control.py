"""The readings the limits of ``correct`` are set from, at a cell's own size.

    python3 portbench/control.py --workload <cell> --program-seeds 1,2,... --control-seeds 7,8,9

For each program seed: the set-up and the compared rounds of the program
(no window), the reference, and the compared numbers (the lower readings).
For each control seed: the reference put in the program's place computed
in bfloat16 (the precision below the configuration's float32: the
control), and the reference with half of each batch left out and the
error of the rest doubled (the fault), each held to the float32
reference (the upper readings).  A state left unchanged reads 1 on both
change gaps by their definition and needs no run.  One JSON line a
reading on standard output; the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(workload: str, program_seeds, control_seeds, device_name: str = "cuda", spec=None,
             out=sys.stdout):
    import gc
    import importlib

    import torch

    from portbench.harness import cell
    from portbench.harness import spec as spec_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = spec or spec_mod.load(workload)
    dev = torch.device(device_name)
    gen = importlib.import_module(f"portbench.gen.{s.traffic['generator']}")
    rows = []

    def emit(kind, seed, nums):
        row = dict(cell=s.name, kind=kind, seed=seed, **nums)
        rows.append(row)
        print(json.dumps(row), file=out, flush=True)

    for seed in program_seeds:
        data = gen.make(s.cfg["conf"], s.traffic, seed)
        trainer, ds, side, _ = cell.program_rounds(s, seed, dev, data)
        del trainer, ds
        gc.collect()
        side["seed"] = seed
        ref = cell.reference_readings(s, seed, dev, data)
        emit("program", seed, cell.numbers(s, side, ref, dev))
    for seed in control_seeds:
        data = gen.make(s.cfg["conf"], s.traffic, seed)
        ref = cell.reference_readings(s, seed, dev, data)
        for kind, kw in (("control_bf16", dict(dtype=torch.bfloat16)),
                         ("fault_half", dict(fault="half"))):
            other = cell.reference_readings(s, seed, dev, data, **kw)
            side = dict(seed=seed, n1=other["n1"], final=other["leaves"], probe=other["probe"])
            emit(kind, seed, cell.numbers(s, side, ref, dev))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    def seeds(text):
        return [int(x) for x in text.split(",") if x]

    readings(args.workload, seeds(args.program_seeds), seeds(args.control_seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
