"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the repository's root.  The cell's configuration, traffic mix,
limits and metrics are found by the names in ``BENCHMARK.json``
(``portbench/harness/spec.py``).  With ``--trace 0`` the last line of
standard output is the result with the cell's end-to-end metrics, with
``--trace 1`` with its per-layer metrics, read from a device trace of the
window; standard error ends with each compared number beside its limit.
The run needs a CUDA card and exits with another code than 0, printing no
result, without one, and when the JAX package or JAX was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# build and kernel caches of the program at fixed paths inside the checkout
CACHE = ROOT / "build" / "portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness import cell, guard, spec

    s = spec.load(args.workload)
    import torch

    t_imports = time.perf_counter()

    chips = int(s.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    try:
        result = cell.run(s, args.seed, args.seconds, bool(args.trace), T_START,
                          t_imports=t_imports)
        found = guard.forbidden_modules()
        if found:
            raise guard.Forbidden(found)
    except guard.Forbidden as e:
        print(str(e), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
