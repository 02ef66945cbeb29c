#!/usr/bin/env python3
"""Compare the machine code of one CUDA source's kernels between two trees.

Usage, from the repository root, on a machine with nvcc and cuobjdump:

    python3 scripts/sass_diff.py --parent build/parent
    python3 scripts/sass_diff.py --parent build/parent --source svdfeature_tpu_torch/csrc/row_scatter.cu

Compiles the source of each tree to a cubin with the build's flags
(svdfeature_tpu_torch/ops/_build.py: sm_90a, -O3), dumps its SASS with
cuobjdump, and for every kernel (matched by its name with the anonymous
namespace's hash taken out) prints whether its instructions are identical
in the two trees, or how many differ.  A kernel whose SASS is identical
runs the same machine code, so a change elsewhere in the file cannot move
its time.
"""

from __future__ import annotations

import argparse
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def kernels(source: pathlib.Path, work: pathlib.Path) -> dict:
    """kernel name -> its instructions (addresses and encodings dropped)."""
    from svdfeature_tpu_torch.ops import _build

    cubin = work / (source.stem + f".{abs(hash(str(source)))}.cubin")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(cubin), str(source)], check=True)
    sass = subprocess.run(["cuobjdump", "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        head, body = part.split("\n", 1)
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", head.strip())
        lines = (re.sub(r"/\*.*?\*/", "", line).strip() for line in body.splitlines())
        out[name] = [line for line in lines if line and not line.startswith(".")]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the other tree (the parent commit, unpacked)")
    ap.add_argument("--source", default="svdfeature_tpu_torch/csrc/tile_sweep.cu")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        old = kernels(pathlib.Path(args.parent).resolve() / args.source, work)
        new = kernels(ROOT / args.source, work)
    for name in sorted(set(old) | set(new)):
        a, b = old.get(name), new.get(name)
        if a is None or b is None:
            print(f"{name}: only in the {'change' if a is None else 'parent'}")
        elif a == b:
            print(f"{name}: identical ({len(a)} instructions)")
        else:
            n = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            print(f"{name}: differs ({len(b)} instructions against {len(a)}, {n} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
