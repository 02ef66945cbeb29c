# Verbatim copy of svdfeature_tpu/cli/line_shuffle.py; tests/test_torch_data.py keeps the two identical.
"""CLI: whole-file seeded line shuffle (tools/line_shuffle.cpp:15-64).

The PRNG differs from the reference's libc rand() (shuffle order is not
bit-identical); determinism per seed is preserved.
"""

import sys

import numpy as np


def read_lines(path: str):
    with open(path, "rb") as f:
        raw = f.read()
    return [l for l in raw.decode("utf-8", "replace").splitlines() if l != ""]


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("Usage: filein out [seed]")
        return -1
    seed = int(argv[2]) if len(argv) > 2 else 10
    lines = read_lines(argv[0])
    print(f"all the data loaded in, {len(lines)} lines, start shuffle")
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(lines))
    with open(argv[1], "w") as fo:
        for i in order:
            fo.write(lines[i] + "\n")
    print("shuffle end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
