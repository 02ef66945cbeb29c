# Verbatim copy of svdfeature_tpu/cli/line_reorder.py; tests/test_torch_data.py keeps the two identical.
"""CLI: apply an order file to reorder lines (tools/line_reorder.cpp)."""

import sys

from .line_shuffle import read_lines


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3:
        print("Usage: filein order out")
        return -1
    lines = read_lines(argv[0])
    print(f"all the data loaded in, {len(lines)} lines, start reorder")
    with open(argv[1]) as fp, open(argv[2], "w") as fo:
        for l in fp:
            parts = l.split()
            if not parts:
                continue
            oid = int(parts[0])
            assert oid < len(lines), "invalid order file"
            fo.write(lines[oid] + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
