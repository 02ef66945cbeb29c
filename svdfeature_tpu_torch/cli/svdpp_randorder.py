# Verbatim copy of svdfeature_tpu/cli/svdpp_randorder.py; tests/test_torch_data.py keeps the two identical.
"""CLI: emit a random order keeping same-uid lines contiguous
(tools/svdpp_randorder.cpp:26-82): shuffle within each uid group, then
shuffle group order; output "[line] [uid]" per line.
"""

import sys

import numpy as np


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("Usage: filein out [seed] [column]")
        return -1
    seed = int(argv[2]) if len(argv) > 2 else 10
    col = int(argv[3]) if len(argv) > 3 else 0
    uids = []
    with open(argv[0]) as f:
        for line in f:
            parts = line.split()
            if len(parts) <= col:
                break
            uids.append(int(parts[col]))
    uids = np.asarray(uids, np.int64)
    lines = np.arange(len(uids), dtype=np.int64)
    rng = np.random.RandomState(seed)
    # stable sort by uid, then shuffle within groups and shuffle groups
    order = np.argsort(uids, kind="stable")
    uids_s, lines_s = uids[order], lines[order]
    groups = []
    i = 0
    while i < len(uids_s):
        j = i
        while j < len(uids_s) and uids_s[j] == uids_s[i]:
            j += 1
        idx = np.arange(i, j)
        rng.shuffle(idx)
        groups.append(idx)
        i = j
    gorder = rng.permutation(len(groups))
    with open(argv[1], "w") as fo:
        for gi in gorder:
            for x in groups[gi]:
                fo.write(f"{lines_s[x]}\t{uids_s[x]}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
