# Verbatim copy of svdfeature_tpu/cli/make_feature_buffer.py; tests/test_torch_data.py keeps the two identical.
"""CLI: text feature file -> random-order binary buffer.

Mirror of tools/make_feature_buffer.cpp:32-64 (same flags, same buffer
bytes — verified byte-identical against the reference tool's output).
"""

import sys
import time


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(
            "Usage:make_feature_buffer <input> <output> [options...]\n"
            "options: -batch_size batch_size, -scale_score scale_score"
        )
        return 0
    from ..data.buffer import write_csr_buffer
    from ..data.text import load_feature_text

    batch_size = 1000
    scale_score = 1.0
    i = 2
    while i < len(argv):
        if argv[i] == "-batch_size":
            i += 1
            batch_size = int(argv[i])
        elif argv[i] == "-scale_score":
            i += 1
            scale_score = float(argv[i])
        i += 1
    start = time.time()
    print("start creating buffer...")
    ds = load_feature_text(argv[0], scale_score)
    write_csr_buffer(argv[1], ds, batch_size)
    print(f"all generation end, {time.time()-start:.0f} sec used")
    return 0


if __name__ == "__main__":
    sys.exit(main())
