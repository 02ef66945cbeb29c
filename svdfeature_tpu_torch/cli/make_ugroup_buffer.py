# Verbatim copy of svdfeature_tpu/cli/make_ugroup_buffer.py; tests/test_torch_data.py keeps the two identical.
"""CLI: user-grouped text (+ optional feedback file) -> binary buffer.

Mirror of tools/make_ugroup_buffer.cpp:32-71 (byte-identical output,
verified against the reference tool on the demo data).
"""

import sys
import time


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(
            "Usage:make_ugroup_buffer <feature_file> <output> [options...]\n"
            "options: -scale_score scale_score -fd feedbackfile -max_block max_line"
        )
        return 0
    from ..data.buffer import write_plus_buffer
    from ..data.text import load_plus_text

    scale_score = 1.0
    feedback = None
    max_block = 10000
    i = 2
    while i < len(argv):
        if argv[i] == "-scale_score":
            i += 1
            scale_score = float(argv[i])
        elif argv[i] == "-fd":
            i += 1
            feedback = argv[i]
        elif argv[i] == "-max_block":
            i += 1
            max_block = int(argv[i])
        i += 1
    start = time.time()
    print(f"feature={argv[0]},feedback={feedback or 'NULL'},start creating buffer...")
    ds = load_plus_text(argv[0], feedback, scale_score, max_block)
    write_plus_buffer(argv[1], ds)
    print(f"all generation end, {time.time()-start:.0f} sec used")
    return 0


if __name__ == "__main__":
    sys.exit(main())
