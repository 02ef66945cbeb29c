# Verbatim copy of svdfeature_tpu/cli/svd_feature.py; tests/test_torch_data.py keeps the two identical.
"""CLI: training entry point.  Usage: <config> [key=val ...]

Mirror of svd_feature.cpp:292-296 / apex_task.h:35-50.
"""

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("Usage:<config> [xxx=xx]")
        return 0
    from ..train.loop import SVDTrainTask

    SVDTrainTask().run(argv[0], argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
