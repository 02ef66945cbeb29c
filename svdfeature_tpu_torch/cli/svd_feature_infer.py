# Verbatim copy of svdfeature_tpu/cli/svd_feature_infer.py; tests/test_torch_data.py keeps the two identical.
"""CLI: inference entry point.  Usage: <config> [key=val ...]

Mirror of svd_feature_infer.cpp:401-405 (with the upstream task dispatch
the fork commented out restored).
"""

import sys


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 1:
        print("Usage:<config> [xxx=xx]")
        return 0
    from ..infer.task import SVDInferTask

    SVDInferTask().run(argv[0], argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
