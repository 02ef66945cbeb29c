"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the least time they allow for a piece of work.
Frozen copy of the repository's ``chip_smoke.py`` constants
(HBM_BYTES_PER_S, F32_FLOPS_PER_S) and its ``bound``."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def least_seconds(flops: float, bytes_moved: float) -> float:
    """The larger of the operations over the f32 peak (no tensor cores) and
    the bytes over the HBM peak."""
    return max(flops / F32_FLOPS_PER_S, bytes_moved / HBM_BYTES_PER_S)
