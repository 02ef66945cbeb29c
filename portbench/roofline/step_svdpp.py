"""The whole SVD++ round's least work: the round is one K2 launch, so its
work is K2's (roofline/k2.py)."""

from .k2 import round_seconds  # noqa: F401
