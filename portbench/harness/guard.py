"""What the run may not load: JAX, its libraries, and the JAX package
(compared by whole top-level name: the port's name begins with it)."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "svdfeature_tpu")


class Forbidden(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__("modules that the benchmark may not load: " + ", ".join(found))
        self.found = found


def forbidden_modules() -> List[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})
