"""The leaves of user-grouped SVD++: biased MF's (layout/mf.py) and the
feedback rows ``fb_w`` / ``fb_b``, saved after the globals."""

from __future__ import annotations

from typing import Dict

from . import mf

FACTORS = {**mf.FACTORS, "fb_w": "ufeedback_init_sigma"}
SECTIONS = mf.SECTIONS + ("fb_b", "fb_w")


def shapes(conf: dict) -> Dict[str, tuple]:
    nf, k = int(conf["num_ufeedback"]), int(conf["num_factor"])
    return {**mf.shapes(conf), "fb_b": (nf,), "fb_w": (nf, k)}
