"""The leaves of biased matrix factorization (separate latent spaces):
``user_w`` / ``user_b`` (the users' factors and biases), ``item_w`` /
``item_b`` and ``g`` (the global biases)."""

from __future__ import annotations

from typing import Dict

# factor leaves and the configuration key of their init sigma, in the order
# of the one normal draw that fills them
FACTORS = {"user_w": "u_init_sigma", "item_w": "i_init_sigma"}
# the checkpoint's sections in the order SVDModel::SaveModel writes them
SECTIONS = ("user_b", "user_w", "item_b", "item_w", "g")


def shapes(conf: dict) -> Dict[str, tuple]:
    """Each leaf's shape."""
    k = int(conf["num_factor"])
    nu, ni, ng = int(conf["num_user"]), int(conf["num_item"]), int(conf.get("num_global", 0))
    return dict(user_b=(nu,), user_w=(nu, k), item_b=(ni,), item_w=(ni, k), g=(ng,))
