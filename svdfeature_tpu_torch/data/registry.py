"""Input-source registry: input_type + config keys -> in-memory dataset.

The in-memory part of svdfeature_tpu/data/registry.py
(create_csr_iterator / create_plus_iterator, apex_svd_data.cpp:1303-1335):
random-order and user-group binary buffers, auto-created from ``data_in``
(+ ``feedback_in``) text when missing (SVDFeatureCSRFactory::init,
apex_svd_data.cpp:227-238), the text sources, and the pairwise-rank
generator over the user-group inputs (input_type 2/3, data/rank.PairSource).
The other inputs raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Optional

from ..params import input_type as it
from .buffer import read_csr_buffer, read_plus_buffer, write_csr_buffer, write_plus_buffer
from .csr import CSRDataset, PlusDataset
from .text import load_basic_text, load_feature_text, load_plus_text


class IteratorConfig:
    """Collects iterator-level config keys via set_param replay."""

    def __init__(self) -> None:
        self.buffer_feature: Optional[str] = None
        self.data_in: Optional[str] = None
        self.feedback_in: Optional[str] = None
        self.scale_score = 1.0
        self.block_max_line = 10000
        self.feature_batch = 1000
        self.silent = 0
        # pairwise rank generator params (apex_svd_data.cpp:981-990)
        self.pos_sample_lowerb = 0.8
        self.neg_sample_upperb = 1e-6
        self.rank_sample_num = -1
        self.rank_sample_max = 1 << 31
        self.rank_sample_method = 0
        self.rank_sample_gap = 0.0001
        self.rank_sample_pointwise = 0
        self.seed_sampler_bytime = 0
        self.streaming = 0

    def set_param(self, name: str, val: str) -> None:
        if name in ("buffer_feature", "data_in", "feedback_in"):
            setattr(self, name, val)
        elif name in ("scale_score", "pos_sample_lowerb", "neg_sample_upperb",
                      "rank_sample_gap"):
            setattr(self, name, float(val))
        elif name in ("block_max_line", "feature_batch", "silent", "rank_sample_num",
                      "rank_sample_max", "rank_sample_method", "rank_sample_pointwise",
                      "seed_sampler_bytime", "streaming"):
            setattr(self, name, int(val))


def load_csr_source(dtype: int, cfg: IteratorConfig) -> CSRDataset:
    if dtype == it.BINARY_PAGE:
        raise NotImplementedError("binary pages (input_type=5) are ROADMAP Queue 1 item 11")
    if dtype == it.BINARY_BUFFER and cfg.streaming:
        raise NotImplementedError("streaming=1 is ROADMAP Queue 1 item 11")
    if dtype == it.BINARY_BUFFER:
        path = cfg.buffer_feature or "svdfeature_buf"
        if not os.path.exists(path):
            if not cfg.silent:
                print(f"can't open buffer {path}, creating from data_in={cfg.data_in}")
            ds = load_feature_text(cfg.data_in, cfg.scale_score)
            write_csr_buffer(path, ds, cfg.feature_batch)
            return ds
        ds, _ = read_csr_buffer(path)
        return ds
    if dtype == it.TEXT_FEATURE:
        return load_feature_text(cfg.data_in, cfg.scale_score)
    if dtype == it.TEXT_BASIC:
        return load_basic_text(cfg.data_in, cfg.scale_score)
    raise ValueError(f"unknown iterator type {dtype}")


def load_plus_source(dtype: int, cfg: IteratorConfig, allow_streaming: bool = True):
    """User-group sources for the SVD++ solver (create_plus_iterator): a
    PlusDataset, or for the rank types a PairSource over the user-group
    input ``dtype & 1``, whose pair sample is drawn afresh every epoch.
    The pair sampler reads a whole dataset, so its inner load ignores
    ``streaming`` (``allow_streaming`` cleared), as in the JAX package."""
    if 100 <= dtype < 300:
        raise NotImplementedError(
            "the user-group attach/filter combinators (input_type 100-299) are "
            "ROADMAP Queue 1 item 13"
        )
    if dtype in (it.BINARY_BUFFER_RANK, it.TEXT_FEATURE_RANK):
        from .rank import PairSource

        return PairSource(load_plus_source(dtype & 1, cfg, allow_streaming=False), cfg)
    if dtype == it.BINARY_BUFFER and cfg.streaming and allow_streaming:
        raise NotImplementedError("streaming=1 is ROADMAP Queue 1 item 11")
    if dtype == it.BINARY_BUFFER:
        path = cfg.buffer_feature or "svdplusfeature_buf"
        if not os.path.exists(path):
            if not cfg.silent:
                print(f"can't open buffer {path}, creating from data_in={cfg.data_in}")
            ds = load_plus_text(cfg.data_in, cfg.feedback_in, cfg.scale_score, cfg.block_max_line)
            write_plus_buffer(path, ds)
            return ds
        return read_plus_buffer(path)
    if dtype == it.TEXT_FEATURE:
        return load_plus_text(cfg.data_in, cfg.feedback_in, cfg.scale_score, cfg.block_max_line)
    raise ValueError(f"unknown iterator type {dtype}")
