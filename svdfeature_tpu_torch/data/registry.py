"""Input-source registry: input_type + config keys -> dataset or stream.

Counterpart of svdfeature_tpu/data/registry.py (create_csr_iterator /
create_plus_iterator, apex_svd_data.cpp:1303-1335): random-order and
user-group binary buffers, auto-created from ``data_in`` (+
``feedback_in``) text when missing (SVDFeatureCSRFactory::init,
apex_svd_data.cpp:227-238), binary pages (input_type=5, data/pages.py),
the text sources, the pairwise-rank generator over the user-group inputs
(input_type 2/3, data/rank.PairSource) and the composed user-group
encodings (apex_svd_data.cpp:1313-1324, the combinators of
data/combinators.py):
  dtype in [200,300) -> filter(create(dtype % 100))
  dtype in [100,200) -> attach(create((dtype/10)%10), create(dtype%10))
With ``streaming=1`` a plain binary buffer is not read whole: the source
is a data/streaming.StreamingCSRBuffer (``stream_chunk`` examples a
chunk) or StreamingPlusBuffer (``stream_chunk`` user blocks, 1 << 16 when
unset), which the trainers consume a chunk at a time (solvers/streamed.py).
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
        # out-of-core streaming (data/streaming.py): read the binary
        # buffer in bounded chunks instead of staging it whole.
        # stream_chunk counts EXAMPLES for the random-order format and
        # logical USER BLOCKS for the user-group format (block default
        # 1<<16 when unset - see load_plus_source)
        self.streaming = 0
        self.stream_chunk = 1 << 20
        self.stream_chunk_set = False
        # combinators
        self.attach_skip = 1
        self.attach_insert = 1
        self.filter_ufeedback = []
        self.filter_global = []
        self.attach = {}  # params routed to the attached iterator

    def set_param(self, name: str, val: str) -> None:
        if name.startswith("attach:"):
            self.attach[name[len("attach:"):]] = val
            return
        if name in ("buffer_feature", "data_in", "feedback_in"):
            setattr(self, name, val)
        elif name in ("scale_score", "pos_sample_lowerb", "neg_sample_upperb",
                      "rank_sample_gap"):
            setattr(self, name, float(val))
        elif name in ("block_max_line", "feature_batch", "silent", "rank_sample_num",
                      "rank_sample_max", "rank_sample_method", "rank_sample_pointwise",
                      "seed_sampler_bytime", "attach_skip", "attach_insert", "streaming",
                      "stream_chunk"):
            setattr(self, name, int(val))
            if name == "stream_chunk":
                self.stream_chunk_set = True
        elif name in ("filter_ufeedback", "filter_global"):
            a, b = val.split("-")
            getattr(self, name).append((int(a), int(b)))


def load_csr_source(dtype: int, cfg: IteratorConfig) -> CSRDataset:
    if dtype == it.BINARY_PAGE:
        from .pages import read_page_file

        return read_page_file(cfg.buffer_feature or "svdfeature_buf")
    if dtype == it.BINARY_BUFFER:
        path = cfg.buffer_feature or "svdfeature_buf"
        ds = None
        if not os.path.exists(path):
            if not cfg.silent:
                print(f"can't open buffer {path}, creating from data_in={cfg.data_in}")
            ds = load_feature_text(cfg.data_in, cfg.scale_score)
            write_csr_buffer(path, ds, cfg.feature_batch)
        if cfg.streaming:
            from .streaming import StreamingCSRBuffer

            return StreamingCSRBuffer(path, cfg.stream_chunk)
        return ds if ds is not None else read_csr_buffer(path)[0]
    if dtype == it.TEXT_FEATURE:
        return load_feature_text(cfg.data_in, cfg.scale_score)
    if dtype == it.TEXT_BASIC:
        return load_basic_text(cfg.data_in, cfg.scale_score)
    raise ValueError(f"unknown iterator type {dtype}")


def load_plus_source(dtype: int, cfg: IteratorConfig, allow_streaming: bool = True):
    """User-group sources (create_plus_iterator): a PlusDataset, or for the
    rank types a PairSource over the user-group input ``dtype & 1``, whose
    pair sample is drawn afresh every epoch.  The filter / attach
    combinators and the pair sampler transform whole datasets, so their
    inner loads ignore ``streaming`` (``allow_streaming`` cleared), as in
    the JAX package."""
    if 200 <= dtype < 300:
        from .combinators import FilteredPlusSource

        return FilteredPlusSource(
            load_plus_source(dtype % 100, cfg, allow_streaming=False),
            cfg.filter_ufeedback,
            cfg.filter_global,
        ).materialize()
    if 100 <= dtype < 200:
        from .combinators import AttachedPlusSource

        acfg = IteratorConfig()
        # primary params apply to both; attach: keys override the attached
        for k, v in vars(cfg).items():
            if k != "attach":
                setattr(acfg, k, list(v) if isinstance(v, list) else v)
        for k, v in cfg.attach.items():
            acfg.set_param(k, v)
        return AttachedPlusSource(
            load_plus_source((dtype // 10) % 10, cfg, allow_streaming=False),
            load_plus_source(dtype % 10, acfg, allow_streaming=False),
            cfg.attach_skip,
            cfg.attach_insert,
        ).materialize()
    if dtype in (it.BINARY_BUFFER_RANK, it.TEXT_FEATURE_RANK):
        from .rank import PairSource

        return PairSource(load_plus_source(dtype & 1, cfg, allow_streaming=False), cfg)
    if dtype == it.BINARY_BUFFER:
        path = cfg.buffer_feature or "svdplusfeature_buf"
        ds = None
        if not os.path.exists(path):
            if not cfg.silent:
                print(f"can't open buffer {path}, creating from data_in={cfg.data_in}")
            ds = load_plus_text(cfg.data_in, cfg.feedback_in, cfg.scale_score, cfg.block_max_line)
            write_plus_buffer(path, ds)
        if cfg.streaming and allow_streaming:
            from .streaming import StreamingPlusBuffer

            # stream_chunk counts logical user blocks here; the examples
            # default of the random-order format would stage ~20x more rows
            # a chunk, so an unset stream_chunk takes a block-count default
            return StreamingPlusBuffer(path, cfg.stream_chunk if cfg.stream_chunk_set else 1 << 16)
        return ds if ds is not None else read_plus_buffer(path)
    if dtype == it.TEXT_FEATURE:
        return load_plus_text(cfg.data_in, cfg.feedback_in, cfg.scale_score, cfg.block_max_line)
    raise ValueError(f"unknown iterator type {dtype}")
