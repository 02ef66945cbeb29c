"""On-device pairwise-rank resampling (``rank_device_sample=1``).

Counterpart of svdfeature_tpu/ops/pair_sample.py, which holds no Pallas
kernel (jnp argsorts inside the training dispatch), so plain PyTorch here.
The reference regenerates training pairs per user block each pass
(PairwiseRankGenerator, apex_svd_data.cpp:812-1025): permute the block's
negative rows, permute its positives, pair them cyclically
(pos[i % n_pos], neg[i % n_neg]) for snum = min(n_neg, rank_sample_max)
pairs.  The packed grid of a pair epoch is epoch-invariant (pair counts
are deterministic, solvers/svdpp._build_pair_skeleton), so every slot
knows at build time its user and its cyclic index into that user's
permuted candidate list; a round only draws the permutations.

Per round, a ``[U+1, maxC]`` uniform-key argsort (pads pushed to the end
with key 2) yields them, from a ``torch.Generator`` on the training device
seeded by ``rank_device_seed`` folded with the round, and two gathers give
the (pos_row, neg_row) planes.  The law is the JAX package's; the stream
is not (neither is the JAX sampler's the host path's), so it is held by a
law test (tests/test_torch_rank.py), not by equality.

Statics (``build_pair_sampler_statics``, numpy; staged by the trainer):
``pos_cand`` / ``neg_cand [U+1, maxC]`` per-user candidate rows (whole-
dataset row ids, padded with the dummy row Rr; user U is the padding user
of empty slots), ``npos`` / ``nneg [U+1]`` (>= 1), ``su [TGS]`` slot ->
user, ``sp_pos`` / ``sp_neg [TGS]`` slot -> cyclic index.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def build_pair_sampler_statics(ds, slot: np.ndarray, TGS: int) -> Dict[str, np.ndarray]:
    """ds: PairSource (rank_sample_method == 0); slot: pair j (epoch
    order) -> packed flat slot (the skeleton's perm array).  numpy int32
    arrays, as svdfeature_tpu/ops/pair_sample.build_pair_sampler_statics
    builds them."""
    cfg = ds.cfg
    assert cfg.rank_sample_method == 0
    rows = ds._rows_cat
    Rr = rows.num_row
    U = len(ds.blocks)
    pos_l, neg_l, snums = [], [], []
    for b, blk in enumerate(ds.blocks):
        r0 = int(ds._row_starts[b])
        n = blk.data.num_row
        labels = rows.labels[r0 : r0 + n]
        pos = np.nonzero(labels - cfg.pos_sample_lowerb > -1e-6)[0]
        neg = np.nonzero(labels - cfg.neg_sample_upperb < 1e-6)[0]
        if len(pos) == 0 or len(neg) == 0:
            pos = np.zeros(0, np.int64)
            neg = np.zeros(0, np.int64)
            snum = 0
        else:
            snum = len(neg) if cfg.rank_sample_num < 0 else cfg.rank_sample_num
            snum = min(snum, cfg.rank_sample_max)
        pos_l.append(pos + r0)
        neg_l.append(neg + r0)
        snums.append(snum)
    snums = np.asarray(snums, np.int64)
    maxP = max(1, max((len(p) for p in pos_l), default=1))
    maxN = max(1, max((len(n) for n in neg_l), default=1))
    pos_cand = np.full((U + 1, maxP), Rr, np.int32)
    neg_cand = np.full((U + 1, maxN), Rr, np.int32)
    npos = np.ones(U + 1, np.int32)
    nneg = np.ones(U + 1, np.int32)
    for u in range(U):
        if len(pos_l[u]):
            pos_cand[u, : len(pos_l[u])] = pos_l[u]
            npos[u] = len(pos_l[u])
        if len(neg_l[u]):
            neg_cand[u, : len(neg_l[u])] = neg_l[u]
            nneg[u] = len(neg_l[u])

    su = np.full(TGS, U, np.int32)
    j_user = np.repeat(np.arange(U, dtype=np.int32), snums)
    j_ord = np.concatenate(
        [np.arange(c, dtype=np.int32) for c in snums]
    ) if snums.sum() else np.zeros(0, np.int32)
    su[slot] = j_user
    sp = np.zeros(TGS, np.int32)
    sp[slot] = j_ord
    return dict(
        pos_cand=pos_cand,
        neg_cand=neg_cand,
        npos=npos,
        nneg=nneg,
        su=su,
        sp_pos=sp % npos[su],
        sp_neg=sp % nneg[su],
    )


def stage_statics(st: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """The statics on ``device``: candidate rows int32, the rest int64
    (they index)."""
    return {name: torch.from_numpy(a).to(device=device,
                                        dtype=torch.int32 if name.endswith("_cand") else torch.int64)
            for name, a in st.items()}


def _generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """The generator of one (round, set) stream: ``seed`` folded with
    ``stream`` (2 * round, + 1 for the negatives)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | (stream & 0xFFFFFFFF))
    return gen


def _perm_gather(gen: torch.Generator, cand: torch.Tensor, ncand: torch.Tensor, su: torch.Tensor,
                 sp: torch.Tensor) -> torch.Tensor:
    """One round's flat plane: permute each user's candidate list with a
    uniform-key argsort (pads get key 2 > U[0, 1) and sink to the end),
    then read each slot's cyclic position."""
    U1, C = cand.shape
    keys = torch.rand((U1, C), generator=gen, device=cand.device)
    col = torch.arange(C, device=cand.device)
    keys = torch.where(col[None, :] < ncand[:, None], keys, 2.0)
    perm = torch.gather(cand, 1, torch.argsort(keys, dim=1))  # [U1, C]
    return perm[su, sp]  # [TGS]


def sample_pair_flats(seed: int, round0: int, st: Dict[str, torch.Tensor],
                      R: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """R rounds (rounds ``round0`` .. ``round0 + R - 1`` of the stream) of
    (pos_row, neg_row) planes, ``[R, TGS]`` int32 each, on the statics'
    device."""
    dev = st["su"].device
    fps, fns = [], []
    for r in range(round0, round0 + R):
        fps.append(_perm_gather(_generator(seed, 2 * r, dev), st["pos_cand"], st["npos"],
                                st["su"], st["sp_pos"]))
        fns.append(_perm_gather(_generator(seed, 2 * r + 1, dev), st["neg_cand"], st["nneg"],
                                st["su"], st["sp_neg"]))
    return torch.stack(fps), torch.stack(fns)
