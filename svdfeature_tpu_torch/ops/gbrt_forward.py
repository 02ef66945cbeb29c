"""The boosted-tree walk on the training device: the whole model at once.

Counterpart of svdfeature_tpu/ops/gbrt_forward.py.  Reference semantics:
the per-row scalar walk ``RTreeTrainer::predict`` / ``get_leaf_id``
(apex_reg_tree.cpp:771-792) inside the per-tree sum of
``GBRTTrainer::forward`` (apex_gbrt.h:601-657).  The walk is level-
synchronous and batched over every (tree, row) walker:

* the trees are stacked on the host into padded [T, M] node arrays
  (``stack_trees``, numpy, the JAX package's padding; leaf iff left == -1,
  leaf value in ``split_value``);
* every walker advances one level per step for exactly D steps, D the
  deepest path of the stacked trees (``tree_depth``, on the host).  A
  walker on a leaf stays where it is, so D steps give the JAX package's
  while loop's result with no host read of a device flag per level;
* the sparse feature lookup is ``torch.searchsorted`` (left side, as
  ``jnp.searchsorted``) over the dataset's sorted int32
  ``row*(nfeat+1)+findex`` keys; a missing feature follows the node's
  packed default direction;
* the boosted sum ``base + sum_t w_t * leaf_t`` is one f32 weighted
  reduction over the [T, R] leaf values.

The JAX package walks with an XLA while loop, not a Pallas kernel, so the
walk stays plain PyTorch on the card.  ``forward_trees.walks`` counts the
walks run on a CUDA device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

_INT32_MAX = np.int64(2**31 - 1)


def stack_trees(trees: Sequence) -> dict:
    """Stack RTree node lists into padded [T, M] arrays, with the depth D
    of the deepest path among them.

    Padding nodes are leaves with value 0 (left == -1), so padded trees
    contribute exactly 0 and padded node slots are never walked into.
    """
    T = len(trees)
    Tp = max(8, -(-T // 8) * 8)
    M = max(max(t.num_nodes for t in trees), 2)
    Mp = 1 << (M - 1).bit_length()

    left = np.full((Tp, Mp), -1, np.int32)
    right = np.full((Tp, Mp), -1, np.int32)
    sindex = np.zeros((Tp, Mp), np.int64)
    sval = np.zeros((Tp, Mp), np.float32)
    for ti, t in enumerate(trees):
        n = t.num_nodes
        left[ti, :n] = t.left
        right[ti, :n] = t.right
        sindex[ti, :n] = np.asarray(t.sindex, np.uint32).astype(np.int64)
        sval[ti, :n] = t.split_value
    split_index = (sindex & 0x7FFFFFFF).astype(np.int32)
    default_left = (sindex >> 31) != 0
    return dict(
        left=left,
        right=right,
        split_index=split_index,
        default_left=default_left,
        split_value=sval,
        num_trees=T,
        num_pad_trees=Tp,
        depth=max(tree_depth(t) for t in trees),
    )


def tree_depth(tree) -> int:
    """Levels of the deepest path from any root (roots are nodes
    0..num_roots-1) down to a leaf."""
    left, right = np.asarray(tree.left, np.int64), np.asarray(tree.right, np.int64)
    frontier = np.arange(tree.num_roots)
    depth = 0
    while True:
        inner = frontier[left[frontier] != -1]
        if not len(inner):
            return depth
        frontier = np.concatenate([left[inner], right[inner]])
        depth += 1


def device_forward_ok(smat) -> bool:
    """The combined (row, findex) key must fit int32 on device."""
    return smat.num_row * (smat.nfeat + 1) + smat.nfeat < _INT32_MAX


def stage_rows(smat, device: torch.device) -> dict:
    """A dataset's sorted int32 lookup keys and their values on ``device``:
    staged once per dataset by the trainer, walked by every model."""
    return dict(
        keys=torch.from_numpy(smat._keys.astype(np.int32)).to(device),
        fvalue=torch.from_numpy(np.ascontiguousarray(smat.fvalue, np.float32)).to(device),
        nfeat=smat.nfeat,
    )


def stage_model(trees: Sequence, gids_per_tree: List[np.ndarray],
                weights_per_tree: List[np.ndarray], device: torch.device) -> dict:
    """The stacked trees (``stack_trees``) with each tree's per-row root ids
    and weights, padded to the stacked tree count, on ``device``."""
    st = stack_trees(trees)
    R = len(gids_per_tree[0])
    gids = np.zeros((st["num_pad_trees"], R), np.int32)
    weights = np.zeros((st["num_pad_trees"], R), np.float32)
    for ti in range(st["num_trees"]):
        gids[ti] = gids_per_tree[ti]
        weights[ti] = weights_per_tree[ti]
    model = {k: torch.from_numpy(np.ascontiguousarray(st[k])).to(device)
             for k in ("left", "right", "split_index", "default_left", "split_value")}
    model.update(gids=torch.from_numpy(gids).to(device),
                 weights=torch.from_numpy(weights).to(device), depth=st["depth"])
    return model


def walk(model: dict, rows: dict, base_pred: torch.Tensor) -> torch.Tensor:
    """base_pred + sum_t weights[t] * leaf value of tree t, every (tree,
    row) walker moved ``model["depth"]`` levels from its root
    ``gids[t, r]`` (``stage_model``; node arrays [T, M], gids and weights
    [T, R]) over the rows' keys (``stage_rows``); f32 [R]."""
    left, right, split_value = model["left"], model["right"], model["split_value"]
    split_index, default_left = model["split_index"], model["default_left"]
    keys, fvalue = rows["keys"], rows["fvalue"]
    T, R = model["gids"].shape
    E = keys.shape[0]
    row_key = torch.arange(R, dtype=torch.int32, device=keys.device) * (rows["nfeat"] + 1)
    pid = model["gids"].long()
    for _ in range(model["depth"]):
        lft = left.gather(1, pid)
        q = row_key[None, :] + split_index.gather(1, pid)
        if E:
            pos = torch.searchsorted(keys, q.reshape(-1)).reshape(T, R).clamp_max(E - 1)
            found = keys[pos] == q
            val = torch.where(found, fvalue[pos], 0.0)
        else:
            found = torch.zeros_like(q, dtype=torch.bool)
            val = torch.zeros(q.shape, dtype=split_value.dtype, device=q.device)
        go_left = torch.where(found, val < split_value.gather(1, pid),
                              default_left.gather(1, pid))
        nxt = torch.where(go_left, lft, right.gather(1, pid)).long()
        pid = torch.where(lft != -1, nxt, pid)
    leaf = split_value.gather(1, pid)
    return base_pred + (leaf * model["weights"]).sum(0)


def forward_trees(
    trees: Sequence,
    smat,
    gids_per_tree: List[np.ndarray],
    weights_per_tree: List[np.ndarray],
    base_pred: np.ndarray,
    device: torch.device,
    staged: Optional[dict] = None,
) -> np.ndarray:
    """base_pred + sum_t w_t * tree_t(rows), walked on ``device`` (the
    rows' keys from ``staged``, else staged here)."""
    model = stage_model(trees, gids_per_tree, weights_per_tree, device)
    rows = staged if staged is not None else stage_rows(smat, device)
    base = torch.from_numpy(np.asarray(base_pred, np.float32)).to(device)
    out = walk(model, rows, base)
    if out.is_cuda:
        forward_trees.walks += 1
    return out.cpu().numpy().astype(np.float64)


forward_trees.walks = 0
