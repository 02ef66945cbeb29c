# Verbatim copy of svdfeature_tpu/solvers/gbrt/tree.py; tests/test_torch_data.py keeps the two identical.
"""Regression tree: exact greedy CART with missing-value default directions.

Port of apex_rt (solvers/gbrt/apex_reg_tree.h/.cpp): multiple roots (one
per group id), prune-on-build, Newton leaf values
``-lr * sum(g) / (sum(h) + wd_child)``, split methods 0 (prune-in-select),
1 (best), 2 (softmax-temperature sampling), per-layer split-loss floors,
and the reference's exact epsilon/tie handling (rt_eps/rt_2eps,
apex_reg_tree.cpp:35-36).

Host-side numpy: tree fitting is epoch-batched (once per round, like the
reference, apex_gbrt.h:820-834) and is data-dependent control flow —
kept off-device per SURVEY.md §7; the forward walk is vectorized over all
rows.  Binary model format matches RTree::Param (140 B) + Node (20 B each)
(apex_reg_tree.cpp:55-134,208-223).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Optional, Tuple

import numpy as np

RT_EPS = 1e-5
RT_2EPS = 2e-5

_PARAM_DT = np.dtype(
    [
        ("num_roots", "<i4"),
        ("num_nodes", "<i4"),
        ("num_group_sparse", "<i4"),
        ("num_deleted", "<i4"),
        ("num_spec_sparse", "<i4"),
        ("num_item", "<i4"),
        ("num_leaf_weight", "<i4"),
        ("max_depth", "<i4"),
        ("reserved", "<i4", (27,)),
    ]
)
_NODE_DT = np.dtype(
    [
        ("sparent", "<i4"),
        ("left", "<i4"),
        ("right", "<i4"),
        ("sindex", "<u4"),
        ("split_value", "<f4"),
    ]
)
assert _PARAM_DT.itemsize == 140 and _NODE_DT.itemsize == 20


class RTParamTrain:
    """Training knobs (apex_reg_tree.cpp:246-302)."""

    def __init__(self) -> None:
        self.learning_rate = 0.3
        self.min_child_weight = 10.0
        self.min_split_weight = 20.0
        self.min_split_loss = 10.0
        self.min_child_instance = 100
        self.min_split_instance = 500
        self.max_depth = 6
        self.split_method = 1
        self.split_temper = 1.0
        self.loss_type = 0
        self.wd_child = 0.0
        self.layer_split_loss: List[float] = []

    def set_param(self, name: str, val: str) -> None:
        f, i = float, int
        if name == "learning_rate":
            self.learning_rate = f(val)
        if name == "min_child_weight":
            self.min_child_weight = f(val)
        if name == "min_split_weight":
            self.min_split_weight = f(val)
        if name == "min_split_loss":
            self.min_split_loss = f(val)
        if name == "layer_split_loss":
            self.layer_split_loss.append(f(val))
        if name == "max_depth":
            self.max_depth = i(val)
        if name == "min_split_instance":
            self.min_split_instance = i(val)
        if name == "min_child_instance":
            self.min_child_instance = i(val)
        if name == "split_method":
            self.split_method = i(val)
        if name == "split_temper":
            self.split_temper = f(val)
        if name == "rt_loss_type":
            self.loss_type = i(val)
        if name == "wd_child":
            self.wd_child = f(val)

    def get_min_split_loss(self, depth: int) -> float:
        if depth < len(self.layer_split_loss):
            return self.layer_split_loss[depth]
        return self.min_split_loss


class RTree:
    """Node-array tree with packed parent/default-left bits."""

    def __init__(self) -> None:
        self.num_roots = 1
        self.num_group_sparse = 0
        self.num_spec_sparse = 0
        self.num_deleted = 0
        self.max_depth_stat = 0
        self.sparent: List[int] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.sindex: List[int] = []
        self.split_value: List[float] = []
        self.deleted: List[int] = []

    # ---- node ops --------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.sparent)

    def init_model(self) -> None:
        n = self.num_roots
        self.sparent = [-1] * n
        self.left = [-1] * n
        self.right = [-1] * n
        self.sindex = [0] * n
        self.split_value = [0.0] * n
        self.deleted = []
        self.num_deleted = 0

    def _alloc(self) -> int:
        if self.deleted:
            self.num_deleted -= 1
            return self.deleted.pop()
        self.sparent.append(-1)
        self.left.append(-1)
        self.right.append(-1)
        self.sindex.append(0)
        self.split_value.append(0.0)
        return self.num_nodes - 1

    def add_childs(self, nid: int) -> None:
        l, r = self._alloc(), self._alloc()
        self.left[nid], self.right[nid] = l, r
        self.sparent[l] = nid | (1 << 31)  # left-child bit
        self.sparent[r] = nid

    def set_split(self, nid: int, sindex: int, value: float, default_left: bool) -> None:
        self.sindex[nid] = sindex | ((1 << 31) if default_left else 0)
        self.split_value[nid] = value

    def set_leaf(self, nid: int, value: float) -> None:
        self.split_value[nid] = value
        self.left[nid] = self.right[nid] = -1

    def is_leaf(self, nid: int) -> bool:
        return self.left[nid] == -1

    def parent(self, nid: int) -> int:
        return self.sparent[nid] & ((1 << 31) - 1)

    def is_root(self, nid: int) -> bool:
        return self.sparent[nid] == -1

    def default_left(self, nid: int) -> bool:
        return (self.sindex[nid] >> 31) != 0

    def split_index(self, nid: int) -> int:
        return self.sindex[nid] & ((1 << 31) - 1)

    def get_depth(self, nid: int) -> int:
        d = 0
        while not self.is_root(nid):
            nid = self.parent(nid)
            d += 1
        return d

    def chg_to_leaf(self, nid: int, value: float) -> None:
        for c in (self.left[nid], self.right[nid]):
            self.deleted.append(c)
            self.sparent[c] = -1
            self.num_deleted += 1
        self.set_leaf(nid, value)

    def num_extra_nodes(self) -> int:
        return self.num_nodes - self.num_roots - self.num_deleted

    # ---- binary IO -------------------------------------------------------
    def save(self, f: BinaryIO) -> None:
        rec = np.zeros((), _PARAM_DT)
        rec["num_roots"] = self.num_roots
        rec["num_nodes"] = self.num_nodes
        rec["num_group_sparse"] = self.num_group_sparse
        rec["num_deleted"] = self.num_deleted
        rec["num_spec_sparse"] = self.num_spec_sparse
        rec["max_depth"] = self.max_depth_stat
        f.write(rec.tobytes())
        nodes = np.zeros(self.num_nodes, _NODE_DT)
        nodes["sparent"] = np.asarray(self.sparent, np.int64).astype(np.uint32).view(np.int32)
        nodes["left"] = self.left
        nodes["right"] = self.right
        nodes["sindex"] = np.asarray(self.sindex, np.int64).astype(np.uint32)
        nodes["split_value"] = self.split_value
        f.write(nodes.tobytes())

    def load(self, f: BinaryIO) -> None:
        rec = np.frombuffer(f.read(_PARAM_DT.itemsize), _PARAM_DT)[0]
        self.num_roots = int(rec["num_roots"])
        self.num_group_sparse = int(rec["num_group_sparse"])
        self.num_spec_sparse = int(rec["num_spec_sparse"])
        self.num_deleted = int(rec["num_deleted"])
        self.max_depth_stat = int(rec["max_depth"])
        n = int(rec["num_nodes"])
        nodes = np.frombuffer(f.read(n * _NODE_DT.itemsize), _NODE_DT)
        self.sparent = nodes["sparent"].astype(np.int64).tolist()
        self.left = nodes["left"].astype(np.int64).tolist()
        self.right = nodes["right"].astype(np.int64).tolist()
        self.sindex = nodes["sindex"].astype(np.int64).tolist()
        self.split_value = nodes["split_value"].astype(np.float64).tolist()
        self.deleted = [
            i for i in range(self.num_roots, n) if self.sparent[i] == -1
        ]

    # ---- vectorized prediction ------------------------------------------
    def predict_rows(self, smat: "SparseRows", gid: np.ndarray) -> np.ndarray:
        """Leaf values for sparse feature rows, starting at root gid[r]."""
        leaf_id = self.leaf_ids(smat, gid)
        return np.asarray(self.split_value, np.float32)[leaf_id]

    def leaf_ids(self, smat: "SparseRows", gid: np.ndarray) -> np.ndarray:
        """Vectorized tree walk (get_leaf_id, apex_reg_tree.cpp:771-786):
        all rows advance one level per iteration; missing features follow
        the node's default direction."""
        left = np.asarray(self.left)
        right = np.asarray(self.right)
        sidx = np.asarray(self.sindex, np.uint32)
        split_index = (sidx & 0x7FFFFFFF).astype(np.int64)
        default_left = (sidx >> 31) != 0
        split_value = np.asarray(self.split_value, np.float32)
        pid = np.asarray(gid, np.int64).copy()
        active = left[pid] != -1
        while active.any():
            rows = np.nonzero(active)[0]
            ap = pid[rows]
            vals = smat.lookup(rows, split_index[ap])
            unk = np.isnan(vals)
            go_left = np.where(unk, default_left[ap], vals < split_value[ap])
            pid[rows] = np.where(go_left, left[ap], right[ap])
            active = left[pid] != -1
        return pid


class SparseRows:
    """Per-row sorted sparse features in the unified index space
    [fcommon | spec_sparse | dense-global] with O(1)-vectorized lookup."""

    def __init__(self, row_ptr: np.ndarray, findex: np.ndarray, fvalue: np.ndarray, nfeat: int):
        self.row_ptr = np.asarray(row_ptr, np.int64)
        self.findex = np.asarray(findex, np.int64)
        self.fvalue = np.asarray(fvalue, np.float32)
        self.nfeat = nfeat
        # combined sorted key: row * (nfeat+1) + findex
        rows = np.repeat(
            np.arange(self.num_row, dtype=np.int64), np.diff(self.row_ptr)
        )
        self._keys = rows * (nfeat + 1) + self.findex

    @property
    def num_row(self) -> int:
        return len(self.row_ptr) - 1

    def lookup(self, rows: np.ndarray, feats: np.ndarray) -> np.ndarray:
        q = rows.astype(np.int64) * (self.nfeat + 1) + feats
        pos = np.searchsorted(self._keys, q)
        pos_c = np.minimum(pos, len(self._keys) - 1)
        found = (len(self._keys) > 0) & (self._keys[pos_c] == q)
        out = np.full(len(rows), np.nan, np.float32)
        out[found] = self.fvalue[pos_c[found]]
        return out

    def gather_entries(self, idset: np.ndarray):
        """(findex, fvalue, ridx) of all entries of the given rows."""
        starts = self.row_ptr[idset]
        counts = self.row_ptr[idset + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.int64),)
        ridx = np.repeat(idset, counts)
        # flat = arange(total) + per-entry delta to its row's start offset
        delta = starts - (np.cumsum(counts) - counts)
        flat = np.arange(total) + np.repeat(delta, counts)
        return self.findex[flat], self.fvalue[flat], ridx


class RTreeTrainer:
    """Single-tree trainer (RTreeTrainer, apex_reg_tree.cpp:726-801)."""

    def __init__(self) -> None:
        self.tree = RTree()
        self.param = RTParamTrain()
        self.silent = 1
        self.rng = np.random.RandomState(10)

    def set_param(self, name: str, val: str) -> None:
        if name == "silent":
            self.silent = int(val)
        if name == "rt_num_group":
            self.tree.num_roots = int(val)
        if name == "rt_num_group_sparse":
            self.tree.num_group_sparse = int(val)
        if name == "rt_num_spec_sparse":
            self.tree.num_spec_sparse = int(val)
        self.param.set_param(name, val)

    def init_trainer(self) -> None:
        self.tree.init_model()

    def load_model(self, f: BinaryIO) -> None:
        self.tree.load(f)

    def save_model(self, f: BinaryIO) -> None:
        self.tree.save(f)

    def predict_rows(self, F, gid):
        return self.tree.predict_rows(F, gid)

    def leaf_ids(self, F, gid):
        return self.tree.leaf_ids(F, gid)

    # ---- boosting ---------------------------------------------------------
    def do_boost(
        self,
        grad: np.ndarray,
        grad_second: np.ndarray,
        smat: SparseRows,
        group_id: Optional[np.ndarray],
        weight: Optional[np.ndarray],
    ) -> None:
        """Fit one tree on the accumulated epoch stats (RTreeUpdater::
        do_boost, apex_reg_tree.cpp:713-724)."""
        R = len(grad)
        grad = np.asarray(grad, np.float64)
        h = np.asarray(grad_second, np.float64)
        if self.param.loss_type == 0:
            w = (
                np.ones(R, np.float64)
                if weight is None or len(weight) == 0
                else np.asarray(weight, np.float64)
            )
        else:
            w = h * 4.0  # compat rule (apex_reg_tree.cpp:456-463)

        self._grad, self._h, self._w, self._smat = grad, h, w, smat
        self._stat = {}
        self.max_depth_seen = 0
        self.num_pruned = 0
        tasks: List[Tuple[int, np.ndarray]] = []
        if group_id is None or len(group_id) == 0:
            tasks.append((0, np.arange(R, dtype=np.int64)))
        else:
            group_id = np.asarray(group_id, np.int64)
            assert group_id.max(initial=0) < self.tree.num_roots, "group id exceed number of roots"
            order = np.argsort(group_id, kind="stable")
            gids, starts = np.unique(group_id[order], return_index=True)
            bounds = np.append(starts, R)
            for k, gd in enumerate(gids):
                tasks.append((int(gd), np.sort(order[bounds[k] : bounds[k + 1]])))
        # LIFO like the reference's task stack
        while tasks:
            nid, idset = tasks.pop()
            tasks.extend(self._expand(nid, idset))
        self.tree.max_depth_stat = self.max_depth_seen
        if not self.silent:
            print(
                f"tree train end, {self.tree.num_roots} roots, "
                f"{self.tree.num_extra_nodes()} extra nodes, "
                f"{self.num_pruned} pruned nodes, max_depth={self.max_depth_seen}"
            )

    def _make_leaf(self, nid, idset, rsum, rweight, compute):
        t = self.tree
        g, h, w = self._grad, self._h, self._w
        rsum_sgrad = float(h[idset].sum())
        if compute:
            rsum = float(g[idset].sum())
            rweight = float(w[idset].sum())
        if rweight < self.param.min_child_weight:
            t.set_leaf(nid, 0.0)
        else:
            assert rsum_sgrad > 1e-5, "second order derivative too low"
            t.set_leaf(
                nid,
                -self.param.learning_rate * rsum / (rsum_sgrad + self.param.wd_child),
            )
        self._try_prune_leaf(nid, rsum, rsum_sgrad, t.get_depth(nid))

    def _try_prune_leaf(self, nid, rsum, rsum_sgrad, depth):
        t = self.tree
        if t.is_root(nid):
            return
        pid = t.parent(nid)
        s = self._stat.setdefault(pid, dict(loss_chg=0.0, rsum=0.0, sg=0.0, cnt=0))
        s["cnt"] += 1
        s["rsum"] += rsum
        s["sg"] += rsum_sgrad
        if s["cnt"] >= 2 and s["loss_chg"] < self.param.get_min_split_loss(depth - 1):
            assert s["sg"] > 1e-5, "second order derivative too low"
            t.chg_to_leaf(
                pid, -self.param.learning_rate * s["rsum"] / (s["sg"] + self.param.wd_child)
            )
            self.num_pruned += 2
            self._try_prune_leaf(pid, s["rsum"], s["sg"], depth - 1)

    def _expand(self, nid: int, idset: np.ndarray):
        """Exact-greedy split search (RTreeUpdater::expand,
        apex_reg_tree.cpp:548-670), vectorized across ALL features at once:
        segmented cumulative sums over the (findex, fvalue)-sorted entry
        array give every candidate's children statistics; the reference's
        forward/backward scans with min-child gating, break semantics
        (monotone, so a mask), first-max tie-breaking, and the
        local-then-global selection order are reproduced exactly."""
        t, p = self.tree, self.param
        g, w = self._grad, self._w
        depth = t.get_depth(nid)
        self.max_depth_seen = max(self.max_depth_seen, depth)
        if depth >= p.max_depth or len(idset) < p.min_split_instance:
            self._make_leaf(nid, idset, 0.0, 0.0, True)
            return []
        min_split_loss = p.get_min_split_loss(depth)

        rsum = float(g[idset].sum())
        rweight = float(w[idset].sum())
        if rweight < p.min_split_weight:
            self._make_leaf(nid, idset, rsum, rweight, False)
            return []
        rmean_sqr_sum = (rsum / rweight) ** 2 * rweight

        fi, fv, ridx = self._smat.gather_entries(idset)
        E = len(fi)
        if E == 0:
            self._make_leaf(nid, idset, rsum, rweight, False)
            return []
        order = np.lexsort((fv, fi))
        fi, fv, ridx = fi[order], fv[order], ridx[order]
        starts = np.concatenate(([0], np.nonzero(np.diff(fi))[0] + 1))
        nseg = len(starts)
        seg_of = np.repeat(np.arange(nseg), np.diff(np.append(starts, E)))
        seg_start = starts[seg_of]
        seg_end = np.append(starts[1:], E)[seg_of]
        pos_in = np.arange(E) - seg_start  # 0-based within segment
        seg_len = seg_end - seg_start
        ntot = len(idset)
        ge = g[ridx]
        we = w[ridx]

        gap_f = np.empty(E, bool)  # boundary after position (forward)
        gap_f[:-1] = fv[:-1] + RT_2EPS < fv[1:]
        gap_f[-1] = True
        gap_f[seg_end - 1] = True
        gap_b = np.empty(E, bool)  # boundary before position (backward)
        gap_b[1:] = fv[:-1] + RT_2EPS < fv[1:]
        gap_b[0] = True
        gap_b[seg_start] = True

        csum_all = np.cumsum(ge)
        cw_all = np.cumsum(we)
        base_g = csum_all[seg_start] - ge[seg_start]
        base_w = cw_all[seg_start] - we[seg_start]

        def losses_for(csum, cweight, clen, gap_mask):
            dweight = rweight - cweight
            dlen = ntot - clen
            ok = (
                (clen >= p.min_child_instance)
                & (cweight >= p.min_child_weight)
                & (dlen >= p.min_child_instance)
                & (dweight >= p.min_child_weight)
                & gap_mask
            )
            # positions with ~zero complement weight are masked by ok;
            # suppress the spurious overflow warnings they generate
            with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
                loss = (
                    (csum / np.maximum(cweight, 1e-300)) ** 2 * cweight
                    + ((rsum - csum) / np.maximum(dweight, 1e-300)) ** 2 * dweight
                    - rmean_sqr_sum
                )
            return np.where(ok & np.isfinite(loss), loss, -np.inf)

        # forward: child = prefix ending at this position (default right)
        lf = losses_for(csum_all - base_g, cw_all - base_w, pos_in + 1, gap_f)
        # backward: child = suffix starting at this position (default left)
        tail_g = (csum_all[seg_end - 1] - csum_all) + ge
        tail_w = (cw_all[seg_end - 1] - cw_all) + we
        lb = losses_for(tail_g, tail_w, seg_len - pos_in, gap_b)

        # per-feature first-max for each direction, then local select
        # (forward candidates precede backward; ties keep the earlier)
        idx_arr = np.arange(E)
        BIG = E + 1

        def seg_best(l):
            m = np.maximum.reduceat(l, starts)
            is_max = (l == m[seg_of]) & np.isfinite(l)
            first = np.minimum.reduceat(np.where(is_max, idx_arr, BIG), starts)
            return m, first

        mf, jf = seg_best(lf)
        mb, jb = seg_best(lb)
        use_b = mb > mf  # backward wins only on strictly greater
        seg_loss = np.where(use_b, mb, mf)
        seg_j = np.where(use_b, jb, jf)

        valid = np.isfinite(seg_loss) & (seg_j < BIG)
        if p.split_method == 0:
            valid &= seg_loss >= min_split_loss
        chosen = None
        if valid.any():
            if p.split_method in (0, 1):
                sl = np.where(valid, seg_loss, -np.inf)
                si = int(np.argmax(sl))
                chosen = (si, float(sl[si]))
            elif p.split_method == 2:
                vs = np.nonzero(valid)[0]
                best_loss = seg_loss[vs].max()
                beta = 1.0 / p.split_temper
                wts = np.cumsum(np.exp((seg_loss[vs] - best_loss) * beta))
                r = self.rng.rand() * wts[-1]
                si = int(vs[min(int(np.searchsorted(wts, r)), len(vs) - 1)])
                chosen = (si, float(seg_loss[si]))
            else:
                raise ValueError("unknown split method")

        if chosen is not None and chosen[1] > RT_EPS:
            si, loss_chg = chosen
            j = int(seg_j[si])
            fx = int(fi[starts[si]])
            s0 = int(starts[si])
            s1 = int(starts[si + 1]) if si + 1 < nseg else E
            if use_b[si]:
                dl = True
                split_rows = ridx[j:s1]
                sv = fv[s0] - RT_EPS if j == s0 else 0.5 * (fv[j - 1] + fv[j])
            else:
                dl = False
                split_rows = ridx[s0 : j + 1]
                sv = fv[j] + RT_EPS if j == s1 - 1 else 0.5 * (fv[j] + fv[j + 1])
            self._stat[nid] = dict(loss_chg=loss_chg, rsum=0.0, sg=0.0, cnt=0)
            t.set_split(nid, fx, float(sv), dl)
            t.add_childs(nid)
            split_rows = np.unique(split_rows)
            rest = np.setdiff1d(idset, split_rows, assume_unique=True)
            # make_split (apex_reg_tree.cpp:506-545): the scanned child rows
            # are the low-value side on a forward scan (-> left child,
            # default right) and the high-value side on a backward scan
            # (-> right child, default left); unknowns follow the default.
            if dl:
                left_set, right_set = rest, split_rows
            else:
                left_set, right_set = split_rows, rest
            return [(t.left[nid], left_set), (t.right[nid], right_set)]
        self._make_leaf(nid, idset, rsum, rweight, False)
        return []
