# Verbatim copy of svdfeature_tpu/cli/combine_ugroup.py; tests/test_torch_data.py keeps the two identical.
"""CLI: merge per-feature-column files into one user-group buffer.

Port of tools/combine_ugroup.cpp (and kddcup_combine_ugroup.cpp, which is
identical except default scale_score=100).  Inputs:

* ``<inname>``: the base 3-column file (labels from its 3rd column, or
  overridden by ``-rt`` rating file);
* ``<inname>.<fdsuffix>`` (default suffix ``imfb``): feedback records
  ``nline nfeedback idx:val ...``;
* per-column files ``features/<inname>.<suffix>`` listed after ``-g``
  (global) / ``-u`` (user) / ``-i`` (item) / ``-efd`` (extra feedback):
  first token = num_feat, then one ``n idx:val ...`` record per line;
  ``-gd`` adds a dense single-value global column; ``-skip n`` widens the
  previous column's id range (or the segment base when first).
* ``-wlist`` file: per-line 0/1 keep flags.

Feature ids are renumbered by cumulative base offsets, rows sorted by
index within each segment, and oversize groups split like the reference.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np

from ..data.csr import CSRDataset, PlusBlock, PlusDataset
from ..data.buffer import write_plus_buffer
from ..data.text import _numeric_tokens, _split_counts, TAG_DEFAULT, TAG_END, TAG_MIDDLE, TAG_START


@dataclasses.dataclass
class Column:
    path: Optional[str]
    is_dense: bool = False
    num_feat: int = 0
    base: int = 0
    skip: int = 0
    toks: Optional[np.ndarray] = None
    pos: int = 0

    def open(self):
        self.toks = _numeric_tokens(open(self.path).read())
        if not self.is_dense:
            self.num_feat = int(self.toks[0])
            self.pos = 1
        else:
            self.num_feat = 1

    def read_row(self):
        """Return (idx, val) arrays for the next line."""
        if self.is_dense:
            v = self.toks[self.pos]
            self.pos += 1
            return np.array([self.base], np.int64), np.array([v], np.float32)
        n = int(self.toks[self.pos])
        self.pos += 1
        pairs = self.toks[self.pos : self.pos + 2 * n]
        self.pos += 2 * n
        idx = pairs[0::2].astype(np.int64)
        if len(idx) and idx.max() >= self.num_feat:
            print(
                f"warning:some feature exceed bound, num_feat={self.num_feat}",
                file=sys.stderr,
            )
        return idx + self.base, pairs[1::2].astype(np.float32)


def _norm(cols: List[Column], base: int) -> int:
    n = base
    for c in cols:
        c.base = n
        n += c.num_feat + c.skip
    return n


def run(argv, default_scale=1.0) -> int:
    if len(argv) < 2:
        print(
            "Usage:<inname> <outname> [options] -g [gf1]... -u [uf1]... -i [if1]... -efd [fd1]...\n"
            "options: -max_block n, -scale_score s, -fd feedback_suffix, -rt rating_file, -wlist whitelist, -gd densefile, -skip n"
        )
        return 0
    inname, outname = argv[0], argv[1]
    folder = "features"
    fdsuffix = "imfb"
    scale_score = default_scale
    max_block = 10000
    rate_path = wlist_path = None
    cols = {0: [], 1: [], 2: [], 3: []}  # g, u, i, efd
    bases = [0, 0, 0, 0]
    mode = 0
    i = 2
    while i < len(argv):
        a = argv[i]
        if a == "-g":
            mode = 0
        elif a == "-u":
            mode = 1
        elif a == "-i":
            mode = 2
        elif a == "-efd":
            mode = 3
        elif a == "-gd":
            mode = 4
        elif a == "-max_block":
            i += 1
            max_block = int(argv[i])
        elif a == "-scale_score":
            i += 1
            scale_score = float(argv[i])
        elif a == "-fd":
            i += 1
            fdsuffix = argv[i]
        elif a == "-rt":
            i += 1
            rate_path = argv[i]
        elif a == "-wlist":
            i += 1
            wlist_path = argv[i]
        elif a == "-skip":
            i += 1
            skip = int(argv[i])
            m = min(mode, 3)
            if cols[m]:
                cols[m][-1].skip += skip
            else:
                bases[m] += skip
        else:
            c = Column(path=f"{folder}/{inname}.{a}", is_dense=(mode == 4))
            c.open()
            cols[0 if mode == 4 else mode].append(c)
        i += 1

    start = time.time()
    ng = _norm(cols[0], bases[0])
    nu = _norm(cols[1], bases[1])
    ni = _norm(cols[2], bases[2])
    nfd = _norm(cols[3], bases[3])
    print(f"num_global={ng}, num_user={nu}, num_item={ni}, num_extra_imfb={nfd}")
    print("start creating buffer...")

    labels_src = open(rate_path).read().split("\n") if rate_path else None
    base_lines = open(inname).read().splitlines()
    fdtoks = _numeric_tokens(open(f"{inname}.{fdsuffix}").read())
    wlist = None
    if wlist_path:
        wlist = [int(l.split()[0]) != 0 for l in open(wlist_path) if l.strip()]

    blocks: List[PlusBlock] = []
    fpos = 0
    line_no = 0
    wl_pos = 0
    while fpos + 2 <= len(fdtoks):
        nline, nfb = int(fdtoks[fpos]), int(fdtoks[fpos + 1])
        fpos += 2
        fb_i = [fdtoks[fpos : fpos + 2 * nfb : 2].astype(np.int64)]
        fb_v = [fdtoks[fpos + 1 : fpos + 2 * nfb : 2].astype(np.float32)]
        fpos += 2 * nfb
        for c in cols[3]:
            ei, ev = c.read_row()
            fb_i.append(ei)
            fb_v.append(ev)
        fb_idx = np.concatenate(fb_i)
        fb_val = np.concatenate(fb_v)
        order = np.argsort(fb_idx, kind="stable")
        fb_idx, fb_val = fb_idx[order].astype(np.uint32), fb_val[order]

        # rows of this group (wlist filters lines but consumes columns)
        labels, row_ptr, fi_, fv_ = [], [0], [], []
        taken = 0
        want = nline
        while taken < want:
            parts = base_lines[line_no].split()
            label = float(labels_src[line_no]) if labels_src else float(parts[2])
            line_no += 1
            segs = []
            for m in (0, 1, 2):
                si, sv = [], []
                for c in cols[m]:
                    ci, cv = c.read_row()
                    si.append(ci)
                    sv.append(cv)
                ii = np.concatenate(si) if si else np.zeros(0, np.int64)
                vv = np.concatenate(sv) if sv else np.zeros(0, np.float32)
                o = np.argsort(ii, kind="stable")
                segs.append((ii[o], vv[o]))
            keep = True
            if wlist is not None:
                keep = wlist[wl_pos]
                wl_pos += 1
                if not keep:
                    want -= 1
                    continue
            labels.append(label / scale_score)
            for si, sv in segs:
                fi_.append(si)
                fv_.append(sv)
                row_ptr.append(row_ptr[-1] + len(si))
            taken += 1

        rows = CSRDataset(
            labels=np.asarray(labels, np.float32),
            row_ptr=np.asarray(row_ptr, np.int32),
            index=(np.concatenate(fi_).astype(np.uint32) if fi_ else np.zeros(0, np.uint32)),
            value=(np.concatenate(fv_).astype(np.float32) if fv_ else np.zeros(0, np.float32)),
        )
        chunks = _split_counts(rows.num_row, max_block)
        r0 = 0
        for ci, num in enumerate(chunks):
            if len(chunks) == 1:
                tg = TAG_DEFAULT
            elif ci == 0:
                tg = TAG_START
            elif ci == len(chunks) - 1:
                tg = TAG_END
            else:
                tg = TAG_MIDDLE
            carries = tg != TAG_MIDDLE
            blocks.append(
                PlusBlock(
                    fb_index=fb_idx if carries else np.zeros(0, np.uint32),
                    fb_value=fb_val if carries else np.zeros(0, np.float32),
                    data=rows.slice_rows(r0, num),
                    extend_tag=tg,
                )
            )
            r0 += num

    ds = PlusDataset.from_blocks(blocks)
    write_plus_buffer(outname, ds)
    print(
        f"all generation end,{len(blocks)} blocks, {time.time()-start:.0f} sec used"
    )
    return 0


def main(argv=None) -> int:
    return run(argv if argv is not None else sys.argv[1:], default_scale=1.0)


def main_kddcup(argv=None) -> int:
    """kddcup_combine_ugroup: same tool, default scale_score=100."""
    return run(argv if argv is not None else sys.argv[1:], default_scale=100.0)


if __name__ == "__main__":
    sys.exit(main())
