"""The port's numpy tools (verbatim copies: cli/line_shuffle.py,
cli/line_reorder.py, cli/svdpp_randorder.py, cli/combine_ugroup.py,
utils/csr_builder.py) give the JAX package's tools' output byte for byte
on the same tiny inputs."""

import numpy as np

from svdfeature_tpu.cli import combine_ugroup as jcombine
from svdfeature_tpu.cli import line_reorder as jreorder
from svdfeature_tpu.cli import line_shuffle as jshuffle
from svdfeature_tpu.cli import svdpp_randorder as jrandorder
from svdfeature_tpu.utils import csr_builder as jcsr
from svdfeature_tpu_torch.cli import combine_ugroup as tcombine
from svdfeature_tpu_torch.cli import line_reorder as treorder
from svdfeature_tpu_torch.cli import line_shuffle as tshuffle
from svdfeature_tpu_torch.cli import svdpp_randorder as trandorder
from svdfeature_tpu_torch.utils import csr_builder as tcsr


def lines_file(path, n=37):
    rng = np.random.RandomState(1)
    path.write_text("".join(f"{rng.randint(1, 6)} 0 1 1 {rng.randint(0, 9)}:1 {i}:1\n"
                            for i in range(n)))
    return path


def outputs(tmp_path, tools, argv_of):
    """Each package's tool run on the same argv (its own output file)."""
    out = []
    for tag, tool in zip(("jax", "torch"), tools):
        dst = tmp_path / f"out.{tag}"
        assert tool.main(argv_of(str(dst))) == 0
        out.append(dst.read_bytes())
    return out


def test_line_shuffle_matches_jax(tmp_path):
    src = lines_file(tmp_path / "in.txt")
    j, t = outputs(tmp_path, (jshuffle, tshuffle), lambda dst: [str(src), dst, "7"])
    assert t == j and t != src.read_bytes() and sorted(t.splitlines()) == sorted(
        src.read_bytes().splitlines())


def test_line_reorder_matches_jax(tmp_path):
    src = lines_file(tmp_path / "in.txt")
    order = tmp_path / "order.txt"
    order.write_text("".join(f"{i}\t0\n" for i in np.random.RandomState(2).permutation(37)))
    j, t = outputs(tmp_path, (jreorder, treorder), lambda dst: [str(src), str(order), dst])
    assert t == j and len(t.splitlines()) == 37


def test_svdpp_randorder_matches_jax(tmp_path):
    src = tmp_path / "in.txt"
    src.write_text("".join(f"{u} {i} 1\n" for u in (3, 1, 3, 2, 1, 1, 0, 2) for i in range(2)))
    j, t = outputs(tmp_path, (jrandorder, trandorder), lambda dst: [str(src), dst, "5"])
    assert t == j and len(t.splitlines()) == 16


def test_combine_ugroup_matches_jax(tmp_path, monkeypatch):
    """A 3-column base file with its feedback, a user column and an item
    column (features/), split blocks at -max_block 2: the same buffer."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "features").mkdir()
    rows = [(0, 1, 5), (0, 2, 3), (0, 3, 4), (1, 0, 2), (2, 1, 1), (2, 3, 5)]
    (tmp_path / "base").write_text("".join(f"{u} {i} {r}\n" for u, i, r in rows))
    (tmp_path / "base.imfb").write_text("3 2 1:0.5 2:0.5\n1 1 0:1\n2 2 1:0.7 3:0.7\n")
    (tmp_path / "features" / "base.user").write_text(
        "3\n" + "".join(f"1 {u}:1\n" for u, _, _ in rows))
    (tmp_path / "features" / "base.item").write_text(
        "4\n" + "".join(f"2 {i}:1 {(i + 1) % 4}:0.5\n" for _, i, _ in rows))
    j, t = outputs(tmp_path, (jcombine, tcombine), lambda dst: [
        "base", dst, "-u", "user", "-i", "item", "-max_block", "2", "-scale_score", "5"])
    assert t == j and len(t) > 0


def test_csr_builder_matches_jax():
    """build_csr and the 5-step SparseCSRMBuilder give the same arrays."""
    rng = np.random.RandomState(4)
    rows, cols = rng.randint(0, 9, 60), rng.randint(0, 100, 60)
    for a, b in zip(jcsr.build_csr(rows, cols, 9), tcsr.build_csr(rows, cols, 9)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    built = []
    for mod in (jcsr, tcsr):
        bld = mod.SparseCSRMBuilder()
        bld.init_budget(9)
        for r in rows:
            bld.add_budget(r)
        bld.init_storage()
        for r, c in zip(rows, cols):
            bld.push_elem(r, c)
        built.append((bld.rptr, bld.findex))
    for a, b in zip(*built):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
