"""The kernel build (svdfeature_tpu_torch/ops/_build.py) with the compiler
stubbed: the ranks of a mesh start together on a fresh tree, and the lock
lets one process build while the others wait and find the library fresh;
a failed compile raises (no plain version stands in for a kernel)."""

import os
import pathlib
import stat
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# a stand-in nvcc: logs its call, takes a while, writes its -o file
FAKE_NVCC = textwrap.dedent("""\
    #!/bin/sh
    out=""; prev=""
    for a in "$@"; do
      if [ "$prev" = "-o" ]; then out="$a"; fi
      prev="$a"
    done
    echo "$out" >> "$NVCC_LOG"
    if [ -n "$NVCC_FAIL" ]; then echo "error: stubbed failure"; exit 2; fi
    sleep 0.3
    echo built > "$out"
""")

BUILD_SCRIPT = textwrap.dedent("""\
    import pathlib, sys
    from svdfeature_tpu_torch.ops import _build
    _build.CSRC_DIR = pathlib.Path(sys.argv[1])
    _build.BUILD_DIR = pathlib.Path(sys.argv[2])
    print(_build.build())
""")


def _setup(tmp_path, fail=False):
    bin_dir, csrc = tmp_path / "bin", tmp_path / "csrc"
    bin_dir.mkdir()
    csrc.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    (csrc / "c.cuh").write_text("// shared\n")
    env = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}", "PYTHONPATH": str(ROOT),
           "NVCC_LOG": str(tmp_path / "nvcc.calls")}
    if fail:
        env["NVCC_FAIL"] = "1"
    cmd = [sys.executable, "-c", BUILD_SCRIPT, str(csrc), str(tmp_path / "build")]
    return cmd, env


def test_concurrent_builds_compile_once(tmp_path):
    """Four processes build at once: two compiles and one link in all, and
    every process gets the library; a fifth finds it fresh."""
    cmd, env = _setup(tmp_path)
    procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    lib = tmp_path / "build" / "libsvdfeature_kernels.so"
    assert {o[0].strip() for o in outs} == {str(lib)}
    calls = (tmp_path / "nvcc.calls").read_text().splitlines()
    assert len(calls) == 3 and calls[-1].endswith(".tmp")
    subprocess.run(cmd, env=env, check=True, capture_output=True, timeout=120)
    assert len((tmp_path / "nvcc.calls").read_text().splitlines()) == 3


def test_failed_build_raises(tmp_path):
    """A compile that fails raises RuntimeError naming the sources and
    leaves no library behind."""
    cmd, env = _setup(tmp_path, fail=True)
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "RuntimeError: nvcc failed on" in proc.stderr and "a.cu" in proc.stderr
    assert not (tmp_path / "build" / "libsvdfeature_kernels.so").exists()
