"""Build and load the port's hand-written CUDA kernels.

nvcc compiles every source under ``svdfeature_tpu_torch/csrc/`` (``*.cu``,
which include the shared ``*.cuh``), one process per source, all started
together, and links the objects into one shared library with a plain C
interface, ``build/kernels/libsvdfeature_kernels.so`` at the repository
root, which is loaded with ctypes.  The build runs at first use, and again
whenever a source or the flags change (a stamp file beside the library
holds their hash).  Nothing is built when a module is imported.  The
ranks of a mesh start together on a fresh tree: an exclusive ``fcntl``
lock on ``build/kernels/.build.lock`` lets one process build while the
others wait, then find the library fresh.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libsvdfeature_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills of each kernel, kept in nvcc.log
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of each C entry point in csrc/ (pointers and the stream as void*)
SIGNATURES = {
    # the persistent kernels (K1, K2, K3): pointer, int and float arrays of
    # their arguments, the grid they chose (int*), the stream
    "sgd_rounds": [_P] * 5,
    "svdpp_rounds": [_P] * 5,
    "imfb_rounds": [_P] * 5,
    "row_write": [_P] * 3 + [_I] * 3 + [_P],
    "row_read": [_P] * 3 + [_I] * 3 + [_P],
    "row_noop": [_P] * 3 + [_I] * 3 + [_P],
    # K4: its pointer array, its int array, the stream
    "sweep_apply": [_P] * 3,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> pathlib.Path:
    """Compile the kernels if the library is missing or stale; returns
    its path.  One process at a time builds (the lock file); a process
    that waited finds the library fresh.  Raises RuntimeError if nvcc
    fails; its output is kept in ``build/kernels/nvcc.log``."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = _digest(sources + sorted(CSRC_DIR.glob("*.cuh")))
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")

    def fresh() -> bool:
        return lib.exists() and stamp.exists() and stamp.read_text() == digest

    if fresh():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes, or the process dies
        if not fresh():
            _compile(sources, lib, stamp, digest)
    return lib


def _compile(sources, lib: pathlib.Path, stamp: pathlib.Path, digest: str) -> None:
    """nvcc on every source at once, then the link; the library and its
    stamp replace the old ones only when all of it succeeded."""
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [" ".join(cmd) + "\n" + proc.communicate()[0] for cmd, proc in zip(cmds, procs)]
    failed = [cmd[-1] for cmd, proc in zip(cmds, procs) if proc.returncode != 0]
    tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
    if not failed:
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(" ".join(link) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append("the link")
    (BUILD_DIR / "nvcc.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{''.join(logs)[-4000:]}")
    os.replace(tmp, lib)  # atomic: a process that loads it never reads half a file
    stamp.write_text(digest)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argtypes and restype declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
