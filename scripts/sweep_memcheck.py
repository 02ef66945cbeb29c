#!/usr/bin/env python3
"""K4's wide kernel (csrc/tile_sweep.cu ``sweep_wide_kernel``) on every wide
case of chip_smoke.py phase 6, with guard bands, under compute-sanitizer's
memcheck where the card allows it.

Usage, from the repository root, on a machine with a card and the CUDA
toolkit:

    python3 scripts/sweep_memcheck.py                  # this tree's kernels, under memcheck
    python3 scripts/sweep_memcheck.py --source FILE    # another tile_sweep.cu (an older form)
    python3 scripts/sweep_memcheck.py --bare           # the cases alone, no sanitizer
    python3 scripts/sweep_memcheck.py --bare --trials 20 --cases 300:skewed:2 --source FILE

Each case (``chip_smoke.WIDE_CASES`` on ``chip_smoke.wide_inputs``, or
``--cases``) runs K4 through ``ops/cuda_sweep.sweep_update`` ``--trials``
times (once by default), each on a fresh copy of the table, and holds the
table to the plain version (``BIG_ATOL`` + ``BIG_RTOL``, ref bits, dummy
and pad rows exact); a fault ends the run.  Every tensor the kernel reads
or writes, the scratch of partial sums and arrival counts included, lies
inside a buffer whose GUARD
elements before and after it hold a canary bit pattern; a case passes only
if every canary is intact and the arrival counts are back at 0.  With
``--source`` that file alone is compiled with the build's flags into a
library of its own, whose ``sweep_apply`` the wrapper then launches.
Without ``--bare`` the script runs itself under ``compute-sanitizer --tool
memcheck``; the sanitizer's report and a line a case go to stdout
(``--log`` copies them to a file).  Exit code 0 only if every case passes
and memcheck reports no error (the sanitizer refuses some cards: "Device
not supported").
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def variant_library(source: pathlib.Path, work: pathlib.Path) -> ctypes.CDLL:
    """``source`` alone compiled with the build's flags, loaded, its
    ``sweep_apply`` typed as the build types it."""
    from svdfeature_tpu_torch.ops import _build

    lib = work / "libsweep_variant.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR), "-o",
           str(lib), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "sweep_wide_kernel" in line or "spill" in line or "registers" in line:
            print(f"variant ptxas: {line.strip()}", flush=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr[-4000:]}")
    out = ctypes.CDLL(str(lib))
    out.sweep_apply.argtypes = _build.SIGNATURES["sweep_apply"]
    out.sweep_apply.restype = ctypes.c_int
    return out


GUARD = 4096  # canary elements before and after every tensor of a case
CANARY = 0x7FC0DEAD  # a NaN's bits, as int32


def guarded(torch, t):
    """(buffer, view): a copy of ``t`` (float32 or int32) inside a buffer
    whose GUARD elements on either side hold CANARY."""
    buf = torch.empty(t.numel() + 2 * GUARD, dtype=t.dtype, device=t.device)
    buf.view(torch.int32).fill_(CANARY)
    view = buf[GUARD:GUARD + t.numel()].view(t.shape)
    view.copy_(t)
    return buf, view


def intact(torch, buf) -> bool:
    bits = buf.view(torch.int32)
    return bool((bits[:GUARD] == CANARY).all()) and bool((bits[-GUARD:] == CANARY).all())


def run_cases(source, cases, trials) -> int:
    import torch

    import chip_smoke
    from svdfeature_tpu_torch.ops import _build, big_embed, cuda_sweep
    from svdfeature_tpu_torch.ops.embed import HyperParams

    if not torch.cuda.is_available():
        print("sweep_memcheck: torch.cuda.is_available() is false", flush=True)
        return 1
    dev = torch.device("cuda", 0)
    scratch = []

    def guarded_scratch(sizes, device, stream):
        """The wrapper's scratch (partial sums, arrival counts), zeroed,
        inside guard bands."""
        total = sum(-(-size // 4) * 4 for size in sizes.values())
        buf = torch.zeros(total + 2 * GUARD, dtype=torch.float32, device=device)
        buf.view(torch.int32)[:GUARD] = CANARY
        buf.view(torch.int32)[-GUARD:] = CANARY
        scratch.append((buf, sizes))
        ptrs, off = {}, GUARD
        for name, size in sizes.items():
            ptrs[name] = buf.data_ptr() + 4 * off
            off += -(-size // 4) * 4
        return ptrs

    cuda_sweep.kept_scratch = guarded_scratch  # the wrapper's name for it
    (ROOT / "build").mkdir(exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="sweep_variant_", dir=ROOT / "build"))
    try:
        if source:
            lib = variant_library(pathlib.Path(source).resolve(), work)
            _build.load_library = lambda: lib  # the wrapper looks it up at each call
        else:
            _build.load_library()
        u, items = chip_smoke.wide_inputs()
        bad = 0
        for k, kind, m in cases:
            case = chip_smoke.big_sweep_case(torch, dev, chip_smoke.WIDE_N, u, items[kind],
                                             seed=17, k=k)
            hp = HyperParams(big_table=True, num_factor=k, sweep_table=True, reg_method=m)
            plan, *rest = case["args"]
            bufs, views = {}, {}
            for name, t in [("w", case["w"])] + list(plan.items()) + list(zip(
                    ("p_u", "p_i", "coef_u", "coef_i", "wdu", "wdi", "scal", "stepi"), rest)):
                bufs[name], views[name] = guarded(torch, t)
            vplan = {key: views[key] for key in plan}
            vrest = [views[name] for name in ("p_u", "p_i", "coef_u", "coef_i", "wdu", "wdi",
                                              "scal", "stepi")]
            want = cuda_sweep.sweep_update_reference(case["w"].clone(), *case["args"], hp)
            n = chip_smoke.WIDE_N
            pieces = int((plan["sw_runs"][:, 3] >= 0).sum())
            label = f"K4 k={k} {kind} items reg_method={m} ({pieces} pieces)"
            wrong = spoilt = largest = 0
            t0 = time.perf_counter()
            for trial in range(trials):
                views["w"].copy_(case["w"])  # a fresh table each launch
                scratch.clear()
                try:
                    got = cuda_sweep.sweep_update(views["w"], vplan, *vrest, hp)
                    torch.cuda.synchronize()
                except Exception as err:  # a fault ends the run: the context is lost
                    print(f"case FAIL: {label}: launch {trial + 1} of {trials} raised "
                          f"{str(err).splitlines()[0]} ({wrong} wrong before it)", flush=True)
                    return 1
                diff = (got[:, :k + 1] - want[:, :k + 1]).abs()
                largest = max(largest, float(diff.max()))
                wrong += not (bool((diff <= chip_smoke.BIG_ATOL + chip_smoke.BIG_RTOL
                                    * want[:, :k + 1].abs()).all())
                              and torch.equal(big_embed.ref_column(got, k),
                                              big_embed.ref_column(want, k))
                              and bool((got[n - 1, :k + 1] == 0).all())
                              and bool((got[n:] == 0).all()))
                guards = all(intact(torch, buf) for buf in bufs.values()) and all(
                    intact(torch, buf) for buf, _ in scratch)
                counts = all(bool((buf[GUARD + -(-sizes["part"] // 4) * 4:][:sizes["count"]]
                                   == 0).all()) for buf, sizes in scratch)
                spoilt += not (guards and counts and len(scratch) == 1)
            bad += wrong + spoilt > 0
            print(f"case {'ok' if wrong + spoilt == 0 else 'FAIL'}: {label}: {trials} launches, "
                  f"{wrong} wrong (largest |d| {largest:.3e}; atol {chip_smoke.BIG_ATOL:g} + rtol "
                  f"{chip_smoke.BIG_RTOL:g}, ref bits, dummy and pad rows exact), {spoilt} with a "
                  f"canary overwritten around the {len(bufs)} tensors and the scratch or an "
                  f"arrival count not back at 0; {time.perf_counter() - t0:.2f} s", flush=True)
            del case, got, want, diff, bufs, views, vplan, vrest
            torch.cuda.empty_cache()
        return 1 if bad else 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", help="a tile_sweep.cu to build and run instead of the tree's")
    ap.add_argument("--bare", action="store_true", help="run the cases without the sanitizer")
    ap.add_argument("--trials", type=int, default=1, help="launches a case (default 1)")
    ap.add_argument("--cases", help="K:ITEMS:REG,... (default chip_smoke.WIDE_CASES)")
    ap.add_argument("--log", help="copy the output to this file")
    args = ap.parse_args()
    if args.bare:
        import chip_smoke

        cases = chip_smoke.WIDE_CASES if not args.cases else [
            (int(k), kind, int(m)) for k, kind, m in (c.split(":") for c in args.cases.split(","))]
        return run_cases(args.source, cases, args.trials)
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    sanitizer = shutil.which("compute-sanitizer") or str(pathlib.Path(home) / "bin" /
                                                         "compute-sanitizer")
    cmd = [sanitizer, "--tool", "memcheck", "--error-exitcode", "7", "--print-limit", "20",
           sys.executable, __file__, "--bare", "--trials", str(args.trials)]
    cmd += (["--source", args.source] if args.source else []) + (
        ["--cases", args.cases] if args.cases else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          cwd=ROOT)
    text = (f"$ {' '.join(cmd)}\n{proc.stdout}exit code {proc.returncode} after "
            f"{time.perf_counter() - t0:.1f} s\n")
    print(text, end="", flush=True)
    if args.log:
        pathlib.Path(args.log).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.log).write_text(text)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
