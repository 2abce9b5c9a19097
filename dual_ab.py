#!/usr/bin/env python3
"""Compare dual_step kernels on one NVIDIA H100, in one process.

    python3 dual_ab.py [OTHER.cu ...]

Each OTHER.cu is another copy of src/repro_torch/kernels/csrc/budget_alloc.cu
(for example the parent commit's, written out with ``git show``), built
with the package's nvcc flags.  At chip_smoke.py's paper, large and ragged
shapes the script times, with CUDA-event times (chip_smoke.time_ms) taken
in turns, the order of the variants and then its reverse:

  step    one SP1 iteration (``ba_dual_step``: x and g), every variant; a
          copy without ``ba_dual_ascent`` is called with the parent's
          arguments (no cluster size);
  ascent  1000 iterations of the whole ascent in one launch
          (``ba_dual_ascent``, cold step, tol 0), per iteration, for every
          variant that has it, and the package's library at every cluster
          size (1, 2, 4, 8) as ``pkg@cs``; a copy whose ``ba_dual_ascent``
          takes no episode count (before the lockstep fleet) is called
          without one.

Each variant's x and g equal the package's bit for bit, and each ascent's
lam and count equal the package's (the cluster size moves no result), or
the script raises.  Every line carries the card's name and power limit.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as c
from repro_torch.kernels import budget_alloc as ba
from repro_torch.kernels import build

ITERS = 1000
SHAPES = [(name, M, K) for name, M, _, K, _ in c.SHAPES]


def _nvcc(src: Path):
    """Build ``src`` next to the package's libraries; (stem, library,
    seconds, nvcc log)."""
    out = build.BUILD_DIR / f"libab_{src.stem}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    return src.stem, out, time.perf_counter() - t0, r.stdout + r.stderr


def _fleet_entry(src: Path) -> bool:
    """Whether the copy's ``ba_dual_ascent`` takes an episode count."""
    text = src.read_text()
    head = text[text.find("int ba_dual_ascent("):]
    return "int E," in head[:head.find(")")]


def _load(path: Path, parent: bool, fleet: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (args, res) in build.SIGNATURES["budget_alloc"].items():
        f = getattr(lib, fn, None)
        if f is not None:
            f.argtypes, f.restype = list(args), res
    if parent:                     # ba_dual_step before the cluster size
        lib.ba_dual_step.argtypes = list(
            build.SIGNATURES["budget_alloc"]["ba_dual_step"][0][:12]) + \
            [ctypes.c_void_p]
    elif not fleet:                # ba_dual_ascent before the episode count
        args = list(build.SIGNATURES["budget_alloc"]["ba_dual_ascent"][0])
        lib.ba_dual_ascent.argtypes = args[:9] + args[10:]
    lib.fleet = fleet
    return lib


def _ops(M, K):
    d = c.make_inputs(M, 1, K, 1)
    return (d["gamma"], d["lam"], d["w_pow"], d["xcap"], d["mask"], d["cap"],
            torch.clamp(d["cap"], min=1e-12))


def _step(lib, parent, ops, cs):
    """One step-mode call of ``lib``; (x, g)."""
    cm, lam = ops[0], ops[1]
    M, K = cm.shape
    x = torch.empty(M, device="cuda")
    g = torch.empty(K, device="cuda")
    inv_beta = float(torch.tensor(1 / 2.2, dtype=torch.float32))
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in ops] + [x.data_ptr(), g.data_ptr()]
    extra = (M, K, inv_beta) if parent else (M, K, inv_beta, cs)
    err = lib.ba_dual_step(*ptrs, *extra, stream)
    if err:
        raise RuntimeError(f"ba_dual_step failed with cudaError_t {err}")
    return x, g


def _ascent(lib, ops, cs):
    """ITERS iterations of the cold ascent, tol 0; (lam, iters)."""
    M, K = ops[0].shape
    lam = torch.empty(K, device="cuda")
    it = torch.empty((), dtype=torch.int32, device="cuda")
    inv_beta = float(torch.tensor(1 / 2.2, dtype=torch.float32))
    sizes = (1, M, K) if getattr(lib, "fleet", True) else (M, K)
    err = lib.ba_dual_ascent(*[t.data_ptr() for t in ops], lam.data_ptr(),
                             it.data_ptr(), *sizes, inv_beta, ITERS, 0.0, 0,
                             cs, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ba_dual_ascent failed with cudaError_t {err}")
    return lam, it


def main() -> int:
    name, smi = c.phase_device()
    c.phase_build()
    others = [Path(p) for p in sys.argv[1:]]
    with concurrent.futures.ThreadPoolExecutor(max(1, len(others))) as pool:
        built = list(pool.map(_nvcc, others))
    variants = {"pkg": (ba._lib(), False)}
    for src, (stem, path, secs, log) in zip(others, built):
        parent = "ba_dual_ascent" not in src.read_text()
        variants[stem] = (_load(path, parent, _fleet_entry(src)), parent)
        c.log(f"built {stem} in {secs:.2f} s" + (" (parent arguments)"
                                                  if parent else ""))
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                c.log(f"  ptxas {stem}: {line.strip()}")
    for shape, M, K in SHAPES:
        ops = _ops(M, K)
        cs = ba.dual_split(M, K)
        x0, g0 = _step(ba._lib(), False, ops, cs)
        lam0, n0 = _ascent(ba._lib(), ops, cs)
        runs = {}
        for stem, (lib, parent) in variants.items():
            x, g = _step(lib, parent, ops, cs)
            if not (torch.equal(x, x0) and torch.equal(g, g0)):
                raise AssertionError(f"{stem} {shape}: step differs")
            runs[f"{stem} step"] = (lambda lib=lib, p=parent:
                                    _step(lib, p, ops, cs), 1)
            if parent:
                continue
            lam, n = _ascent(lib, ops, cs)
            if int(n) != int(n0) or not torch.equal(lam, lam0):
                raise AssertionError(f"{stem} {shape}: ascent differs")
            runs[f"{stem} ascent"] = (lambda lib=lib: _ascent(lib, ops, cs),
                                      ITERS)
        for q in (1, 2, 4, 8):             # the result does not depend on cs
            if q == cs:
                continue
            lam, n = _ascent(ba._lib(), ops, q)
            if int(n) != int(n0) or not torch.equal(lam, lam0):
                raise AssertionError(f"pkg@{q} {shape}: ascent differs")
            runs[f"pkg@{q} ascent"] = (lambda q=q: _ascent(ba._lib(), ops, q),
                                       ITERS)
        times = {k: [] for k in runs}
        order = list(runs)
        for turn in order + order[::-1]:
            fn, per = runs[turn]
            times[turn].append(c.time_ms(fn, 3 if per > 1 else 20, 3) / per)
        for k, ts in times.items():
            unit = "us/iter" if runs[k][1] > 1 else "us/call"
            c.log(f"  {shape:6s} M={M} K={K} cs={cs} {k:24s} "
                  + " / ".join(f"{t * 1e3:.4f}" for t in ts)
                  + f" {unit} ({smi})")
    c.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
