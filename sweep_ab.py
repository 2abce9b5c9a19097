#!/usr/bin/env python3
"""Compare boost-sweep kernels on one NVIDIA H100, in one process.

    python3 sweep_ab.py [OTHER.cu ...]

Each OTHER.cu is another copy of src/repro_torch/kernels/csrc/budget_alloc.cu
(for example the parent commit's, written out with ``git show``), built
with the package's nvcc flags.  At chip_smoke.py's sweep shapes (phase 3's
paper, large and ragged, and the sweep-only beam and spill cases) the
script times ``boost_scan`` (one candidate an analyst, leftover kept) and
``swap_eval`` (C candidates an analyst), with CUDA-event times
(chip_smoke.time_ms) taken in turns, the order of the variants and then
its reverse:

  every variant at the package's geometry (``sweep_split``; a copy
  without ``sweep_tile_kernel`` is called with the parent's arguments,
  no cluster size or tile);
  the package's library at every other cluster size cs and tile T
  (1, 2, 4, 8 each, T up to C) as ``pkg@cs,T``.

Each variant's extras (and leftover) equal the package's bit for bit, or
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

KAPPA_CAP = 1.0                 # kappa_max 2.0, as chip_smoke.py's cases
PARENT_SMEM = 200 * 1024        # the parent's leftover row limit, bytes


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


def _load(path: Path, parent: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (args, res) in build.SIGNATURES["budget_alloc"].items():
        f = getattr(lib, fn, None)
        if f is not None:
            f.argtypes, f.restype = list(args), res
    if parent:                     # ba_boost_sweep before cs and T
        args = build.SIGNATURES["budget_alloc"]["ba_boost_sweep"][0]
        lib.ba_boost_sweep.argtypes = list(args[:10]) + [ctypes.c_void_p]
    return lib


def _sweep(lib, parent, g, sel, left, keep, geo):
    """One ``ba_boost_sweep`` call of ``lib``; (extras, leftover or None)."""
    B, N, K = g.shape
    C = sel.shape[1]
    extras = torch.empty((B, C, N), device="cuda")
    spill = (K * 4 > PARENT_SMEM if parent
             else ba.sweep_smem(K, *geo) > ba.SWEEP_SMEM_MAX)
    out = torch.empty((B, C, K), device="cuda") if keep or spill else None
    args = [g.data_ptr(), sel.data_ptr(), left.data_ptr(), extras.data_ptr(),
            None if out is None else out.data_ptr(), B, C, N, K, KAPPA_CAP]
    if not parent:
        args += list(geo)
    err = lib.ba_boost_sweep(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ba_boost_sweep failed with cudaError_t {err}")
    return extras, (out if keep else None)


def _same(a, b) -> bool:
    return all((x is None and y is None) or
               torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def main() -> int:
    name, smi = c.phase_device()
    c.phase_build()
    others = [Path(p) for p in sys.argv[1:]]
    with concurrent.futures.ThreadPoolExecutor(max(1, len(others))) as pool:
        built = list(pool.map(_nvcc, others))
    variants = {"pkg": (ba._lib(), False)}
    for src, (stem, path, secs, log) in zip(others, built):
        parent = "sweep_tile_kernel" not in src.read_text()
        variants[stem] = (_load(path, parent), parent)
        c.log(f"built {stem} in {secs:.2f} s" + (" (parent arguments)"
                                                  if parent else ""))
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                c.log(f"  ptxas {stem}: {line.strip()}")
    for shape, M, N, K, C in c.SHAPES + c.SWEEP_SHAPES:
        d = c.make_inputs(M, N, K, C)
        ops = {"boost_scan": (d["sel"].reshape(M, 1, N),
                              d["left"].reshape(M, 1, K), True),
               "swap_eval": (d["sel_c"], d["left_c"], False)}
        for kernel, (sel, left, keep) in ops.items():
            Ck = sel.shape[1]
            geo = ba.sweep_split(M, Ck, K)
            want = _sweep(ba._lib(), False, d["g_ord"], sel, left, keep, geo)
            runs = {}
            for stem, (lib, parent) in variants.items():
                def run(lib=lib, parent=parent, geo=geo):
                    return _sweep(lib, parent, d["g_ord"], sel, left, keep,
                                  geo)
                if not _same(run(), want):
                    raise AssertionError(f"{stem} {kernel} {shape}: differs")
                runs[stem] = run
            for q in (1, 2, 4, 8):
                for T in (1, 2, 4, 8):
                    if (q, T) == geo or T > Ck:
                        continue
                    def run(q=q, T=T):
                        return _sweep(ba._lib(), False, d["g_ord"], sel, left,
                                      keep, (q, T))
                    if not _same(run(), want):
                        raise AssertionError(
                            f"pkg@{q},{T} {kernel} {shape}: differs")
                    runs[f"pkg@{q},{T}"] = run
            times = {k: [] for k in runs}
            order = list(runs)
            for turn in order + order[::-1]:
                times[turn].append(c.time_ms(runs[turn], 3, 3))
            for k, ts in times.items():
                c.log(f"  {kernel:10s} {shape:6s} M={M} N={N} K={K} C={Ck} "
                      f"pkg cs,T={geo[0]},{geo[1]} {k:14s} "
                      + " / ".join(f"{t:.4f}" for t in ts) + f" ms ({smi})")
        del d
        torch.cuda.empty_cache()
    c.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
