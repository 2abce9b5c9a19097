#!/usr/bin/env python3
"""Compare RG-LRU scan kernels on one NVIDIA H100, in one process.

    python3 scan_ab.py [OTHER.cu ...]

Each OTHER.cu is another copy of src/repro_torch/kernels/csrc/rg_lru.cu
(for example the parent commit's, written out with ``git show``), built
with the package's nvcc flags and called through ``rg_scan(a, b, h0, h,
B, S, D, stream)``, the entry point of the copies before the package's
``rg_scan_at`` took its stage from the launcher.  At every shape of
chip_smoke.py's RG_CASES the script runs:

  pkg          the package's kernel through rglru_scan_cuda (its stage,
               rg_lru.scan_geometry);
  <stem>       each OTHER.cu;
  pkg@st       the package's library through rg_scan_at at every other
               stage the shape takes: 0 (the direct path), and where
               D % 4 == 0 rings of 8, 16, 24, 32 and 48 steps a stage.

Every variant's output equals the package's bit for bit, or the script
raises.  CUDA-event times (chip_smoke.time_ms) are taken in turns, the
order of the variants and then its reverse, each beside its share of the
bytes bound; every line carries the card's name and power limit.
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
from repro_torch.kernels import build
from repro_torch.kernels import rg_lru


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


def _load(path: Path):
    """The copy's rg_scan."""
    fn = ctypes.CDLL(str(path)).rg_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(fn, name, a, b, h0, *geo):
    B, S, D = a.shape
    out = torch.empty_like(a)
    err = fn(a.data_ptr(), b.data_ptr(), None if h0 is None else
             h0.data_ptr(), out.data_ptr(), B, S, D, *geo,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
    return out


def _stages(D, pkg):
    """Every stage the shape takes but the package's own: 0 (the direct
    path), and where D % 4 == 0 (the tensor maps) 8, 16, 24, 32 and
    SCAN_STAGE_MAX steps."""
    ring = (8, 16, 24, 32, rg_lru.SCAN_STAGE_MAX) if D % 4 == 0 else ()
    return [st for st in (0, *ring) if st != pkg]


def main() -> int:
    name, smi = c.phase_device()
    c.phase_build()
    others = [Path(p) for p in sys.argv[1:]]
    with concurrent.futures.ThreadPoolExecutor(max(1, len(others))) as pool:
        built = list(pool.map(_nvcc, others))
    libs = {}
    for stem, path, secs, log in built:
        libs[stem] = _load(path)
        c.log(f"built {stem} in {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                c.log(f"  ptxas {stem}: {line.strip()}")
    pkg_lib = build.library("rg_lru")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, S, D, with_h0 in c.RG_CASES:
        a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.499 + 0.5
        b = torch.randn((B, S, D), generator=gen, device="cuda")
        h0 = torch.randn((B, D), generator=gen, device="cuda") \
            if with_h0 else None
        pkg = rg_lru.scan_geometry(B, S, D)
        runs = {"pkg": lambda: rg_lru.rglru_scan_cuda(a, b, h0)}
        for stem, fn in libs.items():
            runs[stem] = lambda fn=fn, stem=stem: _call(fn, stem, a, b, h0)
        for st in _stages(D, pkg):
            runs[f"pkg@{st}"] = lambda st=st: _call(
                pkg_lib.rg_scan_at, "rg_scan_at", a, b, h0, st)
        want = runs["pkg"]()
        for k, run in runs.items():
            if not torch.equal(run(), want):
                raise AssertionError(f"{k} {label}: differs from pkg")
        nbytes = 4 * (3 * B * S * D + (B * D if with_h0 else 0))
        bnd, _ = c.bound_ms(nbytes, 2 * B * S * D)
        c.log(f"  {label}: B={B} S={S} D={D} h0={with_h0}; pkg stage {pkg} "
              f"ring {rg_lru.SCAN_STAGES * pkg}; bound {bnd:.6f} ms (bytes)")
        times = {k: [] for k in runs}
        order = list(runs)
        for turn in order + order[::-1]:
            times[turn].append(c.time_ms(runs[turn], 20, 3))
        for k, ts in times.items():
            c.log(f"  rglru_scan {label:7s} {k:12s} "
                  + " / ".join(f"{t:.4f}" for t in ts)
                  + f" ms (share of bound {bnd / min(ts):.3f}; {smi})")
        del a, b, h0, want
        torch.cuda.empty_cache()
    c.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
