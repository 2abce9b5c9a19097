#!/usr/bin/env python3
"""Compare RG-LRU scan gradient kernels on one NVIDIA H100, in one process.

    python3 scan_bwd_ab.py [OTHER.cu ...]

Each OTHER.cu is another copy of src/repro_torch/kernels/csrc/rg_lru.cu
(for example the parent commit's, written out with ``git show``), built
with the package's nvcc flags.  A copy with ``rg_scan_bwd_at`` is called
at the package's stage for the shape; an older one through ``rg_scan_bwd(a,
gh, h, h0, da, db, dh0, B, S, D, stream)``, the entry point before the
gradient took its stage from the launcher.  At every shape of
chip_smoke.py's RG_BWD_CASES and the card tests' edges (S = 31, 32, 33 at
D = 2560; operands one float off 16-byte alignment) the script runs:

  pkg          the package's kernel through rglru_scan_bwd_cuda (its stage,
               rg_lru.scan_bwd_geometry);
  <stem>       each OTHER.cu;
  pkg@st       the package's library through rg_scan_bwd_at at every
               other stage the shape takes: 0 (the direct path), and where
               D % 4 == 0 and the operands are 16-byte aligned rings of 8,
               16, ..., 48 steps a stage.

Every variant's dL/da, dL/db and dL/dh0 equal the package's bit for bit,
or the script raises.  CUDA-event times are taken in turns, the order of
the variants and then its reverse: back-to-back launches
(chip_smoke.time_ms; operands that fit stay in the 50 MB L2), then one
launch at a time after an L2 flush (cold_ms), each beside its share of
the bytes bound; every line carries the card's name and power limit.
Each copy's ptxas registers and spills are printed.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as c
from repro_torch.kernels import build
from repro_torch.kernels import rg_lru

# (name, B, S, D, with h0, operands one float off 16-byte alignment)
SHAPES = [(name, B, S, D, h0, False) for name, B, S, D, h0 in
          c.RG_BWD_CASES] + [("s31", 4, 31, 2560, True, False),
                             ("s32", 4, 32, 2560, False, False),
                             ("s33", 4, 33, 2560, True, False),
                             ("off16", 2, 130, 256, True, True)]


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
    """The copy's gradient entry and whether it takes a stage."""
    lib = ctypes.CDLL(str(path))
    staged = hasattr(lib, "rg_scan_bwd_at")
    fn = lib.rg_scan_bwd_at if staged else lib.rg_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * \
        (4 if staged else 3) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, staged


def _call(fn, name, a, h, g, h0, *geo):
    B, S, D = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    err = fn(a.data_ptr(), g.data_ptr(), h.data_ptr(),
             None if h0 is None else h0.data_ptr(), da.data_ptr(),
             db.data_ptr(), None if dh0 is None else dh0.data_ptr(),
             B, S, D, *geo, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")
    return da, db, dh0


def _off16(t):
    """A copy of ``t`` one float into a larger buffer: 4-byte but not
    16-byte aligned."""
    buf = torch.empty(t.numel() + 1, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _stages(D, pkg, ring):
    """Every stage the shape takes but the package's own: 0 (the direct
    path), and where the ring takes the operands 8 ... SCAN_STAGE_MAX
    steps."""
    steps = range(rg_lru.SCAN_STEP, rg_lru.SCAN_STAGE_MAX + 1,
                  rg_lru.SCAN_STEP) if ring and D % 4 == 0 else ()
    return [st for st in (0, *steps) if st != pkg]


def cold_ms(fn, reps: int = 15) -> float:
    """Device milliseconds of one call of ``fn()`` with the L2 cache
    flushed first (a 128 MiB buffer written before each call, outside the
    timed events): the median over ``reps`` calls, as a caller meets
    operands that an earlier kernel left in device memory.  A ~0.5 ms
    device spin after the flush keeps the card busy while the host
    enqueues the call, so the events time the kernel, not the host."""
    flush = torch.empty(32 << 20, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _same(k, label, got, want):
    for part, x, w in zip(("dL/da", "dL/db", "dL/dh0"), got, want):
        if (x is None) != (w is None) or (x is not None and
                                          not torch.equal(x, w)):
            raise AssertionError(f"{k} {label}: {part} differs from pkg")


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
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif ("registers" in line or "spill" in line) and "bwd" in entry:
                c.log(f"  ptxas {stem}: {entry}: {line.strip()}")
    pkg_lib = build.library("rg_lru")
    gen = torch.Generator(device="cuda").manual_seed(29)
    for label, B, S, D, with_h0, off in SHAPES:
        a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.499 + 0.5
        b = torch.randn((B, S, D), generator=gen, device="cuda")
        g = torch.randn((B, S, D), generator=gen, device="cuda")
        h0 = torch.randn((B, D), generator=gen, device="cuda") \
            if with_h0 else None
        h = rg_lru.rglru_scan_cuda(a, b, h0)
        if off:
            a, g, h = _off16(a), _off16(g), _off16(h)
        ring = rg_lru.ring_takes(a, g, h)
        pkg = rg_lru.scan_bwd_geometry(B, S, D) if ring else 0
        runs = {"pkg": lambda: rg_lru.rglru_scan_bwd_cuda(a, h, g, h0)}
        for stem, (fn, staged) in libs.items():
            geo = (pkg,) if staged else ()
            runs[stem] = lambda fn=fn, stem=stem, geo=geo: _call(
                fn, stem, a, h, g, h0, *geo)
        for st in _stages(D, pkg, ring):
            runs[f"pkg@{st}"] = lambda st=st: _call(
                pkg_lib.rg_scan_bwd_at, "rg_scan_bwd_at", a, h, g, h0, st)
        want = runs["pkg"]()
        for k, run in runs.items():
            _same(k, label, run(), want)
            _same(k + " again", label, run(), want)
        nbytes = 4 * (5 * B * S * D + (2 * B * D if with_h0 else 0))
        bnd, by = c.bound_ms(nbytes, 3 * B * S * D)
        flight = (rg_lru.SCAN_STAGES - 1) * pkg * 12 * B * D
        ch = rg_lru.SCAN_BWD_CHANNELS if pkg else rg_lru.SCAN_CHANNELS
        c.log(f"  {label}: B={B} S={S} D={D} h0={with_h0} off16={off}; pkg "
              f"stage {pkg} ring {rg_lru.SCAN_STAGES * pkg} ({flight} B in "
              f"flight), {ch} channels a block; bound {bnd:.6f} ms ({by})")
        times = {k: [] for k in runs}
        cold = {k: [] for k in runs}
        order = list(runs)
        for turn in order + order[::-1]:
            times[turn].append(c.time_ms(runs[turn], 20, 3))
        for turn in order + order[::-1]:
            cold[turn].append(cold_ms(runs[turn]))
        for k, ts in times.items():
            c.log(f"  rglru_scan_bwd {label:8s} {k:14s} "
                  + " / ".join(f"{t:.4f}" for t in ts)
                  + f" ms (share of bound {bnd / min(ts):.3f}); L2 flushed "
                  + " / ".join(f"{t:.4f}" for t in cold[k])
                  + f" ms ({bnd / min(cold[k]):.3f}; {smi})")
        del a, b, g, h0, h, want
        torch.cuda.empty_cache()
    c.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
