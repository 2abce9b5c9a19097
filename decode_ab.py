#!/usr/bin/env python3
"""Compare decode_attention kernels on one NVIDIA H100, in one process.

    python3 decode_ab.py OTHER.cu [OTHER.cu ...]

Each OTHER.cu is another copy of src/repro_torch/kernels/csrc/attention.cu
(for example the parent commit's, written out with ``git show``), built
with the package's nvcc flags.  At every decode shape of chip_smoke.py's
phases 11 and 14 the script runs, each checked against the twin (rtol =
atol = 2e-5, bitwise from launch to launch):

  pkg       the package's kernel through decode_attention_cuda;
  pkg-ceil  the same library at the grid that rounds the split count up
            (ceil(residency * SMS / blocks per split) splits), which may
            start a partial second wave;
  <stem>    each OTHER.cu at its own grid: its residency under the
            package's split rule and head groups, or, where it has no
            att_decode_residency (kernels before residency-sized splits),
            the old rule: 256 positions a split at least, about four
            blocks an SM, multiples of 64;
  <stem>@pkg  such an older kernel at the package's grid.

CUDA-event times (chip_smoke.time_ms) are taken in turns, the order of
the variants and then its reverse, beside SDPA (kv heads repeated), the
bytes bound and each grid; then torch.profiler's device times of each
variant's split and combine launches at the long shapes.
Every line carries the card's name and power limit.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as c
from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as da

PROFILED = ("32k", "long-2080", "rg-2048", "rg-1000", "rg-serve-33")


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


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (args, res) in build.SIGNATURES["attention"].items():
        f = getattr(lib, fn, None)
        if f is not None:
            f.argtypes, f.restype = list(args), res
    return lib


def _old_split(n: int, blocks_per_split: int) -> int:
    want = -(-4 * da.SMS // max(blocks_per_split, 1))
    split = max(256, -(-n // want))
    return -(-split // 64) * 64


def _ceil_split(n: int, blocks_per_split: int, residency: int, step: int):
    want = min(da.NSPLIT_MAX, -(-residency * da.SMS // blocks_per_split))
    split = max(step, -(-n // want))
    return -(-split // step) * step


def _call(lib, q, k, v, n, split):
    B, H, dh = q.shape
    L, KH = k.shape[1], k.shape[2]
    nsplit = -(-n // split)
    pm = torch.empty(B * H * nsplit, device="cuda")
    pl = torch.empty_like(pm)
    pa = torch.empty(B * H * nsplit * dh, device="cuda")
    o = torch.empty_like(q)
    err = lib.att_decode(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), pm.data_ptr(), pl.data_ptr(),
                         pa.data_ptr(), B, H, KH, L, dh, 0, n, split, nsplit,
                         1.0 / math.sqrt(dh),
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"att_decode failed with cudaError_t {err}")
    return o


def main(argv) -> int:
    if not argv:
        raise SystemExit(__doc__)
    _, smi = c.phase_device()
    with concurrent.futures.ThreadPoolExecutor(len(argv) + 1) as pool:
        own = pool.submit(build.build, "attention")
        others = list(pool.map(_nvcc, [Path(a) for a in argv]))
        path, secs, log = own.result()
    pkg = build.library("attention")
    libs = {}
    for stem, path, secs, log in [("pkg", path, secs, log)] + others:
        print(f"built {stem} in {secs:.2f} s", flush=True)
        entry = ""                 # ptxas names a kernel, then its numbers
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "decode_split" in entry and ("registers" in line or
                                              "spill" in line):
                print(f"  {stem} ptxas: {entry[entry.index('decode_split'):][:40]}"
                      f": {line.strip()}")
        if stem != "pkg":
            libs[stem] = _load(path)

    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [(lb, *c.HEADS, B, Lc, n) for lb, B, Lc, n in c.DECODE_CASES]
    cases += [(lb, *c.RG_HEADS, B, Lc, n)
              for lb, B, Lc, n in c.RG_DECODE_CASES]
    for label, H, KH, dh, B, Lc, n in cases:
        G = H // KH
        q = torch.randn((B, H, dh), generator=gen, device="cuda")
        k = torch.randn((B, Lc, KH, dh), generator=gen, device="cuda")
        v = torch.randn((B, Lc, KH, dh), generator=gen, device="cuda")
        want = ref.decode_attention_ref(q, k, v, n)
        res = da.resident_blocks(dh, G)
        per_split = B * KH * da.HEAD_GROUPS[dh, G]
        split = da.split_size(n, per_split, res, da.STEPS[dh])
        ceil = _ceil_split(n, per_split, res, da.STEPS[dh])
        # variant -> (call, split, blocks per split)
        runs = {"pkg": (lambda: da.decode_attention_cuda(q, k, v, n), split,
                        per_split),
                "pkg-ceil": (lambda: _call(pkg, q, k, v, n, ceil), ceil,
                             per_split)}
        for stem, lib in libs.items():
            if hasattr(lib, "att_decode_residency"):
                s = da.split_size(n, per_split,
                                  lib.att_decode_residency(dh, G),
                                  da.STEPS[dh])
                runs[stem] = (lambda lib=lib, s=s: _call(lib, q, k, v, n, s),
                              s, per_split)
            else:                         # one block per (split, kv head)
                s = _old_split(n, B * KH)
                runs[stem] = (lambda lib=lib, s=s: _call(lib, q, k, v, n, s),
                              s, B * KH)
                runs[stem + "@pkg"] = (
                    lambda lib=lib: _call(lib, q, k, v, n, split), split,
                    B * KH)
        err = max(c._att_check(f"{t} decode {label}", f(), f(), want)
                  for t, (f, _, _) in runs.items())
        order = list(runs) + list(runs)[::-1]
        ms = {t: [] for t in runs}
        for t in order:
            ms[t].append(c.time_ms(runs[t][0], 20))
        kr = c._repeat_kv(k[:, :n], G)
        vr = c._repeat_kv(v[:, :n], G)
        q4 = q[:, :, None]
        lib_ms = c.time_ms(lambda: sdpa(q4, kr, vr), 20)
        bnd, by = c.bound_ms(4 * (2 * B * H * dh + 2 * B * n * KH * dh),
                             4 * B * H * dh * n)
        print(f"{label} H/KH/dh={H}/{KH}/{dh} B={B} Lc={Lc} cache_len={n}: "
              f"residency {res}; max err {err:.3e}; ms (split, splits, "
              "blocks) in turns: " + "; ".join(
                  f"{t} {' / '.join(f'{x:.4f}' for x in ms[t])} "
                  f"({s}, {-(-n // s)}, {-(-n // s) * bps})"
                  for t, (_, s, bps) in runs.items())
              + f"; sdpa {lib_ms:.4f}; bound {bnd:.6f} ({by}) ({smi})",
              flush=True)
        if label in PROFILED:
            for t, (f, _, _) in runs.items():
                _, rows, _ = c._device_kernels(
                    lambda: [f() for _ in range(20)])
                part = {key: sum(ms for name, ms in rows if key in name) / 20
                        for key in ("decode_split", "decode_combine")}
                print(f"  profiler {label} {t}: decode_split "
                      f"{part['decode_split']:.4f} ms, decode_combine "
                      f"{part['decode_combine']:.4f} ms a call ({smi})",
                      flush=True)
        del q, k, v, kr, vr, want
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
