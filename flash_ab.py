#!/usr/bin/env python3
"""Compare flash_attention kernels at dh 256 on one NVIDIA H100, in one
process.

    python3 flash_ab.py [OTHER.cu ...]

Each OTHER.cu is another copy of src/repro_torch/kernels/csrc/attention.cu
(for example the parent commit's, written out with ``git show``), built
with the package's nvcc flags; the ptxas lines of every ``flash_fwd``
kernel are printed.  At every dh-256 shape of chip_smoke.py's phase 14
(recurrentgemma-2b's 10 query heads over 1 kv head) and at the tile edges
of the card tests, each variant is checked against the twin (rtol = atol
= 2e-5, bitwise from launch to launch):

  pkg         the package through flash_attention_cuda (its wide_tiles
              rule picks the kernel; the line names the entry it took);
  pkg-narrow  the package's att_flash (the narrow dh-256 kernel);
  pkg-wide    the package's att_flash_wide (the wide one);
  <stem>      each OTHER.cu through its att_flash, and <stem>-wide
              through its att_flash_wide where it has one (a copy whose
              entries take no key length, Skv, is called without it).

Then CUDA-event times (chip_smoke.time_ms) are taken in turns, the
variants' order and then its reverse, beside SDPA (kv heads repeated, the
masks as chip_smoke.py builds them) and the operations bound.  Every line
carries the card's name and power limit.
"""
from __future__ import annotations

import concurrent.futures
import math
import sys
from pathlib import Path

import torch

import chip_smoke as c
from decode_ab import _load, _nvcc
from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as fa

# (label, B, S, causal, window) at recurrentgemma-2b's heads: phase 14's
# cases, then the card tests' dh-256 tile edges
CASES = c.RG_FLASH_CASES + [
    ("s1", 1, 1, True, 2048), ("s65", 1, 65, True, 2048),
    ("ragged-2047", 1, 2047, True, 2048), ("window-5", 2, 300, True, 5),
    ("full-300", 1, 300, False, None)]


def _call(fn, q, k, v, causal, window, skv=True):
    """One launch of a library's att_flash-shaped entry ``fn``; ``skv``
    False for a copy whose entries predate the key length argument."""
    B, S, H, dh = q.shape
    o = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S,
             *((k.shape[1],) if skv else ()), H, k.shape[2], dh, int(causal),
             window or 0, 1.0 / math.sqrt(dh),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn.__name__} failed with cudaError_t {err}")
    return o


def _sdpa(q, k, v, G, causal, window):
    S = q.shape[1]
    qt = q.transpose(1, 2).contiguous()
    kr, vr = c._repeat_kv(k, G), c._repeat_kv(v, G)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        return lambda: sdpa(qt, kr, vr, is_causal=causal)
    pos = torch.arange(S, device="cuda")
    mask = pos[None, :] > pos[:, None] - window
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    return lambda: sdpa(qt, kr, vr, attn_mask=mask)


def main(argv) -> int:
    _, smi = c.phase_device()
    with concurrent.futures.ThreadPoolExecutor(len(argv) + 1) as pool:
        own = pool.submit(build.build, "attention")
        others = list(pool.map(_nvcc, [Path(a) for a in argv]))
        path, secs, log = own.result()
    pkg = build.library("attention")
    libs, skv = {}, {}
    path_of = {Path(a).stem: a for a in argv}
    for stem, path, secs, log in [("pkg", path, secs, log)] + others:
        print(f"built {stem} in {secs:.2f} s", flush=True)
        entry = ""                 # ptxas names a kernel, then its numbers
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "flash_fwd" in entry and ("registers" in line or
                                           "spill" in line):
                print(f"  {stem} ptxas: {entry[entry.index('flash_fwd'):][:40]}"
                      f": {line.strip()}")
        if stem != "pkg":
            libs[stem] = _load(path)
            skv[stem] = "int Skv" in Path(path_of[stem]).read_text()
            if not skv[stem]:   # the entries' older signature
                for fn in ("att_flash", "att_flash_wide"):
                    if hasattr(libs[stem], fn):
                        getattr(libs[stem], fn).argtypes = \
                            getattr(pkg, fn).argtypes[:6] + \
                            getattr(pkg, fn).argtypes[7:]

    H, KH, dh = c.RG_HEADS
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, S, causal, window in CASES:
        q = torch.randn((B, S, H, dh), generator=gen, device="cuda")
        k = torch.randn((B, S, KH, dh), generator=gen, device="cuda")
        v = torch.randn((B, S, KH, dh), generator=gen, device="cuda")
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        runs = {"pkg": lambda: fa.flash_attention_cuda(q, k, v, causal=causal,
                                                       window=window),
                "pkg-narrow": lambda: _call(pkg.att_flash, q, k, v, causal,
                                            window),
                "pkg-wide": lambda: _call(pkg.att_flash_wide, q, k, v,
                                          causal, window)}
        for stem, lib in libs.items():
            runs[stem] = lambda f=lib.att_flash, n=skv[stem]: _call(
                f, q, k, v, causal, window, n)
            if hasattr(lib, "att_flash_wide"):
                runs[stem + "-wide"] = lambda f=lib.att_flash_wide, \
                    n=skv[stem]: _call(f, q, k, v, causal, window, n)
        shape = (f"H/KH/dh={H}/{KH}/{dh} B={B} S={S} causal={causal} "
                 f"window={window} ({label})")
        err = max(c._att_check(f"{t} flash {shape}", f(), f(), want)
                  for t, f in runs.items())
        del want
        entry = fa.LAST_ENTRY["flash_attention"]
        order = list(runs) + list(runs)[::-1]
        ms = {t: [] for t in runs}
        for t in order:
            ms[t].append(c.time_ms(runs[t], 20))
        lib_ms = c.time_ms(_sdpa(q, k, v, H // KH, causal, window), 20)
        bnd, by = c.bound_ms(4 * (2 * B * S * H * dh + 2 * B * S * KH * dh),
                             4 * dh * c._pairs(S, causal, window) * B * H)
        print(f"{shape}: max err {err:.3e}; pkg runs {entry}; ms in turns: "
              + "; ".join(
            f"{t} {' / '.join(f'{x:.4f}' for x in ms[t])} (share of bound "
            f"{bnd / min(ms[t]):.3f})" for t in runs)
            + f"; sdpa {lib_ms:.4f}; bound {bnd:.6f} ({by}) ({smi})",
            flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
