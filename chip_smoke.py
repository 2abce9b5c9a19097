#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of DPBalance on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. the device: name, compute capability (must be 9.0), power limit;
  2. build the Hopper kernels from src/repro_torch/kernels/csrc;
  3. every kernel against its plain PyTorch twin on the card, at the
     paper's shapes, the large round's shapes and one ragged shape
     (bitwise for rowmax, the boost sweeps and dual_step's g given x;
     1e-5 relative otherwise), with CUDA-event times beside the twin's,
     a one-call PyTorch yardstick where one exists, and the bound;
  4. the paper episode (SimConfig(seed=0): 6 analysts x 25 pipelines,
     100 devices, K=2000, 10 rounds) through run_episode on the card, cold
     and warm SP1, every kernel's launch count above 0, and agreement with
     the same episode on the CPU;
  5. one round at the largest sched_scale geometry (M=32, N=32, K=16384,
     refine on), with its invariants and a swap sweep of C=256 candidates
     per analyst;
  6. where the time goes: SP1 and SP2 spans per round and, from
     torch.profiler, the card's kernel time and busy share (separate
     traced runs, after the untimed checks);
  7. the DP clip kernels (rownorms, clip_accumulate) against their twins
     on the card at the FL path's shapes (B=6 and B=8 rows of P =
     124,668,672 flaas-100m parameters), a ragged P and B=1, with a zero
     row: clip_accumulate bitwise given the same scales, rownorms within
     1e-5 relative, both bitwise from launch to launch; times beside the
     twin's, the bound and a one-call PyTorch yardstick;
  8. one DP-FedAvg round (sigma 0) of flaas-100m at full width, depth cut
     to 2 layers, on the card and on the CPU from the same parameters and
     data: equal cohort and kept set, parameters within RTOL_FL;
  9. the end-to-end FL loop (repro_torch.launch.fl_e2e.run) on the card
     at its defaults -- full flaas-100m, 8 devices, 2 analysts x 3
     pipelines, seq 256, 12 rounds -- with its invariants, the DP kernels
     launched once each per fl_round, and the scheduler's grants equal to
     a scheduler-only run of the same loop on the CPU;
 10. where the FL path's time goes: per round the scheduler, the clients'
     local steps, aggregate (of which the two kernels) and the noise, and
     the card's busy share over one round traced by torch.profiler.

float32 matrix products run in full float32 (TF32 off, set and printed).
The second-to-last lines are a JSON object listing the kernels and the
card's name and power limit; the last line is the run's verdict as JSON.
Exits nonzero without CUDA or outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM published HBM3 bandwidth
FP32_FLOP_PER_S = 67e12        # H100 SXM published fp32 (non-tensor) rate
SOURCE = "src/repro_torch/kernels/csrc/budget_alloc.cu"
DP_SOURCE = "src/repro_torch/kernels/csrc/dp_clip_noise.cu"
DP_REPLACES = {
    "rownorms": "src/repro/kernels/dp_clip_noise.py:41",
    "clip_accumulate": "src/repro/kernels/dp_clip_noise.py:73",
}
P_FLAAS = 124_668_672          # flaas-100m parameters
# (name, B rows, P): the e2e aggregate (6 kept clients), DP-SGD example
# mode (8 examples), a ragged P, one row
DP_SHAPES = [("e2e", 6, P_FLAAS), ("example", 8, P_FLAAS),
             ("ragged", 3, 4096 * 7 + 13), ("one-row", 1, P_FLAAS)]
NORM_RTOL = 1e-5               # rownorms vs twin (sum order differs)
RTOL_FL = 1e-4                 # phase 8: card vs CPU, of the largest delta
REPLACES = {
    "rowmax": "src/repro/kernels/budget_alloc.py:41",
    "matvec": "src/repro/kernels/budget_alloc.py:75",
    "matvec_t": "src/repro/kernels/budget_alloc.py:95",
    "dual_step": "src/repro/kernels/budget_alloc.py:144",
    "boost_scan": "src/repro/kernels/budget_alloc.py:224",
    "swap_eval": "src/repro/kernels/budget_alloc.py:278",
}
# (name, M analysts, N pipelines, K blocks, C swap candidates per analyst)
SHAPES = [("paper", 6, 25, 2000, 156),
          ("large", 32, 32, 16384, 256),
          ("ragged", 5, 7, 53257, 11)]   # K*4 > 200 KB: leftover in HBM


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int, trials: int = 5) -> float:
    """Device milliseconds per call of ``fn()``: the median over ``trials``
    of CUDA-event time around ``reps`` back-to-back calls, divided by
    ``reps``.  Each trial is queued behind a 20 ms device spin, so the
    calls run without waiting on the host's enqueue; inputs stay resident
    in L2 where they fit, as in the SP1 loop."""
    fn()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)          # ~20 ms at ~2 GHz
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check(name, got, want, bitwise: bool) -> float:
    """Raise unless ``got`` matches ``want`` (bitwise, or elementwise
    within 1e-5 relative); return the max absolute error."""
    err = float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0
    if bitwise:
        ok = torch.equal(got, want)
    else:
        ok = bool(torch.all((got.double() - want.double()).abs()
                            <= 1e-5 * want.double().abs() + 1e-30))
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its twin "
                             f"(max abs err {err:.3e}, bitwise={bitwise})")
    return err


def phase_device():
    log("[1] device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"device: {name}, capability {cap}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)
    assert cap == (9, 0), f"needs a Hopper card (sm_90), got {cap}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = "
        f"{torch.backends.cudnn.allow_tf32}")
    return name, smi


def phase_build():
    log("[2] build")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()                  # one nvcc per source, at once
    for name, (path, secs, nvcc_log) in built.items():
        build.library(name)
        log(f"built {path.name} in {secs:.2f} s (nvcc)")
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
    log(f"build total {time.perf_counter() - t0:.2f} s")


def make_inputs(M, N, K, C, seed=0):
    """Seeded inputs at one shape: demand-like shares (10% dense, with an
    all-zero row), duals, selections with unselected rows."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device="cuda")

    gamma = rng.uniform(0, 0.05, (M, K)) * (rng.random((M, K)) > 0.9)
    gamma[-1] = 0.0
    g_ord = rng.uniform(0, 0.05, (M, N, K)) * (rng.random((M, N, K)) > 0.9)
    g_ord[:, 0] = 0.0                                  # a row with no demand
    sel_c = rng.random((M, C, N)) > 0.5
    sel_c[:, 0] = False                                # a candidate with none
    mask = rng.random(M) > 0.2
    mask[0] = True
    return dict(
        gamma=t(gamma), lam=t(rng.uniform(0.5, 2.0, K)),
        x=t(rng.uniform(0.0, 2.0, M)),
        w_pow=t(rng.uniform(0.5, 50.0, M)), xcap=t(rng.uniform(1.0, 30.0, M)),
        mask=t(mask, np.int32), cap=t(rng.uniform(0.2, 1.0, K)),
        g_ord=t(g_ord), sel_c=t(sel_c, np.int32),
        sel=t(rng.random((M, N)) > 0.4, np.int32),
        left=t(rng.uniform(0.0, 0.5, (M, K))),
        left_c=t(rng.uniform(0.0, 0.5, (M, C, K))))


def kernel_cases(d, M, N, K, C):
    """Per kernel: (launch, twin, yardstick or None, compare, bytes, flops)."""
    from repro_torch.kernels import budget_alloc as ba
    from repro_torch.kernels import ref
    kmax = 2.0
    cap_safe = torch.clamp(d["cap"], min=1e-12)
    dual_args = (d["gamma"], d["lam"], d["w_pow"], d["xcap"], d["mask"],
                 d["cap"], cap_safe)
    n_sel = int(d["sel"].sum())
    n_sel_c = int(d["sel_c"].sum())

    def cmp_dual(got, want):
        xk, gk = got
        e1 = check("dual_step x", xk, want[0], False)
        gtwin = ref.dual_residual_ref(d["gamma"], xk, d["cap"], cap_safe)
        return max(e1, check("dual_step g | x", gk, gtwin, True))

    def cmp_pair(got, want):
        return max(check("boost_scan extras", got[0], want[0], True),
                   check("boost_scan leftover", got[1], want[1], True))

    return {
        "rowmax": (lambda: ba.rowmax(d["gamma"]),
                   lambda: ref.rowmax_ref(d["gamma"]),
                   lambda: torch.amax(d["gamma"], dim=-1),
                   lambda g, w: check("rowmax", g, w, True),
                   4 * (M * K + M), M * K),
        "matvec": (lambda: ba.matvec(d["gamma"], d["lam"]),
                   lambda: ref.matvec_ref(d["gamma"], d["lam"]),
                   lambda: torch.mv(d["gamma"], d["lam"]),
                   lambda g, w: check("matvec", g, w, False),
                   4 * (M * K + K + M), 2 * M * K),
        "matvec_t": (lambda: ba.matvec_t(d["gamma"], d["x"]),
                     lambda: ref.matvec_t_ref(d["gamma"], d["x"]),
                     lambda: torch.mv(d["gamma"].T, d["x"]),
                     lambda g, w: check("matvec_t", g, w, False),
                     4 * (M * K + M + K), 2 * M * K),
        "dual_step": (lambda: ba.dual_step(*dual_args, 2.2),
                      lambda: ref.dual_step_ref(*dual_args, 2.2),
                      None, cmp_dual,
                      4 * (M * K + 4 * K + 4 * M), 4 * M * K + 2 * K + 3 * M),
        "boost_scan": (lambda: ba.boost_scan(d["g_ord"], d["sel"], d["left"],
                                             kmax),
                       lambda: ref.boost_scan_ref(d["g_ord"], d["sel"],
                                                  d["left"], kmax),
                       None, cmp_pair,
                       4 * (M * N * K + 2 * M * N + 2 * M * K), 6 * n_sel * K),
        "swap_eval": (lambda: ba.swap_eval(d["g_ord"], d["sel_c"],
                                           d["left_c"], kmax),
                      lambda: ref.swap_eval_ref(d["g_ord"], d["sel_c"],
                                                d["left_c"], kmax),
                      None, lambda g, w: check("swap_eval", g, w, True),
                      4 * (M * N * K + 2 * M * C * N + M * C * K),
                      6 * n_sel_c * K),
    }


def phase_kernels(card):
    log("[3] kernels against their twins on the card")
    from repro_torch.kernels import budget_alloc as ba
    rows = {}
    for shape, M, N, K, C in SHAPES:
        d = make_inputs(M, N, K, C)
        for name, (run, twin, lib, cmp, nbytes, flops) in \
                kernel_cases(d, M, N, K, C).items():
            got = run()
            torch.cuda.synchronize()
            err = cmp(got, twin())
            slow = name in ("boost_scan", "swap_eval") and shape != "paper"
            ms = time_ms(run, 3 if slow else 20)
            plain = time_ms(twin, 1 if slow else 5)
            lib_ms = time_ms(lib, 20) if lib is not None else None
            b, by = bound_ms(nbytes, flops)
            log(f"  {name:10s} {shape:6s} M={M} N={N} K={K} C={C}: "
                f"max_abs_err {err:.3e}  kernel {ms:.4f} ms  twin "
                f"{plain:.4f} ms  yardstick "
                f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms'}  bound "
                f"{b:.6f} ms ({by}, {card})")
            r = rows.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if shape == "large":     # the JSON line reports the large round
                r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                         library_ms=lib_ms,
                         shape=f"M={M} N={N} K={K} C={C}")
    ba.reset_launches()
    return rows


def phase_episode():
    log("[4] paper episode (SimConfig(seed=0)) through run_episode")
    from repro_torch.core import (SchedulerConfig, SimConfig,
                                  generate_episode, run_episode)
    from repro_torch.kernels import budget_alloc as ba
    sim = SimConfig(seed=0)
    ep_gpu = generate_episode(sim, device="cuda")
    ep_cpu = generate_episode(sim, device="cpu")
    launches = None
    for warm in (False, True):
        cfg = SchedulerConfig(sp1_warm_start=warm)
        torch.cuda.synchronize()
        ba.reset_launches()
        t0 = time.perf_counter()
        out = run_episode(ep_gpu, cfg)          # validate: conservation
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ba.LAUNCHES)
        if launches is None:
            launches = counts
        assert all(v > 0 for v in counts.values()), \
            f"a kernel never launched on the main path: {counts}"
        assert float(out["overdraw"].max()) <= 1e-4
        assert float(out["conservation_gap"].max()) <= 1e-4
        ref = run_episode(ep_cpu, cfg)
        g = {k: v.cpu() for k, v in out.items()}
        R = sim.n_rounds
        assert torch.equal(g["n_allocated"], ref["n_allocated"]), \
            (g["n_allocated"], ref["n_allocated"])
        assert torch.equal(g["selected"], ref["selected"])
        for k in ("round_efficiency", "round_fairness", "leftover"):
            assert torch.allclose(g[k], ref[k], rtol=1e-5, atol=0.0), \
                (k, g[k], ref[k])
        iters = g["sp1_iters"].tolist()
        log(f"  {'warm' if warm else 'cold'} SP1: {R / wall:.2f} rounds/s "
            f"({wall:.3f} s for {R} rounds), SP1 iters per round {iters} "
            f"(CPU run: {ref['sp1_iters'].tolist()}), n_allocated "
            f"{g['n_allocated'].tolist()}, launches {counts}")
    return launches


def _round(M, K, N, seed=0, cap=1.0):
    """The seeded round of benchmarks/bench_scheduler_scale.py:_round."""
    from repro_torch.core import RoundInputs
    rng = np.random.default_rng(seed)
    demand = (rng.uniform(0, 0.05, (M, N, K)) *
              (rng.random((M, N, K)) > 0.9)).astype(np.float32)
    return RoundInputs.from_numpy(
        demand=demand, active=demand.sum(-1) > 0,
        arrival=np.zeros((M, N), np.float32),
        loss=np.ones((M, N), np.float32),
        capacity=np.full((K,), cap, np.float32),
        budget_total=np.ones(K, np.float32), now=0.0, device="cuda")


def phase_large_round():
    """The bench's round (capacity 1.0: every block 2.5x oversubscribed, so
    no pipeline fits its analyst's SP1 share and nothing is granted -- as
    in ``repro``) and the same round at capacity 3.0, where SP2 packs."""
    log("[5] one round at M=32, N=32, K=16384, refine on")
    from repro_torch.core import SchedulerConfig, schedule_round
    from repro_torch.kernels import budget_alloc as ba
    M, N, K = 32, 32, 16384
    cfg = SchedulerConfig(beta=2.2, refine=True)
    counts = None
    for cap in (1.0, 3.0):
        rnd = _round(M, K, N, cap=cap)
        schedule_round(rnd, cfg)               # warm-up (allocator)
        torch.cuda.synchronize()
        ba.reset_launches()
        t0 = time.perf_counter()
        res = schedule_round(rnd, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts or dict(ba.LAUNCHES)
        c = rnd.capacity
        assert float((res.consumed - c).max()) <= 1e-4, "overdraw"
        assert float((c - res.consumed - res.leftover).abs().max()) <= 1e-4
        assert not bool((res.selected & ~rnd.active).any())
        x = res.x_pipeline
        assert bool(torch.all(torch.where(res.selected, x >= 1.0, x == 0.0)))
        for f in ("efficiency", "fairness", "platform", "jain"):
            assert bool(torch.isfinite(getattr(res, f))), f
        assert cap == 1.0 or int(res.n_allocated) > 0
        assert ba.LAUNCHES["swap_eval"] == 1 and \
            ba.LAST_GRID["swap_eval"] == (M, 256), \
            (ba.LAUNCHES, ba.LAST_GRID)
        log(f"  capacity {cap}: wall {wall:.3f} s, n_allocated "
            f"{int(res.n_allocated)}, SP1 iters {int(res.sp1_iters)}, "
            f"efficiency {float(res.efficiency):.6g}, swap sweep grid "
            f"(analysts, candidates) {ba.LAST_GRID['swap_eval']}, launches "
            f"{dict(ba.LAUNCHES)}")
    return counts


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _stage_spans(fn):
    """Run ``fn`` with SP1 and SP2 wrapped in synchronised host-clock spans;
    returns ``{"sp1": s, "sp2": s, "iters": n}``."""
    from repro_torch.core import scheduler as sch
    spans = {"sp1": 0.0, "sp2": 0.0, "iters": 0}
    orig = {"sp1": sch.alpha_fair_waterfill, "sp2": sch.pack_all}

    def timed(stage):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[stage](*a, **k)
            torch.cuda.synchronize()
            spans[stage] += time.perf_counter() - t0
            if stage == "sp1":
                spans["iters"] += int(out.iters)
            return out
        return run

    sch.alpha_fair_waterfill, sch.pack_all = timed("sp1"), timed("sp2")
    try:
        fn()
    finally:
        sch.alpha_fair_waterfill, sch.pack_all = orig["sp1"], orig["sp2"]
    return spans


def _device_kernels(fn):
    """Kernel time on the card during ``fn`` from ``torch.profiler``:
    ``(total ms, [(name, ms), ...] largest first)``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
            for e in prof.key_averages()]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def phase_trace():
    """Where a round's time goes: untraced wall, then SP1/SP2 spans, then
    (for the shorter runs) the card's kernel time from the profiler."""
    log("[6] where the time goes (separate traced runs)")
    from repro_torch.core import (SchedulerConfig, SimConfig,
                                  generate_episode, run_episode,
                                  schedule_round)
    ep = generate_episode(SimConfig(seed=0), device="cuda")
    big = _round(32, 16384, 32, cap=3.0)
    cases = [
        ("paper episode cold", 10,
         lambda: run_episode(ep, SchedulerConfig()), False),
        ("paper episode warm", 10,
         lambda: run_episode(ep, SchedulerConfig(sp1_warm_start=True)),
         True),
        ("M=32 N=32 K=16384 capacity 3.0", 1,
         lambda: schedule_round(big, SchedulerConfig()), True),
    ]
    for label, rounds, fn, profiled in cases:
        fn()                                   # warm-up (allocator)
        wall = _wall(fn)
        sp = _stage_spans(fn)
        line = (f"  {label}: {wall / rounds * 1e3:.2f} ms/round untraced; "
                f"traced SP1 {sp['sp1'] / rounds * 1e3:.2f} ms/round "
                f"({sp['iters']} iters, {sp['sp1'] / max(sp['iters'], 1) * 1e3:.4f}"
                f" ms/iter), SP2 {sp['sp2'] / rounds * 1e3:.2f} ms/round")
        if profiled:
            dev_ms, rows = _device_kernels(fn)
            top = ", ".join(f"{n[:40]} {ms:.2f}" for n, ms in rows[:5])
            busy = (f"{dev_ms / (wall * 1e3):.4f}" if dev_ms > 0
                    else "not measured (profiler saw no device time)")
            line += (f"; card busy {dev_ms / rounds:.2f} ms/round, busy "
                     f"share {busy}; top kernels (ms): {top}")
        log(line)


def _dp_inputs(B, P, seed=0):
    """Gradient-like rows on the card, from a seeded torch.Generator: row
    scales 0.01-2, and row 1 (where B > 1) all zero."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn((B, P), generator=gen, device="cuda")
    g *= torch.rand((B, 1), generator=gen, device="cuda") * 1.99 + 0.01
    if B > 1:
        g[1] = 0.0
    return g


def phase_dp_kernels(card):
    log("[7] DP clip kernels against their twins on the card")
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.kernels import ref
    rows = {}
    for shape, B, P in DP_SHAPES:
        g = _dp_inputs(B, P)
        sq, sq2 = dp.rownorms(g), dp.rownorms(g)
        s = dp.clip_scales(torch.sqrt(sq), 0.05)
        acc, acc2 = dp.clip_accumulate(g, s), dp.clip_accumulate(g, s)
        sq_twin = ref.rownorms_ref(g)
        acc_twin = ref.clip_accumulate_ref(g, s)
        torch.cuda.synchronize()
        assert torch.equal(sq, sq2) and torch.equal(acc, acc2), \
            f"{shape}: a kernel is not bitwise stable from launch to launch"
        assert B == 1 or (float(sq[1]) == 0.0 and float(s[1]) == 1.0)
        rel = float(((sq.double() - sq_twin.double()).abs()
                     / sq_twin.double().clamp(min=1e-30)).max())
        assert rel <= NORM_RTOL, f"rownorms {shape}: rel err {rel:.3e}"
        errs = {"rownorms": float((sq - sq_twin).abs().max()),
                "clip_accumulate": check("clip_accumulate " + shape, acc,
                                         acc_twin, True)}
        line = (f"  B={B} P={P} ({shape}): rownorms rel err {rel:.3e} "
                f"(max abs {errs['rownorms']:.3e}), clip_accumulate "
                f"bitwise, both stable")
        cases = {
            "rownorms": (lambda: dp.rownorms(g), lambda: ref.rownorms_ref(g),
                         lambda: torch.linalg.vector_norm(g, dim=1) ** 2,
                         4 * (B * P + B), 2 * B * P),
            "clip_accumulate": (lambda: dp.clip_accumulate(g, s),
                                lambda: ref.clip_accumulate_ref(g, s),
                                lambda: torch.mv(g.T, s),
                                4 * (B * P + B + P), 2 * B * P)}
        for name, (run, twin, lib, nbytes, flops) in cases.items():
            r = rows.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], errs[name])
            if P != P_FLAAS or B == 1:
                continue
            ms, plain, lib_ms = time_ms(run, 10), time_ms(twin, 1, 3), \
                time_ms(lib, 10)
            b, by = bound_ms(nbytes, flops)
            line += (f"\n    {name:15s} kernel {ms:.4f} ms  twin {plain:.4f} "
                     f"ms  yardstick {lib_ms:.4f} ms  bound {b:.4f} ms "
                     f"({by}, {card})")
            if shape == "e2e":     # the JSON line reports the e2e shape
                r.update(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                         library_ms=lib_ms, shape=f"B={B} P={P}")
        log(line)
        del g, sq_twin, acc_twin
        torch.cuda.empty_cache()
    dp.reset_launches()
    return rows


def _fl_data(n_dev, vocab, seq, device, seed=0):
    """Per-device loaders of one seeded [2, seq] token batch each."""
    out = {}
    for d in range(n_dev):
        t = np.random.default_rng(seed + d).integers(
            0, vocab, (2, seq + 1)).astype(np.int32)
        t = torch.as_tensor(t, device=device)
        out[d] = (lambda t=t: [{"tokens": t[:, :-1], "labels": t[:, 1:]}])
    return out


def phase_fl_round():
    log("[8] one DP-FedAvg round of flaas-100m (full width, 2 layers), "
        "card vs CPU")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.launch.fl_e2e import FEDAVG
    from repro_torch.models import Transformer, init_model
    from repro_torch.training import FedAvgConfig, fl_round, make_loss_fn
    cfg = dataclasses.replace(get_arch("flaas-100m"), n_layers=2)
    card = init_model(cfg, 0, device="cuda")
    host = Transformer(cfg, device="cpu")
    with torch.no_grad():
        host.flat.copy_(card.flat.cpu())
    start = host.flat.clone()
    fcfg = FedAvgConfig(**FEDAVG, seed=0)
    loss_fn = make_loss_fn(cfg)
    dp.reset_launches()
    t0 = time.perf_counter()
    _, m_card = fl_round(card, loss_fn, _fl_data(8, cfg.vocab, 256, "cuda"),
                         list(range(8)), fcfg, sigma=0.0, round_idx=0)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    assert dp.LAUNCHES == {"rownorms": 1, "clip_accumulate": 1}, dp.LAUNCHES
    t0 = time.perf_counter()
    _, m_host = fl_round(host, loss_fn, _fl_data(8, cfg.vocab, 256, "cpu"),
                         list(range(8)), fcfg, sigma=0.0, round_idx=0)
    t_host = time.perf_counter() - t0
    assert m_card == m_host, (m_card, m_host)
    got = card.flat.cpu().double()
    want = host.flat.double()
    delta = float((want - start.double()).abs().max())
    diff = (got - want).abs()
    ulp = 2.0 ** -23 * want.abs().clamp(min=2.0 ** -126)
    ok = bool(torch.all(diff <= RTOL_FL * delta + ulp))
    log(f"  P={card.flat.numel()}, cohort {m_card['cohort']}, kept "
        f"{m_card['kept']}, stragglers {m_card['stragglers_dropped']}; "
        f"new params: max |card - CPU| {float(diff.max()):.3e} (at most "
        f"{float((diff / ulp).max()):.2f} ulp of the parameter; "
        f"{int((diff > 0).sum())} of {diff.numel()} differ), max |delta| "
        f"{delta:.3e}; bound {RTOL_FL} of max |delta| + one ulp; card "
        f"{t_card:.2f} s, CPU {t_host:.2f} s")
    assert ok, "card and CPU rounds disagree"


def phase_fl_e2e():
    log("[9] end-to-end FL loop on the card (flaas-100m, defaults)")
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.launch import fl_e2e
    from repro_torch.privacy import RdpAccountant

    def show(r):
        g = ", ".join(f"{tuple(x['pipeline'])}: grant {x['grant']:.6f} "
                      f"sigma {x['sigma']:.4f}" for x in r["granted"])
        log(f"  round {r['round']:2d} allocated={r['allocated']} "
            f"eff={r['efficiency']:.4f} live_blocks={r['live_blocks']} "
            f"loss={r['mean_pipeline_loss']:.4f} wall {r['wall_s']:.3f} s "
            f"(train {r['train_s']:.3f} s); {g}")
    torch.cuda.synchronize()
    dp.reset_launches()
    t0 = time.perf_counter()
    out = fl_e2e.run(device="cuda", log=show)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(dp.LAUNCHES)
    recs = out["records"]
    n_rounds = sum(len(r["granted"]) for r in recs)
    cfg = out["cfg"]
    assert (cfg.name, cfg.n_layers, cfg.d_model) == ("flaas-100m", 12, 768)
    assert launches == {"rownorms": n_rounds, "clip_accumulate": n_rounds}, \
        (launches, n_rounds)
    assert n_rounds > 0
    ledger = out["ledger"]
    for b in range(len(ledger)):
        blk = ledger.block(b)
        assert blk.consumed <= blk.budget + 1e-6, f"block {b} overdrawn"
    fresh = RdpAccountant(alpha_star=8.0)
    for r in recs:
        assert math.isfinite(r["mean_pipeline_loss"]), r
        for x in r["granted"]:
            assert x["sigma"] == fresh.sigma_for_grant(x["grant"], 1), x
    for p in out["pipelines"].values():
        assert all(math.isfinite(v) for v in p["losses"])
    eps, alpha = out["pipelines"][(0, 0)]["acc"].certify(1e-5)
    assert math.isfinite(eps)
    dry = fl_e2e.run(device="cpu", train=False)
    for a, b in zip(recs, dry["records"]):
        assert a["selected"] == b["selected"], (a["round"], a, b)
        assert a["allocated"] == b["allocated"]
        assert [x["pipeline"] for x in a["granted"]] == \
            [x["pipeline"] for x in b["granted"]]
    p00 = out["pipelines"][(0, 0)]["losses"]
    log(f"  {len(recs)} rounds, {n_rounds} fl_rounds in {wall:.2f} s; "
        f"launches {launches}; pipeline (0,0) losses {p00[:2]} -> "
        f"{p00[-2:]}; certified ({eps:.3f}, 1e-5)-DP at alpha {alpha}; "
        f"selections equal to the scheduler-only CPU run; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_fl_trace():
    """Per-round spans of the FL path (synchronised host-clock spans) and
    the card's busy share over one round traced by torch.profiler."""
    log("[10] where the FL path's time goes (flaas-100m, 3 rounds)")
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import dp_clip_noise as dp
    from repro_torch.launch import fl_e2e
    from repro_torch.training import fedavg
    spans = {}
    targets = [(fl_e2e, "schedule_round", "scheduler"),
               (fedavg, "client_update", "clients"),
               (fedavg, "aggregate", "aggregate"),
               (fedavg, "add_noise", "noise"),
               (dp, "rownorms", "rownorms"),
               (dp, "clip_accumulate", "clip_accumulate")]
    orig = {key: getattr(mod, attr) for mod, attr, key in targets}

    def timed(key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[key](*a, **k)
            torch.cuda.synchronize()
            spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    prof = profile(activities=[ProfilerActivity.CUDA])
    traced = {}

    def each_round(r):
        line = ", ".join(f"{k} {v * 1e3:.2f}" for k, v in spans.items())
        log(f"  round {r['round']}: wall {r['wall_s'] * 1e3:.2f} ms; spans "
            f"(ms, aggregate includes noise and the kernels): {line}")
        spans.clear()
        if r["round"] == 0:
            prof.start()
        elif r["round"] == 1:
            torch.cuda.synchronize()
            prof.stop()
            traced["wall_ms"] = r["wall_s"] * 1e3

    for mod, attr, key in targets:
        setattr(mod, attr, timed(key))
    try:
        fl_e2e.run(rounds=3, device="cuda", log=each_round)
    finally:
        for mod, attr, key in targets:
            setattr(mod, attr, orig[key])
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
            for e in prof.key_averages()]
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    top = ", ".join(f"{n[:40]} {ms:.2f}" for n, ms in rows[:6])
    busy = (f"{dev_ms / traced['wall_ms']:.4f}" if dev_ms > 0
            else "not measured (profiler saw no device time)")
    log(f"  traced round 1 (spans on): card busy {dev_ms:.2f} ms of "
        f"{traced['wall_ms']:.2f} ms wall, busy share {busy}; top kernels "
        f"(ms): {top}")


def main() -> int:
    name, smi = phase_device()
    phase_build()
    rows = phase_kernels(smi)
    launches = phase_episode()
    large = phase_large_round()
    phase_trace()
    dp_rows = phase_dp_kernels(smi)
    phase_fl_round()
    dp_launches = phase_fl_e2e()
    phase_fl_trace()
    kernels = [dict(name=k, route="cuda", source=SOURCE, replaces=REPLACES[k],
                    launches=launches[k], launches_large_round=large[k],
                    **rows[k]) for k in REPLACES]
    kernels += [dict(name=k, route="cuda", source=DP_SOURCE,
                     replaces=DP_REPLACES[k], launches=dp_launches[k],
                     **dp_rows[k]) for k in DP_REPLACES]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
