"""The lockstep fleet, ``run_fleet(mode="vmap")``, on the CPU.

A fleet of E same-shape episodes advances one round of every episode at a
time: the round functions take the episodes as a leading axis (SP1 keeps
it as a batch axis, SP2 folds it into the analysts), and every episode's
output must be bitwise what the episode gives alone.  Checked here at
``test_torch_fleet.py``'s small geometry (4 devices, 3 analysts x 6
pipelines, 4 rounds):

* the batched twins (``matvec_ref``, ``matvec_t_ref``, ``dual_step_ref``,
  ``dual_ascent_ref``) bitwise per-episode calls, with episodes that stop
  at different iterations, cold and warm, and an episode whose every
  analyst is masked;
* ``schedule_round`` and each baseline with a leading E bitwise
  per-episode calls, refine on and off, warm, and with the swap beam
  (``[E]`` certificates, some episodes failing theirs);
* ``run_fleet(mode="vmap")`` bitwise ``mode="map"`` on every key, for all
  four schedulers, SP1 cold and warm, with ``diagnostics=True``;
* ``run_fleet(mode="vmap")`` against ``repro``'s ``run_fleet(mode=
  "vmap")``: discrete outputs equal, continuous ones within rtol 1e-5 /
  atol 1e-5, warm SP1 counts equal except the pinned near-ties of
  ``test_torch_fleet.NEAR_TIE_WARM_ITERS``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import scenarios as jscen
from repro.core import scheduler as jsch
from repro_torch.core import engine as teng
from repro_torch.core import packing as tpack
from repro_torch.core import scenarios as tscen
from repro_torch.core import scheduler as tsch
from repro_torch.core.demand import DemandView, RoundInputs
from repro_torch.core.registry import get_round_fn
from repro_torch.kernels import ref
from test_torch_dual_ascent import sp1_operands
from test_torch_fleet import (CONTINUOUS, DIAG_CONTINUOUS, DIAG_DISCRETE,
                              DISCRETE, NAMES, NEAR_TIE_WARM_ITERS, SMALL,
                              assert_episodes_agree)

BETA = 2.2
# (adaptive, warm lam0, max_iters, tol): cold, adaptive warm, capped
ASCENT_MODES = [(False, False, 4000, 1e-6), (True, True, 4000, 1e-6),
                (False, True, 37, 1e-6)]
# SchedulerConfig overrides for the dpbalance round: refine on (the
# default), off, the reference swap path, warm SP1, the swap beam
ROUND_CFGS = [dict(), dict(refine=False), dict(incremental_swap=False),
              dict(sp1_warm_start=True), dict(swap_beam=8),
              dict(swap_beam=1)]
# (scheduler, SP1 warm start) of the fleet runs: the baselines run no SP1
RUNS = [("dpbalance", False), ("dpbalance", True)] + [(n, False)
                                                      for n in NAMES[1:]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's side: its CPU work here is small,
    and the test runner runs several workers at once, each of whose
    thread pools would otherwise oversubscribe the cores (as
    ``tests/test_torch_bf16_train.py`` does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bitwise(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.is_floating_point():
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what
    else:
        assert torch.equal(a, b), what


def _stack_ops(opsets):
    return tuple(torch.stack(t) for t in zip(*opsets))


def _fleet_ops(M=6, K=48, E=5, warm=False):
    """E seeded SP1 operand sets of one shape; the last one with every
    analyst masked (it must stop as its lone run does)."""
    opsets = [sp1_operands(M, K, seed=s, warm=warm) for s in range(E)]
    c, lam, w_pow, xcap, mask, cap, cap_safe = opsets[-1]
    opsets[-1] = (c, lam, torch.zeros_like(w_pow), torch.zeros_like(xcap),
                  torch.zeros_like(mask), cap, cap_safe)
    return opsets


def test_batched_dense_twins_bitwise_per_episode():
    opsets = _fleet_ops()
    c, lam, w_pow, xcap, mask, cap, cap_safe = _stack_ops(opsets)
    x = torch.stack([torch.linspace(0.0, 2.0, c.shape[1]) * (e + 1)
                     for e in range(c.shape[0])])
    y, load = ref.matvec_ref(c, lam), ref.matvec_t_ref(c, x)
    xs, gs = ref.dual_step_ref(c, lam, w_pow, xcap, mask, cap, cap_safe,
                               BETA)
    assert y.shape == xs.shape == c.shape[:2]
    assert load.shape == gs.shape == lam.shape
    for e, ops in enumerate(opsets):
        _bitwise(y[e], ref.matvec_ref(ops[0], ops[1]), ("matvec", e))
        _bitwise(load[e], ref.matvec_t_ref(ops[0], x[e]), ("matvec_t", e))
        x1, g1 = ref.dual_step_ref(*ops, BETA)
        _bitwise(xs[e], x1, ("dual_step x", e))
        _bitwise(gs[e], g1, ("dual_step g", e))


@pytest.mark.parametrize("adaptive,warm,max_iters,tol", ASCENT_MODES)
def test_batched_dual_ascent_bitwise_per_episode(adaptive, warm, max_iters,
                                                  tol):
    """Episodes stop at different iterations; a stopped episode stays
    frozen while the others iterate, so each equals its lone loop."""
    opsets = _fleet_ops(warm=warm)
    kw = dict(adaptive=adaptive, max_iters=max_iters, tol=tol)
    lam, iters = ref.dual_ascent_ref(*_stack_ops(opsets), BETA, **kw)
    assert iters.dtype == torch.int32 and iters.shape == (len(opsets),)
    counts = []
    for e, ops in enumerate(opsets):
        lam1, it1 = ref.dual_ascent_ref(*ops, BETA, **kw)
        assert it1.shape == () and int(iters[e]) == int(it1), e
        _bitwise(lam[e], lam1, ("lam", e))
        counts.append(int(it1))
    if max_iters == 4000:
        assert len(set(counts)) > 1, counts


def test_batched_dual_ascent_counts_host_reads(monkeypatch):
    """The twin's loop reads the fleet's KKT errors once an iteration, not
    once an episode."""
    opsets = _fleet_ops()
    reads = []
    orig = ref.kkt_error

    def counted(lam, g):
        reads.append(tuple(g.shape))
        return orig(lam, g)

    monkeypatch.setattr(ref, "kkt_error", counted)
    _, iters = ref.dual_ascent_ref(*_stack_ops(opsets), BETA,
                                   adaptive=False, max_iters=4000, tol=1e-6)
    assert len(reads) == int(iters.max())
    assert set(reads) == {(len(opsets), opsets[0][0].shape[1])}


def _round_inputs(fleet, r, cfg):
    """The lockstep round ``r`` of ``fleet`` as the engine forms it, from
    fresh capacity (every block minted so far) and no pipeline done."""
    created = fleet.block_round <= r
    capacity = fleet.block_budget * created
    active = fleet.spawn_round[..., None] <= r
    lam = (torch.where(created, 0.7, 1.0) if cfg.sp1_warm_start
           else None)
    return RoundInputs(
        demand=DemandView(base=fleet.demand).masked(active), active=active,
        arrival=torch.where(active, fleet.arrival, 0.0),
        loss=torch.where(active, fleet.loss, 1.0), capacity=capacity,
        budget_total=torch.where(created, fleet.block_budget, 1.0),
        now=torch.tensor(np.float32(r) * np.float32(10.0)), lam=lam)


def _episode_round(rnd, e):
    return dataclasses.replace(rnd, **{
        f.name: getattr(rnd, f.name)[e] for f in dataclasses.fields(rnd)
        if f.name != "now" and getattr(rnd, f.name) is not None})


def _round_cases():
    yield from (("dpbalance", c) for c in ROUND_CFGS)
    yield from ((n, dict()) for n in NAMES[1:])


@pytest.mark.parametrize("name,over", list(_round_cases()))
def test_round_functions_batched_bitwise_per_episode(name, over):
    """Every field of a lockstep round's result, episode by episode, is
    bitwise the lone round's; the certificates are per episode."""
    cfg = tsch.SchedulerConfig(beta=BETA, **over)
    fleet = tscen.make_fleet("elephant_storm", 4, device="cpu", **SMALL)
    fn = get_round_fn(name)
    for r in (1, 3):
        rnd = _round_inputs(fleet, r, cfg)
        res = fn(rnd, cfg)
        for e in range(fleet.demand.shape[0]):
            one = fn(_episode_round(rnd, e), cfg)
            for f in res._fields:
                a, b = getattr(res, f), getattr(one, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    _bitwise(a[e], b, (name, over, r, e, f))
    if over.get("swap_beam"):
        assert res.swap_cert_ok.shape == (fleet.demand.shape[0],)


def test_beam_reruns_only_the_failing_episodes(monkeypatch):
    """With a beam of one, some episodes of the round fail their
    certificate: only their analysts rerun the full sweep, and the round
    still equals the beam-off round bitwise."""
    fleet = tscen.make_fleet("elephant_storm", 4, device="cpu", **SMALL)
    cfg = tsch.SchedulerConfig(beta=BETA, swap_beam=1)
    rnd = _round_inputs(fleet, 1, cfg)
    rows = []
    orig = tpack._swap.swap_refine_incremental

    def spy(gamma, *a, **k):
        rows.append(gamma.shape[0])
        return orig(gamma, *a, **k)

    monkeypatch.setattr(tpack._swap, "swap_refine_incremental", spy)
    res = tsch.schedule_round(rnd, cfg)
    ok = res.swap_cert_ok.tolist()
    assert 0 < ok.count(False) < len(ok), ok
    assert rows == [ok.count(False) * SMALL["n_analysts"]]
    monkeypatch.setattr(tpack._swap, "swap_refine_incremental", orig)
    full = tsch.schedule_round(rnd, dataclasses.replace(cfg, swap_beam=0))
    for f in ("selected", "x_pipeline", "consumed", "efficiency"):
        _bitwise(getattr(res, f), getattr(full, f), f)


@pytest.mark.parametrize("name,warm", RUNS)
def test_run_fleet_vmap_bitwise_map(name, warm):
    fleet = tscen.make_fleet("paper_default", 3, device="cpu", **SMALL)
    cfg = tsch.SchedulerConfig(beta=BETA, sp1_warm_start=warm)
    vm = teng.run_fleet(fleet, cfg, name, mode="vmap", diagnostics=True)
    mp = teng.run_fleet(fleet, cfg, name, mode="map", diagnostics=True)
    assert set(vm) == set(mp)
    assert {"granted_i", "sp1_iters", "selected"} <= set(vm)
    for k in mp:
        _bitwise(vm[k], mp[k], k)


@pytest.mark.parametrize("beam", [1, 8])
def test_run_fleet_vmap_bitwise_map_with_the_beam(beam):
    fleet = tscen.make_fleet("tight_budgets", 4, device="cpu", **SMALL)
    cfg = tsch.SchedulerConfig(beta=BETA, swap_beam=beam)
    vm = teng.run_fleet(fleet, cfg, "dpbalance", mode="vmap")
    mp = teng.run_fleet(fleet, cfg, "dpbalance", mode="map")
    for k in mp:
        _bitwise(vm[k], mp[k], k)


def test_run_fleet_auto_takes_map_on_the_cpu(monkeypatch):
    """``"auto"`` is ``"map"`` for a CPU fleet: one lockstep loop of one
    episode per episode, the same rows as ``"vmap"``."""
    fleet = tscen.make_fleet("paper_default", 2, device="cpu", **SMALL)
    sizes = []
    orig = teng._lockstep

    def spy(f, *a):
        sizes.append(f.demand.shape[0])
        return orig(f, *a)

    monkeypatch.setattr(teng, "_lockstep", spy)
    auto = teng.run_fleet(fleet, tsch.SchedulerConfig(), "dpf")
    assert sizes == [1, 1]
    vm = teng.run_fleet(fleet, tsch.SchedulerConfig(), "dpf", mode="vmap")
    assert sizes == [1, 1, 2]
    for k in auto:
        _bitwise(vm[k], auto[k], k)


@pytest.mark.parametrize("name,warm", RUNS)
def test_run_fleet_vmap_matches_repro_vmap(name, warm):
    scen, seeds = "paper_default", 3
    cfg = dict(beta=BETA, sp1_warm_start=warm)
    jout = jeng.run_fleet(jscen.make_fleet(scen, seeds, **SMALL),
                          jsch.SchedulerConfig(**cfg), name, mode="vmap",
                          diagnostics=True)
    tout = teng.run_fleet(tscen.make_fleet(scen, seeds, device="cpu",
                                           **SMALL),
                          tsch.SchedulerConfig(**cfg), name, mode="vmap",
                          diagnostics=True)
    assert_episodes_agree(jout, tout, DISCRETE + DIAG_DISCRETE,
                          CONTINUOUS + DIAG_CONTINUOUS)
    if warm:
        for e in range(seeds):
            ja = np.asarray(jout["sp1_iters"][e]).tolist()
            tb = tout["sp1_iters"][e].tolist()
            if (scen, e) in NEAR_TIE_WARM_ITERS:
                assert (ja, tb) == NEAR_TIE_WARM_ITERS[(scen, e)], e
            else:
                assert ja == tb, e
