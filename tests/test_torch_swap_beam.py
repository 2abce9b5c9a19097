"""The port's certified swap beam against ``repro`` on the CPU.

The same numpy problems go through ``repro.core.swap`` / ``packing`` (one
analyst at a time, as ``repro`` vmaps them) and the port's batched
functions.  Discrete outputs -- refined selections, certificates, the
bound's ``-inf`` (invalid) and ``-1e30`` (screened infeasible) slots --
must be equal; continuous ones (the finite bounds, the certificate
margin) within rtol 1e-5 / atol 1e-5.  The port's beam must equal its own
full sweep bit for bit, and ``repro``'s ``pack_all`` (the reference's own
beam-on service run is not bitwise with its beam-off run, so ``repro``'s
beam is held only on what it decides: selections and certificates).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockaxis as jbx
from repro.core import demand as jdm
from repro.core import packing as jpk
from repro.core import scheduler as jsch
from repro.core import swap as jsw
from repro_torch.core import packing as tpk
from repro_torch.core import scheduler as tsch
from repro_torch.core import swap as tsw
from repro_torch.core.demand import RoundInputs

RTOL = ATOL = 1e-5
BIG = 1e30
# (budget fraction of each analyst's total demand, seed) -> what repro's
# beam of 1 does: falls back to the full sweep / certifies a swap
FALLBACK_1 = [(0.5, 0), (0.5, 7), (0.8, 0), (0.8, 3), (0.8, 9)]
CERT_SWAP_1 = [(0.8, 4), (0.8, 6), (0.8, 11)]
# repro's per-analyst functions, compiled as its pack_all_pruned runs them
J_BOUNDS = jax.jit(jsw.swap_prune_bounds, static_argnames=("kappa_max",))
J_BEAM = jax.jit(jsw.swap_refine_beam, static_argnames=("kappa_max", "beam"))


def problem(seed, frac, M=3, N=8, K=24):
    """SP2 operands: 40%-dense shares, ~15% inactive pipelines, each
    analyst's budget ``frac`` of its total demand."""
    rng = np.random.default_rng(seed)
    g = (rng.uniform(0, 0.3, (M, N, K))
         * (rng.random((M, N, K)) < 0.4)).astype(np.float32)
    mu = g.max(-1)
    a = rng.uniform(0.3, 1.0, (M, N)).astype(np.float32)
    act = rng.random((M, N)) < 0.85
    bud = (g.sum(1) * frac).astype(np.float32)
    return g, mu, a, act, bud


def torch_args(args):
    return [torch.as_tensor(x) for x in args]


def analyst(args, m):
    return [jnp.asarray(x[m]) for x in args]


def greedy(args):
    g, mu, a, act, bud = torch_args(args)
    return tpk.greedy_cover(g, mu, act, bud)


def assert_bounds_equal(jub, tub, what):
    jub = np.asarray(jub)
    for slot in (-np.inf, -BIG):
        np.testing.assert_array_equal(jub == np.float32(slot),
                                      tub == np.float32(slot),
                                      err_msg=f"{what}: {slot} slots")
    fin = np.isfinite(jub) & (jub > -BIG)
    np.testing.assert_allclose(tub[fin], jub[fin], rtol=RTOL, atol=ATOL,
                               err_msg=what)


def assert_margin_close(jm, tm, what):
    jm, tm = float(jm), float(tm)
    if not np.isfinite(jm) or abs(jm) >= 1e29:
        assert jm == tm, (what, jm, tm)
    else:
        assert abs(jm - tm) <= ATOL + RTOL * abs(jm), (what, jm, tm)


@pytest.mark.parametrize("levels,k", [(2, 1), (2, 8), (3, 5), (4, 9),
                                      (50, 8)])
def test_top_k_matches_lax_top_k(levels, k):
    """Values and indices equal to ``lax.top_k``'s (ties to the lowest
    index) on rows dense with ties, including the ``-inf`` and ``-1e30``
    slots of the beam's bounds."""
    rng = np.random.default_rng(levels * 10 + k)
    x = rng.integers(0, levels, (3, 4, 57)).astype(np.float32)
    x[x == 0] = -np.inf
    x[x == 1] = -BIG
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = tsw._top_k(torch.as_tensor(x), k)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("frac", [0.2, 0.5, 0.8, 1.2])
@pytest.mark.parametrize("seed", range(3))
def test_prune_bounds_match_repro(seed, frac):
    args = problem(seed, frac)
    g, mu, a, act, bud = torch_args(args)
    sel0 = greedy(args)
    s_c, u_c, v_c = tsw.swap_candidates(sel0, act)
    ub = tsw.swap_prune_bounds(g, mu, a, sel0, bud, 2.0, s_c, u_c, v_c)
    for m in range(g.shape[0]):
        jg, jmu, ja, jact, jbud = analyst(args, m)
        jsel = jnp.asarray(sel0[m].numpy())
        js, ju, jv = jsw.swap_candidates(jsel, jact)
        np.testing.assert_array_equal(np.asarray(js), s_c[m].numpy())
        np.testing.assert_array_equal(np.asarray(ju), u_c[m].numpy())
        jub = J_BOUNDS(jg, jmu, ja, jsel, jbud, 2.0, js, ju, jv)
        assert_bounds_equal(jub, ub[m].numpy(), f"analyst {m}")


@pytest.mark.parametrize("beam", [1, 2, 8])
@pytest.mark.parametrize("frac,seed", FALLBACK_1 + CERT_SWAP_1 + [(0.2, 1)])
def test_refine_beam_matches_repro(frac, seed, beam):
    args = problem(seed, frac)
    g, mu, a, act, bud = torch_args(args)
    sel0 = greedy(args)
    sel, ok, margin = tsw.swap_refine_beam(g, mu, a, act, sel0, bud, 2.0,
                                           beam)
    for m in range(g.shape[0]):
        jg, jmu, ja, jact, jbud = analyst(args, m)
        jsel, jok, jmargin = J_BEAM(jg, jmu, ja, jact,
                                    jnp.asarray(sel0[m].numpy()), jbud,
                                    kappa_max=2.0, beam=beam)
        np.testing.assert_array_equal(np.asarray(jsel), sel[m].numpy())
        assert bool(jok) == bool(ok[m]), (m, bool(jok), bool(ok[m]))
        assert_margin_close(jmargin, margin[m], f"analyst {m}")


@pytest.mark.parametrize("beam", [1, 4, 8])
@pytest.mark.parametrize("frac,seed", FALLBACK_1 + CERT_SWAP_1
                         + [(0.2, 1), (1.2, 2)])
def test_pack_all_pruned_bitwise(frac, seed, beam):
    """The beam equals the port's full sweep bit for bit and ``repro``'s
    ``pack_all``; the round's certificate equals ``repro``'s."""
    args = problem(seed, frac)
    P, ok, margin = tpk.pack_all_pruned(*torch_args(args), 2.0, beam)
    F = tpk.pack_all(*torch_args(args), 2.0)
    J = jpk.pack_all(*map(jnp.asarray, args), 2.0, True, True, jbx.LOCAL,
                     False)
    _, jok, jmargin = jpk.pack_all_pruned(*map(jnp.asarray, args), 2.0, beam)
    for f in F._fields:
        assert torch.equal(getattr(P, f), getattr(F, f)), f
        np.testing.assert_array_equal(np.asarray(getattr(J, f)),
                                      getattr(P, f).numpy(), err_msg=f)
    assert bool(ok) == bool(jok)
    assert_margin_close(jmargin, margin, "round")


@pytest.mark.parametrize("frac,seed", FALLBACK_1)
def test_beam_of_one_falls_back(frac, seed):
    """A beam of one cannot certify these rounds: the full sweep reruns
    (counted) and the result is still the full sweep's."""
    args = problem(seed, frac)
    calls = []
    orig = tsw.swap_refine_incremental

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tsw.swap_refine_incremental = counted
    try:
        P, ok, margin = tpk.pack_all_pruned(*torch_args(args), 2.0, 1)
    finally:
        tsw.swap_refine_incremental = orig
    assert not bool(ok) and float(margin) < 0 and calls == [1]
    F = tpk.pack_all(*torch_args(args), 2.0)
    assert torch.equal(P.selected, F.selected)
    assert torch.equal(P.x_ij, F.x_ij)


def test_certified_round_skips_the_full_sweep():
    args = problem(1, 0.2)
    calls = []
    orig = tsw.swap_refine_incremental
    tsw.swap_refine_incremental = lambda *a, **k: calls.append(1)
    try:
        _, ok, _ = tpk.pack_all_pruned(*torch_args(args), 2.0, 8)
    finally:
        tsw.swap_refine_incremental = orig
    assert bool(ok) and calls == []


def test_tight_budget_certifies_through_the_second_clause():
    """Every swap is screened infeasible and the base objective sits below
    the infeasible floor (a weight of -3e38): the first clause fails
    (margin 0, no headroom) and the second certifies, in ``repro`` and in
    the port, with the same selection (the floor's candidate beats that
    base objective, so both accept the beam's first swap)."""
    g = np.zeros((1, 4, 3), np.float32)
    g[0, 0] = [0.5, 0.0, 0.0]
    g[0, 1] = [0.9, 0.4, 0.0]
    g[0, 2] = [0.0, 0.9, 0.0]
    g[0, 3] = [0.8, 0.0, 0.9]
    mu = g.max(-1)
    a = np.array([[-3e38, 1.0, 1.0, 1.0]], np.float32)
    act = np.ones((1, 4), bool)
    bud = np.array([[0.55, 0.5, 0.5]], np.float32)
    args = (g, mu, a, act, bud)
    sel0 = greedy(args)
    assert sel0[0].tolist() == [True, False, False, False]
    sel, ok, margin = tsw.swap_refine_beam(*torch_args(args)[:4], sel0,
                                           torch.as_tensor(bud), 2.0, 1)
    jsel, jok, jmargin = J_BEAM(*analyst(args, 0)[:4],
                                jnp.asarray(sel0[0].numpy()),
                                jnp.asarray(bud[0]), kappa_max=2.0, beam=1)
    assert bool(ok[0]) and bool(jok)
    assert float(margin[0]) == float(jmargin) == 0.0
    np.testing.assert_array_equal(np.asarray(jsel), sel[0].numpy())


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("frac,seed", [(0.5, 0), (0.8, 4), (0.2, 1)])
def test_schedule_round_with_beam(frac, seed, warm):
    """``schedule_round`` with ``swap_beam=4``: the port's round equals its
    beam-off round bit for bit, and ``repro``'s beam decisions."""
    g, _, a, act, bud = problem(seed, frac)
    M, N, K = g.shape
    d = dict(demand=g, active=act,
             arrival=np.zeros((M, N), np.float32), loss=a,
             capacity=bud.sum(0) / M, budget_total=np.ones(K, np.float32),
             now=np.float32(0.0),
             lam=np.ones(K, np.float32) if warm else None)
    tr = RoundInputs.from_numpy(**d, device="cpu")
    beam = tsch.schedule_round(tr, tsch.SchedulerConfig(
        swap_beam=4, sp1_warm_start=warm))
    full = tsch.schedule_round(tr, tsch.SchedulerConfig(
        sp1_warm_start=warm))
    for f in full._fields:
        x, y = getattr(full, f), getattr(beam, f)
        if f.startswith("swap_cert"):
            assert x is None and y is not None and y.shape == ()
        elif x is None:
            assert y is None, f
        else:
            assert torch.equal(x, y), f
    jr = jdm.RoundInputs(**{k: None if v is None else jnp.asarray(v)
                             for k, v in d.items()})
    jres = jsch.schedule_round(jr, jsch.SchedulerConfig(
        swap_beam=4, sp1_warm_start=warm))
    np.testing.assert_array_equal(np.asarray(jres.selected),
                                  beam.selected.numpy())
    assert bool(jres.swap_cert_ok) == bool(beam.swap_cert_ok)
    assert_margin_close(jres.swap_cert_margin, beam.swap_cert_margin, "round")


def test_beam_needs_refine_and_the_incremental_engine():
    g, _, a, act, bud = problem(0, 0.5)
    M, N, K = g.shape
    tr = RoundInputs.from_numpy(
        demand=g, active=act, arrival=np.zeros((M, N)), loss=a,
        capacity=bud.sum(0) / M, budget_total=np.ones(K), now=0.0,
        device="cpu")
    for cfg in (tsch.SchedulerConfig(swap_beam=4, refine=False),
                tsch.SchedulerConfig(swap_beam=4, incremental_swap=False)):
        res = tsch.schedule_round(tr, cfg)
        assert res.swap_cert_ok is None and res.swap_cert_margin is None


@pytest.mark.parametrize("seed,N", [(0, 6), (1, 8), (2, 10), (3, 10)])
def test_exact_pack_matches_repro(seed, N):
    rng = np.random.default_rng(seed)
    K = 12
    g = (rng.uniform(0, 0.4, (N, K)) * (rng.random((N, K)) < 0.5)
         ).astype(np.float32)
    mu = g.max(-1)
    a = rng.uniform(0.3, 1.0, N).astype(np.float32)
    act = rng.random(N) < 0.9
    bud = (g.sum(0) * 0.4).astype(np.float32)
    js, jc, jo = jpk.exact_pack(g, mu, a, act, bud, 2.0)
    ts, tc, to = tpk.exact_pack(g, mu, a, act, bud, 2.0, device="cpu")
    np.testing.assert_array_equal(np.asarray(js), ts)
    assert (jc, jo) == (tc, to)
    # the oracle bounds the heuristic's count
    sel = tpk.pack_analyst(*map(torch.as_tensor, (g, mu, a, act, bud)),
                           2.0).selected
    assert int(sel.sum()) <= tc


def test_exact_pack_refuses_large_n():
    g = np.zeros((17, 2), np.float32)
    with pytest.raises(ValueError):
        tpk.exact_pack(g, g.max(-1), np.ones(17), np.ones(17, bool),
                       np.ones(2), 2.0, device="cpu")


def test_exact_pack_defaults_to_the_card():
    g = np.zeros((3, 2), np.float32)
    args = (g, g.max(-1), np.ones(3), np.ones(3, bool), np.ones(2), 2.0)
    if torch.cuda.is_available():
        pytest.skip("a card is present; the card case covers the default")
    with pytest.raises(RuntimeError):
        tpk.exact_pack(*args)

