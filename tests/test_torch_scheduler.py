"""Port scheduler against ``repro`` on the CPU: SP1 (both modes), SP2,
the Eq 8-10 metrics and whole rounds.

Inputs are the first round of every scenario in ``repro.core.scenarios``
at a small geometry (4 devices, 3 analysts x 6 pipelines, 3 rounds), the
paper's Fig-2 toy and one round at paper geometry, all built in numpy and
handed to both packages.  Discrete outputs must be equal; continuous ones
agree within rtol 1e-5 / atol 1e-5 (``repro``'s own engine-vs-legacy
bound; values are shares and epsilons of order 1).

SP1's iteration count must be equal too, except where the reference's
stop rule sits on its float32 noise floor: near convergence the KKT error
is ``lam * |load - cap|``, a cancellation whose rounding noise is of the
order of ``tol = 1e-6``, so one-ulp differences between XLA's and
PyTorch's ``exp``/``pow`` move the stopping iteration.  Those cases are
listed in :data:`NEAR_TIE_ROUND` / :data:`NEAR_TIE_SP1` with both counts
(and in ROADMAP Queue 3); their solutions still agree within the tolerance
above.  ``repro`` alone shows the same sensitivity: XLA fuses SP1
differently when it is compiled on its own than inside the round, and
``tight_budgets``' cold solve stops after 91 iterations alone but runs to
4000 inside ``schedule_round``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockaxis as jbx
from repro.core import demand as jdm
from repro.core import engine as jeng
from repro.core import packing as jpk
from repro.core import scenarios as jscen
from repro.core import scheduler as jsch
from repro.core import utility as jut
from repro.core import waterfill as jwf
from repro_torch.core import blockaxis as tbx
from repro_torch.core import demand as tdm
from repro_torch.core import packing as tpk
from repro_torch.core import scheduler as tsch
from repro_torch.core import utility as tut
from repro_torch.core import waterfill as twf

SMALL = dict(n_devices=4, n_analysts=3, pipelines_per_analyst=6, n_rounds=3)
SCENARIOS = sorted(jscen.SCENARIOS)
RTOL = ATOL = 1e-5
# (scenario, warm SP1) -> (repro iters, port iters) where the stop rule
# sits on its noise floor: schedule_round on the first small round ...
NEAR_TIE_ROUND = {
    ("paper_default", True): (37, 36),
    ("mice_fleet", True): (41, 43),
    ("elephant_storm", True): (36, 37),
    ("analyst_churn", True): (29, 30),
    ("tight_budgets", True): (37, 36),
    ("deep_history", True): (88, 69),
}
# ... and alpha_fair_waterfill alone on that round's SP1 operands
NEAR_TIE_SP1 = {
    ("paper_default", True): (37, 36),
    ("elephant_storm", True): (36, 37),
    ("analyst_churn", True): (30, 29),
    ("deep_history", True): (83, 70),
    ("mice_fleet", True): (43, 41),
    ("tight_budgets", False): (91, 90),
}


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


def round_arrays(ep, r=0, warm=False):
    """Round ``r`` of a ``repro`` episode as numpy arrays, with every block
    created so far at full capacity (``run_episode``'s first round)."""
    demand = np.asarray(ep.demand)
    br, bb = np.asarray(ep.block_round), np.asarray(ep.block_budget)
    active = np.asarray(ep.spawn_round)[:, None] <= r
    return dict(
        demand=(demand * active[..., None]).astype(np.float32),
        active=active,
        arrival=np.where(active, np.asarray(ep.arrival), 0).astype(np.float32),
        loss=np.where(active, np.asarray(ep.loss), 1).astype(np.float32),
        capacity=(bb * (br <= r)).astype(np.float32),
        budget_total=np.where(br <= r, bb, 1.0).astype(np.float32),
        now=np.float32(r * 10.0),
        lam=np.ones(demand.shape[-1], np.float32) if warm else None)


def both_inputs(d):
    jr = jdm.RoundInputs(**{k: None if v is None else jnp.asarray(v)
                            for k, v in d.items()})
    return jr, tdm.RoundInputs.from_numpy(**d, device="cpu")


def scenario_round(name, warm=False):
    ep = jeng.generate_episode(jscen.scenario_config(name, seed=0, **SMALL))
    return round_arrays(ep, 0, warm)


def assert_close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               b.double().numpy(), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def assert_iters(jit, tit, key, near_ties):
    if key in near_ties:
        assert (jit, tit) == near_ties[key], (key, jit, tit)
    else:
        assert jit == tit, (key, jit, tit)


def assert_rounds_agree(a, b, key=None):
    for f in a._fields:
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is None:
            continue
        if f == "sp1_iters":
            assert_iters(int(va), int(vb), key, NEAR_TIE_ROUND)
        elif np.asarray(va).dtype == bool or f == "n_allocated":
            np.testing.assert_array_equal(np.asarray(va), vb.numpy(),
                                          err_msg=f)
        else:
            assert_close(va, vb, f)


# --------------------------------------------------------------------- SP1

def sp1_problem(name):
    """SP1 operands of a scenario's first round, as ``repro`` forms them."""
    d = scenario_round(name)
    jr, _ = both_inputs(d)
    gamma = jdm.normalized_demand(jr.demand, jr.budget_total)
    cap = jr.capacity / jnp.maximum(jr.budget_total, 1e-9)
    active = jr.active & ~jdm.infeasible_pipelines(gamma, cap)
    view = jdm.AnalystView.build(dataclasses.replace(jr, active=active),
                                 100.0)
    return [np.array(v) for v in (view.mu_i, view.a_i, view.gamma_i,
                                  view.mask, cap)]


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("name", SCENARIOS)
def test_waterfill_matches_repro(name, adaptive):
    mu, a, c, mask, cap = sp1_problem(name)
    lam0 = np.ones(c.shape[1], np.float32) if adaptive else None
    r = jwf.alpha_fair_waterfill(
        *map(jnp.asarray, (mu, a, c, mask)), cap=jnp.asarray(cap), beta=2.2,
        lam0=None if lam0 is None else jnp.asarray(lam0), adaptive=adaptive)
    t = twf.alpha_fair_waterfill(
        *map(torch.as_tensor, (mu, a, c, mask)), cap=torch.as_tensor(cap),
        beta=2.2, lam0=None if lam0 is None else torch.as_tensor(lam0),
        adaptive=adaptive)
    for f in ("x", "lam", "violation"):
        assert_close(getattr(r, f), getattr(t, f), f)
    assert_iters(int(r.iters), int(t.iters), (name, adaptive), NEAR_TIE_SP1)
    assert float(t.violation) <= 1e-6          # the projection's guarantee


def test_waterfill_fig2_sp1_matches_paper():
    mu = torch.tensor([0.8, 0.7])
    c = torch.tensor([[0.8, 0.8], [0.7, 0.6]])
    r = twf.alpha_fair_waterfill(mu, torch.ones(2), c,
                                 torch.ones(2, dtype=torch.bool), beta=2.2)
    np.testing.assert_allclose((c[0] * r.x[0]).numpy(), [0.5, 0.5],
                               atol=2e-3)
    np.testing.assert_allclose((c[1] * r.x[1]).numpy(), [0.5, 0.4286],
                               atol=2e-3)


# --------------------------------------------------------------------- SP2

def pack_problem(seed):
    rng = np.random.default_rng(seed)
    M, N, K = 3, 6 + 2 * (seed % 2), 20 + 17 * (seed % 2)
    g = (rng.uniform(0, 0.3, (M, N, K))
         * (rng.random((M, N, K)) < 0.4)).astype(np.float32)
    mu = g.max(-1)
    a = rng.uniform(0.3, 1.0, (M, N)).astype(np.float32)
    act = rng.random((M, N)) < 0.8
    bud = (g.sum(1) * rng.uniform(0.3, 0.9, (M, 1))).astype(np.float32)
    return g, mu, a, act, bud


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kappa,refine,incremental",
                         [(2.0, True, True), (8.0, True, True),
                          (2.0, False, True), (2.0, True, False)])
def test_pack_all_bitwise_with_repro(seed, kappa, refine, incremental):
    """SP2 follows the reference's rounding exactly: every output of the
    batched port equals ``repro``'s vmapped ``pack_analyst`` bit for bit."""
    args = pack_problem(seed)
    J = jpk.pack_all(*map(jnp.asarray, args), kappa, refine, incremental,
                     jbx.LOCAL, False)
    T = tpk.pack_all(*map(torch.as_tensor, args), kappa, refine, incremental)
    for f in J._fields:
        np.testing.assert_array_equal(np.asarray(getattr(J, f)),
                                      getattr(T, f).numpy(), err_msg=f)


@pytest.mark.parametrize("seed", range(6))
def test_swap_engines_agree_bitwise(seed):
    """The compacted swap engine returns the reference sweep's selection."""
    g, mu, a, act, bud = map(torch.as_tensor, pack_problem(seed))
    sel0 = tpk.greedy_cover(g, mu, act, bud)
    fast = tpk.swap_refine(g, mu, a, act, sel0, bud, 2.0, incremental=True)
    slow = tpk.swap_refine(g, mu, a, act, sel0, bud, 2.0, incremental=False)
    assert torch.equal(fast, slow)


# ----------------------------------------------------------------- metrics

@pytest.mark.parametrize("beta", [2.2, 0.5])
def test_utility_metrics_match_repro(beta):
    rng = np.random.default_rng(3)
    util = rng.uniform(0.0, 2.0, (4, 7)).astype(np.float32)
    util[0, 2] = 0.0
    mask = rng.random((4, 7)) < 0.8
    gid = np.array([0, 1, 0, 2, 1, 1, 0])
    for fn, args in [("dominant_efficiency", (mask,)),
                     ("dominant_fairness", (beta, mask)),
                     ("platform_utility", (beta, 0.3, mask)),
                     ("alpha_fair_objective", (beta, mask)),
                     ("normalized_fairness", (beta, mask)),
                     ("jain_index", (mask,))]:
        j = getattr(jut, fn)(jnp.asarray(util),
                             *[jnp.asarray(x) for x in args])
        t = getattr(tut, fn)(torch.as_tensor(util),
                             *[torch.as_tensor(x) if isinstance(x, np.ndarray)
                               else x for x in args])
        np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=RTOL,
                                   err_msg=fn)
    j = jut.group_fairness(jnp.asarray(util[0]), beta, jnp.asarray(gid), 3,
                           jnp.asarray(mask[0]))
    t = tut.group_fairness(torch.as_tensor(util[0]), beta,
                           torch.as_tensor(gid), 3, torch.as_tensor(mask[0]))
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=RTOL)
    j = jut.group_efficiency(jnp.asarray(util[0]), jnp.asarray(gid), 3)
    t = tut.group_efficiency(torch.as_tensor(util[0]), torch.as_tensor(gid),
                             3)
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=RTOL)


# ------------------------------------------------------------ whole rounds

@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("name", SCENARIOS)
def test_schedule_round_matches_repro(name, refine, warm):
    jr, tr = both_inputs(scenario_round(name, warm))
    a = jsch.schedule_round(jr, jsch.SchedulerConfig(refine=refine,
                                                     sp1_warm_start=warm))
    b = tsch.schedule_round(tr, tsch.SchedulerConfig(refine=refine,
                                                     sp1_warm_start=warm))
    assert_rounds_agree(a, b, (name, warm))


def test_fig2_round_matches_paper_and_repro():
    """Paper Fig. 2: Alice gets P1, Bob gets P3 with kappa = 1.25."""
    demand = np.zeros((2, 2, 2), np.float32)
    demand[0, 0] = [0.5, 0.3]
    demand[0, 1] = [0.3, 0.5]
    demand[1, 0] = [0.4, 0.3]
    demand[1, 1] = [0.3, 0.3]
    d = dict(demand=demand, active=np.ones((2, 2), bool),
             arrival=np.zeros((2, 2)), loss=np.ones((2, 2)),
             capacity=np.ones(2), budget_total=np.ones(2), now=0.0)
    jr, tr = both_inputs(d)
    res = tsch.schedule_round(tr, tsch.SchedulerConfig(beta=2.2))
    sel = res.selected.numpy()
    assert sel[0, 0] and sel[1, 0] and not sel[0, 1] and not sel[1, 1]
    np.testing.assert_allclose(res.grants[0, 0].numpy(), [0.5, 0.3],
                               atol=2e-3)
    np.testing.assert_allclose(res.grants[1, 0].numpy(), [0.5, 0.375],
                               atol=2e-3)
    assert abs(float(res.x_pipeline[1, 0]) - 1.25) < 2e-3
    assert int(res.n_allocated) == 2
    assert_rounds_agree(jsch.schedule_round(jr, jsch.SchedulerConfig()), res)


def test_paper_geometry_round_matches_repro():
    """Round 3 of the paper episode (6 x 25 pipelines, K = 2000) with every
    block created so far at full capacity."""
    ep = jeng.generate_episode(jscen.scenario_config("paper_default", seed=0))
    jr, tr = both_inputs(round_arrays(ep, 3))
    a = jsch.schedule_round(jr, jsch.SchedulerConfig())
    b = tsch.schedule_round(tr, tsch.SchedulerConfig())
    assert int(b.n_allocated) > 0
    assert_rounds_agree(a, b)


def test_outside_the_slice_raises():
    """Nothing of the scheduler is outside the port now: the swap beam is
    ported (``test_torch_swap_beam.py``) and so is a sharded block axis
    (``test_torch_shard.py``).  A sharded axis needs its process group:
    without one the round raises rather than run on one stripe."""
    _, tr = both_inputs(scenario_round("paper_default"))
    with pytest.raises(ValueError, match="process group"):
        tsch.schedule_round(tr, tsch.SchedulerConfig(),
                            block_axis=tbx.BlockAxis("shard"))
