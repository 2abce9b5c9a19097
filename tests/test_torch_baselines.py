"""The port's DPF / DPK / FCFS baselines and the scheduler registry against
``repro`` on the CPU.

Inputs are the first round of every scenario in ``repro.core.scenarios``
at a small geometry (4 devices, 3 analysts x 6 pipelines), a round of the
paper episode and the paper's Fig-2 toy, built in numpy and handed to both
packages.  Discrete outputs (``selected``, ``n_allocated``) must be equal;
continuous ones within rtol 1e-5 / atol 1e-5.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import demand as jdm
from repro.core import engine as jeng
from repro.core import registry as jreg
from repro.core import scenarios as jscen
from repro.core import scheduler as jsch
from repro_torch.core import baselines as tbl
from repro_torch.core import demand as tdm
from repro_torch.core import registry as treg
from repro_torch.core import scheduler as tsch
from repro_torch.fp import tree_sum

SMALL = dict(n_devices=4, n_analysts=3, pipelines_per_analyst=6, n_rounds=3)
BASELINES = ("dpf", "dpk", "fcfs")
RTOL = ATOL = 1e-5


def round_arrays(ep, r=0, weight=None):
    """Round ``r`` of a ``repro`` episode as numpy arrays, every block
    created so far at full capacity."""
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
        now=np.float32(r * 10.0), weight=weight)


def both_inputs(d):
    jr = jdm.RoundInputs(**{k: None if v is None else jnp.asarray(v)
                            for k, v in d.items()})
    return jr, tdm.RoundInputs.from_numpy(**d, device="cpu")


def assert_rounds_agree(a, b):
    for f in a._fields:
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is None:
            continue
        if np.asarray(va).dtype == bool or f == "n_allocated":
            np.testing.assert_array_equal(np.asarray(va), vb.numpy(),
                                          err_msg=f)
        else:
            np.testing.assert_allclose(np.asarray(va, np.float64),
                                       vb.double().numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f)


@pytest.mark.parametrize("name", BASELINES)
@pytest.mark.parametrize("scenario", sorted(jscen.SCENARIOS))
def test_baseline_round_matches_repro(scenario, name):
    ep = jeng.generate_episode(jscen.scenario_config(scenario, seed=0,
                                                     **SMALL))
    jr, tr = both_inputs(round_arrays(ep, 0))
    cfg = dict(beta=2.2)
    a = jreg.get_scheduler(name)(jr, jsch.SchedulerConfig(**cfg))
    b = treg.get_scheduler(name)(tr, tsch.SchedulerConfig(**cfg))
    assert_rounds_agree(a, b)


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_paper_round_matches_repro(name):
    """Round 3 of the paper episode (6 x 25 pipelines, K = 2000), with a
    tier weight per analyst (metrics weighted, grant order not)."""
    ep = jeng.generate_episode(jscen.scenario_config("paper_default", seed=0))
    w = np.array([1.0, 2.0, 0.5, 1.0, 3.0, 1.0], np.float32)
    jr, tr = both_inputs(round_arrays(ep, 3, weight=w))
    a = jreg.get_scheduler(name)(jr, jsch.SchedulerConfig())
    b = treg.get_scheduler(name)(tr, tsch.SchedulerConfig())
    assert int(b.n_allocated) > 0
    assert_rounds_agree(a, b)


def test_dpk_key_sums_in_xla_order():
    """DPK sorts by total normalized demand; the port sums it in XLA's
    order, so the keys (and the visit order) are repro's bit for bit."""
    ep = jeng.generate_episode(jscen.scenario_config("paper_default", seed=0))
    d = round_arrays(ep, 3)
    jr, tr = both_inputs(d)
    jg = jdm.normalized_demand(jr.demand, jr.budget_total)
    tg = tdm.normalized_demand(tr.demand, tr.budget_total)
    jk = np.asarray(jbl._dpk_key(jr, jg, None))
    np.testing.assert_array_equal(jk, tbl._dpk_key(tr, tg, None).numpy())
    np.testing.assert_array_equal(jk, tree_sum(tg, -1).numpy())


@pytest.mark.parametrize("K", [1, 31, 32, 33, 100, 1025, 2000, 16384])
def test_tree_sum_matches_xla(K):
    """``fp.tree_sum`` is XLA:CPU's long-axis sum bit for bit, across the
    window boundaries and paddings of the tree reduction rewriter."""
    rng = np.random.default_rng(K)
    x = (rng.uniform(0, 0.1, (5, 7, K)) * (rng.random((5, 7, K)) < 0.5)
         ).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.sum(jnp.asarray(x), -1)),
                                  tree_sum(torch.as_tensor(x), -1).numpy())
    np.testing.assert_array_equal(
        np.asarray(jnp.sum(jnp.asarray(x), 1)),
        tree_sum(torch.as_tensor(x), 1).numpy())


def fig2_inputs():
    """Paper Fig. 2: Alice P1 [0.5, 0.3], P2 [0.3, 0.5]; Bob P3 [0.4, 0.3],
    P4 [0.3, 0.3]; two blocks of budget 1 (``examples/quickstart.py``)."""
    demand = np.zeros((2, 2, 2), np.float32)
    demand[0, 0] = [0.5, 0.3]
    demand[0, 1] = [0.3, 0.5]
    demand[1, 0] = [0.4, 0.3]
    demand[1, 1] = [0.3, 0.3]
    return dict(demand=demand, active=np.ones((2, 2), bool),
                arrival=np.zeros((2, 2), np.float32),
                loss=np.ones((2, 2), np.float32),
                capacity=np.ones(2, np.float32),
                budget_total=np.ones(2, np.float32), now=np.float32(0.0))


@pytest.mark.parametrize("name", treg.SCHEDULER_NAMES)
def test_fig2_toy_all_schedulers_match_repro(name):
    jr, tr = both_inputs(fig2_inputs())
    a = jreg.get_scheduler(name)(jr, jsch.SchedulerConfig(beta=2.2))
    b = treg.get_scheduler(name)(tr, tsch.SchedulerConfig(beta=2.2))
    assert_rounds_agree(a, b)
    sel = b.selected.numpy()
    if name == "dpbalance":     # Alice P1, Bob P3 boosted to 1.25
        assert sel.tolist() == [[True, False], [True, False]]
    else:                       # whole pipelines, x = 1 where granted
        x = b.x_pipeline.numpy()
        assert set(np.unique(x)) <= {0.0, 1.0}
        np.testing.assert_array_equal(x == 1.0, sel)


def test_baselines_grant_no_boost_and_conserve():
    ep = jeng.generate_episode(jscen.scenario_config("paper_default", seed=0))
    _, tr = both_inputs(round_arrays(ep, 5))
    for name in BASELINES:
        res = treg.get_scheduler(name)(tr, tsch.SchedulerConfig())
        assert res.sp1_iters is None and res.swap_cert_ok is None
        assert res.n_allocated.dtype == torch.int32
        assert float(torch.abs(res.x_analyst).max()) == 0.0
        assert float((res.consumed - tr.capacity).max()) <= 1e-6
        assert torch.allclose(res.leftover + res.consumed, tr.capacity,
                              atol=1e-5)


def test_fcfs_ties_keep_index_order():
    """Every pipeline arrives at once: FCFS visits them in index order
    (a stable sort), granting the first ones that fit."""
    d = fig2_inputs()
    d["capacity"] = np.array([0.95, 0.95], np.float32)
    jr, tr = both_inputs(d)
    b = tbl.fcfs_round(tr, tsch.SchedulerConfig())
    # P1 [0.5, 0.3] fits, P2 [0.3, 0.5] fits (0.8, 0.8), then nothing
    assert b.selected.tolist() == [[True, True], [False, False]]
    assert_rounds_agree(jbl.fcfs_round(jr, jsch.SchedulerConfig()), b)


def test_registry_dispatch():
    assert treg.SCHEDULER_NAMES == jreg.SCHEDULER_NAMES
    assert set(treg.SCHEDULERS) == set(jreg.SCHEDULERS)
    assert treg.get_scheduler("dpbalance") is tsch.schedule_round
    for name, fn in (("dpf", tbl.dpf_round), ("dpk", tbl.dpk_round),
                     ("fcfs", tbl.fcfs_round)):
        assert treg.get_scheduler(name) is fn
    _, tr = both_inputs(fig2_inputs())
    for name in treg.SCHEDULER_NAMES:
        a = treg.get_round_fn(name)(tr, tsch.SchedulerConfig())
        b = treg.get_scheduler(name)(tr, tsch.SchedulerConfig())
        assert torch.equal(a.selected, b.selected)


@pytest.mark.parametrize("lookup", ["get_scheduler", "get_round_fn"])
def test_registry_unknown_name_raises(lookup):
    for mod in (jreg, treg):
        with pytest.raises(ValueError, match="unknown scheduler 'fifo'"):
            getattr(mod, lookup)("fifo")


def test_baseline_config_fields_are_repro_fields():
    """Every SchedulerConfig field the port has is repro's, same default
    (the port drops only ``use_pallas``: it dispatches by device)."""
    j = {f.name: f.default for f in dataclasses.fields(jsch.SchedulerConfig)}
    t = {f.name: f.default for f in dataclasses.fields(tsch.SchedulerConfig)}
    assert set(j) - set(t) == {"use_pallas"}
    assert all(j[k] == v for k, v in t.items())
