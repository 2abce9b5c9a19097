"""Port episode engine against ``repro`` on the CPU.

``generate_episode`` must reproduce ``repro``'s arrays exactly (same numpy
RNG call order); ``run_episode`` must give the same per-round discrete
results and continuous metrics within rtol 1e-5 / atol 1e-5 (``repro``'s
own engine-vs-legacy bound).  Warm-started SP1 iteration counts may differ
where the stop rule sits on its float32 noise floor (see
``test_torch_scheduler.py``); those rounds are listed with both counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import scenarios as jscen
from repro.core import scheduler as jsch
from repro.core import simulation as jsim
from repro_torch.core import engine as teng
from repro_torch.core import scheduler as tsch
from repro_torch.core.blockaxis import BlockAxis
from repro_torch.core.demand import RoundInputs
from repro_torch.core.registry import get_round_fn
from repro_torch.core import simulation as tsim

SMALL = dict(n_devices=4, n_analysts=3, pipelines_per_analyst=6, n_rounds=4)
FIELDS = ("demand", "loss", "arrival", "spawn_round", "block_budget",
          "block_round")
DISCRETE = ("n_allocated", "final_done")
CONTINUOUS = ("round_efficiency", "round_fairness", "round_fairness_norm",
              "round_jain", "leftover", "cumulative_efficiency",
              "cumulative_fairness", "cumulative_fairness_norm",
              "final_capacity")
# (scenario, seed) -> per-round (repro, port) SP1 iterations, warm start
NEAR_TIE_WARM_ITERS = {
    ("paper_default", 1): ([13, 35, 14, 12], [13, 36, 14, 12]),
    ("bursty_arrivals", 2): ([32, 13, 12, 12], [31, 13, 12, 12]),
}


def _sim_pair(name, seed, **kw):
    cfg = jscen.scenario_config(name, seed=seed, **kw)
    return cfg, tsim.SimConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", sorted(jscen.SCENARIOS))
def test_generate_episode_arrays_equal(name):
    jcfg, tcfg = _sim_pair(name, seed=7, **SMALL)
    a = jeng.generate_episode(jcfg)
    b = teng.generate_episode(tcfg, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy(), err_msg=f)
    assert a.n_rounds == b.n_rounds


def test_generate_episode_paper_size_equal():
    a = jeng.generate_episode(jsim.SimConfig(seed=0))
    b = teng.generate_episode(tsim.SimConfig(seed=0), device="cpu")
    assert b.demand.shape == (6, 25, 2000)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f).numpy(), err_msg=f)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("name,seed", [("paper_default", 1),
                                       ("bursty_arrivals", 2),
                                       ("tight_budgets", 3)])
def test_run_episode_matches_repro(name, seed, warm):
    jcfg, tcfg = _sim_pair(name, seed, **SMALL)
    a = jeng.run_episode(jeng.generate_episode(jcfg),
                         jsch.SchedulerConfig(sp1_warm_start=warm))
    b = teng.run_episode(teng.generate_episode(tcfg, device="cpu"),
                         tsch.SchedulerConfig(sp1_warm_start=warm))
    for k in DISCRETE:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy(),
                                      err_msg=k)
    for k in CONTINUOUS:
        np.testing.assert_allclose(np.asarray(a[k], np.float64),
                                   b[k].double().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert float(b["conservation_gap"].max()) <= 1e-4
    assert float(b["overdraw"].max()) <= 1e-4
    # the port also reports per-round selections; they add up to the counts
    assert b["selected"].sum(dim=(1, 2)).tolist() == b["n_allocated"].tolist()
    if warm:
        ja, tb = np.asarray(a["sp1_iters"]).tolist(), b["sp1_iters"].tolist()
        if (name, seed) in NEAR_TIE_WARM_ITERS:
            assert (ja, tb) == NEAR_TIE_WARM_ITERS[(name, seed)]
        else:
            assert ja == tb


def test_validate_raises_on_overdraw():
    out = {"conservation_gap": torch.zeros(3),
           "overdraw": torch.tensor([0.0, 2e-4, 0.0])}
    with pytest.raises(AssertionError):
        teng.check_conservation(out, "dpbalance")
    teng.check_conservation({"conservation_gap": torch.zeros(3),
                             "overdraw": torch.zeros(3)}, "dpbalance")


def test_outside_the_slice_raises():
    """Every scheduler, the diagnostics and both fleet modes run in the
    port now (``test_torch_fleet.py``, ``test_torch_fleet_vmap.py``); a
    fleet on a sharded block axis is outside it (``repro`` runs no
    sharded fleet), and an unknown scheduler is an error."""
    ep = teng.generate_episode(tsim.SimConfig(seed=0, **SMALL), device="cpu")
    fleet = teng.stack_episodes([ep, ep])
    rnd = RoundInputs(
        demand=fleet.demand, active=torch.ones(fleet.loss.shape, dtype=bool),
        arrival=fleet.arrival, loss=fleet.loss,
        capacity=fleet.block_budget, budget_total=fleet.block_budget,
        now=torch.tensor(0.0))
    for name in ("dpbalance", "dpf"):
        with pytest.raises(NotImplementedError, match="sharded"):
            get_round_fn(name)(rnd, tsch.SchedulerConfig(),
                               BlockAxis("shard"))
    with pytest.raises(ValueError):
        teng.run_episode(ep, tsch.SchedulerConfig(), "fifo")
