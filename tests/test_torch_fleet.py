"""The port's episode engine for every scheduler, its fleets, scenarios and
the legacy simulator, against ``repro`` on the CPU.

Episodes come from the same ``SimConfig`` (small geometry: 4 devices,
3 analysts x 6 pipelines, 4 rounds).  Discrete outputs (``n_allocated``,
selections, ``final_done``) must be equal; continuous ones within rtol
1e-5 / atol 1e-5 (``repro``'s own engine-vs-legacy bound).  Warm SP1
iteration counts are compared where they are not pinned near-ties
(``test_torch_engine.py``, ROADMAP Queue 3).
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
from repro_torch.core import scenarios as tscen
from repro_torch.core import scheduler as tsch
from repro_torch.core import simulation as tsim
from repro_torch.launch import sweep

SMALL = dict(n_devices=4, n_analysts=3, pipelines_per_analyst=6, n_rounds=4)
NAMES = ("dpbalance", "dpf", "dpk", "fcfs")
DISCRETE = ("n_allocated", "final_done")
CONTINUOUS = ("round_efficiency", "round_fairness", "round_fairness_norm",
              "round_jain", "leftover", "cumulative_efficiency",
              "cumulative_fairness", "cumulative_fairness_norm",
              "final_capacity")
DIAG_DISCRETE = ("analyst_mask", "selected")
DIAG_CONTINUOUS = ("utility", "a_i", "gamma_i", "mu_i", "x_analyst",
                   "sp1_violation", "granted_i", "cap_frac")
RESULT_KEYS = jsim._RESULT_KEYS
# warm dpbalance SP1 iterations per round (repro, port) where the stop
# rule sits on its float32 noise floor (ROADMAP Queue 3), by (scenario,
# seed) at SMALL; the paper_default ones are the first-round 37/36 of
# test_torch_scheduler.py and seed 1's round 1 of test_torch_engine.py
NEAR_TIE_WARM_ITERS = {("elephant_storm", 3): ([15, 301, 14, 12],
                                               [15, 291, 14, 12]),
                       ("paper_default", 0): ([37, 14, 12, 12],
                                              [36, 14, 12, 12]),
                       ("paper_default", 1): ([13, 35, 14, 12],
                                              [13, 36, 14, 12])}


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-5,
                               atol=1e-5, err_msg=what)


def assert_episodes_agree(a, b, keys_d=DISCRETE, keys_c=CONTINUOUS):
    for k in keys_d:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy(),
                                      err_msg=k)
    for k in keys_c:
        close(a[k], b[k].numpy(), k)


def sim_pair(name, seed, **kw):
    cfg = jscen.scenario_config(name, seed=seed, **kw)
    return cfg, tsim.SimConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_run_episode_every_scheduler(name, warm):
    case = ("elephant_storm", 3)
    jcfg, tcfg = sim_pair(*case, **SMALL)
    cfg = dict(beta=2.2, sp1_warm_start=warm)
    a = jeng.run_episode(jeng.generate_episode(jcfg),
                         jsch.SchedulerConfig(**cfg), name)
    b = teng.run_episode(teng.generate_episode(tcfg, device="cpu"),
                         tsch.SchedulerConfig(**cfg), name)
    assert_episodes_agree(a, b)
    assert b["sp1_iters"].dtype == torch.int32
    if name != "dpbalance":     # no SP1: zero iterations, duals untouched
        assert b["sp1_iters"].tolist() == [0] * tcfg.n_rounds
    if warm:
        ja, tb = np.asarray(a["sp1_iters"]).tolist(), b["sp1_iters"].tolist()
        if name == "dpbalance" and case in NEAR_TIE_WARM_ITERS:
            assert (ja, tb) == NEAR_TIE_WARM_ITERS[case]
        else:
            assert ja == tb


@pytest.mark.parametrize("name", NAMES)
def test_run_episode_diagnostics(name):
    jcfg, tcfg = sim_pair("bursty_arrivals", 0, **SMALL)
    a = jeng.run_episode(jeng.generate_episode(jcfg),
                         jsch.SchedulerConfig(), name, diagnostics=True)
    b = teng.run_episode(teng.generate_episode(tcfg, device="cpu"),
                         tsch.SchedulerConfig(), name, diagnostics=True)
    R, (M, N) = tcfg.n_rounds, (tcfg.n_analysts, tcfg.pipelines_per_analyst)
    assert b["granted_i"].shape == (R, M, b["final_capacity"].shape[0])
    assert b["selected"].shape == (R, M, N)
    assert_episodes_agree(a, b, DISCRETE + DIAG_DISCRETE,
                          CONTINUOUS + DIAG_CONTINUOUS)
    # the diagnostics leave the metrics of a plain run unchanged
    plain = teng.run_episode(teng.generate_episode(tcfg, device="cpu"),
                             tsch.SchedulerConfig(), name)
    for k in plain:
        assert torch.equal(plain[k], b[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_run_fleet_matches_run_episode_and_repro(name):
    seeds = (0, 1)
    jcfgs = [jscen.scenario_config("tight_budgets", seed=s, **SMALL)
             for s in seeds]
    tfleet = tscen.make_fleet("tight_budgets", len(seeds), device="cpu",
                              **SMALL)
    out = teng.run_fleet(tfleet, tsch.SchedulerConfig(), name)
    jout = jeng.run_fleet(jscen.make_fleet("tight_budgets", len(seeds),
                                           **SMALL),
                          jsch.SchedulerConfig(), name, mode="map")
    assert_episodes_agree(jout, out)
    for e, jc in enumerate(jcfgs):
        one = teng.run_episode(
            teng.generate_episode(tsim.SimConfig(**dataclasses.asdict(jc)),
                                  device="cpu"),
            tsch.SchedulerConfig(), name)
        for k, v in one.items():
            assert torch.equal(out[k][e], v), (k, e)


def test_scenario_grid_and_fleet_arrays_equal_repro():
    names = ["paper_default", "local_analysts"]
    j = jscen.make_scenario_grid(names, 2, base_seed=5, **SMALL)
    t = tscen.make_scenario_grid(names, 2, base_seed=5, device="cpu",
                                 **SMALL)
    for f in teng._FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=f)
    assert t.demand.shape[0] == 4 and t.n_rounds == j.n_rounds
    out = teng.run_fleet(t, tsch.SchedulerConfig(), "dpf", diagnostics=True)
    assert out["gamma_i"].shape[:2] == (4, SMALL["n_rounds"])


def test_stack_episodes_errors():
    with pytest.raises(ValueError, match="at least one"):
        teng.stack_episodes([])
    a = teng.generate_episode(tsim.SimConfig(seed=0, **SMALL), device="cpu")
    b = teng.generate_episode(
        tsim.SimConfig(seed=0, **dict(SMALL, n_rounds=3)),
        device="cpu")
    with pytest.raises(ValueError, match="n_rounds"):
        teng.stack_episodes([a, b])
    s = teng.stack_episodes([a, a])
    assert s.demand.shape == (2,) + tuple(a.demand.shape)


def test_resolve_fleet_mode():
    """``repro``'s table by the fleet's device: ``"auto"`` is ``"map"`` on
    the CPU and ``"vmap"`` on an accelerator; ``"vmap"`` runs."""
    assert teng._FLEET_MODE_DEFAULT == jeng._FLEET_MODE_DEFAULT
    assert teng._FLEET_MODE_FALLBACK == jeng._FLEET_MODE_FALLBACK
    assert teng.resolve_fleet_mode("auto", "cpu") == \
        jeng.resolve_fleet_mode("auto") == "map"
    assert teng.resolve_fleet_mode("auto", "cuda") == "vmap"
    assert teng.resolve_fleet_mode("auto", torch.device("cuda", 0)) == "vmap"
    assert teng.resolve_fleet_mode() == "vmap"          # the port's default
    for mode in ("map", "vmap"):
        for dev in ("cpu", "cuda"):
            assert teng.resolve_fleet_mode(mode, dev) == mode
    with pytest.raises(ValueError, match="unknown fleet mode"):
        teng.resolve_fleet_mode("pmap")
    fleet = tscen.make_fleet("paper_default", 1, device="cpu", **SMALL)
    out = teng.run_fleet(fleet, tsch.SchedulerConfig(), "dpf", mode="vmap")
    assert out["n_allocated"].shape == (1, SMALL["n_rounds"])


def test_scenarios_equal_repro():
    assert list(tscen.SCENARIOS) == list(jscen.SCENARIOS)
    assert len(tscen.SCENARIOS) == 9
    for name, s in jscen.SCENARIOS.items():
        t = tscen.get_scenario(name)
        assert (t.name, t.description, t.overrides) == \
            (s.name, s.description, s.overrides)
        assert dataclasses.asdict(tscen.scenario_config(name, seed=4)) == \
            dataclasses.asdict(jscen.scenario_config(name, seed=4))
    with pytest.raises(ValueError, match="unknown scenario"):
        tscen.get_scenario("nope")


def test_flaas_simulator_round_inputs_equal_repro():
    jcfg, tcfg = sim_pair("analyst_churn", 2, **SMALL)
    js, ts = jsim.FlaasSimulator(jcfg), tsim.FlaasSimulator(tcfg,
                                                            device="cpu")
    for _ in range(tcfg.n_rounds):
        for s in (js, ts):
            s._grow_blocks()
            s._spawn_pipelines()
        jr, tr = js.round_inputs(), ts.round_inputs()
        for f in ("demand", "active", "arrival", "loss", "capacity",
                  "budget_total", "now"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                          getattr(tr, f).numpy(),
                                          err_msg=f)
        res = tsch.schedule_round(tr, tsch.SchedulerConfig())
        js.apply(jsch.schedule_round(jr, jsch.SchedulerConfig()))
        ts.apply(res)
        for s in (js, ts):
            s.step_time()


@pytest.mark.parametrize("name", NAMES)
def test_run_simulation_legacy_matches_repro_and_engine(name):
    jcfg, tcfg = sim_pair("paper_default", 1, **SMALL)
    cfg = dict(beta=2.2)
    legacy = tsim.run_simulation(name, tcfg, tsch.SchedulerConfig(**cfg),
                                 engine=False, device="cpu")
    engine = tsim.run_simulation(name, tcfg, tsch.SchedulerConfig(**cfg),
                                 device="cpu")
    ref = jsim.run_simulation(name, jcfg, jsch.SchedulerConfig(**cfg),
                              engine=False)
    assert set(legacy) == set(engine) == set(RESULT_KEYS)
    for other in (engine, ref):
        np.testing.assert_array_equal(legacy["n_allocated"],
                                      np.asarray(other["n_allocated"]))
        for k in RESULT_KEYS:
            close(other[k], legacy[k], k)


def test_simulator_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tsim.FlaasSimulator(tsim.SimConfig())
    with pytest.raises(RuntimeError):
        tsim.run_simulation("dpf", tsim.SimConfig(**SMALL),
                            tsch.SchedulerConfig())


def test_sweep_launcher_smoke_on_cpu(capsys):
    res = sweep.main(["--device", "cpu", "--smoke"])
    printed = capsys.readouterr().out
    assert "=== paper_default: 2 seeds, M=3 N=6 K=32 R=4 on cpu" in printed
    rows = res["paper_default"]
    assert list(rows) == list(NAMES)
    fleet = tscen.make_fleet("paper_default", sweep.SMOKE_SEEDS,
                             device="cpu", **sweep.SMOKE)
    for name in NAMES:
        assert f"\n{name:<10} " in printed
        out = teng.run_fleet(fleet, tsch.SchedulerConfig(), name)
        for k in ("cumulative_efficiency", "n_allocated"):
            assert torch.equal(rows[name]["out"][k], out[k]), (name, k)
