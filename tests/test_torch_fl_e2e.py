"""The whole slice: the port's end-to-end FL loop
(``repro_torch.launch.fl_e2e.run``) against the same loop written with
``repro``'s functions (``examples/train_fl_e2e.py`` without checkpoints),
on ``reduced(flaas-100m)`` with 4 devices, 2 analysts x 2 pipelines and 4
rounds, on the CPU.

Both start from ``repro``'s initial parameters (the port's ``make_state``
is replaced, in this test only, by ``params_from_jax`` of ``repro``'s) and
both have their DP noise replaced by zeros, in this test only: the two
frameworks draw different Gaussian numbers from the same seed.

Equal: every round's demand tensor, the capacities the scheduler sees,
selections, ``n_allocated``, grants and sigmas, and every accountant's
ledger.  Within one float32 ulp of the debit: the block ledger after the
last round's debit (``schedule_round``'s ``consumed`` sums four grants in
another order than XLA does at this shape; ROADMAP Queue 3).  Within 1e-5 relative:
every pipeline's loss after every round (float32 training in two
frameworks; measured gaps ~1e-7).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.launch import fl_e2e
from repro_torch.models import params_from_jax
from repro_torch.training import fedavg as tfedavg

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.core import (RoundInputs, SchedulerConfig,  # noqa: E402
                        schedule_round)
from repro.data.blocks import DeviceDataset  # noqa: E402
from repro.models import init_model as jinit  # noqa: E402
from repro.privacy import BlockLedger, RdpAccountant  # noqa: E402
from repro.training import FedAvgConfig, fl_round, make_loss_fn  # noqa: E402
from repro.training import fedavg as jfedavg  # noqa: E402

ROUNDS, DEVICES, ANALYSTS, PIPES, SEQ = 4, 4, 2, 2, 16


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


def _jax_params(seed, cfg):
    return jax.device_get(jinit(jax.random.PRNGKey(seed), cfg,
                                dtype=jnp.float32))


def _repro_loop(cfg):
    """``examples/train_fl_e2e.py``'s loop with ``repro``'s functions;
    returns per-round ``(demand, selected, n_allocated, the capacities
    the scheduler saw, [(pipeline, grant, sigma)], {pipeline: loss})``
    and the pipelines, ledger last."""
    ledger = BlockLedger()
    datasets = {d: DeviceDataset(d, tokens_per_block=4 * SEQ,
                                 vocab=cfg.vocab) for d in range(DEVICES)}
    rng = np.random.default_rng(0)
    loss_fn = make_loss_fn(cfg)
    pipes = {(i, j): {"params": _jax_params(17 * i + j, cfg),
                      "acc": RdpAccountant(alpha_star=8.0)}
             for i in range(ANALYSTS) for j in range(PIPES)}
    out, now = [], 0.0
    for rnd in range(ROUNDS):
        for d in range(DEVICES):
            datasets[d].add_block(ledger.create_block(
                d, float(rng.uniform(1.0, 1.5)), now))
        live = ledger.live_blocks()
        K = len(ledger)
        demand = np.zeros((ANALYSTS, PIPES, K), np.float32)
        active = np.ones((ANALYSTS, PIPES), bool)
        for (i, j) in pipes:
            eps = float(rng.uniform(0.095, 0.105))
            for bid in live[-DEVICES:]:
                demand[i, j, bid] = eps
        rinp = RoundInputs(
            demand=jnp.asarray(demand), active=jnp.asarray(active),
            arrival=jnp.full((ANALYSTS, PIPES), now, jnp.float32),
            loss=jnp.ones((ANALYSTS, PIPES), jnp.float32),
            capacity=jnp.asarray(ledger.capacity_vector(range(K))),
            budget_total=jnp.asarray(ledger.budget_vector(range(K))),
            now=jnp.asarray(now, jnp.float32))
        capacity = ledger.capacity_vector(range(K))
        res = schedule_round(rinp, SchedulerConfig(beta=2.2))
        ledger.debit_grants(np.arange(K), np.asarray(res.consumed))
        sel = np.asarray(res.selected)
        granted, losses = [], {}
        for (i, j), p in pipes.items():
            if not sel[i, j]:
                continue
            grant = float(np.asarray(res.grants[i, j]).max())
            sigma = p["acc"].sigma_for_grant(grant, 1)
            granted.append(((i, j), grant, sigma))

            def loader(dev):
                def load():
                    t = datasets[dev].sample(datasets[dev].block_ids[-3:],
                                             SEQ + 1, 2, seed=rnd)
                    return [{"tokens": jnp.asarray(t[:, :-1]),
                             "labels": jnp.asarray(t[:, 1:])}]
                return load
            data = {d: loader(d) for d in range(DEVICES)}
            p["params"], _ = fl_round(
                p["params"], loss_fn, data, list(range(DEVICES)),
                FedAvgConfig(**fl_e2e.FEDAVG, seed=rnd), accountant=p["acc"],
                sigma=sigma, round_idx=rnd)
            losses[(i, j)] = float(loss_fn(p["params"], data[0]()[0]))
        out.append((demand, sel, int(res.n_allocated), capacity, granted,
                    losses))
        now += 10.0
    return out, pipes, ledger


@pytest.fixture
def no_noise(monkeypatch):
    monkeypatch.setattr(jfedavg, "add_noise", lambda tree, key, std: tree)
    monkeypatch.setattr(tfedavg, "add_noise", lambda tree, gen, std: tree)


def test_e2e_matches_repro_loop(monkeypatch, no_noise):
    cfg = reduced(get_arch("flaas-100m"))
    want, jpipes, jledger = _repro_loop(cfg)

    monkeypatch.setattr(fl_e2e, "make_state", lambda seed, c, tcfg, device: {
        "params": params_from_jax(_jax_params(seed, c), c, device=device)})
    seen = []                     # (demand, capacity) the scheduler got
    real_schedule = fl_e2e.schedule_round

    def spy(rinp, scfg):
        seen.append((rinp.demand.numpy().copy(), rinp.capacity.numpy().copy()))
        return real_schedule(rinp, scfg)
    monkeypatch.setattr(fl_e2e, "schedule_round", spy)
    got = fl_e2e.run(rounds=ROUNDS, devices=DEVICES, analysts=ANALYSTS,
                     pipes=PIPES, small=True, seq=SEQ, device="cpu")
    assert len(got["records"]) == ROUNDS
    for rnd, (rec, w) in enumerate(zip(got["records"], want)):
        demand, sel, n_alloc, capacity, granted, _ = w
        assert np.array_equal(seen[rnd][0], demand)
        assert np.array_equal(seen[rnd][1], capacity)
        assert rec["selected"] == [[i, j] for i, j in zip(*np.nonzero(sel))]
        assert rec["allocated"] == n_alloc
        assert [(tuple(g["pipeline"]), g["grant"], g["sigma"])
                for g in rec["granted"]] == granted
    # after the last debit: within one float32 ulp of the debit (consumed
    # ~0.8, ulp 6e-8; the scheduler's ``consumed`` sum is a float near-tie
    # at M=N=2, ROADMAP Queue 3)
    ledger = got["ledger"]
    np.testing.assert_allclose(ledger.capacity_vector(range(len(ledger))),
                               jledger.capacity_vector(range(len(jledger))),
                               rtol=0, atol=2.0 ** -24)
    for key, p in got["pipelines"].items():
        wl = [w[5][key] for w in want if key in w[5]]
        assert len(p["losses"]) == len(wl)
        for a, b in zip(p["losses"], wl):
            assert abs(a - b) <= 1e-5 * abs(b)
        assert np.array_equal(p["acc"]._ledger, jpipes[key]["acc"]._ledger)


def test_e2e_small_runs_with_noise_and_holds_its_invariants():
    seen = []
    out = fl_e2e.run(rounds=2, devices=4, analysts=1, pipes=2, small=True,
                     seq=8, device="cpu", log=seen.append)
    assert [r["round"] for r in seen] == [0, 1]
    ledger = out["ledger"]
    for b in range(len(ledger)):
        blk = ledger.block(b)
        assert blk.consumed <= blk.budget + 1e-6
    for r in out["records"]:
        assert math.isfinite(r["mean_pipeline_loss"])
        for g in r["granted"]:
            acc = out["pipelines"][tuple(g["pipeline"])]["acc"]
            assert g["sigma"] == acc.sigma_for_grant(g["grant"], 1)
    eps, _ = out["pipelines"][(0, 0)]["acc"].certify(1e-5)
    assert math.isfinite(eps)


def test_scheduler_only_run_grants_what_the_training_run_grants():
    kw = dict(rounds=3, devices=4, analysts=2, pipes=2, small=True, seq=8,
              device="cpu")
    full, dry = fl_e2e.run(**kw), fl_e2e.run(**kw, train=False)
    for a, b in zip(full["records"], dry["records"]):
        assert a["selected"] == b["selected"]
        assert a["granted"] == b["granted"]
    assert np.array_equal(full["pipelines"][(1, 1)]["acc"]._ledger,
                          dry["pipelines"][(1, 1)]["acc"]._ledger)
    assert torch.isnan(torch.tensor(dry["records"][0]["mean_pipeline_loss"]))
