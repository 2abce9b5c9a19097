"""The lockstep fleet's kernels on the card (Hopper only; skips elsewhere).

Collects without JAX: the card machine runs these with ``--noconftest``.

* ``matvec``, ``matvec_t`` and ``dual_ascent`` over a leading fleet axis,
  one launch each: every episode bitwise a lone launch on its operands
  (lam bitwise and the same SP1 count for the ascent), matvec_t bitwise
  and matvec within 1e-5 of their twins, at the paper's shape and at a
  ragged one whose episodes start off the 16-byte grid;
* ``run_fleet(mode="vmap")`` on the card bitwise ``mode="map"`` for every
  scheduler, and a lockstep dpbalance round launching each budget kernel
  as often as one episode's round, whatever the fleet's size.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SchedulerConfig, make_fleet, run_fleet
from repro_torch.kernels import budget_alloc as ba
from repro_torch.kernels import ref

# (E, M, K): paper, a ragged K whose episodes' rows start off the 16-byte
# grid (M * K % 4 != 0), the large round's M and K
SHAPES = [(4, 6, 2000), (5, 3, 1531), (3, 32, 16384)]
SMALL = dict(n_devices=4, n_analysts=3, pipelines_per_analyst=6, n_rounds=4)
# (scheduler, SP1 warm start): the baselines run no SP1
RUNS = [("dpbalance", False), ("dpbalance", True), ("dpf", False),
        ("dpk", False), ("fcfs", False)]
PER_ROUND = {"rowmax": 1, "matvec": 1, "matvec_t": 2, "dual_step": 1,
             "boost_scan": 2, "swap_eval": 1}


@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _ops(E, M, K, dev, warm):
    """E seeded SP1 operand sets formed as alpha_fair_waterfill forms
    them, stacked: (c, lam, w_pow, xcap, mask int32, cap, cap_safe)."""
    rng = np.random.default_rng(E * 1000 + M)
    c = rng.uniform(0, 0.1, (E, M, K)) * (rng.random((E, M, K)) < 0.5)
    c[:, -1] = 0.0
    c = torch.as_tensor(c.astype(np.float32))
    mu = torch.as_tensor(rng.uniform(0.1, 1.0, (E, M)).astype(np.float32))
    a = torch.as_tensor(rng.uniform(0.3, 1.0, (E, M)).astype(np.float32))
    mask = torch.as_tensor(rng.random((E, M)) > 0.2)
    cap = torch.as_tensor(rng.uniform(0.05, 0.5, (E, K)).astype(np.float32))
    w_pow = torch.where(mask, torch.clamp(mu * a, min=1e-12) ** (1 - 2.2),
                        0.0)
    ratio = torch.where(c > 1e-12, cap[:, None] / torch.clamp(c, min=1e-12),
                        torch.tensor(float("inf")))
    xcap = torch.amin(ratio, dim=-1)
    mask = mask & (torch.amax(c, dim=-1) > 1e-12) & torch.isfinite(xcap)
    xcap = torch.where(mask, xcap, 0.0)
    lam = (torch.as_tensor(rng.uniform(0.5, 2.0, (E, K)).astype(np.float32))
           if warm else torch.ones(E, K))
    ops = (c, lam, w_pow, xcap, mask.to(torch.int32), cap,
           torch.clamp(cap, min=1e-12))
    return tuple(t.to(dev) for t in ops)


@pytest.mark.cuda
@pytest.mark.parametrize("E,M,K", SHAPES)
def test_cuda_batched_matvecs(hopper, E, M, K):
    c, lam = _ops(E, M, K, hopper, False)[:2]
    x = torch.rand(E, M, generator=torch.Generator().manual_seed(K)).to(hopper)
    ba.reset_launches()
    y, load = ba.matvec(c, lam), ba.matvec_t(c, x)
    assert ba.LAUNCHES["matvec"] == ba.LAUNCHES["matvec_t"] == 1
    assert ba.LAST_GRID["matvec"] == (ba.row_split(M, K), E * M)
    torch.testing.assert_close(y, ref.matvec_ref(c, lam), rtol=1e-5,
                               atol=1e-30)
    assert torch.equal(load, ref.matvec_t_ref(c, x))
    for e in range(E):           # a view in place, and fresh copies
        for ce, le, xe in ((c[e], lam[e], x[e]),
                           (c[e].clone(), lam[e].clone(), x[e].clone())):
            assert torch.equal(y[e], ba.matvec(ce, le)), e
            assert torch.equal(load[e], ba.matvec_t(ce, xe)), e


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("E,M,K", SHAPES)
def test_cuda_batched_dual_ascent(hopper, E, M, K, warm):
    ops = _ops(E, M, K, hopper, warm)
    kw = dict(adaptive=warm, max_iters=4000 if M < 32 else 300, tol=1e-6)
    ba.reset_launches()
    lam, iters = ba.dual_ascent(*ops, 2.2, **kw)
    assert ba.LAUNCHES["dual_step"] == 1
    assert lam.shape == (E, K) and iters.shape == (E,)
    assert iters.dtype == torch.int32
    for e in range(E):
        lam1, it1 = ba.dual_ascent(*(t[e] for t in ops), 2.2, **kw)
        assert int(iters[e]) == int(it1), e
        assert torch.equal(lam[e].view(torch.int32), lam1.view(torch.int32))
    assert ba.dual_waves(E, M, K) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name,warm", RUNS)
def test_cuda_run_fleet_vmap_bitwise_map(hopper, name, warm):
    fleet = make_fleet("paper_default", 3, device=hopper, **SMALL)
    cfg = SchedulerConfig(sp1_warm_start=warm)
    ba.reset_launches()
    vm = run_fleet(fleet, cfg, name)                 # "auto": vmap here
    torch.cuda.synchronize()
    per_round = {k: v / SMALL["n_rounds"] for k, v in ba.LAUNCHES.items()
                 if v}
    want = PER_ROUND if name == "dpbalance" else {"rowmax": 1}
    assert per_round == want, per_round
    mp = run_fleet(fleet, cfg, name, mode="map")
    for k in mp:
        assert vm[k].dtype == mp[k].dtype and torch.equal(vm[k], mp[k]), k
