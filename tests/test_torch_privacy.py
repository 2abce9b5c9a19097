"""Privacy accounting: the port's ``privacy/`` against ``repro``'s.

``repro`` computes RDP in jnp with JAX's default float32; the port
repeats that rounding in numpy.  Contracts: ``gaussian_rdp``,
``subsampled_gaussian_rdp``, ``sigma_for_rdp_budget`` /
``sigma_for_grant`` and the accountant's float64 ledger are bitwise equal;
``rdp_to_dp`` and ``certify`` (a float32 ``log``) hold to 1e-6 relative,
with the certified order equal.  The block ledger is host Python, copied:
its state after the same operations is equal.
"""
import numpy as np
import pytest

from repro_torch.privacy import BlockLedger, RdpAccountant
from repro_torch.privacy import rdp

jrdp = pytest.importorskip("repro.privacy.rdp")
from repro.privacy import BlockLedger as JLedger  # noqa: E402
from repro.privacy import RdpAccountant as JAccountant  # noqa: E402

SIGMAS = np.random.default_rng(0).uniform(0.3, 40.0, 64)


@pytest.mark.parametrize("q", [None, 0.01, 0.2, 0.5])
def test_rdp_costs_bitwise(q):
    for s in SIGMAS:
        if q is None:
            want = jrdp.gaussian_rdp(s, jrdp.DEFAULT_ORDERS)
            got = rdp.gaussian_rdp(s, rdp.DEFAULT_ORDERS)
        else:
            want = jrdp.subsampled_gaussian_rdp(s, q, jrdp.DEFAULT_ORDERS)
            got = rdp.subsampled_gaussian_rdp(s, q, rdp.DEFAULT_ORDERS)
        assert got.dtype == np.float32
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("steps", [1, 3, 300])
def test_sigma_for_grant_bitwise(steps):
    eps = np.random.default_rng(steps).uniform(1e-4, 2.0, 200)
    ja, ta = JAccountant(alpha_star=8.0), RdpAccountant(alpha_star=8.0)
    for e in list(eps) + [0.0, 1e-13]:
        assert ta.sigma_for_grant(e, steps) == ja.sigma_for_grant(e, steps)
        assert float(rdp.sigma_for_rdp_budget(e, 8.0, steps)) == \
            float(jrdp.sigma_for_rdp_budget(e, 8.0, steps))


def test_accountant_ledger_and_certificate():
    ja, ta = JAccountant(alpha_star=8.0), RdpAccountant(alpha_star=8.0)
    for s in SIGMAS[:20]:
        ja.record_step(float(s))
        ta.record_step(float(s))
        ja.record_step(float(s), 0.1)
        ta.record_step(float(s), 0.1)
        assert ta.step_cost(float(s)) == ja.step_cost(float(s))
        assert ta.step_cost(float(s), 0.1) == ja.step_cost(float(s), 0.1)
    assert np.array_equal(ta._ledger, ja._ledger)
    assert ta.spent_at_alpha_star == ja.spent_at_alpha_star
    for delta in (1e-5, 1e-8):
        (te, ta_), (je, ja_) = ta.certify(delta), ja.certify(delta)
        assert ta_ == ja_
        assert abs(te - je) <= 1e-6 * abs(je)


def test_rdp_to_dp_within_float32_log():
    eps = np.random.default_rng(1).uniform(0.0, 50.0, 18)
    for delta in (1e-5, 1e-3):
        got = rdp.rdp_to_dp(eps, rdp.DEFAULT_ORDERS, delta)
        want = np.asarray(jrdp.rdp_to_dp(eps, jrdp.DEFAULT_ORDERS, delta))
        assert np.allclose(got, want, rtol=1e-6, atol=0)


def test_block_ledger_matches_repro():
    rng = np.random.default_rng(2)
    jl, tl = JLedger(), BlockLedger()
    for rnd in range(6):
        for d in range(4):
            b = float(rng.uniform(1.0, 1.5))
            assert jl.create_block(d, b, rnd * 10.0) == \
                tl.create_block(d, b, rnd * 10.0)
        live = tl.live_blocks()
        assert live == jl.live_blocks()
        cap = tl.capacity_vector(range(len(tl)))
        assert np.array_equal(cap, jl.capacity_vector(range(len(jl))))
        grants = (cap * rng.uniform(0.0, 1.0, cap.shape)
                  * (rng.random(cap.shape) < 0.6)).astype(np.float32)
        grants[live[:1]] = cap[live[:1]]                # retire one block
        jl.debit_grants(np.arange(len(cap)), grants)
        tl.debit_grants(np.arange(len(cap)), grants)
    assert np.array_equal(tl.budget_vector(range(len(tl))),
                          jl.budget_vector(range(len(jl))))
    for d in range(4):
        assert tl.device_loss(d) == jl.device_loss(d)
    with pytest.raises(ValueError):
        tl.consume(tl.live_blocks()[0], 10.0)           # overdraw refused
