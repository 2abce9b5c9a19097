"""The RG-LRU scan: the port's twin against ``repro``'s oracle and Pallas
kernel (interpret mode) on the CPU, its gradient, the dispatch rule, and
(on a Hopper card only) the CUDA kernel against the twin.

Inputs are seeded numpy arrays: decays a in [0.5, 0.999), inputs b and
h0 standard normal.  Every comparison of values is bitwise: the twin runs
the recurrence in time order with one correctly rounded FMA per step,
which is what ``repro``'s ``lax.scan`` oracle, its Pallas kernel and the
CUDA kernel's ``__fmaf_rn`` compute.  The gradient has no bitwise
reference; it is held to rtol = atol = 1e-5 against ``jax.grad``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import rg_lru

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_side():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as jref
    from repro.kernels.rg_lru import rglru_scan
    from repro.models import recurrent as JR
    return jax, jref, rglru_scan, JR


@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _abh(B, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 0.999, (B, S, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("S", [1, 37, 256])
@pytest.mark.parametrize("D", [32, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_twin_is_bitwise_repro_oracle(jax_side, S, D, with_h0):
    _, jref, _, _ = jax_side
    a, b, h0 = _abh(2, S, D, seed=S + D)
    h0 = h0 if with_h0 else None
    got = ref.rglru_scan_ref(*_t(a, b, h0)).numpy()
    want = np.asarray(jref.rglru_scan_ref(a, b, h0))
    assert got.dtype == np.float32 and got.shape == (2, S, D)
    assert np.array_equal(got, want)


# (B, S, D, block_s, block_d): repro's tests/test_kernels.py shapes
@pytest.mark.parametrize("B,S,D,bs,bd", [(1, 32, 16, 8, 16),
                                         (2, 64, 32, 16, 16),
                                         (2, 128, 64, 32, 32)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_twin_is_bitwise_pallas_kernel(jax_side, B, S, D, bs, bd, with_h0):
    _, _, rglru_scan, _ = jax_side
    a, b, h0 = _abh(B, S, D, seed=S)
    h0 = h0 if with_h0 else None
    got = ref.rglru_scan_ref(*_t(a, b, h0)).numpy()
    want = np.asarray(rglru_scan(a, b, h0, block_s=bs, block_d=bd,
                                 interpret=True))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("with_h0", [False, True])
def test_twin_gradient_matches_jax_grad(jax_side, with_h0):
    """The CPU autograd path (the recurrence run in reverse) against
    ``jax.grad`` of ``repro``'s ``linear_scan`` for a weighted sum."""
    jax, _, _, JR = jax_side
    a, b, h0 = _abh(2, 19, 24, seed=3)
    h0 = h0 if with_h0 else None
    w = np.random.default_rng(4).standard_normal((2, 19, 24)).astype(
        np.float32)

    def jloss(a, b, h0):
        return (JR.linear_scan(a, b, h0) * w).sum()
    argn = (0, 1, 2) if with_h0 else (0, 1)
    want = jax.grad(jloss, argnums=argn)(a, b, h0)
    ta, tb, th = (None if x is None else x.requires_grad_()
                  for x in _t(a, b, h0))
    (rg_lru.rglru_scan(ta, tb, th) * torch.from_numpy(w)).sum().backward()
    got = (ta.grad, tb.grad) + ((th.grad,) if with_h0 else ())
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **GRAD_TOL)


def _count_calls(monkeypatch):
    calls, twin = [], ref.rglru_scan_ref
    monkeypatch.setattr(ref, "rglru_scan_ref",
                        lambda *a, **kw: calls.append(1) or twin(*a, **kw))
    return calls


def test_dispatch_runs_the_twin_on_the_cpu(monkeypatch):
    a, b, h0 = _t(*_abh(3, 9, 40, seed=5))
    want = ref.rglru_scan_ref(a, b, h0)
    calls = _count_calls(monkeypatch)
    rg_lru.reset_launches()
    for got in (rg_lru.rglru_scan(a, b, h0),
                rg_lru.rglru_scan(a.requires_grad_(), b, h0).detach()):
        assert torch.equal(got, want)
    assert rg_lru.LAUNCHES == {"rglru_scan": 0}
    assert len(calls) == 2
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_cuda(a.detach(), b, h0)      # no kernel for the CPU


def test_no_backward_off_the_cpu():
    """A tensor that is not on the CPU and needs a gradient raises before
    any launch (meta tensors stand in for the card's here); without one
    it goes to the launcher, which takes CUDA tensors only."""
    a = torch.empty((1, 4, 8), device="meta", requires_grad=True)
    b = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(NotImplementedError):
        rg_lru.rglru_scan(a, b)
    with torch.no_grad(), pytest.raises(ValueError):
        rg_lru.rglru_scan(a, b)


# ------------------------------------------------------------ on the card
# (B, S, D, with h0): ragged S and D against the kernel's 16-step and
# 64-channel tiling, the decode shape (S = 1), the serve's widths
CARD_SCAN = [(3, 1000, 2560 + 37, True), (2, 37, 100, False),
             (4, 1, 2560, True), (1, 1, 7, False), (4, 32, 2560, False),
             (2, 17, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,D,with_h0", CARD_SCAN)
def test_cuda_scan_is_bitwise_the_twin(hopper, B, S, D, with_h0):
    a, b, h0 = (None if x is None else x.to(hopper)
                for x in _t(*_abh(B, S, D, seed=S)))
    h0 = h0 if with_h0 else None
    rg_lru.reset_launches()
    got = rg_lru.rglru_scan(a, b, h0)
    again = rg_lru.rglru_scan_cuda(a, b, h0)
    want = ref.rglru_scan_ref(a, b, h0)
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    assert rg_lru.LAUNCHES == {"rglru_scan": 2}


@pytest.mark.cuda
def test_cuda_scan_rejects_what_the_kernel_does_not_take(hopper):
    a, b, h0 = (x.to(hopper) for x in _t(*_abh(2, 8, 16)))
    with pytest.raises(TypeError):
        rg_lru.rglru_scan_cuda(a.double(), b, h0)
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_cuda(a.transpose(1, 2), b, h0)  # not contiguous
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_cuda(a, b, h0.cpu())            # mixed devices
    with pytest.raises(ValueError):
        rg_lru.rglru_scan_cuda(a, b, h0[:1])              # wrong h0 shape
    with pytest.raises(NotImplementedError):
        rg_lru.rglru_scan(a.requires_grad_(), b, h0)      # no backward
