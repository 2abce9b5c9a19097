"""SP1's dual ascent as one call: the twin's loop (``ref.dual_ascent_ref``)
on the CPU, and (on a Hopper card only) the ``dual_step`` kernel's ascent
mode against the per-iteration loop over its step mode.

On the CPU: the twin equals hand-written iterations of ``dual_step_ref``
and the update bit for bit, freezes lam and the count once the stop rule
fires, and the kernel's float32 step size ``0.5 / fma(0.001, it, 1)``
equals the host's rounding for every iteration SP1 can run.  Against
``repro``: ``alpha_fair_waterfill`` makes exactly one ``dual_ascent`` call
and matches ``repro``'s solve as ``test_torch_scheduler.py`` holds it.
On the card: iteration counts equal and lam bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hotpath
from repro_torch.core import waterfill as twf
from repro_torch.fp import fma_exact
from repro_torch.kernels import budget_alloc as ba
from repro_torch.kernels import ref

F32 = np.float32
BETA = 2.2
# (M, K): paper-like, ragged, one row, one column, M > cs with K % cs != 0
SHAPES = [(6, 2000), (7, 1531), (1, 40), (5, 1), (11, 1003)]
# (M, K) -> cs of the dual cluster: paper, FL e2e, large round, ragged,
# production, short rows
DUAL_SPLITS = [((6, 2000), 8), ((2, 96), 1), ((32, 16384), 8),
               ((5, 53257), 8), ((1024, 131072), 8), ((11, 1003), 4),
               ((13, 257), 2), ((3, 255), 1), ((3, 24), 1)]
# (M, K) on the card: paper, large round, ragged, M > cs with K % cs != 0,
# and the cluster sizes 1 and 2
CARD_SHAPES = [(6, 2000), (32, 16384), (5, 53257), (11, 1003), (3, 24),
               (13, 257)]
# (adaptive, warm lam0, max_iters, tol): cold, adaptive, warm, capped
MODES = [(False, False, 4000, 1e-6), (True, False, 4000, 1e-6),
         (True, True, 4000, 1e-6), (False, True, 37, 1e-6)]


def sp1_operands(M, K, seed=0, warm=False):
    """Seeded SP1 operands formed as ``alpha_fair_waterfill`` forms them:
    ``(c, lam, w_pow, xcap, mask int32, cap, cap_safe)`` on the CPU."""
    rng = np.random.default_rng(seed)
    c = (rng.uniform(0, 0.1, (M, K)) * (rng.random((M, K)) < 0.5))
    c[-1] = 0.0                                          # an all-zero row
    c = torch.as_tensor(c.astype(F32))
    mu = torch.as_tensor(rng.uniform(0.1, 1.0, M).astype(F32))
    a = torch.as_tensor(rng.uniform(0.3, 1.0, M).astype(F32))
    mask = torch.as_tensor(np.arange(M) % 3 != 2)
    cap = torch.as_tensor(rng.uniform(0.05, 0.5, K).astype(F32))
    w = torch.clamp(mu * a, min=1e-12)
    w_pow = torch.where(mask, w ** (1.0 - BETA), torch.zeros_like(w))
    ratio = torch.where(c > 1e-12, cap[None, :] / torch.clamp(c, min=1e-12),
                        torch.full((), float("inf")))
    xcap = torch.amin(ratio, dim=1)
    mask = mask & (torch.amax(c, dim=1) > 1e-12) & torch.isfinite(xcap)
    xcap = torch.where(mask, xcap, torch.zeros_like(xcap))
    lam = (torch.as_tensor(rng.uniform(0.5, 2.0, K).astype(F32)) if warm
           else torch.ones(K))
    return (c, lam, w_pow, xcap, mask.to(torch.int32), cap,
            torch.clamp(cap, min=1e-12))


def handwritten(ops, k, adaptive):
    """k iterations of ``dual_step_ref`` and the update, written out."""
    c, lam, w_pow, xcap, mask, cap, cap_safe = ops
    eta, viol_prev = F32(0.5), F32(np.inf)
    for it in range(k):
        _, g = ref.dual_step_ref(c, lam, w_pow, xcap, mask, cap, cap_safe,
                                 BETA)
        if not adaptive:
            eta = F32(0.5) / F32(np.float64(F32(0.001)) * it + 1.0)
        lam = torch.clamp(lam * torch.exp(float(eta) * g), 1e-12, 1e12)
        viol = F32(max(float(torch.clamp(g, min=0.0).max()),
                       float((lam * g.abs()).max())))
        if adaptive:
            eta = (min(eta * F32(1.2), F32(1.5)) if viol <= viol_prev
                   else max(eta * F32(0.7), F32(0.2)))
            viol_prev = viol
    return lam


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("M,K", SHAPES)
@pytest.mark.parametrize("adaptive,warm", [(False, False), (True, False),
                                           (True, True), (False, True)])
def test_twin_is_handwritten_iterations(M, K, adaptive, warm):
    ops = sp1_operands(M, K, seed=M * 7 + K, warm=warm)
    for k in (0, 1, 9):
        lam, iters = ref.dual_ascent_ref(*ops, BETA, adaptive=adaptive,
                                         max_iters=k, tol=0.0)
        assert iters.dtype == torch.int32 and int(iters) == k
        assert torch.equal(_bits(lam), _bits(handwritten(ops, k, adaptive)))


@pytest.mark.parametrize("adaptive,warm", [(False, False), (True, True)])
@pytest.mark.parametrize("M,K", [(6, 2000), (1, 40)])
def test_twin_freezes_once_the_stop_rule_fires(M, K, adaptive, warm):
    """A loose tolerance stops the solve at n < max_iters: any larger cap
    gives the same lam and count, a cap of n - 1 stops one short."""
    ops = sp1_operands(M, K, seed=3, warm=warm)
    lam, n = ref.dual_ascent_ref(*ops, BETA, adaptive=adaptive,
                                 max_iters=4000, tol=1e-2)
    n = int(n)
    assert 1 < n < 4000
    for cap in (n, n + 1, n + 50):
        lam2, n2 = ref.dual_ascent_ref(*ops, BETA, adaptive=adaptive,
                                       max_iters=cap, tol=1e-2)
        assert int(n2) == n and torch.equal(_bits(lam2), _bits(lam))
    short, n3 = ref.dual_ascent_ref(*ops, BETA, adaptive=adaptive,
                                    max_iters=n - 1, tol=1e-2)
    assert int(n3) == n - 1
    assert torch.equal(_bits(short), _bits(handwritten(ops, n - 1, adaptive)))


def test_cold_step_size_is_one_fma_in_float32():
    """The kernel's ``0.5f / __fmaf_rn(0.001f, (float)it, 1.0f)`` equals the
    host's ``0.5 / f32(f64(f32(0.001)) * it + 1)`` for every it SP1 can
    run: the float64 product and sum are exact for it < 2^24, so both
    round once."""
    its = np.arange(4001)
    host = F32(0.5) / (np.float64(F32(0.001)) * its + 1.0).astype(F32)
    t = torch.as_tensor(its.astype(F32))
    denom = fma_exact(torch.full_like(t, 0.001), t, torch.ones_like(t))
    np.testing.assert_array_equal(
        denom.numpy(), (np.float64(F32(0.001)) * its + 1.0).astype(F32))
    card = torch.full_like(t, 0.5) / denom
    np.testing.assert_array_equal(card.numpy().view(np.int32),
                                  host.view(np.int32))


@pytest.mark.parametrize("MK,cs", DUAL_SPLITS)
def test_dual_split(MK, cs):
    M, K = MK
    assert ba.dual_split(M, K) == cs
    assert cs in (1, 2, 4, ba.ROW_SPLIT_MAX)
    assert cs == ba.ROW_SPLIT_MAX or K < 2 * cs * ba.DUAL_MIN_STRIPE


# ------------------------------------------- against repro (needs JAX)

@pytest.fixture(scope="module")
def repro_sp1():
    """``repro``'s waterfill and the scheduler tests' SP1 problems (imports
    JAX on demand, so the card-only tests collect without it)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import waterfill as jwf
    import test_torch_scheduler as tts
    return jnp, jwf, tts


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("name", ["paper_default", "tight_budgets",
                                  "elephant_storm"])
def test_waterfill_is_one_ascent_matching_repro(repro_sp1, monkeypatch,
                                                name, adaptive):
    jnp, jwf, tts = repro_sp1
    mu, a, c, mask, cap = tts.sp1_problem(name)
    lam0 = np.ones(c.shape[1], F32) if adaptive else None
    calls = []
    orig = hotpath.dual_ascent

    def spy(*args, **kw):
        out = orig(*args, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(hotpath, "dual_ascent", spy)
    t = twf.alpha_fair_waterfill(
        *map(torch.as_tensor, (mu, a, c, mask)), cap=torch.as_tensor(cap),
        beta=BETA, lam0=None if lam0 is None else torch.as_tensor(lam0),
        adaptive=adaptive)
    assert len(calls) == 1
    assert t.lam is calls[0][0] and t.iters is calls[0][1]
    r = jwf.alpha_fair_waterfill(
        *map(jnp.asarray, (mu, a, c, mask)), cap=jnp.asarray(cap), beta=BETA,
        lam0=None if lam0 is None else jnp.asarray(lam0), adaptive=adaptive)
    tts.assert_close(r.lam, t.lam, "lam")
    tts.assert_iters(int(r.iters), int(t.iters), (name, adaptive),
                     tts.NEAR_TIE_SP1)


# ------------------------------------------------ CUDA kernel (card only)

@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", CARD_SHAPES)
@pytest.mark.parametrize("adaptive,warm,max_iters,tol", MODES)
def test_cuda_ascent_matches_per_iteration_loop(hopper, M, K, adaptive,
                                                warm, max_iters, tol):
    """One ascent launch against the parent's algorithm on the card: the
    twin's loop over ``ba.dual_step`` launches, the update in torch and the
    stop rule on the host.  Equal counts, lam bit for bit."""
    ops = [t.to(hopper) for t in sp1_operands(M, K, seed=M + K, warm=warm)]
    ba.reset_launches()
    lam, iters = ba.dual_ascent(*ops, BETA, adaptive=adaptive,
                                max_iters=max_iters, tol=tol)
    assert ba.LAUNCHES["dual_step"] == 1
    assert iters.device == lam.device == ops[0].device and iters.shape == ()
    want, n = ref.dual_ascent_ref(*ops, BETA, adaptive=adaptive,
                                  max_iters=max_iters, tol=tol,
                                  step=ba.dual_step)
    assert int(iters) == int(n), (int(iters), int(n))
    assert torch.equal(_bits(lam), _bits(want))
    if max_iters == 37:
        assert int(iters) == 37


@pytest.mark.cuda
def test_cuda_waterfill_solves_in_one_launch_without_sync(hopper):
    """``alpha_fair_waterfill`` on the card: one ``dual_step`` launch for
    the whole ascent, and no host sync anywhere in the solve."""
    c, lam, w_pow, xcap, mask, cap, cap_safe = sp1_operands(6, 2000)
    mu = torch.rand(6, generator=torch.Generator().manual_seed(0)) + 0.1
    args = [t.to(hopper) for t in (mu, torch.ones(6), c, mask.bool(), cap)]
    twf.alpha_fair_waterfill(*args[:4], cap=args[4])      # build, warm up
    torch.cuda.synchronize()
    ba.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = twf.alpha_fair_waterfill(*args[:4], cap=args[4])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ba.LAUNCHES["dual_step"] == 1
    assert r.iters.is_cuda and r.iters.dtype == torch.int32
    assert float(r.violation) <= 1e-6


@pytest.mark.cuda
def test_cuda_refused_dual_launch_raises(hopper, monkeypatch):
    """A cluster size the card does not take, or more rows than shared
    memory holds, raises; nothing falls back or counts."""
    ops = [t.to(hopper) for t in sp1_operands(6, 2000)]
    ba.reset_launches()
    monkeypatch.setattr(ba, "dual_split", lambda M, K: 3)
    with pytest.raises(RuntimeError):
        ba.dual_step(*ops, BETA)
    with pytest.raises(RuntimeError):
        ba.dual_ascent(*ops, BETA, adaptive=False, max_iters=5, tol=0.0)
    assert ba.LAUNCHES["dual_step"] == 0
    monkeypatch.undo()
    rows = ba._lib().ba_dual_smem_limit() // 4 + 1
    big = [torch.zeros((rows, 4), device=hopper), torch.ones(4, device=hopper),
           torch.ones(rows, device=hopper), torch.ones(rows, device=hopper),
           torch.ones(rows, dtype=torch.int32, device=hopper),
           torch.ones(4, device=hopper), torch.ones(4, device=hopper)]
    with pytest.raises(ValueError):
        ba.dual_step(*big, BETA)
