"""DP clip-and-accumulate: the port's twins against ``repro``'s Pallas
kernels (interpret mode) and oracles on the CPU, the kernel build map, and
(on a Hopper card only) the CUDA kernels against their twins.

Inputs are seeded numpy arrays handed to both frameworks.  Contracts:

* ``clip_accumulate``: bitwise, given the same scales (rows summed in
  order, one correctly rounded FMA each -- the Pallas body as XLA
  contracts it);
* ``rownorms``: 1e-6 relative (the sum order over P is each library's);
* ``dp_clip_accumulate``: norms 1e-6 relative; the clipped sum within
  1e-6 of its largest entry, since a one-ulp norm moves every scale.

``repro``'s Pallas kernels assert ``P % min(4096, P) == 0``, so ragged P
is checked against ``repro/kernels/ref.py`` instead.
"""
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.fp import fma_exact
from repro_torch.kernels import build
from repro_torch.kernels import dp_clip_noise as dp
from repro_torch.kernels import ref

# (B, P): Pallas-able (P <= 4096 or a multiple of it), and ragged
PALLAS_SHAPES = [(3, 4096), (6, 8192), (1, 100), (4, 4096 * 3), (8, 257)]
RAGGED_SHAPES = [(3, 4096 * 7 + 13), (6, 5003), (2, 1)]
NORM_RTOL = 1e-6


@pytest.fixture(scope="module")
def jax_side():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import dp_clip_noise as jdp
    from repro.kernels import ref as jref
    return jnp, jdp, jref


@pytest.fixture
def hopper():
    """Skip unless an sm_90 card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    return torch.device("cuda")


def _case(B, P, seed=0):
    """Gradient-like rows of different scales, row 1 all zero."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((B, P)) * rng.uniform(0.01, 2.0, (B, 1))
    if B > 1:
        g[1] = 0.0
    return (g.astype(np.float32),
            rng.uniform(0.0, 1.0, B).astype(np.float32))


def _rel_ok(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.all(np.abs(got - want) <= rtol * np.abs(want)))


@pytest.mark.parametrize("B,P", PALLAS_SHAPES)
def test_twins_match_pallas_interpret(jax_side, B, P):
    jnp, jdp, _ = jax_side
    g, s = _case(B, P)
    want_acc = np.asarray(jdp.clip_accumulate(jnp.asarray(g), jnp.asarray(s),
                                              interpret=True))
    got_acc = ref.clip_accumulate_ref(torch.from_numpy(g),
                                      torch.from_numpy(s)).numpy()
    assert np.array_equal(got_acc, want_acc)
    want_sq = np.asarray(jdp.rownorms(jnp.asarray(g), interpret=True))
    got_sq = ref.rownorms_ref(torch.from_numpy(g)).numpy()
    assert _rel_ok(got_sq, want_sq, NORM_RTOL)


@pytest.mark.parametrize("B,P", PALLAS_SHAPES)
@pytest.mark.parametrize("clip", [0.5, 1e-3, 1e6])
def test_dp_clip_accumulate_matches_pallas(jax_side, B, P, clip):
    jnp, jdp, _ = jax_side
    g, _ = _case(B, P, seed=1)
    want, want_n = jdp.dp_clip_accumulate(jnp.asarray(g), clip,
                                          interpret=True)
    got, got_n = dp.dp_clip_accumulate(torch.from_numpy(g), clip)
    want, want_n = np.asarray(want), np.asarray(want_n)
    assert _rel_ok(got_n.numpy(), want_n, NORM_RTOL)
    assert np.allclose(got.numpy(), want, rtol=0,
                       atol=1e-6 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("B,P", RAGGED_SHAPES)
def test_twins_match_reference_oracles_at_ragged_p(jax_side, B, P):
    jnp, _, jref = jax_side
    g, s = _case(B, P, seed=2)
    want = np.asarray(jref.clip_accumulate_ref(jnp.asarray(g),
                                               jnp.asarray(s)))
    got = ref.clip_accumulate_ref(torch.from_numpy(g), torch.from_numpy(s))
    assert np.array_equal(got.numpy(), want)
    assert _rel_ok(ref.rownorms_ref(torch.from_numpy(g)).numpy(),
                   np.asarray(jref.rownorms_ref(jnp.asarray(g))), NORM_RTOL)


def test_zero_row_has_norm_zero_and_scale_one():
    g = torch.zeros((2, 37))
    g[0] = 3.0
    total, norms = dp.dp_clip_accumulate(g, 1.0)
    assert norms[1] == 0.0
    assert torch.equal(dp.clip_scales(norms, 1.0)[1], torch.tensor(1.0))
    assert torch.allclose(total, torch.full((37,), 3.0 / norms[0].item()))


def test_clip_scales_divide_once():
    """``clip / x`` in one IEEE division (``python_float / tensor`` in
    PyTorch would take a reciprocal and multiply: two roundings)."""
    x = torch.tensor(np.random.default_rng(3).uniform(1e-3, 10, 10_000),
                     dtype=torch.float32)
    want = np.minimum(np.float32(1.0), np.float32(0.7) / x.numpy())
    assert np.array_equal(dp.clip_scales(x, 0.7).numpy(), want)


def test_fma_exact_is_correctly_rounded():
    """Random operands against exact rationals, plus a case where float64
    rounding lands on a float32 halfway point (double rounding)."""
    rng = np.random.default_rng(4)
    n = 400
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
         ).astype(np.float32)
    a[0], b[0], c[0] = 1 + 2 ** -23, 2 ** -24 * (1 - 2 ** -23), 1 + 2 ** -23
    got = fma_exact(*map(torch.from_numpy, (a, b, c))).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf))]
        best = min(abs(Fraction(float(t)) - exact) for t in cands)
        assert abs(Fraction(float(got[i])) - exact) == best, i
    assert got[0] == np.float32(1 + 2 ** -23)       # not 1 + 2**-22


def test_launchers_refuse_cpu_tensors():
    g = torch.ones((2, 8))
    with pytest.raises(ValueError):
        dp.rownorms(g)
    with pytest.raises(ValueError):
        dp.clip_accumulate(g, torch.ones(2))


def test_build_map_names_every_source_and_symbol():
    sources = {p.stem for p in build.CSRC.glob("*.cu")}
    assert sources == set(build.SIGNATURES) == {"budget_alloc",
                                                "dp_clip_noise"}
    for name, sigs in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        c_api = src[src.index('extern "C"'):]
        for fn in sigs:
            assert re.search(rf"\b{fn}\s*\(", c_api), (name, fn)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("B,P", [(6, 4096 * 7 + 13), (3, 4096 * 7 + 13),
                                 (1, 1000), (2, 32768), (6, 1 << 20)])
def test_cuda_kernels_match_twins(hopper, B, P):
    g, s = _case(B, P, seed=5)
    g, s = torch.from_numpy(g).to(hopper), torch.from_numpy(s).to(hopper)
    dp.reset_launches()
    sq, sq2 = dp.rownorms(g), dp.rownorms(g)
    assert torch.equal(sq, sq2)                       # bitwise stable
    assert _rel_ok(sq.cpu(), ref.rownorms_ref(g).cpu(), 1e-5)
    acc, acc2 = dp.clip_accumulate(g, s), dp.clip_accumulate(g, s)
    assert torch.equal(acc, acc2)
    assert torch.equal(acc, ref.clip_accumulate_ref(g, s))
    total, norms = dp.dp_clip_accumulate(g, 0.5)
    assert torch.equal(total, ref.clip_accumulate_ref(
        g, dp.clip_scales(norms, 0.5)))
    assert dp.LAUNCHES == {"rownorms": 3, "clip_accumulate": 3}


@pytest.mark.cuda
def test_cuda_launchers_reject_what_the_kernels_do_not_take(hopper):
    g = torch.ones((4, 8), device=hopper)
    with pytest.raises(TypeError):
        dp.rownorms(g.double())
    with pytest.raises(ValueError):
        dp.rownorms(g.T)                                 # not contiguous
    with pytest.raises(ValueError):
        dp.clip_accumulate(g, torch.ones(4))             # mixed devices
    with pytest.raises(ValueError):
        dp.clip_accumulate(g, torch.ones(3, device=hopper))
